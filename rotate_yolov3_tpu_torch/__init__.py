"""rotate_yolov3_tpu_torch — the PyTorch/CUDA port of ``rotate_yolov3_tpu``.

The JAX package beside it stays the reference; this package mirrors its
layout and names so each counterpart is easy to find, imports ``torch`` and
numpy only (never jax, never ``rotate_yolov3_tpu``), and replaces each TPU
Pallas kernel on its path with a CUDA kernel written by hand for Hopper
(``csrc/``, built by ``_build`` at first use). On a CPU tensor every kernel
wrapper runs its plain PyTorch version instead.

Ported: everything the JAX package does. The serving path of ``Detector``
(cfg and ``.weights`` loading, the BN-folded Darknet with the canonical or
the packed stem, score-first top-k, the gathered decode with the row-gather
kernel for heads of one na or several, rotated NMS with the skew-IoU
kill-mask kernel or the fused greedy-NMS kernel, the serving options),
``python -m rotate_yolov3_tpu_torch.detect``; the DOTA tool chain with its
on-device tile pipeline, ``python -m rotate_yolov3_tpu_torch.dota``; the
data pipeline, evaluation (``python -m rotate_yolov3_tpu_torch.test``) and
training with the skew-IoU loss and ``.pt``/``.weights`` checkpoints
(``python -m rotate_yolov3_tpu_torch.train``), on one device or several;
the profiling, device and plotting utilities (``utils/``); and the anchor
and reference-check tools (``python -m
rotate_yolov3_tpu_torch.tools.kmeans_anchors`` / ``.verify_reference``).
"""

__version__ = "0.1.0"
