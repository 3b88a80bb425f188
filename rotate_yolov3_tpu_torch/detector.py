"""High-level detection API: uint8 images -> rotated detections on one device.

Torch counterpart of ``rotate_yolov3_tpu/detector.py``: the BN-folded
Darknet forward (1/255 folded into the first conv, head convs permuted to
field-major channels), score-first top-k, the gathered decode (kernel A)
and the two-stage rotated NMS (kernel B with pair algo ``iou_algo``, then
the greedy fixpoint), or the NMS through an ``iou_matrix_fn`` hook (e.g.
kernel E), all on the ``device`` the detector was built for.

The reference's ``bake_params`` (closing the XLA program over the weights)
has no PyTorch counterpart — PyTorch runs eagerly — and is dropped.
Not ported yet, and refused with ``NotImplementedError``: ``devices > 1``
(data parallelism) and ``packed_stem=True`` (see ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .config.parse import parse_model_cfg
from .models.darknet import (ConvSpec, FusedDarknet, NetworkSpec,
                             build_network, fuse_bn, init_params, layer_key)
from .models.weights_io import load_weights_file
from .models.yolo_head import decode_all, field_major_perm
from .ops.rotated_nms import non_max_suppression_fused
from .ops.skew_iou_cuda import check_algo


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``: "cuda" raises without a card (no
    fallback to the CPU), and only "cuda" and "cpu" are accepted."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r}: no CUDA device is available "
            f"(use device='cpu' for the plain-PyTorch path)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


class Detector:
    """Rotated-object detector on one device.

        det = Detector("cfg/yolov3-rotate-hrsc.cfg", weights="model.weights")
        boxes, mask = det(images)   # (B,H,W,3) uint8 -> (B,K,7), (B,K)

    Detection rows are (cx, cy, w, h, theta, score, class) in net-input
    pixels, score-sorted, zeroed where not kept, padded to ``max_det``, with
    a keep mask.

    Args:
      cfg_path: Darknet .cfg file.
      weights: optional darknet .weights checkpoint.
      img_size: net input size (defaults to the cfg's [net] width).
      conf_thres / nms_thres / max_det: post-processing knobs; ``max_det``
        caps both pre-NMS candidates and output capacity.
      compute_dtype: dtype of the conv stack (torch.bfloat16 on the card in
        production; torch.float32 for parity runs). Decode and NMS stay f32.
      iou_matrix_fn: NMS through a pairwise-IoU hook instead of the kill
        mask: ``fn(boxes (N, 5), boxes (M, 5)) -> (N, M)``, called once per
        image, cross-class pairs zeroed, greedy keep of ``IoU > nms_thres``.
        ``ops.skew_iou_cuda.skew_iou_matrix_auto_nms`` (kernel E on the card,
        the argsort oracle on the CPU) and ``skew_iou_matrix`` (kernel E)
        are drop-ins; these (and partials of them) are called once per
        batch, one launch of kernel E.
      seed: seed of the random init used when no weights are given.
      approx_top_k: strided-bin top-k (``ops.topk.strided_topk``); None
        means strided on CUDA and exact on the CPU.
      field_major_heads: permute head-conv channels to field-major so the
        score pass reads contiguous slices (same results).
      iou_algo: pair algo of the kill mask (kernel B): "green"
        (Green's-theorem slab clipping), "green2" (the same in B's rotated
        frame) or "candidates" (24 candidates, 8-slot rank sort). All exact;
        an unknown name raises ValueError.
      device: "cuda" (default) or "cpu". CUDA without a card raises.
    """

    def __init__(self, cfg_path: str, weights: Optional[str] = None,
                 img_size: Optional[int] = None, conf_thres: float = 0.3,
                 nms_thres: float = 0.4, max_det: int = 128,
                 compute_dtype: torch.dtype = torch.float32,
                 iou_matrix_fn=None, seed: int = 0, devices: int = 0,
                 packed_stem: bool = False,
                 approx_top_k: Optional[bool] = None,
                 field_major_heads: bool = True,
                 iou_algo: str = "green", device="cuda"):
        if devices and devices > 1:
            raise NotImplementedError(
                "Detector(devices>1): data parallelism is not ported yet "
                "(ROADMAP queue 1, item 12)")
        if packed_stem:
            raise NotImplementedError(
                "Detector(packed_stem=True) is not ported yet (ROADMAP "
                "queue 1, item 13)")
        check_algo(iou_algo)
        self.iou_algo = iou_algo
        self.iou_matrix_fn = iou_matrix_fn
        self.device = resolve_device(device)
        self.spec: NetworkSpec = build_network(
            parse_model_cfg(cfg_path), img_size=img_size)
        self.img_size = self.spec.img_size
        self.conf_thres = conf_thres
        self.nms_thres = nms_thres
        self.max_det = max_det
        self.compute_dtype = compute_dtype

        params, state = init_params(self.spec, seed)
        self.seen, self.epoch = 0, -1
        if weights is not None:
            params, state, meta = load_weights_file(
                self.spec, params, state, weights)
            self.seen, self.epoch = meta.seen, meta.epoch
        self.params, self.state = params, state

        # field-major head channels need each head conv to feed ONLY its
        # yolo layer (true for every darknet yolov3 cfg, checked anyway)
        self.field_major_heads = bool(field_major_heads)
        if self.field_major_heads:
            for ys in self.spec.yolo_specs:
                prev = [l for l in self.spec.layers
                        if getattr(l, "index", None) == ys.index - 1]
                if not (prev and isinstance(prev[0], ConvSpec)
                        and prev[0].out_c == ys.na * ys.no
                        and prev[0].index not in self.spec.routs):
                    self.field_major_heads = False

        if approx_top_k is None:
            approx_top_k = self.device.type == "cuda"
        self.approx_top_k = approx_top_k
        self.refresh_params()

    def refresh_params(self, params=None, state=None) -> None:
        """Rebuild the fused network: BN fold, 1/255 fold into the first
        conv, field-major head permutation — all on the f32 kernels, on the
        detector's device (so the fused weights depend only on the values
        given, wherever they lie: a detector refreshed from a trainer's
        card tensors equals one loaded from its saved file) — then the
        cast to the compute dtype."""
        if params is not None:
            self.params = params
        if state is not None:
            self.state = state
        params, state = ({k: {n: t.to(self.device) for n, t in d.items()}
                          for k, d in tree.items()}
                         for tree in (self.params, self.state))
        fused = {k: dict(v) for k, v in
                 fuse_bn(self.spec, params, state).items()}
        # conv is linear: the input normalisation folds into the first
        # kernel (bias untouched), so the net consumes raw 0..255 pixels
        first = layer_key(self.spec.conv_specs[0].index)
        fused[first]["kernel"] = fused[first]["kernel"] * (1.0 / 255.0)
        if self.field_major_heads:
            for ys in self.spec.yolo_specs:
                key = layer_key(ys.index - 1)
                perm = torch.from_numpy(field_major_perm(ys)).to(self.device)
                fused[key]["kernel"] = fused[key]["kernel"][perm]
                fused[key]["bias"] = fused[key]["bias"][perm]
        self.net = FusedDarknet(self.spec, fused).to(dtype=self.compute_dtype)

    def _images(self, images) -> torch.Tensor:
        x = torch.as_tensor(images)
        if x.ndim == 3:
            x = x[None]
        if not (x.shape[1] == x.shape[2] == self.img_size):
            raise ValueError(
                f"expected {self.img_size}x{self.img_size} letterboxed "
                f"input, got {tuple(x.shape)}; use data.letterbox first")
        return x.to(self.device, non_blocking=True).to(self.compute_dtype)

    @torch.inference_mode()
    def heads(self, images):
        """Raw (B, H, W, na·no) head maps in the compute dtype (field-major
        channels when ``field_major_heads``)."""
        return self.net(self._images(images))

    @torch.inference_mode()
    def __call__(self, images) -> Tuple[torch.Tensor, torch.Tensor]:
        """Run detection on (B, H, W, 3) images (uint8 or float 0-255)."""
        heads = self.net(self._images(images))
        return non_max_suppression_fused(
            heads, self.spec.yolo_specs, conf_thres=self.conf_thres,
            nms_thres=self.nms_thres, max_det=self.max_det,
            iou_matrix_fn=self.iou_matrix_fn, approx_top_k=self.approx_top_k,
            field_major=self.field_major_heads, iou_algo=self.iou_algo)

    @torch.inference_mode()
    def predict_raw(self, images) -> torch.Tensor:
        """Decoded predictions before NMS (B, N, 6+nc) — eval-path hook."""
        heads = self.net(self._images(images))
        if self.field_major_heads:
            # undo the field-major permutation: canonical anchor-major
            heads = [h[..., torch.from_numpy(np.argsort(field_major_perm(ys)))
                       .to(h.device)]
                     for h, ys in zip(heads, self.spec.yolo_specs)]
        return decode_all([h.float() for h in heads], self.spec.yolo_specs)


def detections_to_numpy(dets, mask):
    """Unpad a fixed-shape detection batch to per-image numpy arrays."""
    dets = dets.detach().float().cpu().numpy() if torch.is_tensor(dets) \
        else np.asarray(dets)
    mask = mask.detach().cpu().numpy() if torch.is_tensor(mask) \
        else np.asarray(mask)
    return [d[m] for d, m in zip(dets, mask)]
