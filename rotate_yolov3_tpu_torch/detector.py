"""High-level detection API: uint8 images -> rotated detections.

Torch counterpart of ``rotate_yolov3_tpu/detector.py``: the BN-folded
Darknet forward (1/255 folded into the first conv, head convs permuted to
field-major channels), score-first top-k, the gathered decode (kernel A)
and the two-stage rotated NMS (kernel B with pair algo ``iou_algo``, then
the greedy fixpoint), or the NMS through an ``iou_matrix_fn`` hook (e.g.
kernel E), all on the ``device`` the detector was built for.

``devices=N`` is the reference's data-parallel inference: one replica of
the fused weights per device of ``parallel.mesh.make_mesh(N, device)``,
the batch split contiguously over them, each replica's detections on its
device, the results gathered on the first. Replicas run in one thread each
(as ``torch.nn.parallel.parallel_apply`` runs them): the NMS's greedy
fixpoint waits on its device between passes, and in one thread those waits
would serialise the replicas.

``packed_stem=True`` runs the stem in its packed form
(``models.packed_stem``), as the reference's does; training and checkpoint
IO keep the canonical spec. The reference's ``bake_params`` (closing the
XLA program over the weights) has no PyTorch counterpart — PyTorch runs
eagerly — and is dropped.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import List, Optional, Tuple

import numpy as np
import torch

from .config.parse import parse_model_cfg
from .models.darknet import (ConvSpec, FusedDarknet, NetworkSpec,
                             build_network, fuse_bn, init_params, layer_key)
from .models.packed_stem import pack_stem
from .models.weights_io import load_weights_file
from .models.yolo_head import decode_all, field_major_perm
from .ops.rotated_nms import non_max_suppression_fused
from .ops.skew_iou_cuda import check_algo
from .parallel.mesh import make_mesh
from .utils.device import resolve_device


class Detector:
    """Rotated-object detector on one device, or data-parallel on several.

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
      devices: more than 1: data-parallel over the first ``devices``
        cards (``make_mesh``; more than there are raises ``ValueError``),
        or as many replicas on the CPU; a call's batch must divide by it.
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
        check_algo(iou_algo)
        self.iou_algo = iou_algo
        self.iou_matrix_fn = iou_matrix_fn
        self.device = resolve_device(device)
        # the replicas' devices; the first holds the gathered results
        self.mesh: List[torch.device] = [self.device]
        if devices and devices > 1:
            self.mesh = make_mesh(devices, self.device)
            self.device = self.mesh[0]
        self.spec: NetworkSpec = build_network(
            parse_model_cfg(cfg_path), img_size=img_size)
        self.img_size = self.spec.img_size
        self.conf_thres = conf_thres
        self.nms_thres = nms_thres
        self.max_det = max_det
        self.compute_dtype = compute_dtype
        self.packed_stem = bool(packed_stem)

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
        """Rebuild the fused network: BN fold, then the packed stem with
        1/255 folded into its first kernel (``packed_stem``) or the 1/255
        fold into the first conv, field-major head permutation — all on the
        f32 kernels, on the detector's device (so the fused weights depend
        only on the values given, wherever they lie: a detector refreshed
        from a trainer's card tensors equals one loaded from its saved
        file) — then the cast to the compute dtype, and a copy on every
        other device of ``mesh``."""
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
        if self.packed_stem:
            # the inference spec: self.spec stays canonical for training
            # and checkpoint IO
            self._infer_spec, fused = pack_stem(self.spec, fused,
                                                input_scale=1.0 / 255.0)
        else:
            self._infer_spec = self.spec
            first = layer_key(self.spec.conv_specs[0].index)
            fused[first]["kernel"] = fused[first]["kernel"] * (1.0 / 255.0)
        if self.field_major_heads:
            for ys in self.spec.yolo_specs:
                key = layer_key(ys.index - 1)
                perm = torch.from_numpy(field_major_perm(ys)).to(self.device)
                fused[key]["kernel"] = fused[key]["kernel"][perm]
                fused[key]["bias"] = fused[key]["bias"][perm]
        self.net = FusedDarknet(self._infer_spec, fused).to(
            dtype=self.compute_dtype)
        nets = {self.device: self.net}
        for dev in self.mesh:
            if dev not in nets:
                nets[dev] = FusedDarknet(self._infer_spec, {
                    k: {n: t.to(dev) for n, t in d.items()}
                    for k, d in fused.items()}).to(dtype=self.compute_dtype)
        self.nets = [nets[dev] for dev in self.mesh]

    def _images(self, images, device=None) -> torch.Tensor:
        x = torch.as_tensor(images)
        if x.ndim == 3:
            x = x[None]
        if not (x.shape[1] == x.shape[2] == self.img_size):
            raise ValueError(
                f"expected {self.img_size}x{self.img_size} letterboxed "
                f"input, got {tuple(x.shape)}; use data.letterbox first")
        return x.to(device or self.device,
                    non_blocking=True).to(self.compute_dtype)

    @torch.inference_mode()
    def heads(self, images):
        """Raw (B, H, W, na·no) head maps in the compute dtype (field-major
        channels when ``field_major_heads``)."""
        return self.net(self._images(images))

    def __call__(self, images) -> Tuple[torch.Tensor, torch.Tensor]:
        """Run detection on (B, H, W, 3) images (uint8 or float 0-255).
        With several devices, B must divide by their number: replica r
        takes the r-th contiguous slice."""
        if len(self.mesh) == 1:
            return self._detect(self.net, images, self.device)
        x = torch.as_tensor(images)
        x = x[None] if x.ndim == 3 else x
        n = len(self.mesh)
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} not divisible by {n} "
                             f"devices")
        parts = x.chunk(n)
        with ThreadPoolExecutor(max_workers=n) as pool:
            futures = [pool.submit(self._detect, net, part, dev)
                       for net, part, dev in zip(self.nets, parts,
                                                 self.mesh)]
            outs = [f.result() for f in futures]
        return tuple(torch.cat([o[i].to(self.device) for o in outs])
                     for i in range(2))

    @torch.inference_mode()
    def _detect(self, net: FusedDarknet, images, device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One replica's detections of ``images`` on ``device`` (every
        kernel launches under that device, on its current stream)."""
        x = self._images(images, device)
        with torch.cuda.device(x.device) if x.is_cuda else nullcontext():
            heads = net(x)
            return non_max_suppression_fused(
                heads, self.spec.yolo_specs, conf_thres=self.conf_thres,
                nms_thres=self.nms_thres, max_det=self.max_det,
                iou_matrix_fn=self.iou_matrix_fn,
                approx_top_k=self.approx_top_k,
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
