"""On-device DOTA tile pipeline: full source image -> merged detections.

Counterpart of ``rotate_yolov3_tpu/data/dota/device_tiles.py``. The DOTA
devkit splits huge scenes into tiles offline on the host, detects per tile
and merges on the host (``img_split``, ``result_merge``: the offline path,
kept as the oracle). Here one call takes the full-resolution source image
and returns merged, source-coordinate detections, with every stage on the
detector's device:

  1. **tiles**: the uint8 source goes to the device once and is padded
     there; the overlapping tile grid is static per source shape
     (``img_split.tile_origins``), so the T tiles are static slices;
  2. **letterbox**: ``data.letterbox.letterbox_torch`` resizes the (T,
     subsize, subsize, 3) tile batch to the net input size (ratio and pad
     are Python numbers; the resize is PyTorch's antialiased bilinear
     ``interpolate``, the resize of ``jax.image.resize``);
  3. **detection**: one ``Detector.__call__`` over the tile batch;
  4. **re-map**: inverse letterbox (``ops.boxes.scale_coords_rotated``),
     then the tile origins;
  5. **merge**: the exact global top-k of the T·max_det scores (ties keep
     the lower flat index, as ``lax.top_k`` does) to m = min(max_merged,
     T·max_det) rows, then class-aware greedy rotated NMS through the fused
     kernel C (``ops.nms_greedy``) while m <= 1024, else through kernel B
     and the greedy fixpoint.

Fixed shapes everywhere: the only capacity approximation against the host
merge is ``max_merged``. Source images are bucketed: (H, W) pads up to the
next multiple of the tile stride (``subsize - gap``). PyTorch runs eagerly,
so nothing is compiled or cached per bucket.

**Tile parallelism.** With a ``Detector(devices=N)`` the (T, sub, sub, 3)
tile stack is padded with zero tiles to a multiple of N before the
letterbox, stage 3 runs on the detector's N replicas (kernels A and B on
each), the padded tiles' detections are dropped, and stages 4-5 (kernel C)
run on the first device, where the detector gathers its results. The
merged detections equal the single-device pipeline's.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ...ops.boxes import scale_coords_rotated
from ...ops.nms_greedy import nms_greedy, nms_greedy_fused_ok
from ...ops.rotated_nms import keep_two_stage
from ...ops.topk import exact_topk
from ..letterbox import letterbox_torch
from .img_split import tile_origins


class DeviceTilePipeline:
    """Full image -> merged detections on the detector's device (see the
    module docstring).

    Args:
      detector: a ``Detector``; its ``max_det`` is the per-tile capacity.
      subsize / gap: devkit tile grid parameters (1024/200 defaults).
      merge_nms_thres: cross-tile NMS threshold (devkit merge uses 0.3).
      max_merged: merged-detection capacity per source image.
    """

    def __init__(self, detector, subsize: int = 1024, gap: int = 200,
                 merge_nms_thres: float = 0.3, max_merged: int = 1024):
        assert gap < subsize, (subsize, gap)
        self.det = detector
        self.subsize = int(subsize)
        self.gap = int(gap)
        self.slide = self.subsize - self.gap
        self.merge_nms_thres = float(merge_nms_thres)
        self.max_merged = int(max_merged)

    def bucket_shape(self, h: int, w: int) -> Tuple[int, int]:
        """Pad-up target shape: next slide multiple >= max(dim, subsize)."""
        def up(v):
            v = max(int(v), self.subsize)
            return self.subsize + -(-(v - self.subsize) // self.slide) \
                * self.slide
        return up(h), up(w)

    def num_tiles(self, h: int, w: int) -> int:
        hp, wp = self.bucket_shape(h, w)
        return len(tile_origins(wp, hp, self.subsize, self.gap))

    def upload(self, img: np.ndarray) -> torch.Tensor:
        """HWC uint8 source -> the zero-padded (HP, WP, 3) bucket on the
        detector's device: one host-to-device copy of the source, padded
        on the device (padding on the host first costs a full extra pass
        over the image there)."""
        h, w = img.shape[:2]
        hp, wp = self.bucket_shape(h, w)
        src = torch.from_numpy(np.ascontiguousarray(img)).to(self.det.device)
        padded = src.new_zeros((hp, wp) + tuple(img.shape[2:]))
        padded[:h, :w] = src
        return padded

    def letterbox_tiles(self, img: torch.Tensor):
        """Stages 1-2: (HP, WP, 3) uint8 bucket -> letterboxed (T', S, S, 3)
        f32 tiles, ratio, pad and the (T, 2) f32 tile origins. T' is T
        padded with zero tiles to a multiple of the detector's devices."""
        hp, wp = img.shape[:2]
        sub = self.subsize
        origins = tile_origins(wp, hp, sub, self.gap)
        tiles = [img[y0:y0 + sub, x0:x0 + sub] for (x0, y0) in origins]
        n = len(self.det.mesh)
        tiles += [torch.zeros_like(tiles[0])] * (-len(tiles) % n)
        lb, ratio, pad = letterbox_torch(torch.stack(tiles),
                                         self.det.img_size)
        org = torch.tensor(origins, dtype=torch.float32, device=img.device)
        return lb, ratio, pad, org

    def select(self, dets, mask, ratio, pad, org):
        """Stage 4 and the top-k of stage 5: per-tile (T', max_det, 7)
        detections and mask (the T tiles of ``org`` first; padding tiles
        after them are dropped) -> source coordinates -> the m best rows
        over all tiles. Returns (m, 7) rows, (m,) validity and (m,) flat
        indices."""
        dets, mask = dets[:len(org)], mask[:len(org)]
        dets = scale_coords_rotated(dets, ratio, pad)
        cx = dets[..., 0] + org[:, 0, None]
        cy = dets[..., 1] + org[:, 1, None]
        dets = torch.cat([cx[..., None], cy[..., None], dets[..., 2:]],
                         dim=-1)
        t, k = mask.shape
        scores = torch.where(mask, dets[..., 5], 0.0).reshape(-1)
        top_s, top_i = exact_topk(scores, min(self.max_merged, t * k))
        return dets.reshape(t * k, 7)[top_i], top_s > 0.0, top_i

    def merge_nms(self, rows, valid, keep_fn: Callable = nms_greedy):
        """Rest of stage 5: class-aware greedy NMS of the m rows, zero-pad
        to ``max_merged``. ``keep_fn`` (boxes, cls_id, valid, iou_thr) ->
        keep is the fused kernel's wrapper; a check passes its plain
        version. m above the fused kernel's cap takes the two-stage path."""
        m = rows.shape[0]
        boxes = torch.where(valid[:, None], rows[:, :5], 0.0)
        cls_id = rows[:, 6].to(torch.int32)
        nc = self.det.spec.yolo_specs[0].num_classes
        if not nms_greedy_fused_ok(m):
            keep_fn = keep_two_stage
        keep = keep_fn(boxes[None].contiguous(),
                       cls_id[None].contiguous() if nc > 1 else None,
                       valid[None], iou_thr=self.merge_nms_thres)[0]
        out = torch.where(keep[:, None], rows, 0.0)
        if m < self.max_merged:
            out = torch.nn.functional.pad(out, (0, 0, 0, self.max_merged - m))
            keep = torch.nn.functional.pad(keep, (0, self.max_merged - m))
        return out, keep

    @torch.inference_mode()
    def __call__(self, img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Full-resolution HWC RGB uint8 image -> (max_merged, 7) dets +
        mask, as numpy arrays: all five stages on the device, then one copy
        of the result to the host.

        Detections are (cx, cy, w, h, theta, score, class) in SOURCE-image
        pixels, score-descending, zero-padded with a validity mask.
        """
        lb, ratio, pad, org = self.letterbox_tiles(self.upload(img))
        dets, mask = self.det(lb)
        rows, valid, _ = self.select(dets, mask, ratio, pad, org)
        out, keep = self.merge_nms(rows, valid)
        return out.cpu().numpy(), keep.cpu().numpy()
