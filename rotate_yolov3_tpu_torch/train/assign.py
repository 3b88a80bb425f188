"""Rotated-anchor target assignment, vectorized and fixed-shape.

Counterpart of ``rotate_yolov3_tpu/train/assign.py``: ground truth is
padded to ``MAX_GT`` slots per image, and each head's assignment is one
batched tensor program:

  * anchor fit = wh-IoU(gt, anchor) * |cos(theta_gt - anchor_angle)|;
  * each valid GT is assigned to its best-fit anchor at its center cell if
    the fit exceeds ``hyp.iou_t``;
  * outputs are per-GT gather indices + regression targets and a dense
    objectness target grid written by one scatter.

The objectness ignore region depends on the decoded predictions, so it
lives in ``train.loss`` (``objectness_ignore``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch

from ..models.darknet import YoloSpec
from ..models.yolo_head import anchor_tables
from ..ops.boxes import normalize_angle


class HeadTargets(NamedTuple):
    """Fixed-shape assignment result for one YOLO head."""
    flat_idx: torch.Tensor    # (B, G) int32 index into H*W*na, -1 if none
    assigned: torch.Tensor    # (B, G) bool
    txy: torch.Tensor         # (B, G, 2) cell-offset targets in [0, 1)
    twh: torch.Tensor         # (B, G, 2) log-size targets vs anchor wh
    tangle: torch.Tensor      # (B, G) angle offset vs anchor angle (radians)
    tcls: torch.Tensor        # (B, G) int32 class ids
    tbox_abs: torch.Tensor    # (B, G, 5) absolute GT rotated box (pixels)
    obj_target: torch.Tensor  # (B, H, W, na) float 0/1


def _wh_iou(gt_wh: torch.Tensor, anchor_wh: torch.Tensor) -> torch.Tensor:
    """Darknet wh-IoU, the overlap of co-centered axis-aligned boxes:
    gt_wh (B, G, 1, 2), anchor_wh (1, 1, na, 2) -> (B, G, na)."""
    inter = (torch.minimum(gt_wh[..., 0], anchor_wh[..., 0])
             * torch.minimum(gt_wh[..., 1], anchor_wh[..., 1]))
    union = (gt_wh[..., 0] * gt_wh[..., 1]
             + anchor_wh[..., 0] * anchor_wh[..., 1] - inter)
    return inter / (union + 1e-9)


def build_targets_head(targets: torch.Tensor, valid: torch.Tensor,
                       spec: YoloSpec, img_size: int,
                       iou_t: float) -> HeadTargets:
    """Assign padded GT boxes to one head's anchor grid.

    Args:
      targets: (B, G, 6) = (cls, cx, cy, w, h, theta), cx..h normalized to
        [0, 1] of the net input, theta in radians.
      valid: (B, G) bool — real (non-padding) GT rows.
      spec: head metadata; img_size: the batch's net input size; iou_t:
        assignment threshold from hyp.
    """
    b, g = targets.shape[:2]
    grid = img_size // spec.stride
    awh, aang = anchor_tables(spec, targets.device)    # (na, 2), (na,)
    na = spec.na

    cls_id = targets[..., 0].to(torch.int32)
    xy = targets[..., 1:3] * img_size       # pixels
    wh = targets[..., 3:5] * img_size
    theta = targets[..., 5]

    # anchor fit: wh-IoU x angle proximity
    fit_wh = _wh_iou(wh[:, :, None, :], awh[None, None, :, :])   # (B,G,na)
    dtheta_all = normalize_angle(theta[:, :, None] - aang[None, None, :])
    fit = fit_wh * torch.abs(torch.cos(dtheta_all))
    best_a = torch.argmax(fit, dim=-1)                           # (B,G)
    best_fit = torch.gather(fit, -1, best_a[..., None])[..., 0]
    assigned = valid & (best_fit > iou_t)

    # cell + regression targets
    cell = torch.clamp((xy / spec.stride).to(torch.int32), 0, grid - 1)
    gi, gj = cell[..., 0], cell[..., 1]     # col, row
    txy = xy / spec.stride - cell.to(xy.dtype)
    twh = torch.log(torch.clamp(wh, min=1e-4) / awh[best_a])
    tangle = normalize_angle(theta - aang[best_a])
    tbox_abs = torch.cat([xy, wh, theta[..., None]], dim=-1)

    size = grid * grid * na
    flat = (gj.long() * grid + gi.long()) * na + best_a
    flat_idx = torch.where(assigned, flat, -1).to(torch.int32)
    # padding rows scatter to an extra column past the grid, dropped after
    # (an index of -1 would mark the grid's last slot)
    scatter_idx = torch.where(assigned, flat, size)
    batch_idx = torch.arange(b, device=targets.device)[:, None].expand(b, g)
    obj_target = torch.zeros((b, size + 1), dtype=torch.float32,
                             device=targets.device)
    obj_target[batch_idx, scatter_idx] = 1.0

    return HeadTargets(
        flat_idx=flat_idx, assigned=assigned, txy=txy, twh=twh,
        tangle=tangle, tcls=cls_id, tbox_abs=tbox_abs,
        obj_target=obj_target[:, :size].reshape(b, grid, grid, na))


def build_targets(targets: torch.Tensor, valid: torch.Tensor,
                  yolo_specs: Sequence[YoloSpec], img_size: int,
                  iou_t: float = 0.2) -> List[HeadTargets]:
    """Per-head assignment for all heads (reference ``build_targets``)."""
    return [build_targets_head(targets, valid, s, img_size, iou_t)
            for s in yolo_specs]
