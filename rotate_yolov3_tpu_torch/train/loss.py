"""Multi-part rotated-detection loss.

Counterpart of ``rotate_yolov3_tpu/train/loss.py``: objectness BCE with the
darknet ignore region, class BCE, smooth-L1 box regression on the
cell/anchor parameterisation and on the angle offset, and the skew-IoU
regression term (1 - exact skew-IoU between each decoded positive
prediction and its GT box), differentiable through the argsort
``ops.skew_iou.skew_iou`` by autograd. Every term is computed on the
fixed-shape GT slots (MAX_GT per image) and dense masked grids.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..config.hyp import Hyp
from ..models.darknet import YoloSpec
from ..models.yolo_head import (ANGLE_RANGE, anchor_tables,
                                decode_boxes_grid, reshape_head)
from ..ops.skew_iou import skew_iou
from .assign import HeadTargets, build_targets

# GT slots per IoU pass of the ignore region: 8 (B, H, W, na) grids at a
# time bound the pass's memory whatever MAX_GT is
_IGNORE_CHUNK = 8


def _bce_logits(logits, labels, pos_weight=1.0):
    """Numerically stable BCE-with-logits."""
    return -(pos_weight * labels * F.logsigmoid(logits)
             + (1.0 - labels) * F.logsigmoid(-logits))


def _smooth_l1(x, beta: float = 1.0 / 9.0):
    ax = torch.abs(x)
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def _masked_mean(x, mask):
    return torch.sum(x * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _aabb_iou(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Axis-aligned IoU of center-format (..., 4) = (cx, cy, w, h) boxes —
    darknet's ``box_iou``, which has no angle term."""
    half1 = b1[..., 2:4] * 0.5
    half2 = b2[..., 2:4] * 0.5
    lo = torch.maximum(b1[..., 0:2] - half1, b2[..., 0:2] - half2)
    hi = torch.minimum(b1[..., 0:2] + half1, b2[..., 0:2] + half2)
    wh = torch.clamp(hi - lo, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = (b1[..., 2] * b1[..., 3] + b2[..., 2] * b2[..., 3] - inter)
    return inter / (union + 1e-9)


@torch.no_grad()
def objectness_ignore(raw: torch.Tensor, gt_boxes: torch.Tensor,
                      spec: YoloSpec, rotated: bool = False) -> torch.Tensor:
    """Darknet grid-wide objectness ignore region: (B, H, W, na) bool.

    A prediction anywhere on the grid whose decoded box overlaps any GT
    with IoU > ``spec.ignore_thresh`` is excluded from the no-object
    penalty. ``rotated=False`` (``Hyp.rotated_ignore``'s default) is
    darknet's ``box_iou``: axis-aligned (cx, cy, w, h), theta ignored.
    ``rotated=True`` uses the exact rotated skew-IoU (``skew_iou_green``).
    ``gt_boxes`` is the padded (B, G, 5) pixel-box tensor; padding rows
    are zero-area, so their IoU is 0 and they ignore nothing. No gradient
    flows through the mask.
    """
    pred = decode_boxes_grid(reshape_head(raw.float(), spec), spec)
    best = torch.zeros(pred.shape[:-1], dtype=torch.float32,
                       device=pred.device)
    for c0 in range(0, gt_boxes.shape[1], _IGNORE_CHUNK):
        gt_c = gt_boxes[:, c0:c0 + _IGNORE_CHUNK].transpose(0, 1)
        gt_c = gt_c[:, :, None, None, None, :]         # (chunk, B,1,1,1,5)
        if rotated:
            from ..ops.skew_iou_green import skew_iou_green

            iou = skew_iou_green(pred[None], gt_c)
        else:
            iou = _aabb_iou(pred[None, ..., :4], gt_c[..., :4])
        best = torch.maximum(best, iou.amax(dim=0))
    return best > spec.ignore_thresh


def compute_loss_head(raw: torch.Tensor, tgt: HeadTargets, spec: YoloSpec,
                      hyp: Hyp) -> Dict[str, torch.Tensor]:
    """Loss terms for one head. ``raw`` is the (B, H, W, na*no) f32 map."""
    p = reshape_head(raw, spec)                  # (B, H, W, na, no)
    b, h, w, na, no = p.shape
    flat = p.reshape(b, h * w * na, no)

    # gather positive-slot predictions (B, G, no)
    safe_idx = torch.clamp(tgt.flat_idx, min=0).long()
    pos = torch.gather(flat, 1, safe_idx[..., None].expand(-1, -1, no))
    m = tgt.assigned.to(p.dtype)                 # (B, G)
    n_pos = torch.clamp(torch.sum(m), min=1.0)

    # xy: sigmoid offset vs target offset
    pxy = torch.sigmoid(pos[..., 0:2])
    lxy = torch.sum(_smooth_l1(pxy - tgt.txy) * m[..., None]) / n_pos
    # wh: raw log-ratio regression
    lwh = torch.sum(_smooth_l1(pos[..., 2:4] - tgt.twh) * m[..., None]) / n_pos
    # angle: bounded tanh offset vs target delta-theta
    pang = ANGLE_RANGE * torch.tanh(pos[..., 4])
    langle = torch.sum(_smooth_l1(pang - tgt.tangle) * m) / n_pos

    # skew-IoU regression on the decoded positive boxes
    awh, aang = anchor_tables(spec, raw.device)
    a_idx = safe_idx % na                        # anchor of each slot
    cell_flat = torch.div(safe_idx, na, rounding_mode="floor")
    gi = (cell_flat % w).to(p.dtype)
    gj = torch.div(cell_flat, w, rounding_mode="floor").to(p.dtype)
    bx = (pxy[..., 0] + gi) * spec.stride
    by = (pxy[..., 1] + gj) * spec.stride
    bwh = awh[a_idx] * torch.exp(torch.clamp(pos[..., 2:4], -8.0, 8.0))
    bth = aang[a_idx] + pang
    pbox = torch.stack([bx, by, bwh[..., 0], bwh[..., 1], bth], dim=-1)
    siou = skew_iou(pbox, tgt.tbox_abs)          # (B, G)
    lsiou = torch.sum((1.0 - siou) * m) / n_pos

    # classification BCE on positive slots
    if spec.num_classes > 1:
        onehot = F.one_hot(tgt.tcls.long(), spec.num_classes).to(p.dtype)
        lcls = torch.sum(_bce_logits(pos[..., 6:], onehot, hyp.cls_pw)
                         * m[..., None]) / n_pos
    else:
        # single class: the class probability is trained to 1 on positives
        lcls = torch.sum(_bce_logits(pos[..., 6], torch.ones_like(m),
                                     hyp.cls_pw) * m) / n_pos

    # Objectness BCE over the dense grid with the grid-wide ignore region.
    # Positives and negatives are averaged separately: a head has 10^3-10^5
    # cells and a handful of positives, so a single grid mean lets every
    # obj logit go to 0 at near-zero loss.
    obj_logits = p[..., 5]
    bce = _bce_logits(obj_logits, tgt.obj_target, hyp.obj_pw)
    ignore = objectness_ignore(raw, tgt.tbox_abs, spec,
                               rotated=hyp.rotated_ignore).to(p.dtype)
    pos_mask = tgt.obj_target
    neg_mask = (1.0 - tgt.obj_target) * (1.0 - ignore)
    lobj = _masked_mean(bce, neg_mask) + _masked_mean(bce, pos_mask)

    return {"xy": lxy, "wh": lwh, "angle": langle, "siou": lsiou,
            "cls": lcls, "obj": lobj}


def compute_loss(head_raws: Sequence[torch.Tensor], targets: torch.Tensor,
                 valid: torch.Tensor, yolo_specs: Sequence[YoloSpec],
                 img_size: int, hyp: Hyp = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total training loss over all heads.

    Args:
      head_raws: raw f32 head maps (B, H, W, na*no), anchor-major.
      targets: (B, MAX_GT, 6) padded GT (cls, cx, cy, w, h, theta), xywh
        normalized; valid: (B, MAX_GT) row mask.
      img_size: the batch's net input size.
    Returns (total_loss, components): components are pre-gain means over
    the heads, the total is gain-weighted.
    """
    hyp = hyp or Hyp()
    tgts = build_targets(targets, valid, yolo_specs, img_size, hyp.iou_t)
    comp = {k: 0.0 for k in ("xy", "wh", "angle", "siou", "cls", "obj")}
    for raw, tgt, spec in zip(head_raws, tgts, yolo_specs):
        hloss = compute_loss_head(raw, tgt, spec, hyp)
        for k, v in hloss.items():
            comp[k] = comp[k] + v
    nh = float(len(yolo_specs))
    comp = {k: v / nh for k, v in comp.items()}
    total = (hyp.xy * comp["xy"] + hyp.wh * comp["wh"]
             + hyp.angle * comp["angle"] + hyp.siou * comp["siou"]
             + hyp.cls * comp["cls"] + hyp.obj * comp["obj"])
    comp["total"] = total
    return total, comp
