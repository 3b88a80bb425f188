"""Rotated YOLO head decode: raw (B, H, W, na·no) maps -> boxes and scores.

Torch counterpart of ``rotate_yolov3_tpu/models/yolo_head.py``. Per cell:

    bx = (sigmoid(tx) + cx) * stride        bw = pw * exp(clip(tw, ±8))
    by = (sigmoid(ty) + cy) * stride        bh = ph * exp(clip(th, ±8))
    theta = anchor_angle + ANGLE_RANGE * tanh(t_theta)
    obj, cls = sigmoid

Anchors are (wh-major, angle-minor): anchor k = (wh[k // n_ang],
angles[k % n_ang]). ``decode_gathered`` ports both paths of the reference:
with one na for all heads (every cfg in ``cfg/``) the K candidate cell rows
are gathered once, through kernel A (``ops.gather_rows``), from the head
maps in place; heads of different na take the per-head path, one launch
of kernel A per head.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from .darknet import NetworkSpec, YoloSpec

# Max angle offset a head can regress away from its anchor's angle (radians).
ANGLE_RANGE = math.pi / 6
# exp clamp for w/h regression: keeps early-training decode finite.
_WH_CLAMP = 8.0


def head_anchors(spec: YoloSpec) -> Tuple[np.ndarray, np.ndarray]:
    """Effective anchors of a head: (na, 2) w/h in pixels and (na,) angles."""
    wh = np.asarray(spec.anchors_wh, np.float32)          # (n_wh, 2)
    ang = np.asarray(spec.anchor_angles, np.float32)      # (n_ang,)
    n_wh, n_ang = len(wh), len(ang)
    return np.repeat(wh, n_ang, axis=0), np.tile(ang, n_wh)


def reshape_head(raw: torch.Tensor, spec: YoloSpec) -> torch.Tensor:
    """(B, H, W, na*no) -> (B, H, W, na, no): the anchor-major view of a
    head map that the loss reads."""
    b, h, w, c = raw.shape
    assert c == spec.na * spec.no, (c, spec.na, spec.no)
    return raw.reshape(b, h, w, spec.na, spec.no)


def decode_boxes_grid(p: torch.Tensor, spec: YoloSpec) -> torch.Tensor:
    """Decode only the boxes of a head view: (B, H, W, na, no) -> (B, H, W,
    na, 5) pixel boxes (cx, cy, w, h, theta), keeping the grid layout."""
    b, h, w, na, no = p.shape
    awh, aang = anchor_tables(spec, p.device)
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=p.dtype, device=p.device),
        torch.arange(w, dtype=p.dtype, device=p.device), indexing="ij")
    grid = torch.stack([gx, gy], dim=-1)[None, :, :, None, :]
    xy = (torch.sigmoid(p[..., 0:2]) + grid) * spec.stride
    wh = awh[None, None, None] * torch.exp(
        torch.clamp(p[..., 2:4], -_WH_CLAMP, _WH_CLAMP))
    theta = (aang[None, None, None]
             + ANGLE_RANGE * torch.tanh(p[..., 4]))[..., None]
    return torch.cat([xy, wh, theta], dim=-1)


def decode_head(raw: torch.Tensor, spec: YoloSpec) -> torch.Tensor:
    """Decode one head's raw map into (B, H*W*na, 6+nc) rows: cx, cy, w, h
    (net-input pixels), theta (radians), obj, per-class probabilities."""
    p = reshape_head(raw, spec)
    b, h, w = p.shape[:3]
    obj = torch.sigmoid(p[..., 5:6])
    cls = torch.sigmoid(p[..., 6:])
    out = torch.cat([decode_boxes_grid(p, spec), obj, cls], dim=-1)
    return out.reshape(b, h * w * spec.na, spec.no)


def decode_all(head_raws: Sequence[torch.Tensor],
               yolo_specs: Sequence[YoloSpec]) -> torch.Tensor:
    """Decode + concatenate all heads: (B, N_total, 6+nc)."""
    assert len(head_raws) == len(yolo_specs)
    return torch.cat([decode_head(r, s) for r, s in zip(head_raws,
                                                        yolo_specs)], dim=1)


def field_major_perm(spec: YoloSpec) -> np.ndarray:
    """Head-conv output-channel permutation, anchor-major (a*no + f) ->
    field-major (f*na + a): ``perm[f*na + a] = a*no + f``, applied to dim 0
    of the OIHW kernel and to the bias."""
    na, no = spec.na, spec.no
    perm = np.empty(na * no, np.int64)
    for f in range(no):
        for a in range(na):
            perm[f * na + a] = a * no + f
    return perm


def head_scores(raw: torch.Tensor, spec: YoloSpec,
                field_major: bool = False) -> torch.Tensor:
    """Detection scores straight from the raw head map: (B, H*W*na),
    sigmoid(obj) * max_c sigmoid(cls_c), in cell-major / anchor-minor order.
    """
    b = raw.shape[0]
    if field_major:
        na = spec.na
        obj = torch.sigmoid(raw[..., 5 * na:6 * na])
        m = raw[..., 6 * na:7 * na]
        for c in range(1, spec.num_classes):
            # max of logits == argmax of sigmoids (monotonic)
            m = torch.maximum(m, raw[..., (6 + c) * na:(7 + c) * na])
        return (obj * torch.sigmoid(m)).reshape(b, -1)
    p = raw.reshape(*raw.shape[:3], spec.na, spec.no)
    obj = torch.sigmoid(p[..., 5])
    if spec.num_classes > 1:
        cls = torch.sigmoid(p[..., 6:]).amax(dim=-1)
    else:
        cls = torch.sigmoid(p[..., 6])
    return (obj * cls).reshape(b, -1)


@functools.lru_cache(maxsize=64)
def anchor_tables(spec: YoloSpec, device: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A head's (na, 2) anchor w/h and (na,) angles on ``device``, built
    once per (spec, device), so no call copies them from the host. Callers
    only read them."""
    awh, aang = head_anchors(spec)
    return (torch.from_numpy(awh).to(device),
            torch.from_numpy(aang).to(device))


def decode_gathered(head_raws: Sequence[torch.Tensor],
                    yolo_specs: Sequence[YoloSpec], idx: torch.Tensor,
                    field_major: bool = False) -> torch.Tensor:
    """Decode only the selected predictions.

    ``idx``: (B, K) int32 flat indices into the concatenated prediction axis
    (heads in order, each H*W*na cell-major / anchor-minor). Returns
    (B, K, 6+nc) f32 rows equal to ``decode_all(...)[b, idx]``.

    With one na for all heads, ``idx // na`` is the global cell row and
    ``idx % na`` the anchor: one row gather (kernel A) over the heads' cell
    rows, read in place as (B, H*W, na·no) tables, then the anchor's ``no``
    fields are picked from the gathered row. Heads of different na take
    ``_decode_gathered_perhead``, one launch of kernel A per head.
    """
    from ..ops.gather_rows import gather_rows

    if len({s.na for s in yolo_specs}) != 1:
        return _decode_gathered_perhead(head_raws, yolo_specs, idx,
                                        field_major)
    b, k = idx.shape
    no, na = yolo_specs[0].no, yolo_specs[0].na

    cell_g = torch.div(idx, na, rounding_mode="floor")
    a_idx = (idx - cell_g * na).long()
    r_cells = gather_rows([r.reshape(r.shape[0], -1, na * no).contiguous()
                           for r in head_raws], cell_g.contiguous())

    # lane of field f of the selected anchor
    f = torch.arange(no, device=idx.device, dtype=torch.int64)
    a = a_idx[..., None]
    lanes = f * na + a if field_major else a * no + f
    rows = torch.gather(r_cells, 2, lanes).float()          # (B, K, no)

    zf = torch.zeros((b, k), dtype=torch.float32, device=idx.device)
    stride_v, gx, gy = zf, zf, zf
    aw_v, ah_v, aang_v = zf, zf, zf
    off = 0
    for raw, s in zip(head_raws, yolo_specs):
        h, w = raw.shape[1], raw.shape[2]
        local = cell_g - off
        in_h = (local >= 0) & (local < h * w)
        stride_v = torch.where(in_h, float(s.stride), stride_v)
        gx = torch.where(in_h, (local % w).float(), gx)
        gy = torch.where(in_h, torch.div(local, w, rounding_mode="floor")
                         .float(), gy)
        awh_t, aang_t = anchor_tables(s, idx.device)
        aw_v = torch.where(in_h, awh_t[a_idx, 0], aw_v)
        ah_v = torch.where(in_h, awh_t[a_idx, 1], ah_v)
        aang_v = torch.where(in_h, aang_t[a_idx], aang_v)
        off += h * w
    return _decode_rows(rows, stride_v, gx, gy, aw_v, ah_v, aang_v)


def _decode_gathered_perhead(head_raws, yolo_specs, idx, field_major):
    """``decode_gathered`` for heads that differ in na: per head, the rows
    of ``idx`` inside it (``local = idx - offset``) gather their cells
    through kernel A, one launch on that head's own (B, H*W, na·no) table
    in place, at clipped indices (``safe``), and pick the anchor's ``no``
    fields; rows outside the head keep the previous value, so a row in no
    head (negative, or past the last) decodes all-zero raw values, as the
    reference's ``where`` chain does."""
    from ..ops.gather_rows import gather_rows

    b, k = idx.shape
    no = yolo_specs[0].no
    dev = idx.device
    zf = torch.zeros((b, k), dtype=torch.float32, device=dev)
    stride_v, gx, gy = zf, zf, zf
    aw_v, ah_v, aang_v = zf, zf, zf
    rows = torch.zeros((b, k, no), dtype=torch.float32, device=dev)
    f = torch.arange(no, device=dev, dtype=torch.int64)
    offset = 0
    for raw, s in zip(head_raws, yolo_specs):
        h, w, na = raw.shape[1], raw.shape[2], s.na
        n = h * w * na
        local = idx - offset
        in_head = (local >= 0) & (local < n)
        safe = local.clamp(0, n - 1)
        cell = torch.div(safe, na, rounding_mode="floor")
        a_idx = (safe - cell * na).long()
        r_cells = gather_rows(raw.reshape(b, h * w, na * no).contiguous(),
                              cell.to(torch.int32).contiguous())
        a = a_idx[..., None]
        lanes = f * na + a if field_major else a * no + f
        picked = torch.gather(r_cells, 2, lanes).float()     # (B, K, no)
        rows = torch.where(in_head[..., None], picked, rows)
        stride_v = torch.where(in_head, float(s.stride), stride_v)
        gx = torch.where(in_head, (cell % w).float(), gx)
        gy = torch.where(in_head, torch.div(cell, w, rounding_mode="floor")
                         .float(), gy)
        awh_t, aang_t = anchor_tables(s, dev)
        aw_v = torch.where(in_head, awh_t[a_idx, 0], aw_v)
        ah_v = torch.where(in_head, awh_t[a_idx, 1], ah_v)
        aang_v = torch.where(in_head, aang_t[a_idx], aang_v)
        offset += n
    return _decode_rows(rows, stride_v, gx, gy, aw_v, ah_v, aang_v)


def _decode_rows(rows, stride_v, gx, gy, aw_v, ah_v, aang_v):
    """(B, K, no) raw rows + per-row grid/anchor metadata -> (B, K, 6+nc)."""
    xy = (torch.sigmoid(rows[..., 0:2])
          + torch.stack([gx, gy], dim=-1)) * stride_v[..., None]
    wh = torch.stack([aw_v, ah_v], dim=-1) * torch.exp(
        torch.clamp(rows[..., 2:4], -_WH_CLAMP, _WH_CLAMP))
    theta = (aang_v + ANGLE_RANGE * torch.tanh(rows[..., 4]))[..., None]
    obj = torch.sigmoid(rows[..., 5:6])
    cls = torch.sigmoid(rows[..., 6:])
    return torch.cat([xy, wh, theta, obj, cls], dim=-1)


def num_predictions(spec: NetworkSpec) -> int:
    """Total decoded prediction count for a square net-input image."""
    n = 0
    for ys in spec.yolo_specs:
        g = spec.img_size // ys.stride
        n += g * g * ys.na
    return n
