"""Top-K candidate indices -> decoded rotated boxes in one launch: kernel D.

Counterpart of ``rotate_yolov3_tpu/ops/decode_pallas.py``
(``HeadMeta``, ``heads_meta``, ``decode_rows_pallas``). For each of the
(B, K) global candidate indices (heads in order, each H·W·na cell-major /
anchor-minor, as ``models.yolo_head.decode_gathered`` reads them) it
gathers the cell row's anchor lanes, selects the head's grid cell, stride
and anchor, and decodes:

    cx = (sigmoid(tx) + gx)·stride      w = anchor_w · exp(clip(tw, ±8))
    cy = (sigmoid(ty) + gy)·stride      h = anchor_h · exp(clip(th, ±8))
    theta = anchor_angle + ANGLE_RANGE · tanh(t_theta)

Out come (B, K, 8) f32 rows ``(cx, cy, w, h, theta, cls_id, 0, 0)``: the box
fields multiplied by 0 where ``valid`` is False, the class id kept on
invalid rows. The class id follows the reference's loop: class 0 first, then
class c wherever its raw logit is strictly greater than the best so far (0
when nc = 1), so a NaN never wins, a NaN in class 0 pins the id to 0 and an
all −inf row gives 0; the clip of tw, th keeps a NaN and takes ±inf to ±8.

``decode_rows`` launches the hand-written CUDA kernel (``csrc/decode_rows.cu``)
on CUDA tensors; ``decode_rows_ref`` is its plain version (kernel A's plain
gather, ``yolo_head._decode_rows`` and the argmax), which a CPU tensor
takes. Where the reference reads one concatenated (B, N, na·no) cell table,
both read the head maps in place, so the concatenation is never built.
Indices are clamped to [0, N·na), the row gather's clip mode.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import torch

from .. import _build

_MAX_HEADS = 4     # the kernel's per-head tables
_MAX_NA = 32       # anchors per head in those tables


class HeadMeta(NamedTuple):
    """Per-head decode tables."""

    n_cells: int                  # H*W
    width: int                    # W
    stride: int
    anchor_w: Tuple[float, ...]   # (na,)
    anchor_h: Tuple[float, ...]
    anchor_a: Tuple[float, ...]


def heads_meta(yolo_specs, head_shapes) -> Tuple[HeadMeta, ...]:
    """HeadMeta of each head from its YoloSpec and raw map shape
    (B, H, W, C)."""
    from ..models.yolo_head import head_anchors

    out = []
    for spec, shp in zip(yolo_specs, head_shapes):
        awh, aang = head_anchors(spec)
        out.append(HeadMeta(
            n_cells=int(shp[1] * shp[2]), width=int(shp[2]),
            stride=int(spec.stride),
            anchor_w=tuple(float(v) for v in awh[:, 0]),
            anchor_h=tuple(float(v) for v in awh[:, 1]),
            anchor_a=tuple(float(v) for v in aang)))
    return tuple(out)


def _check(head_raws, idx, valid, meta, na, nc) -> None:
    if len(head_raws) != len(meta) or not head_raws:
        raise ValueError(f"decode_rows: {len(head_raws)} head maps for "
                         f"{len(meta)} head tables")
    for r, m in zip(head_raws, meta):
        if r.ndim != 4 or r.shape[1] * r.shape[2] != m.n_cells or \
                r.shape[2] != m.width or r.shape[3] != na * (6 + nc):
            raise ValueError(f"decode_rows: head map {tuple(r.shape)} does "
                             f"not match its table {m.n_cells} cells of "
                             f"width {m.width}, na={na}, nc={nc}")
        if r.dtype != head_raws[0].dtype or r.shape[0] != idx.shape[0]:
            raise ValueError("decode_rows: head maps differ in dtype or "
                             "batch")
        if len(m.anchor_w) != na:
            raise ValueError(f"decode_rows: {len(m.anchor_w)} anchors in a "
                             f"head table, na={na}")
    if idx.ndim != 2 or idx.dtype != torch.int32:
        raise TypeError(f"decode_rows: idx must be (B, K) int32, got "
                        f"{tuple(idx.shape)} {idx.dtype}")
    if tuple(valid.shape) != tuple(idx.shape) or valid.dtype != torch.bool:
        raise ValueError(f"decode_rows: valid must be (B, K) bool, got "
                         f"{tuple(valid.shape)} {valid.dtype}")


def decode_rows_ref(head_raws: Sequence[torch.Tensor], idx: torch.Tensor,
                    valid: torch.Tensor, meta: Sequence[HeadMeta], na: int,
                    nc: int, field_major: bool = True) -> torch.Tensor:
    """Plain PyTorch version of ``decode_rows``."""
    from ..models.yolo_head import _decode_rows
    from .gather_rows import gather_rows_ref

    _check(head_raws, idx, valid, meta, na, nc)
    no = 6 + nc
    n_cells = sum(m.n_cells for m in meta)
    g = idx.long().clamp(0, n_cells * na - 1)
    cell = torch.div(g, na, rounding_mode="floor")
    a = g - cell * na
    cells = torch.cat([r.reshape(r.shape[0], -1, na * no)
                       for r in head_raws], dim=1)
    r_cells = gather_rows_ref(cells, cell)
    f = torch.arange(no, device=idx.device)
    lanes = f * na + a[..., None] if field_major else a[..., None] * no + f
    rows = torch.gather(r_cells, 2, lanes).float()           # (B, K, no)

    zf = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    stride_v, gx, gy, aw_v, ah_v, aang_v = zf, zf, zf, zf, zf, zf
    off = 0
    for m in meta:
        local = cell - off
        in_h = (local >= 0) & (local < m.n_cells)

        def pick(vals, cur):
            table = torch.tensor(vals, dtype=torch.float32, device=idx.device)
            return torch.where(in_h, table[a], cur)

        stride_v = torch.where(in_h, float(m.stride), stride_v)
        gx = torch.where(in_h, (local % m.width).float(), gx)
        gy = torch.where(in_h, torch.div(local, m.width,
                                         rounding_mode="floor").float(), gy)
        aw_v = pick(m.anchor_w, aw_v)
        ah_v = pick(m.anchor_h, ah_v)
        aang_v = pick(m.anchor_a, aang_v)
        off += m.n_cells
    boxes = _decode_rows(rows, stride_v, gx, gy, aw_v, ah_v, aang_v)[..., :5]
    boxes = boxes * valid.float()[..., None]
    cls = zf
    if nc > 1:          # the reference's strict > from class 0 on
        best = rows[..., 6]
        for c in range(1, nc):
            v = rows[..., 6 + c]
            better = v > best
            cls = torch.where(better, float(c), cls)
            best = torch.where(better, v, best)
    return torch.cat([boxes, cls[..., None], zf[..., None], zf[..., None]],
                     dim=-1)


def _launcher():
    fn = _build.load("decode_rows").decode_rows_launch
    fn.argtypes = [ctypes.c_void_p] * _MAX_HEADS + [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float)] + [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 7 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decode_rows(head_raws: Sequence[torch.Tensor], idx: torch.Tensor,
                valid: torch.Tensor, meta: Sequence[HeadMeta], na: int,
                nc: int, field_major: bool = True) -> torch.Tensor:
    """(B, H, W, na·(6+nc)) head maps (f32 or bf16), (B, K) int32 global
    candidate indices and (B, K) bool valid -> (B, K, 8) f32 rows
    ``(cx, cy, w, h, theta, cls_id, 0, 0)``. A CPU tensor takes the plain
    version; CUDA tensors launch the kernel, or raise."""
    from ..models.yolo_head import _WH_CLAMP, ANGLE_RANGE

    _check(head_raws, idx, valid, meta, na, nc)
    tensors = list(head_raws) + [idx, valid]
    if all(t.device.type == "cpu" for t in tensors):
        return decode_rows_ref(head_raws, idx, valid, meta, na, nc,
                               field_major)
    dev = idx.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("decode_rows: head maps, idx and valid must lie on "
                         "one CUDA device")
    if head_raws[0].dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_rows: head maps must be float32 or "
                        f"bfloat16, got {head_raws[0].dtype}")
    if len(meta) > _MAX_HEADS or na > _MAX_NA:
        raise ValueError(f"decode_rows: at most {_MAX_HEADS} heads of "
                         f"{_MAX_NA} anchors, got {len(meta)} of {na}")
    heads = [r.contiguous() for r in head_raws]
    idx, valid = idx.contiguous(), valid.contiguous()
    b, k = idx.shape
    out = torch.empty((b, k, 8), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    nh = len(meta)
    ints = ctypes.c_int * _MAX_HEADS
    cells = ints(*[m.n_cells for m in meta])
    width = ints(*[m.width for m in meta])
    stride = (ctypes.c_float * _MAX_HEADS)(*[float(m.stride) for m in meta])
    anchors = (ctypes.c_float * (nh * 3 * na))(
        *[v for m in meta for v in (*m.anchor_w, *m.anchor_h, *m.anchor_a)])
    ptrs = [h.data_ptr() for h in heads] + [None] * (_MAX_HEADS - nh)
    with torch.cuda.device(dev):
        err = _launcher()(
            *ptrs, nh, cells, width, stride, anchors, idx.data_ptr(),
            valid.data_ptr(), out.data_ptr(), b, k, heads[0].shape[3], na,
            nc, int(field_major), int(heads[0].dtype == torch.bfloat16),
            ANGLE_RANGE, _WH_CLAMP, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_rows kernel launch failed: CUDA error "
                           f"{err}")
    _build.count_launch(decode_rows)
    return out


decode_rows.launches = 0
