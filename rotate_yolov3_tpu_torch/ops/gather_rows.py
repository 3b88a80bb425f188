"""Batched row gather over the head maps, read in place: kernel A of the port.

Counterpart of ``rotate_yolov3_tpu/ops/gather_rows.py``: (B, N, C) cells +
(B, K) int32 row indices -> (B, K, C). The decode stage of the score-first
serving path gathers the top-K candidate cell rows of the head maps
(``models.yolo_head.decode_gathered``). Where the reference gathers from the
concatenated (B, N, C) cell table, ``gather_rows`` also takes the heads as a
sequence of (B, N_h, C) tables (each head map viewed as rows) and gathers
from their virtual concatenation along the cell axis, so that table is never
built; a single tensor is a one-element sequence.

``gather_rows`` launches the hand-written CUDA kernel (``csrc/gather_rows.cu``)
on CUDA tensors and uses the plain version, ``gather_rows_ref`` (``torch.cat``
+ ``torch.gather``), only for tensors on the CPU. Out-of-range indices are
clamped to [0, N), the reference's XLA ``mode="clip"`` contract. Both copy
raw elements, so they agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple, Union

import torch

from .. import _build

_MAX_HEADS = 4     # the kernel's head pointers, as kernel D's

Cells = Union[torch.Tensor, Sequence[torch.Tensor]]


def _tables(cells: Cells) -> Tuple[torch.Tensor, ...]:
    """The (B, N_h, C) tables of ``cells``: one tensor or a sequence."""
    tables = (cells,) if isinstance(cells, torch.Tensor) else tuple(cells)
    if not tables:
        raise ValueError("gather_rows: no tables to gather from")
    if len(tables) > _MAX_HEADS:
        raise ValueError(f"gather_rows: {len(tables)} tables, the kernel "
                         f"takes at most {_MAX_HEADS}")
    b, c = tables[0].shape[0], tables[0].shape[-1]
    for t in tables:
        if t.ndim != 3 or t.shape[0] != b or t.shape[2] != c or \
                t.dtype != tables[0].dtype:
            raise ValueError(f"gather_rows: tables "
                             f"{[tuple(x.shape) for x in tables]} "
                             f"{[x.dtype for x in tables]} are not (B, N_h, "
                             f"C) of one dtype")
    return tables


def gather_rows_ref(cells: Cells, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``torch.cat`` of the tables along the cell
    axis, then ``torch.gather`` on clamped int64 indices."""
    tables = _tables(cells)
    cat = tables[0] if len(tables) == 1 else torch.cat(tables, dim=1)
    i = idx.long().clamp(0, cat.shape[1] - 1)
    return torch.gather(cat, 1, i[..., None].expand(-1, -1, cat.shape[2]))


def _launcher():
    fn = _build.load("gather_rows").gather_rows_launch
    fn.argtypes = [ctypes.c_void_p] * _MAX_HEADS + [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int)] + [ctypes.c_void_p] * 2 \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gather_rows(cells: Cells, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) cells, or a sequence of at most four (B, N_h, C) tables
    read as their concatenation along the cell axis, + (B, K) int32 row
    indices -> (B, K, C).

    Equals ``gather_rows_ref`` bit for bit. CPU tensors take the plain
    version; CUDA tensors launch the kernel, or raise.
    """
    tables = _tables(cells)
    if idx.ndim != 2 or idx.shape[0] != tables[0].shape[0]:
        raise ValueError(f"gather_rows: tables of batch {tables[0].shape[0]} "
                         f"and idx {tuple(idx.shape)} are not (B, N_h, C) "
                         f"and (B, K)")
    if idx.dtype != torch.int32:
        raise TypeError(f"gather_rows: idx must be int32, got {idx.dtype}")
    if sum(t.shape[1] for t in tables) == 0:
        raise ValueError("gather_rows: no rows to gather from")
    tensors = tables + (idx,)
    if all(t.device.type == "cpu" for t in tensors):
        return gather_rows_ref(tables, idx)
    dev = idx.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"gather_rows: tables on "
                         f"{[str(t.device) for t in tables]} and idx on "
                         f"{dev}; all must be on one CUDA device")
    if tables[0].element_size() not in (2, 4):
        raise TypeError(f"gather_rows: {tables[0].dtype} is not a 2- or "
                        f"4-byte type")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gather_rows: tables and idx must be contiguous")
    b, c = tables[0].shape[0], tables[0].shape[2]
    k = idx.shape[1]
    out = torch.empty((b, k, c), dtype=tables[0].dtype, device=dev)
    n = len(tables)
    ptrs = [t.data_ptr() for t in tables] + [None] * (_MAX_HEADS - n)
    cells_per = (ctypes.c_int * _MAX_HEADS)(*[t.shape[1] for t in tables])
    with torch.cuda.device(dev):
        err = _launcher()(*ptrs, n, cells_per, idx.data_ptr(),
                          out.data_ptr(), b, k, c, tables[0].element_size(),
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: CUDA error "
                           f"{err}")
    _build.count_launch(gather_rows)
    return out


gather_rows.launches = 0
