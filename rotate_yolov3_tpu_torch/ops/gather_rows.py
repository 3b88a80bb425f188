"""Batched row gather (B, N, C)[(B, K)] -> (B, K, C): kernel A of the port.

Counterpart of ``rotate_yolov3_tpu/ops/gather_rows.py``. The decode stage of
the score-first serving path gathers the top-K candidate cell rows out of
the concatenated head maps (``models.yolo_head.decode_gathered``).
``gather_rows`` launches the hand-written CUDA kernel
(``csrc/gather_rows.cu``) on a CUDA tensor and uses the plain version,
``gather_rows_ref``, only for a tensor on the CPU. Out-of-range indices are
clamped to [0, N), the reference's XLA ``mode="clip"`` contract. Both copy
raw elements, so they agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build


def gather_rows_ref(cells: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``torch.gather`` on clamped int64 indices."""
    i = idx.long().clamp(0, cells.shape[1] - 1)
    return torch.gather(cells, 1, i[..., None].expand(-1, -1, cells.shape[2]))


def _launcher():
    fn = _build.load("gather_rows").gather_rows_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gather_rows(cells: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) cells + (B, K) int32 row indices -> (B, K, C).

    Equals ``gather_rows_ref`` bit for bit. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel, or raises.
    """
    if cells.ndim != 3 or idx.ndim != 2 or idx.shape[0] != cells.shape[0]:
        raise ValueError(f"gather_rows: cells {tuple(cells.shape)} and idx "
                         f"{tuple(idx.shape)} are not (B, N, C) and (B, K)")
    if idx.dtype != torch.int32:
        raise TypeError(f"gather_rows: idx must be int32, got {idx.dtype}")
    if cells.shape[1] == 0:
        raise ValueError("gather_rows: no rows to gather from")
    if cells.device.type == "cpu" and idx.device.type == "cpu":
        return gather_rows_ref(cells, idx)
    if cells.device.type != "cuda" or idx.device != cells.device:
        raise ValueError(f"gather_rows: cells on {cells.device} and idx on "
                         f"{idx.device}; both must be on one CUDA device")
    if cells.element_size() not in (2, 4):
        raise TypeError(f"gather_rows: {cells.dtype} is not a 2- or 4-byte "
                        f"type")
    if not (cells.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows: cells and idx must be contiguous")
    b, n, c = cells.shape
    k = idx.shape[1]
    out = torch.empty((b, k, c), dtype=cells.dtype, device=cells.device)
    with torch.cuda.device(cells.device):
        err = _launcher()(cells.data_ptr(), idx.data_ptr(), out.data_ptr(),
                          b, n, k, c, cells.element_size(),
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: CUDA error "
                           f"{err}")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
