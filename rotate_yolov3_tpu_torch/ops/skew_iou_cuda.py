"""Greedy-NMS kill mask of score-sorted rotated boxes: kernel B of the port.

Counterpart of ``rotate_yolov3_tpu/ops/skew_iou_pallas.py::
skew_kill_matrix_pallas`` (algo ``"green"``), batched over images:

    kill[b, i, j] = j > i ∧ cls_i == cls_j ∧ inter·(1+thr) > thr·(A+B)

with ``inter`` the exact rotated-rect intersection
(``ops.skew_iou_green.inter_area_green``) clamped to min(A, B). The
divide-free predicate is algebraically IoU > thr; it can differ from a
thresholded IoU matrix only for pairs within FP rounding of ``thr``.

``skew_kill_matrix`` launches the hand-written CUDA kernel
(``csrc/skew_kill.cu``) on a CUDA tensor and uses the plain version,
``skew_kill_matrix_ref``, only for a tensor on the CPU. The reference's
other per-pair algos (``"green2"``, ``"candidates"``) are not ported yet.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from .skew_iou_green import inter_area_green


def _check(boxes: torch.Tensor, cls_id: Optional[torch.Tensor]) -> None:
    if boxes.ndim != 3 or boxes.shape[-1] != 5:
        raise ValueError(f"skew_kill_matrix: boxes must be (B, K, 5), got "
                         f"{tuple(boxes.shape)}")
    if boxes.dtype != torch.float32:
        raise TypeError(f"skew_kill_matrix: boxes must be float32, got "
                        f"{boxes.dtype}")
    if cls_id is not None:
        if tuple(cls_id.shape) != tuple(boxes.shape[:2]):
            raise ValueError(f"skew_kill_matrix: cls_id {tuple(cls_id.shape)}"
                             f" does not match boxes {tuple(boxes.shape)}")
        if cls_id.dtype != torch.int32:
            raise TypeError(f"skew_kill_matrix: cls_id must be int32, got "
                            f"{cls_id.dtype}")


def skew_kill_matrix_ref(boxes: torch.Tensor,
                         cls_id: Optional[torch.Tensor] = None,
                         iou_thr: float = 0.4) -> torch.Tensor:
    """Plain PyTorch version: ``inter_area_green`` broadcast over
    (B, K, 1) × (B, 1, K), then the same predicate, triangle and class
    masks. (B, K, 5) f32 [+ (B, K) int32] -> (B, K, K) int8."""
    _check(boxes, cls_id)
    a = boxes[:, :, None, :]
    b = boxes[:, None, :, :]
    inter = inter_area_green(a[..., 0], a[..., 1], a[..., 2], a[..., 3],
                             a[..., 4], b[..., 0], b[..., 1], b[..., 2],
                             b[..., 3], b[..., 4])
    area_a = a[..., 2] * a[..., 3]
    area_b = b[..., 2] * b[..., 3]
    inter = torch.minimum(inter, torch.minimum(area_a, area_b))
    kill = inter * (1.0 + iou_thr) > iou_thr * (area_a + area_b)
    k = boxes.shape[1]
    kill = kill & torch.ones((k, k), dtype=torch.bool,
                             device=boxes.device).triu(1)
    if cls_id is not None:
        kill = kill & (cls_id[:, :, None] == cls_id[:, None, :])
    return kill.to(torch.int8)


def _launcher():
    fn = _build.load("skew_kill").skew_kill_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
        + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def skew_kill_matrix(boxes: torch.Tensor,
                     cls_id: Optional[torch.Tensor] = None,
                     iou_thr: float = 0.4) -> torch.Tensor:
    """(B, K, 5) f32 score-sorted boxes [+ (B, K) int32 class ids] ->
    (B, K, K) int8 kill mask. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel, or raises."""
    _check(boxes, cls_id)
    on_cpu = boxes.device.type == "cpu"
    if on_cpu and (cls_id is None or cls_id.device.type == "cpu"):
        return skew_kill_matrix_ref(boxes, cls_id, iou_thr)
    if boxes.device.type != "cuda" or (
            cls_id is not None and cls_id.device != boxes.device):
        raise ValueError("skew_kill_matrix: boxes and cls_id must lie on "
                         "one CUDA device")
    if not boxes.is_contiguous() or (
            cls_id is not None and not cls_id.is_contiguous()):
        raise ValueError("skew_kill_matrix: inputs must be contiguous")
    b, k = boxes.shape[:2]
    out = torch.empty((b, k, k), dtype=torch.int8, device=boxes.device)
    with torch.cuda.device(boxes.device):
        err = _launcher()(
            boxes.data_ptr(), None if cls_id is None else cls_id.data_ptr(),
            out.data_ptr(), b, k, iou_thr, 1.0 + iou_thr,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"skew_kill kernel launch failed: CUDA error "
                           f"{err}")
    skew_kill_matrix.launches += 1
    return out


skew_kill_matrix.launches = 0
