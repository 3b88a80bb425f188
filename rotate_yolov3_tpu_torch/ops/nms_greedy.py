"""Fused greedy rotated NMS, boxes -> keep mask in one launch: kernel C.

Counterpart of ``rotate_yolov3_tpu/ops/nms_pallas.py::nms_greedy_pallas``:
(B, K, 5) f32 score-descending boxes, optional (B, K) int32 class ids and
the (B, K) validity mask give the (B, K) greedy keep mask. It equals the
kill mask of kernel B (``ops.skew_iou_cuda.skew_kill_matrix``) followed by
``ops.rotated_nms.greedy_suppress_fixpoint_kill``: the same pair predicate,
and a greedy walk that reaches the fixpoint's unique solution.

``nms_greedy`` launches the hand-written CUDA kernel (``csrc/nms_greedy.cu``)
on a CUDA tensor and uses the plain version, ``nms_greedy_ref``, only for a
tensor on the CPU. ``greedy_walk_ref`` mirrors the kernel's chunked greedy
walk in plain PyTorch for the tests. K is capped at 1024
(``nms_greedy_fused_ok``), as in the reference; a larger K takes the
two-stage path. The pair algo is ``"green"`` or ``"green2"``; like the
reference, any other known algo (``"candidates"``) computes ``"green"``,
and an unknown one raises ``ValueError``. The reference's TPU tiling
arguments (``block_n``, ``block_m``, ``interpret``) have no counterpart
here.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .. import _build
from .skew_iou_cuda import check_algo, skew_kill_matrix_ref

# words of 32 kill bits per row fit the 32 lanes of the kernel's greedy warp
_MAX_K = 1024
_MASK_DTYPES = ("float32", "bfloat16")
# the kernel's pair algos; the reference computes "green" for any algo
# other than "green2"
_ALGOS = ("green", "green2")
_WORD = 32
# (device index, stream) -> the kernel's per-image counters and summary
# words: zero on entry to every launch, and the kernel leaves them zero, so
# no memset runs per call. Grown (zeroed anew) when a batch needs more.
_STATE: Dict[Tuple[int, int], torch.Tensor] = {}


def kernel_algo(algo: str) -> str:
    """The pair algo kernel C computes for ``algo``: ``"green2"`` for
    itself, ``"green"`` for any other known algo, as in the reference."""
    check_algo(algo)
    return algo if algo in _ALGOS else "green"


def nms_greedy_fused_ok(k: int) -> bool:
    """Shape gate of the fused path: K <= 1024, as in the reference."""
    return k <= _MAX_K


def _check(boxes: torch.Tensor, cls_id: Optional[torch.Tensor],
           valid: torch.Tensor, mask_dtype: str) -> None:
    if mask_dtype not in _MASK_DTYPES:
        raise ValueError(f"nms_greedy: mask_dtype must be one of "
                         f"{_MASK_DTYPES}, got {mask_dtype!r}")
    if boxes.ndim != 3 or boxes.shape[-1] != 5:
        raise ValueError(f"nms_greedy: boxes must be (B, K, 5), got "
                         f"{tuple(boxes.shape)}")
    if boxes.dtype != torch.float32:
        raise TypeError(f"nms_greedy: boxes must be float32, got "
                        f"{boxes.dtype}")
    if not nms_greedy_fused_ok(boxes.shape[1]):
        raise ValueError(f"nms_greedy: K = {boxes.shape[1]} exceeds the "
                         f"fused kernel's {_MAX_K}; use the two-stage path")
    if tuple(valid.shape) != tuple(boxes.shape[:2]) or \
            valid.dtype != torch.bool:
        raise ValueError(f"nms_greedy: valid must be (B, K) bool, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    if cls_id is not None and (tuple(cls_id.shape) != tuple(boxes.shape[:2])
                               or cls_id.dtype != torch.int32):
        raise ValueError(f"nms_greedy: cls_id must be (B, K) int32, got "
                         f"{tuple(cls_id.shape)} {cls_id.dtype}")


def nms_greedy_ref(boxes: torch.Tensor, cls_id: Optional[torch.Tensor],
                   valid: torch.Tensor, iou_thr: float = 0.4,
                   algo: str = "green") -> torch.Tensor:
    """Plain PyTorch version: the plain kill mask of the algo kernel C
    computes (``kernel_algo``), then the greedy fixpoint."""
    from .rotated_nms import greedy_suppress_fixpoint_kill

    kill = skew_kill_matrix_ref(boxes, cls_id, iou_thr, kernel_algo(algo))
    return greedy_suppress_fixpoint_kill(kill, valid)


def greedy_walk_ref(kill: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain mirror of kernel C's greedy walk, for the tests: a (B, K, K)
    kill mask (strictly upper-triangular; ``kill[b, i, j]``: kept row i
    suppresses row j) + (B, K) valid -> (B, K) keep, the same keep as
    ``greedy_suppress_fixpoint_kill``.

    As the kernel: each row's kill bits packed into 32-bit words (chunk c
    holds rows and columns 32c..32c+31); per chunk a summary word of the
    rows that kill past their own chunk's (diagonal) word. Chunk by chunk:
    alive = valid & ~removed, resolved in row order among the alive rows
    whose diagonal word is not zero; then the words past the diagonal of
    the kept rows with a summary bit are ORed into removed."""
    b, k = valid.shape
    nw = -(-k // _WORD)
    pad = nw * _WORD - k
    weights = 1 << torch.arange(_WORD, dtype=torch.int64)
    bits = torch.nn.functional.pad(kill.bool().cpu(), (0, pad, 0, pad))
    words = (bits.view(b, nw * _WORD, nw, _WORD).long() * weights).sum(-1)
    vbits = torch.nn.functional.pad(valid.bool().cpu(), (0, pad))
    vwords = (vbits.view(b, nw, _WORD).long() * weights).sum(-1)
    keep = torch.zeros((b, nw * _WORD), dtype=torch.bool)
    for img in range(b):
        rows = words[img].tolist()              # rows[i][w]
        summ = [sum(1 << r for r in range(_WORD)
                    if any(rows[c * _WORD + r][c + 1:]))
                for c in range(nw)]
        removed = [0] * nw
        for c in range(nw):
            alive = vwords[img, c].item() & ~removed[c]
            diag = [rows[c * _WORD + r][c] for r in range(_WORD)]
            m = alive & sum(1 << r for r in range(_WORD) if diag[r])
            while m:
                r = (m & -m).bit_length() - 1
                alive &= ~diag[r]
                m &= (m - 1) & alive
            for r in range(_WORD):
                keep[img, c * _WORD + r] = bool(alive >> r & 1)
            m = alive & summ[c]
            while m:
                r = (m & -m).bit_length() - 1
                m &= m - 1
                for w in range(c + 1, nw):
                    removed[w] |= rows[c * _WORD + r][w]
    return keep[:, :k].to(valid.device)


def _lib():
    lib = _build.load("nms_greedy")
    fn = lib.nms_greedy_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 \
        + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for size in (lib.nms_greedy_mask_ld, lib.nms_greedy_state_words):
        size.argtypes = [ctypes.c_int]
        size.restype = ctypes.c_int
    return lib


def _state(device: torch.device, words: int) -> torch.Tensor:
    """The zeroed counter and summary words of the current stream."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _STATE.get(key)
    if buf is None or buf.numel() < words:
        buf = torch.zeros((words,), dtype=torch.int32, device=device)
        _STATE[key] = buf
    return buf


def nms_greedy(boxes: torch.Tensor, cls_id: Optional[torch.Tensor],
               valid: torch.Tensor, iou_thr: float = 0.4,
               algo: str = "green", mask_dtype: str = "float32"
               ) -> torch.Tensor:
    """Batched fused greedy rotated NMS: (B, K, 5) boxes -> (B, K) keep.

    Rows must be score-descending per image. ``cls_id`` enables class-aware
    suppression; rows that are not ``valid`` never keep nor kill. ``algo``
    is the pair algo (``kernel_algo``: ``"candidates"`` computes
    ``"green"``).
    ``mask_dtype`` is the reference's choice of kill-scratch type (f32 or
    bf16, same keep in both); the kernel packs the mask into bits, so both
    give the same keep here too and the argument only gets checked.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel,
    or raises.
    """
    algo = kernel_algo(algo)
    _check(boxes, cls_id, valid, mask_dtype)
    tensors = [boxes, valid] + ([] if cls_id is None else [cls_id])
    if all(t.device.type == "cpu" for t in tensors):
        return nms_greedy_ref(boxes, cls_id, valid, iou_thr, algo)
    if boxes.device.type != "cuda" or any(t.device != boxes.device
                                          for t in tensors):
        raise ValueError("nms_greedy: boxes, cls_id and valid must lie on "
                         "one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("nms_greedy: inputs must be contiguous")
    b, k = boxes.shape[:2]
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if keep.numel() == 0:
        return keep
    with torch.cuda.device(boxes.device):
        lib = _lib()
        mask = torch.empty((b * k * lib.nms_greedy_mask_ld(k),),
                           dtype=torch.int32, device=boxes.device)
        state = _state(boxes.device, b * lib.nms_greedy_state_words(k))
        err = lib.nms_greedy_launch(
            boxes.data_ptr(), None if cls_id is None else cls_id.data_ptr(),
            valid.data_ptr(), mask.data_ptr(), state.data_ptr(),
            keep.data_ptr(), b, k, iou_thr, 1.0 + iou_thr,
            _ALGOS.index(algo), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"nms_greedy kernel launch failed: CUDA error "
                           f"{err}")
    _build.count_launch(nms_greedy, algo)
    return keep


# launches in all, and per pair algo the kernel computed
nms_greedy.launches = 0
nms_greedy.algo_launches = dict.fromkeys(_ALGOS, 0)
