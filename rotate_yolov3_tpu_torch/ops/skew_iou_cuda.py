"""Pairwise skew-IoU on the card: the kill mask (kernel B, with its pair algos
B') and the IoU matrix (kernel E).

Counterpart of ``rotate_yolov3_tpu/ops/skew_iou_pallas.py``:

* ``skew_kill_matrix`` (``skew_kill_matrix_pallas``), batched over images::

      kill[b, i, j] = j > i ∧ cls_i == cls_j ∧ inter·(1+thr) > thr·(A+B)

  The divide-free predicate is algebraically IoU > thr; it can differ from a
  thresholded IoU matrix only for pairs within FP rounding of ``thr``.
* ``skew_iou_matrix`` (``skew_iou_matrix_pallas``): (N, 5) × (M, 5) →
  (N, M) f32 ``inter / (A + B − inter + 1e-8)``, or (B, N, 5) × (B, M, 5)
  → (B, N, M) in one launch (what ``jax.vmap`` makes of the reference's
  kernel). ``triangle=True`` zeroes every entry with j ≤ i (greedy NMS reads
  only j > i; the reference leaves that region unspecified).
* ``skew_iou_matrix_auto`` and ``skew_iou_matrix_auto_nms``: the reference's
  ``iou_matrix_fn`` drop-ins, kernel E for a CUDA tensor and the argsort
  oracle (``ops.skew_iou.skew_iou_matrix``) for a CPU one, as the reference
  takes the Pallas kernel on a TPU and the oracle elsewhere.

``inter`` is the exact rotated-rect intersection clamped to min(A, B), by
one of three pair algos: ``"green"`` (Green's-theorem slab clipping,
``ops.skew_iou_green.inter_area_green``), ``"green2"`` (the same in B's
frame, ``inter_area_green_bframe``) or ``"candidates"`` (24 candidate
vertices compacted into 8 slots, rank-sorted by a diamond angle, masked
shoelace; ``inter_area_candidates`` below). Each wrapper launches its
hand-written CUDA kernel (``csrc/skew_kill.cu``, ``csrc/skew_iou_matrix.cu``)
on a CUDA tensor and takes its plain version (``*_ref``) only for a tensor
on the CPU. An unknown algo raises ``ValueError``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from .skew_iou import skew_iou_matrix as skew_iou_matrix_argsort
from .skew_iou_green import inter_area_green, inter_area_green_bframe

ALGOS = ("green", "green2", "candidates")
_EPS = 1e-8
_TOL = 1e-6
_NSLOT = 8   # a convex quad ∩ quad has at most 8 vertices


def check_algo(algo: str) -> int:
    """The kernels' id of a pair algo; ``ValueError`` if it is unknown."""
    if algo not in ALGOS:
        raise ValueError(f"unknown pair algo {algo!r}; expected one of "
                         f"{ALGOS}")
    return ALGOS.index(algo)


# --------------------------------------------------------------------------
# "candidates": the plain version, in the order the kernels evaluate it
# --------------------------------------------------------------------------

def _corners(cx, cy, w, h, th):
    """Corner coordinate lists (len 4), CCW from (-w/2, -h/2)."""
    cos, sin = torch.cos(th), torch.sin(th)
    xs, ys = [], []
    for sx, sy in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
        dx = sx * w * 0.5
        dy = sy * h * 0.5
        xs.append(cx + dx * cos - dy * sin)
        ys.append(cy + dx * sin + dy * cos)
    return xs, ys


def _candidates(ax, ay, bx, by):
    """The 24 intersection-polygon vertex candidates ``(px, py, valid)``,
    in the reference's list order: 16 edge-pair intersections (A's edge
    major), A's corners inside B, B's corners inside A. Invalid ones are
    (0, 0)."""
    zero = ax[0].new_zeros(())
    for i in range(4):
        p1x, p1y = ax[i], ay[i]
        d1x = ax[(i + 1) % 4] - p1x
        d1y = ay[(i + 1) % 4] - p1y
        for j in range(4):
            q1x, q1y = bx[j], by[j]
            d2x = bx[(j + 1) % 4] - q1x
            d2y = by[(j + 1) % 4] - q1y
            denom = d1x * d2y - d1y * d2x
            # relative parallelism test: a contracted FMA leaves ~ulp of
            # |d1||d2| in the cross product of parallel edges, which would
            # mint spurious on-segment candidates
            scale = (torch.abs(d1x) + torch.abs(d1y)) \
                * (torch.abs(d2x) + torch.abs(d2y))
            ok = torch.abs(denom) > 1e-5 * scale + _EPS
            sd = torch.where(ok, denom, torch.ones_like(denom))
            rx, ry = q1x - p1x, q1y - p1y
            t = (rx * d2y - ry * d2x) / sd
            u = (rx * d1y - ry * d1x) / sd
            v = ok & (t >= -_TOL) & (t <= 1 + _TOL) \
                & (u >= -_TOL) & (u <= 1 + _TOL)
            yield (torch.where(v, p1x + t * d1x, zero),
                   torch.where(v, p1y + t * d1y, zero), v)

    def _inside(qx, qy, cx_, cy_):
        res = None
        for j in range(4):
            ex = cx_[(j + 1) % 4] - cx_[j]
            ey = cy_[(j + 1) % 4] - cy_[j]
            crs = ex * (qy - cy_[j]) - ey * (qx - cx_[j])
            tol = _TOL * torch.sqrt(ex * ex + ey * ey + _EPS)
            ok = crs >= -tol
            res = ok if res is None else (res & ok)
        return res

    for i in range(4):
        v = _inside(ax[i], ay[i], bx, by)
        yield (torch.where(v, ax[i] + 0.0 * bx[0], zero),
               torch.where(v, ay[i] + 0.0 * by[0], zero), v)
    for j in range(4):
        v = _inside(bx[j], by[j], ax, ay)
        yield (torch.where(v, bx[j] + 0.0 * ax[0], zero),
               torch.where(v, by[j] + 0.0 * ay[0], zero), v)


def _diamond_angle(y, x):
    """Branch-free monotonic surrogate for atan2, range [0, 4)."""
    denom = torch.abs(x) + torch.abs(y)
    ok = denom > _EPS
    t = y / torch.where(ok, denom, torch.ones_like(denom))
    pos_y = torch.where(x >= 0, t, 2.0 - t)            # y >= 0: [0, 2)
    neg_y = torch.where(x < 0, 2.0 - t, 4.0 + t)       # y <  0: [2, 4)
    ang = torch.where(y >= 0, pos_y, neg_y)
    return torch.where(ok, ang, torch.zeros_like(ang))


def _area_from_candidates(cands):
    """Masked convex-polygon area from the 24 unordered candidates.

    The first 8 valid candidates fill 8 slots (the reference's prefix-count
    compaction), the slots are ranked by the diamond angle around the
    centroid of ALL valid candidates (keys offset by slot·1e-6, so no ties
    among valid slots) and a masked shoelace over the first min(n, 8)
    ranked slots gives the area; fewer than 3 valid candidates give 0.
    Candidates past the 8th valid one are dropped, which underestimates a
    measure-zero family of corner-touch configurations exactly as the
    reference does (pinned in tests/test_pallas.py). Sums run in list order,
    as the kernels run them.
    """
    slot_x = slot_y = None
    for px, py, v in cands:
        if slot_x is None:
            zero = px.new_zeros(px.shape)
            n_valid, sum_x, sum_y = zero, zero, zero
            slot_x, slot_y = [zero] * _NSLOT, [zero] * _NSLOT
        for s in range(_NSLOT):
            hit = v & (n_valid == float(s))
            slot_x[s] = torch.where(hit, px, slot_x[s])
            slot_y[s] = torch.where(hit, py, slot_y[s])
        vf = v.to(px.dtype)
        n_valid = n_valid + vf
        sum_x = sum_x + px * vf
        sum_y = sum_y + py * vf
    inv_n = 1.0 / torch.clamp(n_valid, min=1.0)
    cx, cy = sum_x * inv_n, sum_y * inv_n
    crx = [torch.where(float(s) < n_valid, 0.0 + (slot_x[s] - cx), zero)
           for s in range(_NSLOT)]
    cry = [torch.where(float(s) < n_valid, 0.0 + (slot_y[s] - cy), zero)
           for s in range(_NSLOT)]
    n_eff = torch.clamp(n_valid, max=float(_NSLOT))

    keys = [torch.where(float(s) < n_eff, _diamond_angle(cry[s], crx[s]),
                        torch.full_like(zero, 1e4)) + s * 1e-6
            for s in range(_NSLOT)]
    ranks = []
    for s in range(_NSLOT):
        r = zero
        for t in range(_NSLOT):
            if t != s:
                r = r + (keys[t] < keys[s]).to(zero.dtype)
        ranks.append(r)
    srx, sry = [], []
    for r in range(_NSLOT):
        ax_, ay_ = zero, zero
        for s in range(_NSLOT):
            hit = ranks[s] == float(r)
            ax_ = ax_ + torch.where(hit, crx[s], zero)
            ay_ = ay_ + torch.where(hit, cry[s], zero)
        srx.append(ax_)
        sry.append(ay_)
    area2 = zero
    for r in range(_NSLOT):
        wrap = (float(r) + 1.0) >= n_eff
        nx = torch.where(wrap, srx[0], srx[(r + 1) % _NSLOT])
        ny = torch.where(wrap, sry[0], sry[(r + 1) % _NSLOT])
        crs = srx[r] * ny - sry[r] * nx
        area2 = area2 + torch.where(float(r) < n_eff, crs, zero)
    area = 0.5 * torch.abs(area2)
    return torch.where(n_valid >= 3.0, area, zero)


def inter_area_candidates(acx, acy, aw, ah, ath, bcx, bcy, bw, bh, bth):
    """Rect∩rect area by the candidate formulation (algo ``"candidates"``),
    elementwise over broadcastable f32 fields."""
    ax, ay = _corners(acx, acy, aw, ah, ath)
    bx, by = _corners(bcx, bcy, bw, bh, bth)
    return _area_from_candidates(_candidates(ax, ay, bx, by))


_INTER = {"green": inter_area_green, "green2": inter_area_green_bframe,
          "candidates": inter_area_candidates}


def pair_inter_areas(a: torch.Tensor, b: torch.Tensor, algo: str = "green"):
    """Broadcastable (..., 5) boxes -> (inter clamped to min(A, B), A, B)."""
    check_algo(algo)
    inter = _INTER[algo](a[..., 0], a[..., 1], a[..., 2], a[..., 3],
                         a[..., 4], b[..., 0], b[..., 1], b[..., 2],
                         b[..., 3], b[..., 4])
    area_a = a[..., 2] * a[..., 3]
    area_b = b[..., 2] * b[..., 3]
    inter = torch.minimum(inter, torch.minimum(area_a, area_b))
    return inter, area_a, area_b


# --------------------------------------------------------------------------
# the near-pair tests of kernels B, C (may_overlap in csrc/skew_green.cuh)
# and E (iou_may_overlap)
# --------------------------------------------------------------------------

_RAD_REL, _RAD_COORD, _RAD_ABS = 1.0001, 1e-5, 1e-5
_MIN_SIDE, _MAX_COORD = 1e-3, 1e18


def near_radius(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) f32 boxes -> (...,) the near-pair radius of each box: -inf
    for a zero-area box with finite fields (its pairs cannot kill), +inf for a
    box whose pairs always take the geometry (a NaN or inf field, a side
    below 1e-3 or a coordinate or side above 1e18), else the circumradius
    · 1.0001 + 1e-5·(|cx| + |cy|) + 1e-5 (the margin's derivation is in
    ``csrc/skew_green.cuh``)."""
    boxes = boxes.float()
    cx, cy, w, h = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    finite = torch.isfinite(boxes).all(dim=-1)
    plain = finite & (w >= _MIN_SIDE) & (h >= _MIN_SIDE) \
        & (w <= _MAX_COORD) & (h <= _MAX_COORD) \
        & (cx.abs() <= _MAX_COORD) & (cy.abs() <= _MAX_COORD)
    hw, hh = w * 0.5, h * 0.5
    r = torch.sqrt(hw * hw + hh * hh)
    rad = r * _RAD_REL + _RAD_COORD * (cx.abs() + cy.abs()) + _RAD_ABS
    rad = torch.where(plain, rad, torch.full_like(rad, float("inf")))
    return torch.where(finite & (w * h == 0),
                       torch.full_like(rad, float("-inf")), rad)


def iou_may_overlap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcastable (..., 5) boxes -> (...) bool: False only where every
    pair algo's IoU is exactly +0, as kernel E skips the pair (its zeroed
    tile holds that value): both radii finite and d² > R². A zero-area box
    (radius −inf) and a box with a non-finite, tiny or huge field (+inf)
    keep every pair, since R² is then +inf or NaN (``iou_may_overlap`` in
    ``csrc/skew_green.cuh``, with the derivation)."""
    r = near_radius(a) + near_radius(b)
    dx = a[..., 0].float() - b[..., 0].float()
    dy = a[..., 1].float() - b[..., 1].float()
    return ~(dx * dx + dy * dy > r * r)


def pair_may_overlap(a: torch.Tensor, b: torch.Tensor,
                     iou_thr: float = 0.4) -> torch.Tensor:
    """Broadcastable (..., 5) boxes -> (...) bool: False only where the pair's
    kill is 0 whatever its intersection algo gives (a zero-area box, or
    circumcircles plus the margin apart), as kernels B and C skip it: the
    radii sum R is negative, or d² > R² (a NaN keeps the pair). For a
    negative or NaN ``iou_thr`` nothing is skipped (inter 0 can kill then).
    Used by the tests and by ``chip_smoke.py``'s bound count."""
    ra, rb = near_radius(a), near_radius(b)
    dx = a[..., 0].float() - b[..., 0].float()
    dy = a[..., 1].float() - b[..., 1].float()
    d2 = dx * dx + dy * dy
    r = ra + rb
    near = ~((r < 0) | (d2 > r * r))
    if not iou_thr >= 0:
        return torch.ones_like(near)
    return near


# --------------------------------------------------------------------------
# kernels B and B': the kill mask
# --------------------------------------------------------------------------

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
                         iou_thr: float = 0.4,
                         algo: str = "green") -> torch.Tensor:
    """Plain PyTorch version: the pair algo broadcast over (B, K, 1) ×
    (B, 1, K), then the same predicate, triangle and class masks.
    (B, K, 5) f32 [+ (B, K) int32] -> (B, K, K) int8."""
    _check(boxes, cls_id)
    inter, area_a, area_b = pair_inter_areas(boxes[:, :, None, :],
                                             boxes[:, None, :, :], algo)
    kill = inter * (1.0 + iou_thr) > iou_thr * (area_a + area_b)
    k = boxes.shape[1]
    kill = kill & torch.ones((k, k), dtype=torch.bool,
                             device=boxes.device).triu(1)
    if cls_id is not None:
        kill = kill & (cls_id[:, :, None] == cls_id[:, None, :])
    return kill.to(torch.int8)


def _kill_launcher():
    fn = _build.load("skew_kill").skew_kill_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
        + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def skew_kill_matrix(boxes: torch.Tensor,
                     cls_id: Optional[torch.Tensor] = None,
                     iou_thr: float = 0.4,
                     algo: str = "green") -> torch.Tensor:
    """(B, K, 5) f32 score-sorted boxes [+ (B, K) int32 class ids] ->
    (B, K, K) int8 kill mask. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel, or raises."""
    _check(boxes, cls_id)
    algo_id = check_algo(algo)
    on_cpu = boxes.device.type == "cpu"
    if on_cpu and (cls_id is None or cls_id.device.type == "cpu"):
        return skew_kill_matrix_ref(boxes, cls_id, iou_thr, algo)
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
        err = _kill_launcher()(
            boxes.data_ptr(), None if cls_id is None else cls_id.data_ptr(),
            out.data_ptr(), b, k, iou_thr, 1.0 + iou_thr, algo_id,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"skew_kill kernel launch failed: CUDA error "
                           f"{err}")
    _build.count_launch(skew_kill_matrix, algo)
    return out


# launches in all, and per pair algo
skew_kill_matrix.launches = 0
skew_kill_matrix.algo_launches = dict.fromkeys(ALGOS, 0)


# --------------------------------------------------------------------------
# kernel E: the IoU matrix
# --------------------------------------------------------------------------

def _check_pairs(a: torch.Tensor, b: torch.Tensor) -> None:
    for name, t in (("a", a), ("b", b)):
        if t.ndim not in (2, 3) or t.shape[-1] != 5:
            raise ValueError(f"skew_iou_matrix: {name} must be (N, 5) or "
                             f"(B, N, 5), got {tuple(t.shape)}")
        if not t.is_floating_point():
            raise TypeError(f"skew_iou_matrix: {name} must be floating "
                            f"point, got {t.dtype}")
    if a.ndim != b.ndim or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"skew_iou_matrix: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} differ in batch")


def skew_iou_matrix_ref(a: torch.Tensor, b: torch.Tensor,
                        triangle: bool = False,
                        algo: str = "green") -> torch.Tensor:
    """Plain PyTorch version: (N, 5) × (M, 5) -> (N, M) f32 IoU by the pair
    algo, or (B, N, 5) × (B, M, 5) -> (B, N, M); ``triangle`` zeroes every
    entry with j <= i."""
    _check_pairs(a, b)
    a, b = a.float(), b.float()
    inter, area_a, area_b = pair_inter_areas(a[..., :, None, :],
                                             b[..., None, :, :], algo)
    iou = inter / (area_a + area_b - inter + _EPS)
    if triangle:
        iou = torch.where(torch.ones_like(iou, dtype=torch.bool).triu(1),
                          iou, iou.new_zeros(()))
    return iou


def _iou_launcher():
    fn = _build.load("skew_iou_matrix").skew_iou_matrix_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def skew_iou_matrix(a: torch.Tensor, b: torch.Tensor, triangle: bool = False,
                    algo: str = "green") -> torch.Tensor:
    """Exact pairwise skew-IoU matrix (N, 5) × (M, 5) -> (N, M) f32, the
    ``iou_matrix_fn`` drop-in, or (B, N, 5) × (B, M, 5) -> (B, N, M) in one
    launch. A CPU tensor takes the plain version; a CUDA tensor launches
    kernel E, or raises."""
    _check_pairs(a, b)
    algo_id = check_algo(algo)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return skew_iou_matrix_ref(a, b, triangle, algo)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError("skew_iou_matrix: a and b must lie on one CUDA "
                         "device")
    a, b = a.float().contiguous(), b.float().contiguous()
    nb = a.shape[0] if a.ndim == 3 else 1
    n, m = a.shape[-2], b.shape[-2]
    out = torch.empty((*a.shape[:-2], n, m), dtype=torch.float32,
                      device=a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        err = _iou_launcher()(a.data_ptr(), b.data_ptr(), out.data_ptr(), nb,
                              n, m, int(triangle), algo_id,
                              torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"skew_iou_matrix kernel launch failed: CUDA "
                           f"error {err}")
    _build.count_launch(skew_iou_matrix, algo)
    return out


skew_iou_matrix.launches = 0
skew_iou_matrix.algo_launches = dict.fromkeys(ALGOS, 0)


def skew_iou_matrix_auto(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel E on a CUDA tensor, the argsort oracle on a CPU one; (N, 5) ×
    (M, 5) or batched (B, N, 5) × (B, M, 5)."""
    if a.device.type == "cuda":
        return skew_iou_matrix(a, b)
    return skew_iou_matrix_argsort(a, b)


def skew_iou_matrix_auto_nms(a: torch.Tensor, b: torch.Tensor
                             ) -> torch.Tensor:
    """IoU matrix for greedy NMS: exact where j > i, the rest unspecified.
    Kernel E with ``triangle=True`` on a CUDA tensor (zero at and below the
    diagonal); the full argsort matrix on a CPU one. Greedy NMS reads only
    j > i, so both give the same keep. (N, 5) × (M, 5) or batched."""
    if a.device.type == "cuda":
        return skew_iou_matrix(a, b, triangle=True)
    return skew_iou_matrix_argsort(a, b)
