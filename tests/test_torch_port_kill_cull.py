"""The near-pair test of kernels B and C (``may_overlap`` in
``csrc/skew_green.cuh``, mirrored by ``ops.skew_iou_cuda.pair_may_overlap``)
is conservative: every pair it skips has an intersection of exactly 0 in the
port's plain pair algos and in the JAX package's Pallas kernels (interpret
mode), so the kill mask is the same with and without the cull. Inputs are
seeded numpy, shared by both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rotate_yolov3_tpu.ops.skew_iou_green import skew_iou_matrix_green
from rotate_yolov3_tpu.ops.skew_iou_pallas import (skew_iou_matrix_pallas,
                                                   skew_kill_matrix_pallas)
from rotate_yolov3_tpu_torch.ops.skew_iou_cuda import (
    ALGOS, near_radius, pair_inter_areas, pair_may_overlap,
    skew_kill_matrix, skew_kill_matrix_ref)

BAND = 1e-4     # pairs this close to thr may be decided either way
N = 64          # every Pallas matrix below is N x N: one compile per algo

# tests/test_pallas.py:50-58, chip_smoke.py's DEGENERATE
_DEGENERATE = np.array([
    [50, 50, 20, 10, 0.8], [50, 50, 20, 10, 0.8],
    [50, 50, 20, 10, 0.0], [55, 50, 20, 10, 0.0], [50, 52, 20, 10, 0.0],
    [30, 30, 16, 8, 0.5], [34, 33, 16, 8, 0.5]], np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _boxes(rng, n, spread, lo=5.0, hi=40.0):
    return np.stack([
        rng.uniform(0, spread, n), rng.uniform(0, spread, n),
        rng.uniform(lo, hi, n), rng.uniform(lo, hi, n),
        rng.uniform(-np.pi, np.pi, n)], axis=1).astype(np.float32)


def _corner_to_corner(rng, n, scale, gap_rel):
    """n pairs whose corners point at each other across the gap that the
    near-pair radii leave, times ``1 + gap_rel``: a at random, b placed along
    a's corner-2 diagonal at distance (rad_a + rad_b)(1 + gap_rel) with its
    corner 0 pointing back at a."""
    a = _boxes(rng, n, 100.0 * scale, 0.5 * scale, 30.0 * scale)
    a[:, :2] += 1000.0 * scale
    b = _boxes(rng, n, 1.0, 0.5 * scale, 30.0 * scale)
    phi = a[:, 4] + np.arctan2(a[:, 3], a[:, 2])
    b[:, 4] = phi - np.arctan2(b[:, 3], b[:, 2])
    b[:, :2] = a[:, :2]          # rad depends on |cx| + |cy|: settle it first
    for _ in range(3):
        d = (near_radius(_t(a)) + near_radius(_t(b))).double().numpy() \
            * (1.0 + gap_rel)
        b[:, 0] = a[:, 0] + d * np.cos(phi)
        b[:, 1] = a[:, 1] + d * np.sin(phi)
    return a, b


def _corner_touch(rng, n):
    """tests/test_pallas.py:92-108: a corner of A exactly on an edge of B."""
    from rotate_yolov3_tpu.ops.boxes import rbox_corners
    b = _boxes(rng, n, 10.0, 5.0, 30.0)
    a = _boxes(rng, n, 10.0, 5.0, 30.0)
    bc = np.asarray(rbox_corners(jnp.asarray(b)))
    ac = np.asarray(rbox_corners(jnp.asarray(a)))
    for i in range(n):
        target = bc[i, 0] + rng.uniform(0.1, 0.9) * (bc[i, 1] - bc[i, 0])
        a[i, :2] += target - ac[i, 0]
    return a, b


def _touching_edges(rng, n):
    """Axis-aligned and rotated pairs sharing an edge exactly, and the same
    pairs pulled apart by one and by 1e-3 px along the shared normal."""
    a = _boxes(rng, n, 200.0)
    b = a.copy()
    b[:, 2] = rng.uniform(5, 40, n).astype(np.float32)
    a[: n // 2, 4] = 0.0
    b[:, 4] = a[:, 4]
    off = 0.5 * (a[:, 2] + b[:, 2]) + np.repeat([0.0, 1e-3, 1.0], n)[:n]
    b[:, 0] = a[:, 0] + off * np.cos(a[:, 4])
    b[:, 1] = a[:, 1] + off * np.sin(a[:, 4])
    return a, b


def _case(name):
    """(a, b): N boxes each; the tests use the N x N matrix of pairs."""
    rng = np.random.default_rng(sorted(_CASES).index(name))
    if name == "random":
        return _boxes(rng, N, 300.0), _boxes(rng, N, 300.0)
    if name == "past_margin":
        return _corner_to_corner(rng, N, 1.0, 1e-6)
    if name == "past_margin_scales":
        parts = [_corner_to_corner(rng, N // 4, s, g) for s, g in
                 ((1e-2, 1e-6), (1.0, 1e-3), (30.0, 1e-6), (3.0, 0.0))]
        return tuple(np.concatenate(p) for p in zip(*parts))
    if name == "touching":
        return _touching_edges(rng, N)
    if name == "corner_touch":
        return _corner_touch(rng, N)
    if name == "degenerate":
        a = np.concatenate([_DEGENERATE, _boxes(rng, N - 7, 80.0)])
        return a, a[::-1].copy()
    if name == "zero_huge_tiny":
        a = _boxes(rng, N, 300.0)
        a[:8, 2] = 0.0                                  # zero area
        a[8:16, 3] = 0.0
        a[16:24, 2:4] = rng.uniform(1e-3, 1e-2, (8, 2))  # tiny, kept finite
        a[24:32, 2:4] = rng.uniform(1e-6, 1e-4, (8, 2))  # below 1e-3
        a[32:40] = _boxes(rng, 8, 1e7, 1e5, 1e6)         # huge
        a[40:48, :2] += 2e6                              # far coordinates
        b = a[rng.permutation(N)]
        return a, b
    raise KeyError(name)


_CASES = ("random", "past_margin", "past_margin_scales", "touching",
          "corner_touch", "degenerate", "zero_huge_tiny")


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("case", _CASES)
def test_skipped_pairs_have_zero_intersection(case, algo):
    """(i): every pair that pair_may_overlap rejects intersects in exactly 0,
    in the port's plain pair algo and in skew_iou_matrix_pallas
    (interpret)."""
    a, b = _case(case)
    ta, tb = _t(a)[:, None, :], _t(b)[None, :, :]
    near = pair_may_overlap(ta, tb, 0.4).numpy()
    inter = pair_inter_areas(ta, tb, algo)[0].numpy()
    assert not inter[~near].any(), case
    iou = np.asarray(skew_iou_matrix_pallas(jnp.asarray(a), jnp.asarray(b),
                                            interpret=True, algo=algo))
    assert not iou[~near].any(), case
    if case.startswith("past_margin"):
        # most constructed pairs (the diagonal) land just past the margin;
        # f32 rounding of the placement puts the rest just inside
        assert (~np.diag(near)).mean() > 0.5
    if case in ("touching", "corner_touch"):
        assert np.diag(near).all()
    if case == "random":
        assert 0.3 < (~near).mean() < 0.99


def test_nan_and_inf_rows_are_never_rejected():
    """(ii): a box with a NaN or inf in any field keeps every pair."""
    rng = np.random.default_rng(7)
    ok = _boxes(rng, 12, 500.0)
    ok[0, 2] = 0.0                                 # and a zero-area box
    bad = np.repeat(_boxes(rng, 1, 50.0), 15, axis=0)
    for f in range(5):
        bad[3 * f, f], bad[3 * f + 1, f], bad[3 * f + 2, f] = \
            np.nan, np.inf, -np.inf
    rad = near_radius(_t(bad)).numpy()
    assert np.isinf(rad).all() and (rad > 0).all()
    for thr in (0.4, 0.0):
        assert pair_may_overlap(_t(bad)[:, None], _t(ok)[None], thr).all()
        assert pair_may_overlap(_t(ok)[:, None], _t(bad)[None], thr).all()
        assert pair_may_overlap(_t(bad)[:, None], _t(bad)[None], thr).all()


def _kill_inputs(seed, k=48):
    rng = np.random.default_rng(seed)
    boxes = _boxes(rng, k, 160.0, 5.0, 60.0)
    boxes[5] = boxes[4]                            # an identical pair
    boxes[-6:-3] = 0.0                             # padding rows
    boxes[-3:, 2] = 0.0                            # zero-area decoded rows
    cls = rng.integers(0, 3, k).astype(np.int32)
    return boxes, cls


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("use_cls", [False, True])
def test_kill_mask_survives_the_cull(algo, use_cls):
    """(iii): ref & pair_may_overlap == ref == skew_kill_matrix_pallas
    (interpret) bit for bit, on inputs with no pair within BAND of thr."""
    thr = 0.4
    boxes, cls = _kill_inputs(34)
    iou = np.asarray(skew_iou_matrix_green(jnp.asarray(boxes),
                                           jnp.asarray(boxes)))
    assert (np.abs(iou - thr) > BAND).all()
    tb = _t(boxes)[None]
    tcls = torch.from_numpy(cls)[None] if use_cls else None
    ref = skew_kill_matrix_ref(tb, tcls, thr, algo)
    near = pair_may_overlap(tb[:, :, None], tb[:, None, :], thr)
    assert torch.equal(ref & near.to(torch.int8), ref)
    assert (~near).float().mean() > 0.5 and int(ref.sum()) >= 3
    want = np.asarray(skew_kill_matrix_pallas(
        jnp.asarray(boxes), jnp.asarray(cls) if use_cls else None,
        iou_thr=thr, interpret=True, algo=algo))
    np.testing.assert_array_equal((ref & near.to(torch.int8))[0].numpy(),
                                  want)
    assert torch.equal(skew_kill_matrix(tb, tcls, thr, algo), ref)


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("thr", [0.0, -0.1])
def test_cull_is_off_for_a_negative_threshold(algo, thr):
    """(iv): thr = 0 culls and the mask is unchanged; thr < 0 culls nothing,
    and there the far pairs do kill (0 > thr (A + B))."""
    boxes, _ = _kill_inputs(32)
    tb = _t(boxes)[None]
    ref = skew_kill_matrix_ref(tb, None, thr, algo)
    near = pair_may_overlap(tb[:, :, None], tb[:, None, :], thr)
    assert torch.equal(ref & near.to(torch.int8), ref)
    far = ~pair_may_overlap(tb[:, :, None], tb[:, None, :], 0.4)
    if thr < 0:
        assert bool(near.all()) and bool(pair_may_overlap(
            tb[:, :, None], tb[:, None, :], float("nan")).all())
        assert bool(ref.bool()[far].any())
    else:
        assert bool(far.any()) and not bool(ref.bool()[far].any())
