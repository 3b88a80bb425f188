"""PyTorch port, third slice, kernel by kernel against the JAX package on
the CPU: the pair algos green2 and candidates (kernels B', C green2), the
IoU matrix (kernel E), the gather + decode (kernel D) and the argsort IoU
oracle. ``test_torch_port_options.py`` covers the paths that run them.

The JAX side takes its TPU branch where the port's card path runs a kernel:
the Pallas kernels run in interpret mode, composed as the reference's TPU
branch composes them. On the CPU the port's wrappers take their plain
versions; ``chip_smoke.py`` holds the CUDA kernels to those on the card.
Inputs are seeded numpy, shared by both sides.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rotate_yolov3_tpu.config.parse import parse_model_cfg as jparse
from rotate_yolov3_tpu.models import yolo_head as jyh
from rotate_yolov3_tpu.models.darknet import build_network as jbuild
from rotate_yolov3_tpu.ops import boxes as jboxes
from rotate_yolov3_tpu.ops.decode_pallas import decode_rows_pallas
from rotate_yolov3_tpu.ops.decode_pallas import heads_meta as jheads_meta
from rotate_yolov3_tpu.ops.nms_pallas import nms_greedy_pallas
from rotate_yolov3_tpu.ops.skew_iou import skew_iou_matrix as jax_argsort
from rotate_yolov3_tpu.ops.skew_iou_green import \
    inter_area_green_bframe as jax_bframe
from rotate_yolov3_tpu.ops.skew_iou_green import skew_iou_matrix_green
from rotate_yolov3_tpu.ops.skew_iou_pallas import (skew_iou_matrix_pallas,
                                                   skew_kill_matrix_pallas)
from rotate_yolov3_tpu_torch import _build
from rotate_yolov3_tpu_torch.ops import boxes as tboxes
from rotate_yolov3_tpu_torch.ops.decode_rows import (decode_rows,
                                                     decode_rows_ref,
                                                     heads_meta)
from rotate_yolov3_tpu_torch.ops.nms_greedy import nms_greedy, nms_greedy_ref
from rotate_yolov3_tpu_torch.ops.skew_iou import skew_iou_matrix as argsort
from rotate_yolov3_tpu_torch.ops.skew_iou_cuda import (
    skew_iou_matrix, skew_iou_matrix_auto, skew_iou_matrix_auto_nms,
    skew_iou_matrix_ref, skew_kill_matrix, skew_kill_matrix_ref)
from rotate_yolov3_tpu_torch.ops.skew_iou_green import \
    inter_area_green_bframe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAND = 1e-4     # pairs this close to thr may be decided either way

# tests/test_pallas.py:50-58 and the port's own zero-area / touching cases
_DEGENERATE = np.array([
    [50, 50, 20, 10, 0.8], [50, 50, 20, 10, 0.8],
    [50, 50, 20, 10, 0.0], [55, 50, 20, 10, 0.0], [50, 52, 20, 10, 0.0],
    [30, 30, 16, 8, 0.5], [34, 33, 16, 8, 0.5],
    [70, 50, 20, 10, 0.0], [50, 50, 20, 10, np.pi / 2],
    [0, 0, 0, 0, 0], [10, 10, 0, 5, 0.3],
], np.float32)


def _random_boxes(rng, n, spread=60.0):
    return np.stack([
        rng.uniform(0, spread, n), rng.uniform(0, spread, n),
        rng.uniform(5, 30, n), rng.uniform(5, 30, n),
        rng.uniform(-np.pi, np.pi, n)], axis=1).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _corner_touch(n=24, seed=11):
    """tests/test_pallas.py:78-108: a corner of A exactly on an edge of B
    while B's corners sit inside A, the 8-slot compaction's pinned
    underestimate. Returns (A, B) boxes, pairwise aligned."""
    s2 = float(np.sqrt(2.0))
    a = [[-1.0, 0.0, 2.0 * s2, 2.0 * s2, np.pi / 4],
         [-0.7, 0.0, 1.7 * s2, 1.7 * s2, np.pi / 4]]
    b = [[0.0, 0.0, 2.0, 2.0, 0.0]] * 2
    rng = np.random.default_rng(seed)
    bs = _random_boxes(rng, n, 10.0)
    as_ = _random_boxes(rng, n, 10.0)
    bc = np.asarray(jboxes.rbox_corners(jnp.asarray(bs)))
    ac = np.asarray(jboxes.rbox_corners(jnp.asarray(as_)))
    for i in range(n):
        target = bc[i, 0] + rng.uniform(0.1, 0.9) * (bc[i, 1] - bc[i, 0])
        as_[i, :2] += target - ac[i, 0]
    return (np.concatenate([np.asarray(a, np.float32), as_]),
            np.concatenate([np.asarray(b, np.float32), bs]))


# --------------------------------------------------------------------------
# box helpers and the argsort oracle
# --------------------------------------------------------------------------

def test_box_helpers_match_jax():
    rng = np.random.default_rng(0)
    b = _random_boxes(rng, 50, 100.0)
    b[:5, 4] = rng.uniform(-9.0, 9.0, 5)
    for name in ("rbox_corners", "rbox_area", "rbox_aabb",
                 "normalize_angle"):
        arg = b[:, 4] if name == "normalize_angle" else b
        want = np.asarray(getattr(jboxes, name)(jnp.asarray(arg)))
        got = getattr(tboxes, name)(_t(arg)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5,
                                   err_msg=name)
    pts = np.asarray(jboxes.rbox_corners(jnp.asarray(b)))
    np.testing.assert_allclose(tboxes.poly_area(_t(pts)).numpy(),
                               np.asarray(jboxes.poly_area(jnp.asarray(pts))),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(tboxes.poly_area(_t(pts)).numpy(),
                               b[:, 2] * b[:, 3], rtol=1e-4)


@pytest.mark.parametrize("case", ["random", "degenerate", "corner_touch"])
def test_argsort_iou_matrix_matches_jax(case):
    """26 x 26 in every case, so the JAX side compiles once."""
    rng = np.random.default_rng(1)
    if case == "random":
        a, b = _random_boxes(rng, 26), _random_boxes(rng, 26)
    elif case == "degenerate":
        a = b = np.concatenate([_DEGENERATE, _random_boxes(rng, 15)])
    else:
        a, b = _corner_touch()
    want = np.asarray(jax_argsort(jnp.asarray(a), jnp.asarray(b)))
    got = argsort(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    if case == "degenerate":
        np.testing.assert_allclose(np.diag(got)[:9], 1.0, atol=2e-3)
        assert not got[9].any() and not got[:, 9].any()


# --------------------------------------------------------------------------
# pair algos: green2 and candidates (plain versions of B', C and E)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "degenerate"])
def test_green2_matches_jax(case):
    rng = np.random.default_rng(2)
    if case == "random":
        a, b = _random_boxes(rng, 2000, 30.0), _random_boxes(rng, 2000, 30.0)
    else:
        a = np.repeat(_DEGENERATE, len(_DEGENERATE), axis=0)
        b = np.tile(_DEGENERATE, (len(_DEGENERATE), 1))
    want = np.asarray(jax_bframe(*[jnp.asarray(a[:, i]) for i in range(5)],
                                 *[jnp.asarray(b[:, i]) for i in range(5)]))
    got = inter_area_green_bframe(*[_t(a[:, i]) for i in range(5)],
                                  *[_t(b[:, i]) for i in range(5)]).numpy()
    assert np.isfinite(got).all() and (got > 0).mean() > 0.2
    # the Green terms are products of coordinates; the two frameworks' CPU
    # sin/cos differ in the last bit, so one f32 ulp of the largest term
    # (~1e3 px² for centres within 30 px, 6e-5) bounds the difference
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def iou_boxes():
    """40 random boxes (shared angles force parallel edges) and the
    degenerate set."""
    rng = np.random.default_rng(3)
    a = _random_boxes(rng, 40, 50.0)
    a[:12, 4] = rng.choice([0.0, np.pi / 4, 1.1], 12)
    return np.concatenate([a, _DEGENERATE])


@pytest.mark.parametrize("algo", ["green", "green2", "candidates"])
def test_iou_matrix_ref_matches_pallas(iou_boxes, algo):
    """Kernel E's plain version == skew_iou_matrix_pallas (interpret), full
    and, on the strict upper triangle, with ``triangle``; near the argsort
    oracle (tests/test_pallas.py's 2e-3) everywhere."""
    a = iou_boxes
    ja = jnp.asarray(a)
    want = np.asarray(skew_iou_matrix_pallas(ja, ja, interpret=True,
                                             algo=algo))
    got = skew_iou_matrix(_t(a), _t(a), algo=algo).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(jax_argsort(ja, ja)), atol=2e-3)
    want_t = np.asarray(skew_iou_matrix_pallas(
        ja, ja, block_n=16, block_m=32, interpret=True, triangle=True,
        algo=algo))
    got_t = skew_iou_matrix_ref(_t(a), _t(a), triangle=True,
                                algo=algo).numpy()
    up = np.triu(np.ones(got_t.shape, bool), 1)
    np.testing.assert_allclose(got_t[up], want_t[up], atol=1e-5)
    assert not got_t[~up].any()
    np.testing.assert_array_equal(got_t[up], got[up])


def test_candidates_corner_touch_matches_pallas():
    """The candidate algo keeps the reference's 8-slot compaction, including
    its pinned corner-touch underestimate (tests/test_pallas.py:67-119).

    Each touch pair (the diagonal) puts a corner exactly on the other box's
    edge, at the 1e-6 inclusive tolerance, so which coincident candidates
    pass depends on the last bit of f32 rounding, which XLA (contracting
    FMAs on the CPU) and PyTorch (one rounding per op) take differently:
    the two constructed cases and every pair that does not touch agree
    within 1e-5, at most one random touch pair of 24 may differ, and every
    touch pair stays inside the reference's pinned bounds."""
    a, b = _corner_touch()
    want = np.asarray(skew_iou_matrix_pallas(
        jnp.asarray(a), jnp.asarray(b), interpret=True, algo="candidates"))
    got = skew_iou_matrix_ref(_t(a), _t(b), algo="candidates").numpy()
    touch = np.eye(len(a), dtype=bool)
    touch[:2, :2] = False
    np.testing.assert_allclose(got[~touch], want[~touch], atol=1e-5)
    assert (np.abs(got - want)[touch] > 1e-5).sum() <= 1
    pair = np.arange(len(a))
    err = np.abs(got[pair, pair] - argsort(_t(a), _t(b)).numpy()[pair, pair])
    assert err.max() < 0.05 and (err > 5e-3).sum() <= 2


def test_iou_matrix_auto_functions_on_the_cpu():
    """On CPU tensors the reference's dispatch functions take the argsort
    oracle, as the reference does off the TPU."""
    rng = np.random.default_rng(4)
    a, b = _t(_random_boxes(rng, 9)), _t(_random_boxes(rng, 13))
    for fn in (skew_iou_matrix_auto, skew_iou_matrix_auto_nms):
        assert torch.equal(fn(a, b), argsort(a, b))


# --------------------------------------------------------------------------
# kernel B': the kill mask with green2 and candidates
# --------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["green2", "candidates"])
@pytest.mark.parametrize("use_cls", [False, True])
def test_kill_matrix_pair_algos_match_pallas(algo, use_cls):
    """Plain kill mask == skew_kill_matrix_pallas (interpret, same algo) on
    every pair more than BAND from thr; the degenerate boxes included."""
    rng = np.random.default_rng(10)
    thr = 0.4
    boxes = np.concatenate([_random_boxes(rng, 37, 45.0), _DEGENERATE])
    cls = rng.integers(0, 3, len(boxes)).astype(np.int32)
    want = np.asarray(skew_kill_matrix_pallas(
        jnp.asarray(boxes), jnp.asarray(cls) if use_cls else None,
        iou_thr=thr, interpret=True, algo=algo))
    tcls = _t(cls)[None] if use_cls else None
    got = skew_kill_matrix(_t(boxes)[None], tcls, iou_thr=thr, algo=algo)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(
        got.numpy(), skew_kill_matrix_ref(_t(boxes)[None], tcls, thr,
                                          algo).numpy())
    iou = np.asarray(skew_iou_matrix_green(jnp.asarray(boxes),
                                           jnp.asarray(boxes)))
    far = np.abs(iou - thr) > BAND
    np.testing.assert_array_equal(got.numpy()[0][far], want[far])
    assert want.sum() >= 3
    # the same kills as the green algo away from the band
    green = skew_kill_matrix(_t(boxes)[None], tcls, iou_thr=thr).numpy()[0]
    np.testing.assert_array_equal(got.numpy()[0][far], green[far])


# --------------------------------------------------------------------------
# kernel C: green2, and "candidates" computing green
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "classes_chain"])
def test_nms_greedy_green2_matches_pallas(case):
    rng = np.random.default_rng(20)
    b, k = 2, 70
    boxes = np.stack([_random_boxes(rng, k, 90.0) for _ in range(b)])
    valid = rng.uniform(size=(b, k)) > 0.1
    cls = None
    if case == "classes_chain":
        cls = rng.integers(0, 3, (b, k)).astype(np.int32)
        boxes[0] = 0.0
        boxes[0, :, 0] = 10.0 + 6.0 * np.arange(k)   # a suppression chain
        boxes[0, :, 1:4] = (10.0, 12.0, 12.0)
        cls[0], valid[0] = 1, True
    boxes = np.where(valid[..., None], boxes, 0.0).astype(np.float32)
    jcls = None if cls is None else jnp.asarray(cls)
    want = np.asarray(nms_greedy_pallas(jnp.asarray(boxes), jcls,
                                        jnp.asarray(valid), iou_thr=0.3,
                                        interpret=True, algo="green2"))
    tcls = None if cls is None else _t(cls)
    got = nms_greedy(_t(boxes), tcls, _t(valid), 0.3, algo="green2")
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < int(got.sum()) < int(valid.sum())
    if cls is not None:
        np.testing.assert_array_equal(got[0].numpy(), np.arange(k) % 2 == 0)
    # "candidates" computes green, as the reference's kernel C does
    assert torch.equal(nms_greedy(_t(boxes), tcls, _t(valid), 0.3,
                                  algo="candidates"),
                       nms_greedy_ref(_t(boxes), tcls, _t(valid), 0.3,
                                      algo="green"))


# --------------------------------------------------------------------------
# kernel D: gather + decode
# --------------------------------------------------------------------------

def _decode_case(cfg, img, b, k, seed, dtype="float32"):
    spec = jbuild(jparse(os.path.join(ROOT, cfg)), img_size=img)
    rng = np.random.default_rng(seed)
    ys = spec.yolo_specs
    heads = [rng.normal(0, 0.7, (b, img // y.stride, img // y.stride,
                                 y.na * y.no)).astype(np.float32)
             for y in ys]
    n = sum(h.shape[1] * h.shape[2] for h in heads) * ys[0].na
    idx = rng.integers(0, n, (b, k)).astype(np.int32)
    off = 0
    for h in heads:                    # first and last row of every head
        m = h.shape[1] * h.shape[2] * ys[0].na
        idx[0, :2] = (off, off + m - 1)
        idx = np.roll(idx, 2, axis=1)
        off += m
    valid = rng.uniform(size=(b, k)) > 0.2
    if dtype == "bfloat16":
        heads = [np.array(jnp.asarray(h, jnp.bfloat16).astype(jnp.float32))
                 for h in heads]
        if ys[0].num_classes > 1:      # exact ties of the class maximum
            na = ys[0].na
            for h in heads:
                h[..., ::2, 10 * na:11 * na] = h[..., ::2, 7 * na:8 * na]
    return ys, heads, idx, valid


@pytest.mark.parametrize("cfg,img,field_major,dtype", [
    ("cfg/yolov3-rotate-tiny.cfg", 128, True, "float32"),
    ("cfg/yolov3-rotate-tiny.cfg", 128, False, "float32"),
    ("cfg/yolov3-rotate-dota.cfg", 96, True, "float32"),    # nc = 15
    ("cfg/yolov3-rotate-dota.cfg", 96, True, "bfloat16"),
])
def test_decode_rows_matches_pallas(cfg, img, field_major, dtype):
    """Kernel D's plain version == decode_rows_pallas (interpret): boxes
    within rtol 1e-5 / atol 1e-4 (transcendentals), class ids exact
    (including ties and bf16 cells), columns 6-7 zero, head-boundary
    indices decoded with their own head's tables."""
    ys, heads, idx, valid = _decode_case(cfg, img, 2, 48, seed=5,
                                         dtype=dtype)
    na, no, nc = ys[0].na, ys[0].no, ys[0].num_classes
    jh = [jnp.asarray(h, getattr(jnp, dtype)) for h in heads]
    cells = jnp.concatenate([r.reshape(r.shape[0], -1, na * no)
                             for r in jh], axis=1)
    want = np.asarray(decode_rows_pallas(
        cells, jnp.asarray(idx), jnp.asarray(valid),
        jheads_meta(ys, [r.shape for r in jh]), na=na, nc=nc,
        field_major=field_major, interpret=True))
    th = [_t(h).to(getattr(torch, dtype)) for h in heads]
    meta = heads_meta(ys, [r.shape for r in th])
    got = decode_rows(th, _t(idx), _t(valid), meta, na, nc,
                      field_major).numpy()
    assert got.shape == (2, 48, 8)
    np.testing.assert_allclose(got[..., :5], want[..., :5], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(got[..., 5], want[..., 5])
    assert not got[..., 6:].any() and not got[~valid][:, :5].any()
    if nc > 1:
        assert len(set(got[..., 5].reshape(-1).tolist())) > 3
    # kernel A + decode gives the same boxes
    ref = jyh.decode_gathered(jh, ys, jnp.asarray(idx), field_major)
    np.testing.assert_allclose(
        got[..., :5], np.where(valid[..., None], np.asarray(ref[..., :5]),
                               0.0), rtol=1e-5, atol=1e-4)
    assert torch.equal(decode_rows_ref(th, _t(idx), _t(valid), meta, na, nc,
                                       field_major), _t(got))


# --------------------------------------------------------------------------
# wrappers and build
# --------------------------------------------------------------------------

def test_new_wrappers_refuse_non_cuda_devices_and_bad_inputs():
    meta_boxes = torch.zeros(6, 5, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        skew_iou_matrix(meta_boxes, meta_boxes)
    with pytest.raises(ValueError, match="algo"):
        skew_iou_matrix(torch.zeros(3, 5), torch.zeros(3, 5), algo="argsort")
    with pytest.raises(ValueError, match=r"\(N, 5\)"):
        skew_iou_matrix(torch.zeros(3, 4), torch.zeros(3, 5))
    ys, heads, idx, valid = _decode_case("cfg/yolov3-rotate-tiny.cfg", 64, 1,
                                         4, seed=1)
    th = [_t(h) for h in heads]
    meta = heads_meta(ys, [h.shape for h in th])
    na, nc = ys[0].na, ys[0].num_classes
    with pytest.raises(ValueError, match="CUDA"):
        decode_rows([h.to("meta") for h in th], _t(idx).to("meta"),
                    _t(valid).to("meta"), meta, na, nc)
    with pytest.raises(TypeError, match="int32"):
        decode_rows(th, _t(idx).long(), _t(valid), meta, na, nc)
    with pytest.raises(ValueError, match="does not match"):
        decode_rows(th, _t(idx), _t(valid), meta, na + 1, nc)


def test_build_lists_five_kernels_with_their_flags():
    # the five TPU kernels' ports and the conv epilogue
    assert _build.kernel_names() == ("conv_epilogue", "decode_rows",
                                     "gather_rows", "nms_greedy",
                                     "skew_iou_matrix", "skew_kill")
    for name in ("skew_kill", "nms_greedy", "skew_iou_matrix",
                 "conv_epilogue"):
        assert "-fmad=false" in _build.flags(name)
    assert "-fmad=false" not in _build.flags("decode_rows")
