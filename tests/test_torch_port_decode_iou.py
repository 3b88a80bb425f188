"""PyTorch port, kernels D (gather + decode) and E (the IoU matrix), against
the JAX package on the CPU.

Kernel D's plain version (``ops.decode_rows.decode_rows_ref``) follows the
reference's class rule and NaN-propagating clip on non-finite head values;
kernel E's plain version (``ops.skew_iou_cuda.skew_iou_matrix_ref``) takes
batches, as ``jax.vmap`` of the reference's kernel does; the near-pair test
kernel E skips pairs by (``iou_may_overlap``) skips only pairs whose IoU is
exactly +0; ``keep_iou_matrix`` calls the port's matrix functions once per
batch and any other hook once per image, with the same keep. Inputs are
seeded numpy, shared by both packages; ``chip_smoke.py`` holds the CUDA
kernels to these plain versions on the card.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rotate_yolov3_tpu.config.parse import parse_model_cfg as jparse
from rotate_yolov3_tpu.models.darknet import build_network as jbuild
from rotate_yolov3_tpu.ops.decode_pallas import decode_rows_pallas
from rotate_yolov3_tpu.ops.decode_pallas import heads_meta as jheads_meta
from rotate_yolov3_tpu.ops.skew_iou_pallas import skew_iou_matrix_pallas
from rotate_yolov3_tpu_torch.ops import rotated_nms, skew_iou_cuda
from rotate_yolov3_tpu_torch.ops.decode_rows import (decode_rows,
                                                     decode_rows_ref,
                                                     heads_meta)
from rotate_yolov3_tpu_torch.ops.rotated_nms import (keep_iou_matrix,
                                                     takes_batches)
from rotate_yolov3_tpu_torch.ops.skew_iou_cuda import (
    ALGOS, iou_may_overlap, near_radius, skew_iou_matrix,
    skew_iou_matrix_auto, skew_iou_matrix_auto_nms, skew_iou_matrix_ref)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAN, INF = float("nan"), float("inf")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# --------------------------------------------------------------------------
# kernel D on non-finite head values
# --------------------------------------------------------------------------

# (name, {field: value}): fields 0-4 are tx, ty, tw, th, t_theta; 6 + c is
# class c's logit; "cls" plants every class logit
_PLANTS = [
    ("tw nan", {2: NAN}), ("tw +inf", {2: INF}), ("tw -inf", {2: -INF}),
    ("th nan", {3: NAN}), ("th +inf", {3: INF}), ("th -inf", {3: -INF}),
    ("ttheta nan", {4: NAN}), ("ttheta +inf", {4: INF}),
    ("ttheta -inf", {4: -INF}), ("tx +inf, ty -inf", {0: INF, 1: -INF}),
    ("class 0 nan", {6: NAN}), ("class 9 nan", {15: NAN}),
    ("class 0 nan, class 4 large", {6: NAN, 10: 50.0}),
    ("class 3 nan, class 4 large", {9: NAN, 10: 50.0}),
    ("all classes -inf", {"cls": -INF}), ("all classes nan", {"cls": NAN}),
]


def _planted_case(cfg, img, k, seed):
    """One image per plant: random f32 heads with the plant in one selected
    cell's anchor lanes, and (B, K) indices whose other rows avoid that
    anchor. The reference gathers rows as a one-hot matmul, where 0 x NaN and
    0 x inf are NaN: a non-finite lane reaches every row of its image that
    reads the same lane, so no other row reads it here."""
    spec = jbuild(jparse(os.path.join(ROOT, cfg)), img_size=img)
    ys = spec.yolo_specs
    na, nc = ys[0].na, ys[0].num_classes
    plants = [(n, p) for n, p in _PLANTS
              if nc > 1 or all(f != "cls" and f < 6 for f in p)]
    b = len(plants)
    rng = np.random.default_rng(seed)
    heads = [rng.normal(0, 1.5, (b, img // y.stride, img // y.stride,
                                 na * y.no)).astype(np.float32) for y in ys]
    cells = [h.shape[1] * h.shape[2] for h in heads]
    n = sum(cells) * na
    idx = rng.integers(0, n, (b, k)).astype(np.int64)
    rows = rng.integers(0, k, b)              # the planted row of each image
    valid = rng.uniform(size=(b, k)) > 0.3
    valid[::2, :] = True
    for i, (_, plant) in enumerate(plants):
        g = int(idx[i, rows[i]])
        a0 = g % na
        others = np.arange(k) != rows[i]
        clash = others & (idx[i] % na == a0)
        idx[i, clash] = idx[i, clash] - a0 + (a0 + 1) % na
        cell, off = g // na, 0
        for h, m in zip(heads, cells):        # the head holding the cell
            if cell < off + m:
                y, x = divmod(cell - off, h.shape[2])
                break
            off += m
        for f, v in plant.items():
            fields = range(6, 6 + nc) if f == "cls" else (f,)
            for ff in fields:
                h[i, y, x, ff * na + a0] = v   # field-major lanes
    valid[np.arange(b) % 4 == 3, rows[np.arange(b) % 4 == 3]] = False
    return ys, heads, idx.astype(np.int32), valid, rows, plants


@pytest.mark.parametrize("cfg,img", [("cfg/yolov3-rotate-tiny.cfg", 128),
                                     ("cfg/yolov3-rotate-dota.cfg", 96)])
def test_decode_rows_ref_matches_pallas_on_non_finite_heads(cfg, img):
    """Kernel D's plain version == decode_rows_pallas (interpret) on planted
    NaN and ±inf in tw, th, t_theta and the class lanes, valid and not:
    class ids exact (the reference's strict > from class 0, so NaN never
    wins), boxes within rtol 1e-5 / atol 1e-4 with NaN and inf in the same
    places (the clip keeps NaN and takes ±inf to ±8)."""
    ys, heads, idx, valid, rows, plants = _planted_case(cfg, img, 24, 3)
    na, no, nc = ys[0].na, ys[0].no, ys[0].num_classes
    jh = [jnp.asarray(h) for h in heads]
    cells = jnp.concatenate([r.reshape(r.shape[0], -1, na * no)
                             for r in jh], axis=1)
    want = np.asarray(decode_rows_pallas(
        cells, jnp.asarray(idx), jnp.asarray(valid),
        jheads_meta(ys, [r.shape for r in jh]), na=na, nc=nc,
        field_major=True, interpret=True))
    th = [_t(h) for h in heads]
    meta = heads_meta(ys, [h.shape for h in th])
    got = decode_rows_ref(th, _t(idx), _t(valid), meta, na, nc).numpy()
    np.testing.assert_array_equal(got[..., 5], want[..., 5])
    np.testing.assert_allclose(got[..., :5], want[..., :5], rtol=1e-5,
                               atol=1e-4)
    assert not got[..., 6:].any()
    # the wrapper takes the plain version on the CPU
    torch.testing.assert_close(
        decode_rows(th, _t(idx), _t(valid), meta, na, nc), _t(got),
        rtol=0, atol=0, equal_nan=True)
    planted = got[np.arange(len(plants)), rows]
    for (name, plant), row, ok in zip(plants, planted,
                                      valid[np.arange(len(plants)), rows]):
        if 2 in plant or 3 in plant:
            f = 2 if 2 in plant else 3
            assert np.isnan(row[f]) == np.isnan(plant[f]), name
        if 6 in plant and np.isnan(plant[6]) or plant.get("cls") is not None:
            assert row[5] == 0, name           # pinned to class 0
        if name == "class 3 nan, class 4 large":
            assert row[5] == 4, name
        if not ok and any(np.isnan(v) for f, v in plant.items()
                          if f != "cls" and f < 5):
            assert np.isnan(row[:5]).any(), name   # NaN x 0 stays NaN
    assert np.isnan(got).any() and np.isfinite(got).mean() > 0.9


def test_decode_rows_ref_fault_is_the_class_rule():
    """The rule the plain version now follows differs from torch.argmax
    exactly where the reference's loop does: NaN lanes and all −inf rows."""
    ys, heads, idx, valid, rows, plants = _planted_case(
        "cfg/yolov3-rotate-dota.cfg", 96, 8, 4)
    na, nc = ys[0].na, ys[0].num_classes
    th = [_t(h) for h in heads]
    meta = heads_meta(ys, [h.shape for h in th])
    got = decode_rows_ref(th, _t(idx), _t(valid), meta, na, nc)
    cls = got[np.arange(len(plants)), rows, 5]
    by_name = dict(zip([n for n, _ in plants], cls.tolist()))
    assert by_name["class 0 nan"] == 0
    assert by_name["class 0 nan, class 4 large"] == 0
    assert by_name["all classes -inf"] == 0
    assert by_name["all classes nan"] == 0
    assert by_name["class 3 nan, class 4 large"] == 4


# --------------------------------------------------------------------------
# kernel E, batched
# --------------------------------------------------------------------------

def _boxes(rng, n, spread=60.0, lo=5.0, hi=30.0):
    return np.stack([
        rng.uniform(0, spread, n), rng.uniform(0, spread, n),
        rng.uniform(lo, hi, n), rng.uniform(lo, hi, n),
        rng.uniform(-np.pi, np.pi, n)], axis=1).astype(np.float32)


def _batch(seed, b, n):
    """b images of n boxes: random, with shared angles (parallel edges), an
    identical pair, zero-area rows and padding."""
    rng = np.random.default_rng(seed)
    out = np.stack([_boxes(rng, n) for _ in range(b)])
    out[:, :6, 4] = rng.choice([0.0, np.pi / 4, 1.1], (b, 6))
    out[:, 7] = out[:, 6]
    out[:, -3:] = 0.0
    out[:, -5, 2] = 0.0
    return out


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("triangle", [False, True])
def test_batched_iou_matrix_ref_matches_pallas(algo, triangle):
    """Kernel E's plain version on (B, N, 5) x (B, M, 5) == the reference's
    kernel (interpret) image by image within 1e-5; with ``triangle``, on the
    strict upper triangle, zeros below, and the full matrix's values above."""
    b, n = 3, 24
    a = _batch(5, b, n)
    other = a if triangle else _batch(6, b, n)
    got = skew_iou_matrix_ref(_t(a), _t(other), triangle, algo).numpy()
    assert got.shape == (b, n, n)
    for i in range(b):
        want = np.asarray(skew_iou_matrix_pallas(
            jnp.asarray(a[i]), jnp.asarray(other[i]), block_n=8, block_m=16,
            interpret=True, triangle=triangle, algo=algo))
        if triangle:
            up = np.triu(np.ones((n, n), bool), 1)
            np.testing.assert_allclose(got[i][up], want[up], atol=1e-5)
            assert not got[i][~up].any()
        else:
            np.testing.assert_allclose(got[i], want, atol=1e-5)
        per_image = skew_iou_matrix_ref(_t(a[i]), _t(other[i]), triangle,
                                        algo).numpy()
        np.testing.assert_allclose(got[i], per_image, rtol=1e-6, atol=1e-7)
    if triangle:
        full = skew_iou_matrix_ref(_t(a), _t(a), False, algo).numpy()
        up = np.broadcast_to(np.triu(np.ones((n, n), bool), 1), got.shape)
        np.testing.assert_array_equal(got[up], full[up])
    assert (got > 0.05).sum() >= 3 * b


def test_batched_iou_matrix_wrappers_on_the_cpu():
    """The wrapper and the argsort oracle take batches on CPU tensors;
    shapes that differ in batch or width are refused."""
    a = _t(_batch(7, 2, 9))
    b = _t(_batch(8, 2, 13))
    assert skew_iou_matrix(a, b, algo="green2").shape == (2, 9, 13)
    assert torch.equal(skew_iou_matrix(a, b, algo="green2"),
                       skew_iou_matrix_ref(a, b, algo="green2"))
    auto = skew_iou_matrix_auto(a, b)
    assert torch.equal(auto, skew_iou_matrix_auto_nms(a, b))
    for i in range(2):
        torch.testing.assert_close(auto[i], skew_iou_matrix_auto(a[i], b[i]),
                                   rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="batch"):
        skew_iou_matrix(a, b[:1])
    with pytest.raises(ValueError, match="batch"):
        skew_iou_matrix(a, b[0])
    with pytest.raises(ValueError, match=r"\(B, N, 5\)"):
        skew_iou_matrix(a[..., :4], b)


# --------------------------------------------------------------------------
# kernel E's cull: a skipped pair has IoU exactly +0
# --------------------------------------------------------------------------

def _corner_to_corner(rng, n, scale, gap_rel):
    """n pairs whose corners point at each other across the gap the
    near-pair radii leave, times 1 + gap_rel."""
    a = _boxes(rng, n, 100.0 * scale, 0.5 * scale, 30.0 * scale)
    a[:, :2] += 1000.0 * scale
    b = _boxes(rng, n, 1.0, 0.5 * scale, 30.0 * scale)
    phi = a[:, 4] + np.arctan2(a[:, 3], a[:, 2])
    b[:, 4] = phi - np.arctan2(b[:, 3], b[:, 2])
    b[:, :2] = a[:, :2]
    for _ in range(3):
        d = (near_radius(_t(a)) + near_radius(_t(b))).double().numpy() \
            * (1.0 + gap_rel)
        b[:, 0] = a[:, 0] + d * np.cos(phi)
        b[:, 1] = a[:, 1] + d * np.sin(phi)
    return a, b


def _cull_case(name, n=48):
    rng = np.random.default_rng(_CULL_CASES.index(name) + 40)
    if name == "random":
        return _boxes(rng, n, 300.0), _boxes(rng, n, 300.0)
    if name == "clustered":
        centres = rng.uniform(0, 400, (6, 2))
        a = _boxes(rng, n, 1.0, 5.0, 60.0)
        a[:, :2] = centres[rng.integers(0, 6, n)] + rng.normal(0, 8, (n, 2))
        return a, a[rng.permutation(n)]
    if name == "past_margin":
        parts = [_corner_to_corner(rng, n // 4, s, g) for s, g in
                 ((1e-2, 1e-6), (1.0, 1e-3), (30.0, 1e-6), (3.0, 0.0))]
        return tuple(np.concatenate(p) for p in zip(*parts))
    if name == "degenerate":
        a = _boxes(rng, n, 300.0)
        a[:6, 2] = 0.0                                   # zero area
        a[6:10, 3] = 0.0
        a[10:14] = 0.0                                   # padding
        a[14:18, 2:4] = rng.uniform(1e-6, 1e-4, (4, 2))  # below 1e-3
        for f in range(5):                               # NaN, +inf, -inf
            a[18 + 3 * f:21 + 3 * f, f] = (NAN, INF, -INF)
        a[33:37] = _boxes(rng, 4, 1e7, 1e5, 1e6)         # huge
        return a, a[rng.permutation(n)]
    raise KeyError(name)


_CULL_CASES = ("random", "clustered", "past_margin", "degenerate")


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("case", _CULL_CASES)
def test_iou_cull_skips_only_exact_positive_zeros(case, algo):
    """Every pair iou_may_overlap skips has plain IoU exactly +0 (not -0,
    not NaN) in every pair algo; pairs with a zero-area, non-finite, tiny or
    huge box are never skipped."""
    a, b = _cull_case(case)
    ta, tb = _t(a), _t(b)
    near = iou_may_overlap(ta[:, None, :], tb[None, :, :])
    iou = skew_iou_matrix_ref(ta, tb, algo=algo)
    skipped = iou[~near]
    assert bool((skipped == 0).all()) and not bool(skipped.signbit().any())
    rad_a, rad_b = near_radius(ta), near_radius(tb)
    odd = ~torch.isfinite(rad_a)[:, None] | ~torch.isfinite(rad_b)[None, :]
    assert bool(near[odd].all())
    if case in ("random", "clustered"):
        assert 0.2 < float((~near).float().mean()) < 0.99
    if case == "past_margin":
        assert float((~near.diagonal()).float().mean()) > 0.5
    if case == "degenerate":
        assert bool(odd.any()) and bool(iou[odd].isnan().any())


# --------------------------------------------------------------------------
# keep_iou_matrix: the port's hooks once per batch
# --------------------------------------------------------------------------

def _nms_inputs(seed, b=3, k=40):
    rng = np.random.default_rng(seed)
    boxes = np.stack([_boxes(rng, k, 120.0, 10.0, 40.0) for _ in range(b)])
    boxes[:, -4:] = 0.0
    valid = np.ones((b, k), bool)
    valid[:, -4:] = False
    cls = rng.integers(0, 3, (b, k)).astype(np.int32)
    return _t(boxes), _t(cls), _t(valid)


_PORT_HOOKS = {
    "skew_iou_matrix_ref": skew_iou_matrix_ref,
    "skew_iou_matrix": skew_iou_matrix,
    "partial(skew_iou_matrix, green2, triangle)": functools.partial(
        skew_iou_matrix, algo="green2", triangle=True),
    "partial(skew_iou_matrix_ref, candidates)": functools.partial(
        skew_iou_matrix_ref, algo="candidates"),
    "skew_iou_matrix_auto": skew_iou_matrix_auto,
    "skew_iou_matrix_auto_nms": skew_iou_matrix_auto_nms,
}


@pytest.mark.parametrize("use_cls", [False, True])
@pytest.mark.parametrize("name", list(_PORT_HOOKS))
def test_keep_iou_matrix_batches_port_hooks(monkeypatch, name, use_cls):
    """A port hook (bare or a partial) is called once on the (B, K, 5)
    boxes, a foreign callable wrapping it once per image, and both give the
    same keep."""
    hook = _PORT_HOOKS[name]
    assert takes_batches(hook)
    calls = []

    def counted(fn):
        def wrapped(*args, **kw):
            calls.append(args[0].ndim)
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(skew_iou_cuda, "pair_inter_areas",
                        counted(skew_iou_cuda.pair_inter_areas))
    monkeypatch.setattr(skew_iou_cuda, "skew_iou_matrix_argsort",
                        counted(skew_iou_cuda.skew_iou_matrix_argsort))
    boxes, cls, valid = _nms_inputs(9)
    cls = cls if use_cls else None
    keep = keep_iou_matrix(boxes, cls, valid, 0.3, hook)
    assert len(calls) == 1 and calls[0] in (3, 4)   # (B,K,5) or (B,K,1,5)
    calls.clear()

    def foreign(a, b):
        return hook(a, b)

    assert not takes_batches(foreign)
    keep_f = keep_iou_matrix(boxes, cls, valid, 0.3, foreign)
    assert len(calls) == boxes.shape[0] and set(calls) <= {2, 3}
    assert torch.equal(keep, keep_f)
    assert 0 < int(keep.sum()) < int(valid.sum())


def test_takes_batches_only_port_functions():
    assert takes_batches(functools.partial(functools.partial(
        skew_iou_matrix, algo="green"), triangle=True))
    assert not takes_batches(functools.partial(skew_iou_matrix,
                                               torch.zeros(3, 5)))
    assert not takes_batches(lambda a, b: skew_iou_matrix(a, b))
    assert not takes_batches(rotated_nms.greedy_suppress)
