"""PyTorch port, op by op, against the JAX package on the CPU.

Each module of ``rotate_yolov3_tpu_torch`` that holds a kernel (or feeds
one) gets the same numpy-seeded inputs as its JAX counterpart. Where the JAX
side is a Pallas kernel it runs in interpret mode, as the JAX package's own
tests run it. On the CPU the port's kernel wrappers take their plain PyTorch
versions; the CUDA kernels themselves are checked against those plain
versions on the card by ``chip_smoke.py``.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rotate_yolov3_tpu.ops.gather_rows import gather_rows_pallas
from rotate_yolov3_tpu.ops.rotated_nms import \
    greedy_suppress_fixpoint_kill as jax_fixpoint_kill
from rotate_yolov3_tpu.ops.skew_iou_green import \
    inter_area_green as jax_inter_area_green
from rotate_yolov3_tpu.ops.skew_iou_green import \
    skew_iou_matrix_green as jax_iou_matrix_green
from rotate_yolov3_tpu.ops.skew_iou_pallas import skew_kill_matrix_pallas
from rotate_yolov3_tpu.ops.topk import strided_topk as jax_strided_topk
from rotate_yolov3_tpu_torch.ops.gather_rows import (gather_rows,
                                                     gather_rows_ref)
from rotate_yolov3_tpu_torch.ops.rotated_nms import (
    greedy_suppress_fixpoint_kill, non_max_suppression_fused)
from rotate_yolov3_tpu_torch.ops.skew_iou_cuda import (skew_kill_matrix,
                                                       skew_kill_matrix_ref)
from rotate_yolov3_tpu_torch.ops.skew_iou_green import (
    inter_area_green, skew_iou_matrix_green)
from rotate_yolov3_tpu_torch.ops.topk import select_topk, strided_topk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_boxes(rng, n, spread=100.0):
    return np.stack([
        rng.uniform(0, spread, n), rng.uniform(0, spread, n),
        rng.uniform(5, 30, n), rng.uniform(5, 30, n),
        rng.uniform(-np.pi, np.pi, n)], axis=1).astype(np.float32)


# --------------------------------------------------------------------------
# kernel A: row gather
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c,k", [(7581, 126, 128), (40, 42, 32)])
def test_gather_rows_bit_exact_vs_pallas(dtype, n, c, k):
    """Plain version == Pallas kernel (interpret), bit for bit, including
    duplicate and out-of-range indices (clamped)."""
    rng = np.random.default_rng(0)
    b = 2
    cells = rng.normal(size=(b, n, c)).astype(np.float32)
    idx = rng.integers(0, n, (b, k)).astype(np.int32)
    idx[0, :6] = [0, 0, n - 1, n - 1, -3, n + 5]   # dups + out of range
    idx[1, :4] = [7, 7, 7, -1]
    jcells = jnp.asarray(cells).astype(getattr(jnp, dtype))
    want = np.asarray(gather_rows_pallas(jcells, jnp.asarray(idx),
                                         interpret=True).astype(jnp.float32))
    tcells = torch.from_numpy(cells).to(getattr(torch, dtype))
    got = gather_rows(tcells, torch.from_numpy(idx))
    assert got.dtype == tcells.dtype and got.shape == (b, k, c)
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(
        gather_rows_ref(tcells, torch.from_numpy(idx)).float().numpy(), want)


def test_gather_rows_rejects_bad_inputs():
    cells = torch.zeros(2, 10, 4)
    with pytest.raises(TypeError):
        gather_rows(cells, torch.zeros(2, 3, dtype=torch.int64))
    with pytest.raises(ValueError):
        gather_rows(cells, torch.zeros(3, 3, dtype=torch.int32))
    with pytest.raises(ValueError):   # meta tensors are neither CPU nor CUDA
        gather_rows(cells.to("meta"),
                    torch.zeros(2, 3, dtype=torch.int32, device="meta"))


# --------------------------------------------------------------------------
# Green's-theorem intersection (plain version of kernel B)
# --------------------------------------------------------------------------

_DEGENERATE = np.array([
    [50, 50, 20, 10, 0.8],    # identical pair
    [50, 50, 20, 10, 0.8],
    [50, 50, 20, 10, 0.0],    # axis-aligned trio with parallel edges
    [55, 50, 20, 10, 0.0],
    [50, 52, 20, 10, 0.0],
    [30, 30, 16, 8, 0.5],     # same-angle shifted (parallel edges)
    [34, 33, 16, 8, 0.5],
    [70, 50, 20, 10, 0.0],    # touches [50, 50, 20, 10, 0] along x = 60
    [50, 50, 20, 10, np.pi / 2],   # right angle to the axis-aligned box
    [0, 0, 0, 0, 0],          # zero-area padding rows
    [0, 0, 0, 0, 0],
    [10, 10, 0, 5, 0.3],      # zero width
], np.float32)


def _pairs(boxes):
    a = np.repeat(boxes, len(boxes), axis=0)
    b = np.tile(boxes, (len(boxes), 1))
    return a, b


@pytest.mark.parametrize("case", ["random", "degenerate"])
def test_inter_area_green_matches_jax(case):
    """rtol 1e-4 / atol 1e-3 px²: the two frameworks' CPU sin/cos and
    summation orders differ in the last bits."""
    rng = np.random.default_rng(1)
    if case == "random":
        a, b = _random_boxes(rng, 2000, 40.0), _random_boxes(rng, 2000, 40.0)
    else:
        a, b = _pairs(_DEGENERATE)
    want = np.asarray(jax_inter_area_green(*[jnp.asarray(a[:, i])
                                             for i in range(5)],
                                           *[jnp.asarray(b[:, i])
                                             for i in range(5)]))
    got = inter_area_green(*[torch.from_numpy(a[:, i]) for i in range(5)],
                           *[torch.from_numpy(b[:, i]) for i in range(5)])
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
    if case == "degenerate":
        # identical boxes intersect fully; touching and zero-area give 0
        assert abs(float(got[0 * 12 + 1]) - 200.0) < 0.05
        assert float(got[2 * 12 + 7]) == 0.0
        assert float(got[9 * 12 + 10]) == 0.0


def test_skew_iou_matrix_green_matches_jax():
    rng = np.random.default_rng(2)
    a = _random_boxes(rng, 40, 60.0)
    want = np.asarray(jax_iou_matrix_green(jnp.asarray(a), jnp.asarray(a)))
    got = skew_iou_matrix_green(torch.from_numpy(a), torch.from_numpy(a))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.diag(got.numpy()), 1.0, atol=2e-3)


# --------------------------------------------------------------------------
# kernel B: kill mask
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", [64, 128])
@pytest.mark.parametrize("use_cls", [False, True])
def test_kill_matrix_matches_pallas(k, use_cls):
    """Plain version == Pallas kill kernel (interpret, algo "green") on every
    pair whose IoU lies more than 1e-4 from thr; near-threshold pairs may
    round either way in the divide-free predicate."""
    rng = np.random.default_rng(10 + k)
    thr = 0.4
    boxes = _random_boxes(rng, k, spread=60.0)
    boxes[-4:] = 0.0                               # zero-area padding rows
    boxes[5] = boxes[4]                            # an identical pair
    cls = rng.integers(0, 3, k).astype(np.int32)
    want = np.asarray(skew_kill_matrix_pallas(
        jnp.asarray(boxes), jnp.asarray(cls) if use_cls else None,
        iou_thr=thr, interpret=True, algo="green"))
    tcls = torch.from_numpy(cls)[None] if use_cls else None
    got = skew_kill_matrix(torch.from_numpy(boxes)[None], tcls, iou_thr=thr)
    assert got.dtype == torch.int8 and got.shape == (1, k, k)
    np.testing.assert_array_equal(
        got.numpy(),
        skew_kill_matrix_ref(torch.from_numpy(boxes)[None], tcls,
                             iou_thr=thr).numpy())
    iou = np.asarray(jax_iou_matrix_green(jnp.asarray(boxes),
                                          jnp.asarray(boxes)))
    far = np.abs(iou - thr) > 1e-4
    assert far.mean() >= 0.99
    np.testing.assert_array_equal(got.numpy()[0][far], want[far])
    assert want.sum() >= 1 and got.numpy().sum() >= 1
    # zero-area padding never kills and is never killed
    assert not got.numpy()[0][-4:].any() and not got.numpy()[0][:, -4:].any()


def test_kill_matrix_batched_equals_per_image():
    rng = np.random.default_rng(5)
    boxes = np.stack([_random_boxes(rng, 48, 50.0) for _ in range(3)])
    cls = rng.integers(0, 2, (3, 48)).astype(np.int32)
    batched = skew_kill_matrix(torch.from_numpy(boxes),
                               torch.from_numpy(cls), iou_thr=0.3)
    for i in range(3):
        single = skew_kill_matrix(torch.from_numpy(boxes[i:i + 1]),
                                  torch.from_numpy(cls[i:i + 1]), iou_thr=0.3)
        np.testing.assert_array_equal(batched[i].numpy(), single[0].numpy())


def test_kill_matrix_rejects_bad_inputs():
    with pytest.raises(TypeError):
        skew_kill_matrix(torch.zeros(1, 4, 5, dtype=torch.float64))
    with pytest.raises(ValueError):
        skew_kill_matrix(torch.zeros(4, 5))
    with pytest.raises(TypeError):
        skew_kill_matrix(torch.zeros(1, 4, 5),
                         torch.zeros(1, 4, dtype=torch.int64))


# --------------------------------------------------------------------------
# greedy fixpoint
# --------------------------------------------------------------------------

def _chain_kill(n):
    """A -> B -> C ... chain: each box overlaps its neighbour > thr."""
    boxes = np.zeros((n, 5), np.float32)
    for i in range(n):
        boxes[i] = (10.0 + 6.0 * i, 10.0, 12.0, 12.0, 0.0)
    return np.asarray(skew_kill_matrix_pallas(
        jnp.asarray(boxes), None, iou_thr=0.3, interpret=True)) != 0


@pytest.mark.parametrize("case", ["random", "chain"])
def test_fixpoint_bit_equal_to_jax(case):
    rng = np.random.default_rng(3)
    if case == "chain":
        kills = [_chain_kill(24), _chain_kill(24)]
        valids = [np.ones(24, bool), rng.uniform(size=24) < 0.8]
    else:
        kills, valids = [], []
        for _ in range(4):
            k = np.triu(rng.uniform(size=(40, 40)) < 0.08, 1)
            kills.append(k)
            valids.append(rng.uniform(size=40) < 0.9)
    kill_b = torch.from_numpy(np.stack(kills))
    valid_b = torch.from_numpy(np.stack(valids))
    got = greedy_suppress_fixpoint_kill(kill_b, valid_b).numpy()
    for i, (k, v) in enumerate(zip(kills, valids)):
        want = np.asarray(jax_fixpoint_kill(jnp.asarray(k), jnp.asarray(v)))
        np.testing.assert_array_equal(got[i], want)
    if case == "chain":
        # alternating keep is the greedy result of an unbroken chain
        np.testing.assert_array_equal(got[0], np.arange(24) % 2 == 0)


# --------------------------------------------------------------------------
# top-k
# --------------------------------------------------------------------------

def _assert_topk_equal(s, k):
    wv, wi = jax_strided_topk(jnp.asarray(s), k)
    gv, gi = strided_topk(torch.from_numpy(s), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    return set(gi.numpy().reshape(-1).tolist())


@pytest.mark.parametrize("n,k", [(131_072, 128), (24_576, 512), (5000, 64)])
def test_strided_topk_random_matches_jax(n, k):
    """N > 2*num_bins, so the strided path (bins, per-bin top-2, exact tail,
    clamp) runs."""
    rng = np.random.default_rng(0)
    s = (rng.permutation(n).astype(np.float32) / n)[None].repeat(2, 0)
    s[1, ::7] = 0.0                                # many tied zeros
    _assert_topk_equal(s, k)


def test_strided_topk_adjacency_cases_match_jax():
    n, k, na = 131_072, 128, 18
    nb = -(-max(512, 4 * k) // 128) * 128
    base = np.linspace(0.0, 0.1, n).astype(np.float32)
    for start in range(0, n - 2 * na, 26_111):     # adjacent cells
        s = base.copy()
        s[start], s[start + na] = 0.9, 0.8
        got = _assert_topk_equal(s[None], k)
        assert {start, start + na} <= got
    s = base.copy()                                # congruent pair (top-2)
    s[3 * nb + 7], s[4 * nb + 7] = 0.9, 0.8
    assert {3 * nb + 7, 4 * nb + 7} <= _assert_topk_equal(s[None], k)
    s = base.copy()                                # triple: documented drop
    hits = [2 * nb + 5, 5 * nb + 5, 9 * nb + 5]
    for h, val in zip(hits, (0.9, 0.8, 0.7)):
        s[h] = val
    got = _assert_topk_equal(s[None], k)
    assert hits[0] in got and hits[1] in got and hits[2] not in got


def test_exact_topk_ties_keep_lower_index():
    import jax

    s = np.array([[0.5, 0.9, 0.5, 0.0, 0.9, 0.0]], np.float32)
    v, i = select_topk(torch.from_numpy(s), 5, approx=False)
    assert i.tolist() == [[1, 4, 0, 2, 3]]
    wv, wi = jax.lax.top_k(jnp.asarray(s), 5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(v.numpy(), np.asarray(wv))


# --------------------------------------------------------------------------
# scores + gathered decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cfg,field_major", [
    ("cfg/yolov3-rotate-hrsc.cfg", True), ("cfg/yolov3-rotate-dota.cfg", True),
    ("cfg/yolov3-rotate-dota.cfg", False)])
def test_scores_and_gathered_decode_match_jax(cfg, field_major):
    from rotate_yolov3_tpu.config.parse import parse_model_cfg as jparse
    from rotate_yolov3_tpu.models.darknet import build_network as jbuild
    from rotate_yolov3_tpu.models import yolo_head as jyh
    from rotate_yolov3_tpu_torch.config.parse import parse_model_cfg
    from rotate_yolov3_tpu_torch.models import yolo_head as tyh
    from rotate_yolov3_tpu_torch.models.darknet import build_network

    path = os.path.join(ROOT, cfg)
    jspec = jbuild(jparse(path), img_size=64)
    tspec = build_network(parse_model_cfg(path), img_size=64)
    def fields(spec):
        return ([(type(l).__name__, dataclasses.asdict(l))
                 for l in spec.layers],
                spec.routs, spec.img_size, spec.channels, spec.hyp)

    assert fields(tspec) == fields(jspec)
    rng = np.random.default_rng(4)
    c = jspec.yolo_specs[0].na * jspec.yolo_specs[0].no
    heads = [rng.normal(size=(2, 64 // y.stride, 64 // y.stride, c))
             .astype(np.float32) for y in jspec.yolo_specs]
    n = sum(h.shape[1] * h.shape[2] for h in heads) * jspec.yolo_specs[0].na
    idx = rng.integers(0, n, (2, 40)).astype(np.int32)
    idx[0, :3] = [0, n - 1, n - 1]

    jh = [jnp.asarray(h) for h in heads]
    th = [torch.from_numpy(h) for h in heads]
    for jr, tr, js, ts in zip(jh, th, jspec.yolo_specs, tspec.yolo_specs):
        np.testing.assert_allclose(
            tyh.head_scores(tr, ts, field_major).numpy(),
            np.asarray(jyh.head_scores(jr, js, field_major)),
            rtol=1e-6, atol=1e-7)
    want = np.asarray(jyh.decode_gathered(jh, jspec.yolo_specs,
                                          jnp.asarray(idx), field_major))
    got = tyh.decode_gathered(th, tspec.yolo_specs, torch.from_numpy(idx),
                              field_major).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    if not field_major:
        np.testing.assert_allclose(
            tyh.decode_all(th, tspec.yolo_specs).numpy(),
            np.asarray(jyh.decode_all(jh, jspec.yolo_specs)),
            rtol=1e-6, atol=1e-5)


def test_scale_coords_rotated_matches_jax():
    from rotate_yolov3_tpu.ops.boxes import scale_coords_rotated as jscale
    from rotate_yolov3_tpu_torch.ops.boxes import scale_coords_rotated

    rng = np.random.default_rng(6)
    d = rng.uniform(0, 600, (9, 7)).astype(np.float32)
    want = np.asarray(jscale(jnp.asarray(d), 0.75, (12.0, 30.0)))
    got = scale_coords_rotated(torch.from_numpy(d), 0.75, (12.0, 30.0))
    np.testing.assert_array_equal(got.numpy(), want)


def test_unported_options_raise():
    """Every pair algo option is ported: an unknown algo name raises
    ValueError on each entry that takes one."""
    from rotate_yolov3_tpu_torch.ops.rotated_nms import non_max_suppression
    from rotate_yolov3_tpu_torch.ops.skew_iou_cuda import skew_iou_matrix

    heads = [torch.zeros(1, 2, 2, 126)]

    class _Spec:
        na, no, num_classes, stride = 18, 7, 1, 32
        anchors_wh, anchor_angles = ((10.0, 20.0),) * 3, (0.0,) * 6

    for kw in ({"iou_algo": "green3"}, {"iou_algo": "candidates ",
                                        "decode_kernel": True}):
        with pytest.raises(ValueError, match="algo"):
            non_max_suppression_fused(heads, [_Spec()], **kw)
    with pytest.raises(ValueError, match="algo"):
        non_max_suppression(torch.zeros(1, 4, 7), iou_algo="Green")
    with pytest.raises(ValueError, match="algo"):
        skew_kill_matrix(torch.zeros(1, 4, 5), algo="argsort")
    with pytest.raises(ValueError, match="algo"):
        skew_iou_matrix(torch.zeros(4, 5), torch.zeros(4, 5), algo="")
    # the ported options run
    for kw in ({"decode_kernel": True}, {"iou_algo": "green2"},
               {"iou_matrix_fn": lambda a, b: a[:, :1] * b[:, 0]}):
        dets, keep = non_max_suppression_fused(heads, [_Spec()], **kw)
        assert dets.shape == (1, 512, 7) and keep.shape == (1, 512)


def test_nms_greedy_refuses_unported_algo_and_large_k():
    from rotate_yolov3_tpu_torch.ops.nms_greedy import (nms_greedy,
                                                        nms_greedy_fused_ok)

    valid = torch.ones(1, 8, dtype=torch.bool)
    with pytest.raises(ValueError, match="algo"):
        nms_greedy(torch.zeros(1, 8, 5), None, valid, algo="green3")
    for algo in ("green2", "candidates"):
        assert torch.equal(nms_greedy(torch.zeros(1, 8, 5), None, valid,
                                      algo=algo), valid)
    assert nms_greedy_fused_ok(1024) and not nms_greedy_fused_ok(1025)
    with pytest.raises(ValueError, match="1024"):
        nms_greedy(torch.zeros(1, 1025, 5), None,
                   torch.ones(1, 1025, dtype=torch.bool))
    with pytest.raises(ValueError, match="mask_dtype"):
        nms_greedy(torch.zeros(1, 8, 5), None, valid, mask_dtype="int8")
    with pytest.raises(ValueError, match="valid"):
        nms_greedy(torch.zeros(1, 8, 5), None, valid.int())


def test_import_hygiene():
    """The port imports neither jax, nor triton, nor the JAX package."""
    code = ("import sys, rotate_yolov3_tpu_torch, "
            "rotate_yolov3_tpu_torch.detector, rotate_yolov3_tpu_torch.detect,"
            " rotate_yolov3_tpu_torch.dota, "
            "rotate_yolov3_tpu_torch.data.dota.device_tiles, "
            "rotate_yolov3_tpu_torch.data.dota.evaluation, "
            "rotate_yolov3_tpu_torch.data.dota.result_merge, "
            "rotate_yolov3_tpu_torch.ops.nms_greedy, "
            "rotate_yolov3_tpu_torch.ops.rotated_nms, "
            "rotate_yolov3_tpu_torch.ops.skew_iou, "
            "rotate_yolov3_tpu_torch.ops.skew_iou_cuda, "
            "rotate_yolov3_tpu_torch.ops.decode_rows;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'triton', 'rotate_yolov3_tpu')];"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
