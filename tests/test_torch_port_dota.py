"""The PyTorch port's DOTA slice against the JAX package on the CPU.

Covers the on-device tile pipeline (``data.dota.device_tiles``) with its
letterbox (``letterbox_torch``) and the fused greedy NMS (kernel C,
``ops.nms_greedy``, its plain version on the CPU), the ``fused_greedy``
option of ``non_max_suppression_fused``, the host DOTA tool chain
(``img_split``, ``formats``, ``result_merge``, ``evaluation``,
``native.polyiou``) and ``python -m rotate_yolov3_tpu_torch.dota``.

Both packages see the same numpy-seeded inputs; both detectors load the same
``.weights`` bytes written by the JAX package. Where the JAX side reaches a
Pallas kernel it runs in interpret mode. Tolerances: letterboxed pixels
atol 1e-4 on 0-255 values (the two resize implementations sum in different
orders); detection boxes and scores 1e-3 (f32 conv stacks of the two
frameworks drift in the last bits, as in test_torch_port_detector.py);
keep masks, classes and top-k indices exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rotate_yolov3_tpu.config.parse import parse_model_cfg as jparse
from rotate_yolov3_tpu.data.dota import device_tiles as jdt
from rotate_yolov3_tpu.data.dota import evaluation as jeval
from rotate_yolov3_tpu.data.dota import formats as jfmt
from rotate_yolov3_tpu.data.dota import img_split as jsplit
from rotate_yolov3_tpu.data.dota import result_merge as jmerge
from rotate_yolov3_tpu.data.letterbox import letterbox_jax
from rotate_yolov3_tpu.detector import Detector as JaxDetector
from rotate_yolov3_tpu.models.darknet import build_network as jbuild
from rotate_yolov3_tpu.models.darknet import init_params as jinit
from rotate_yolov3_tpu.models.weights_io import save_darknet_weights
from rotate_yolov3_tpu.ops.boxes import scale_coords_rotated as jscale
from rotate_yolov3_tpu.ops.nms_pallas import nms_greedy_pallas
from rotate_yolov3_tpu.ops.rotated_nms import \
    greedy_suppress_fixpoint_kill as jax_fixpoint_kill
from rotate_yolov3_tpu.ops.skew_iou_green import skew_iou_matrix_green
from rotate_yolov3_tpu.ops.skew_iou_pallas import skew_kill_matrix_pallas
from rotate_yolov3_tpu_torch import _build
from rotate_yolov3_tpu_torch.data.dota import device_tiles as tdt
from rotate_yolov3_tpu_torch.data.dota import evaluation as teval
from rotate_yolov3_tpu_torch.data.dota import formats as tfmt
from rotate_yolov3_tpu_torch.data.dota import img_split as tsplit
from rotate_yolov3_tpu_torch.data.dota import result_merge as tmerge
from rotate_yolov3_tpu_torch.data.letterbox import letterbox_torch
from rotate_yolov3_tpu_torch.detector import Detector
from rotate_yolov3_tpu_torch.ops.nms_greedy import nms_greedy, nms_greedy_ref
from rotate_yolov3_tpu_torch.ops.rotated_nms import non_max_suppression_fused
from rotate_yolov3_tpu_torch.ops.skew_iou_green import \
    skew_iou_matrix_green as t_iou_green

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOTA_CFG = os.path.join(ROOT, "cfg/yolov3-rotate-dota.cfg")
TINY_CFG = os.path.join(ROOT, "cfg/yolov3-tiny-rotate-hrsc.cfg")
IMG, SUB, GAP, MAX_DET, MERGE_THR = 96, 256, 64, 32, 0.3


def _scene(h, w, seed=0):
    """Bright rotated rectangles on a dark background (cv2-drawn)."""
    import cv2

    rng = np.random.default_rng(seed)
    img = rng.integers(20, 60, (h, w, 3)).astype(np.uint8)
    for _ in range(12):
        cx, cy = rng.uniform(40, w - 40), rng.uniform(40, h - 40)
        pts = cv2.boxPoints(((cx, cy), (rng.uniform(40, 120),
                                        rng.uniform(20, 60)),
                             rng.uniform(-90, 90))).astype(np.int32)
        cv2.fillPoly(img, [pts], (230, 230, 230))
    return img


# --------------------------------------------------------------------------
# letterbox and tile grid
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape,size", [
    ((2, 256, 256, 3), 96),       # downsample, square
    ((1, 384, 300, 3), 128),      # downsample, padded columns
    ((2, 100, 70, 3), 128),       # upsample, padded columns
])
def test_letterbox_torch_matches_jax(shape, size):
    x = np.random.default_rng(0).uniform(0, 255, shape).astype(np.float32)
    want, wratio, wpad = letterbox_jax(jnp.asarray(x), size)
    got, ratio, pad = letterbox_torch(torch.from_numpy(x), size)
    assert ratio == wratio and tuple(pad) == tuple(wpad)
    assert got.shape == (shape[0], size, size, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    # uint8 input: the values of its float copy, bit for bit
    x8 = x.astype(np.uint8)
    got8 = letterbox_torch(torch.from_numpy(x8), size)[0]
    assert got8.dtype == torch.float32
    assert torch.equal(got8,
                       letterbox_torch(torch.from_numpy(x8).float(), size)[0])


def test_tile_grid_matches_jax():
    for sub, gap in ((1024, 200), (256, 64)):
        port = tdt.DeviceTilePipeline(None, subsize=sub, gap=gap)
        ref = jdt.DeviceTilePipeline(None, subsize=sub, gap=gap)
        for h, w in ((4000, 4000), (100, 100), (700, 900), (1025, 3000),
                     (400, 520)):
            assert port.bucket_shape(h, w) == ref.bucket_shape(h, w)
            assert port.num_tiles(h, w) == ref.num_tiles(h, w)
            hp, wp = port.bucket_shape(h, w)
            assert tsplit.tile_origins(wp, hp, sub, gap) == \
                jsplit.tile_origins(wp, hp, sub, gap)
    assert tdt.DeviceTilePipeline(None).num_tiles(4000, 4000) == 25


# --------------------------------------------------------------------------
# kernel C: fused greedy NMS (plain version on the CPU)
# --------------------------------------------------------------------------

def _nms_case(case):
    """(boxes (B, K, 5), cls (B, K) int32 or None, valid (B, K), thr)."""
    rng = np.random.default_rng({"random": 1, "classes": 2, "chain": 3,
                                 "invalid": 4, "k1024": 5}[case])

    def boxes(b, k, spread, wh=(5, 40)):
        return np.stack([rng.uniform(0, spread, (b, k)),
                         rng.uniform(0, spread, (b, k)),
                         rng.uniform(*wh, (b, k)), rng.uniform(*wh, (b, k)),
                         rng.uniform(-np.pi, np.pi, (b, k))],
                        axis=-1).astype(np.float32)

    if case == "random":
        b = boxes(2, 130, 120.0)
        valid = rng.uniform(size=(2, 130)) > 0.1
        return np.where(valid[..., None], b, 0), None, valid, 0.4
    if case == "classes":
        b = boxes(2, 64, 40.0)
        return b, rng.integers(0, 3, (2, 64)).astype(np.int32), \
            np.ones((2, 64), bool), 0.3
    if case == "chain":
        # each box overlaps its neighbour above thr, the next but one below
        b = np.zeros((1, 24, 5), np.float32)
        b[0, :, 0] = 10.0 + 6.0 * np.arange(24)
        b[0, :, 1:4] = (10.0, 12.0, 12.0)
        return b, None, np.ones((1, 24), bool), 0.3
    if case == "invalid":
        return boxes(2, 40, 60.0), None, np.zeros((2, 40), bool), 0.4
    b = boxes(1, 1024, 600.0, (10, 60))
    valid = rng.uniform(size=(1, 1024)) > 0.05
    return np.where(valid[..., None], b, 0), \
        rng.integers(0, 15, (1, 1024)).astype(np.int32), valid, 0.3


@pytest.mark.parametrize("case", ["random", "classes", "chain", "invalid",
                                  "k1024"])
def test_nms_greedy_matches_pallas(case):
    """nms_greedy (plain version) == nms_greedy_pallas (interpret) and ==
    the JAX kill kernel + fixpoint, keep for keep."""
    boxes, cls, valid, thr = _nms_case(case)
    jcls = None if cls is None else jnp.asarray(cls)
    want = np.asarray(nms_greedy_pallas(jnp.asarray(boxes), jcls,
                                        jnp.asarray(valid), iou_thr=thr,
                                        interpret=True))
    tcls = None if cls is None else torch.from_numpy(cls)
    got = nms_greedy(torch.from_numpy(boxes), tcls, torch.from_numpy(valid),
                     iou_thr=thr)
    assert got.dtype == torch.bool and got.shape == valid.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if case in ("classes", "chain"):
        kill = skew_kill_matrix_pallas(
            jnp.asarray(boxes[0]), None if cls is None
            else jnp.asarray(cls[0]), iou_thr=thr, interpret=True)
        np.testing.assert_array_equal(
            got[0].numpy(),
            np.asarray(jax_fixpoint_kill(kill != 0, jnp.asarray(valid[0]))))
    if case == "chain":
        np.testing.assert_array_equal(got[0].numpy(), np.arange(24) % 2 == 0)
    if case == "invalid":
        assert not got.any()
    if case in ("random", "k1024"):
        assert 0 < int(got.sum()) < int(valid.sum())


def test_nms_greedy_mask_dtype_and_batching():
    """bf16 mask_dtype gives the same keep; a batch equals its images one
    by one."""
    boxes, cls, valid, thr = _nms_case("random")
    tb, tv = torch.from_numpy(boxes), torch.from_numpy(valid)
    f32 = nms_greedy(tb, None, tv, iou_thr=thr)
    assert torch.equal(f32, nms_greedy(tb, None, tv, iou_thr=thr,
                                       mask_dtype="bfloat16"))
    for i in range(len(boxes)):
        assert torch.equal(f32[i:i + 1],
                           nms_greedy_ref(tb[i:i + 1], None, tv[i:i + 1],
                                          thr))


def _random_heads(specs, img, b, seed):
    rng = np.random.default_rng(seed)
    c = specs[0].na * specs[0].no
    return [torch.from_numpy(rng.normal(0, 2.0, (b, img // y.stride,
                                                 img // y.stride, c))
                             .astype(np.float32)) for y in specs]


@pytest.mark.parametrize("max_det", [128, 1100])
def test_fused_greedy_equals_default(max_det):
    """``fused_greedy=True`` (kernel C for K <= 1024, two-stage past it)
    returns the default path's detections and keep exactly."""
    from rotate_yolov3_tpu_torch.config.parse import parse_model_cfg
    from rotate_yolov3_tpu_torch.models.darknet import build_network

    specs = build_network(parse_model_cfg(DOTA_CFG), img_size=64).yolo_specs
    heads = _random_heads(specs, 64, 2 if max_det <= 1024 else 1, seed=9)
    kw = dict(conf_thres=0.05, nms_thres=0.4, max_det=max_det,
              approx_top_k=False, field_major=True)
    base = non_max_suppression_fused(heads, specs, **kw)
    for mask_dtype in ("float32", "bfloat16"):
        fused = non_max_suppression_fused(heads, specs, fused_greedy=True,
                                          mask_dtype=mask_dtype, **kw)
        assert torch.equal(fused[1], base[1])
        assert torch.equal(fused[0], base[0])
    kept = base[1].sum(-1)
    assert bool((kept > 0).all()) and bool((kept < max_det).all())


# --------------------------------------------------------------------------
# the tile pipeline against the JAX package
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dota_pair(tmp_path_factory):
    """Port and JAX detectors (DOTA cfg, nc = 15, at 96 px) on the same
    .weights, with a conf threshold that passes ~60 candidates of the test
    scene in all, with a margin from its neighbours."""
    wpath = str(tmp_path_factory.mktemp("dota") / "dota.weights")
    spec = jbuild(jparse(DOTA_CFG), img_size=IMG)
    params, state = jinit(spec, jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    state = {k: {"bn_mean": jnp.asarray(rng.normal(0, 0.05, v["bn_mean"].shape)
                                        .astype(np.float32)),
                 "bn_var": jnp.asarray(rng.uniform(0.8, 1.2, v["bn_var"].shape)
                                       .astype(np.float32))}
             for k, v in state.items()}
    save_darknet_weights(spec, params, state, wpath)

    img = _scene(400, 520)
    port = Detector(DOTA_CFG, weights=wpath, img_size=IMG, max_det=MAX_DET,
                    approx_top_k=False, device="cpu")
    pipe = tdt.DeviceTilePipeline(port, subsize=SUB, gap=GAP,
                                  merge_nms_thres=MERGE_THR, max_merged=256)
    lb = pipe.letterbox_tiles(pipe.upload(img))[0]
    raw = port.predict_raw(lb).numpy()
    score = raw[..., 5] * raw[..., 6:].max(-1)
    srt = np.sort(score.reshape(-1))[::-1]
    conf = float(0.5 * (srt[59] + srt[60]))
    assert srt[59] - srt[60] > 1e-4
    assert (score > conf).sum(axis=1).max() <= MAX_DET
    port.conf_thres = conf
    jdet = JaxDetector(DOTA_CFG, weights=wpath, img_size=IMG,
                       conf_thres=conf, max_det=MAX_DET,
                       iou_matrix_fn=skew_iou_matrix_green,
                       approx_top_k=False, bake_params=False)
    return port, jdet, pipe, img


def test_device_tiles_match_jax_tpu_branch(dota_pair):
    """The port's pipeline, stage by stage, against the JAX reference's TPU
    branch composed from JAX functions: letterbox_jax -> infer_fn ->
    re-map -> lax.top_k -> nms_greedy_pallas (interpret)."""
    port, jdet, pipe, img = dota_pair
    assert pipe.num_tiles(*img.shape[:2]) == 6
    bucket = pipe.upload(img)
    lb, ratio, pad, org = pipe.letterbox_tiles(bucket)
    dets, mask = port(lb)
    rows, valid, top_i = pipe.select(dets, mask, ratio, pad, org)
    out, keep = pipe.merge_nms(rows, valid)
    m = rows.shape[0]
    assert m == 6 * MAX_DET and out.shape == (256, 7)

    hp, wp = bucket.shape[:2]
    origins = jsplit.tile_origins(wp, hp, SUB, GAP)
    tiles = np.stack([bucket.numpy()[y:y + SUB, x:x + SUB]
                      for (x, y) in origins])
    jlb, jratio, jpad = letterbox_jax(jnp.asarray(tiles, jnp.float32), IMG)
    assert (jratio, tuple(jpad)) == (ratio, tuple(pad))
    np.testing.assert_allclose(lb.numpy(), np.asarray(jlb), rtol=0,
                               atol=1e-4)
    jdets, jmask = jax.jit(jdet.infer_fn)(jdet.fused_params, jlb)
    jdets = jscale(jdets, jratio, jpad)
    jorg = jnp.asarray(origins, jnp.float32)
    jdets = jdets.at[..., 0].add(jorg[:, 0, None]).at[..., 1].add(
        jorg[:, 1, None])
    scores = jnp.where(jmask, jdets[..., 5], 0.0).reshape(-1)
    top_s, jtop_i = jax.lax.top_k(scores, m)
    jrows = jdets.reshape(-1, 7)[jtop_i]
    jvalid = top_s > 0.0
    jboxes = jnp.where(jvalid[:, None], jrows[:, :5], 0.0)
    jkeep = nms_greedy_pallas(jboxes[None],
                              jrows[:, 6].astype(jnp.int32)[None],
                              jvalid[None], iou_thr=MERGE_THR,
                              interpret=True)[0]

    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(jtop_i))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(rows[:, 6].numpy(),
                                  np.asarray(jrows[:, 6]))
    np.testing.assert_allclose(rows[:, :6].numpy(), np.asarray(jrows[:, :6]),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(keep[:m].numpy(), np.asarray(jkeep))
    assert 10 <= int(keep.sum()) < int(valid.sum())    # the merge suppressed
    assert not keep[m:].any() and not out[m:].any()
    # the whole call gives the same as its stages
    full, full_keep = pipe(img)
    np.testing.assert_array_equal(full_keep, keep.numpy())
    np.testing.assert_array_equal(full, out.numpy())


def test_device_tiles_match_jax_pipeline(dota_pair):
    """The port's pipeline against the JAX DeviceTilePipeline as it stands.
    Its CPU merge thresholds the argsort skew-IoU matrix (IoU > thr), which
    can differ from the divide-free kill predicate only for pairs within FP
    rounding of thr: no merge pair may lie within 1e-4 of it."""
    port, jdet, pipe, img = dota_pair
    dets, keep = pipe(img)
    jdets, jkeep = jdt.DeviceTilePipeline(
        jdet, subsize=SUB, gap=GAP, merge_nms_thres=MERGE_THR,
        max_merged=256)(img)

    lb, ratio, pad, org = pipe.letterbox_tiles(pipe.upload(img))
    rows, valid, _ = pipe.select(*port(lb), ratio, pad, org)
    boxes = rows[valid][:, :5]
    iou = t_iou_green(boxes, boxes).numpy()
    same = (rows[valid][:, 6, None] == rows[valid][None, :, 6]).numpy()
    live = same & np.triu(np.ones_like(same), 1)
    assert live.sum() > 0
    assert np.abs(iou[live] - MERGE_THR).min() > 1e-4

    np.testing.assert_array_equal(keep, jkeep)
    assert keep.sum() >= 10
    np.testing.assert_array_equal(dets[:, 6], jdets[:, 6])
    np.testing.assert_allclose(dets, jdets, rtol=1e-3, atol=1e-3)


# --------------------------------------------------------------------------
# host DOTA tool chain
# --------------------------------------------------------------------------

NAMES = ["plane", "ship", "small-vehicle"]


def _tile_dets(rng):
    """Per-tile detections of two source images under devkit tile names,
    with overlaps across tiles so the merge suppresses."""
    out = {}
    for base in ("P0001", "P0002"):
        for x0, y0 in ((0, 0), (192, 0), (0, 192)):
            n = int(rng.integers(0, 9))
            d = np.stack([rng.uniform(150, 256, n), rng.uniform(150, 256, n),
                          rng.uniform(10, 60, n), rng.uniform(10, 60, n),
                          rng.uniform(-1.5, 1.5, n), rng.uniform(0.1, 1, n),
                          rng.integers(0, 3, n)], axis=1).astype(np.float32)
            out[jsplit.tile_name(base, x0, y0)] = d
    return out


def test_result_merge_and_task1_files_match_jax(tmp_path):
    tile_dets = _tile_dets(np.random.default_rng(8))
    want = jmerge.merge_tile_detections(tile_dets, nms_thres=0.3)
    got = tmerge.merge_tile_detections(tile_dets, nms_thres=0.3)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert sum(len(v) for v in got.values()) < \
        sum(len(v) for v in tile_dets.values())
    jmerge.write_task1_results(want, NAMES, str(tmp_path / "jax"))
    tmerge.write_task1_results(got, NAMES, str(tmp_path / "port"))
    for name in NAMES:
        a = (tmp_path / "jax" / f"Task1_{name}.txt").read_bytes()
        assert (tmp_path / "port" / f"Task1_{name}.txt").read_bytes() == a


def test_formats_and_split_match_jax(tmp_path):
    rng = np.random.default_rng(12)
    objs = []
    for i in range(6):
        poly = jfmt.rbox_to_poly(rng.uniform(20, 380), rng.uniform(20, 280),
                                 rng.uniform(10, 80), rng.uniform(10, 40),
                                 rng.uniform(-1.5, 1.5))
        objs.append({"poly": poly, "name": NAMES[i % 3],
                     "difficult": int(i == 4)})
    for mod in (jfmt, tfmt):
        mod.write_dota_annotation(str(tmp_path / f"{mod.__name__}.txt"),
                                  objs)
    paths = [tmp_path / f"{m.__name__}.txt" for m in (jfmt, tfmt)]
    assert paths[0].read_bytes() == paths[1].read_bytes()
    jobjs = jfmt.parse_dota_annotation(str(paths[0]))
    tobjs = tfmt.parse_dota_annotation(str(paths[0]))
    assert [(o["name"], o["difficult"]) for o in tobjs] == \
        [(o["name"], o["difficult"]) for o in jobjs]
    for a, b in zip(tobjs, jobjs):
        np.testing.assert_array_equal(a["poly"], b["poly"])
        assert tfmt.poly_to_rbox(a["poly"]) == jfmt.poly_to_rbox(b["poly"])
    np.testing.assert_array_equal(
        tfmt.objs_to_labels(tobjs, NAMES, 400, 300, skip_difficult=True),
        jfmt.objs_to_labels(jobjs, NAMES, 400, 300, skip_difficult=True))
    img = _scene(300, 400, seed=2)
    want = jsplit.split_image(img, jobjs, subsize=256, gap=64)
    got = tsplit.split_image(img, tobjs, subsize=256, gap=64)
    assert [o for o, _, _ in got] == [o for o, _, _ in want]
    for (_, gt, gobjs), (_, wt, wobjs) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        assert [(o["name"], o["difficult"]) for o in gobjs] == \
            [(o["name"], o["difficult"]) for o in wobjs]
    name = tsplit.tile_name("P0003", 192, 64)
    assert name == jsplit.tile_name("P0003", 192, 64)
    assert tsplit.parse_tile_name(name) == jsplit.parse_tile_name(name)


def test_task1_evaluation_matches_jax(tmp_path):
    rng = np.random.default_rng(21)
    gt_dir, det_dir = tmp_path / "gt", tmp_path / "det"
    gt_dir.mkdir()
    merged = {}
    for base in ("P0001", "P0002", "P0003"):
        rows, objs = [], []
        for i in range(7):
            box = (rng.uniform(50, 400), rng.uniform(50, 400),
                   rng.uniform(20, 80), rng.uniform(10, 40),
                   rng.uniform(-1.5, 1.5))
            c = int(rng.integers(0, 3))
            objs.append({"poly": jfmt.rbox_to_poly(*box), "name": NAMES[c],
                         "difficult": int(i == 6)})
            if i % 3:       # a jittered hit; every third object missed
                rows.append([box[0] + rng.normal(0, 3), box[1], box[2],
                             box[3], box[4], rng.uniform(0.2, 1), c])
        rows.append([10, 10, 5, 5, 0, 0.9, 0])    # a false positive
        jfmt.write_dota_annotation(str(gt_dir / f"{base}.txt"), objs)
        merged[base] = np.asarray(rows, np.float32)
    tmerge.write_task1_results(merged, NAMES, str(det_dir))
    for method in ("11point", "continuous"):
        want = jeval.evaluate_task1(str(det_dir), str(gt_dir), NAMES,
                                    method=method)
        got = teval.evaluate_task1(str(det_dir), str(gt_dir), NAMES,
                                   method=method)
        assert got == want
        assert 0.0 < got["map"] < 1.0
    dets = teval.load_task1_detections(str(det_dir / "Task1_ship.txt"))
    assert dets.keys() == jeval.load_task1_detections(
        str(det_dir / "Task1_ship.txt")).keys()


def test_dota_cli_on_cpu(tmp_path):
    """``python -m rotate_yolov3_tpu_torch.dota`` on the CPU: detect
    --source writes Task-1 files; split, detect --tiles, merge and eval run
    the host chain."""
    import cv2

    from rotate_yolov3_tpu_torch.dota import main

    src, labels = tmp_path / "src", tmp_path / "labels"
    src.mkdir()
    labels.mkdir()
    for i, (h, w) in enumerate(((200, 260), (150, 150))):
        cv2.imwrite(str(src / f"P{i}.png"), _scene(h, w, seed=i))
        tfmt.write_dota_annotation(str(labels / f"P{i}.txt"), [
            {"poly": tfmt.rbox_to_poly(70, 60, 50, 20, 0.3), "name": "0"}])
    names = tmp_path / "one.names"
    names.write_text("0\n")
    common = ["--cfg", TINY_CFG, "--img-size", "64", "--conf-thres", "0.0",
              "--max-det", "16", "--device", "cpu"]
    main(["detect", "--source", str(src), "--out", str(tmp_path / "task1"),
          "--subsize", "128", "--gap", "32", "--names", str(names),
          *common])
    lines = (tmp_path / "task1" / "Task1_0.txt").read_text().splitlines()
    assert {ln.split()[0] for ln in lines} == {"P0", "P1"}
    assert all(len(ln.split()) == 10 for ln in lines)

    main(["split", "--images", str(src), "--labels", str(labels),
          "--out", str(tmp_path / "split"), "--subsize", "128", "--gap",
          "32"])
    main(["detect", "--tiles", str(tmp_path / "split" / "images"),
          "--out", str(tmp_path / "tiles"), "--batch-size", "4", *common])
    main(["merge", "--dets", str(tmp_path / "tiles"), "--out",
          str(tmp_path / "merged"), "--names", str(names)])
    assert (tmp_path / "merged" / "Task1_0.txt").stat().st_size > 0
    main(["eval", "--dets", str(tmp_path / "merged"), "--gt", str(labels),
          "--names", str(names), "--json", str(tmp_path / "ap.json")])
    assert (tmp_path / "ap.json").exists()


# --------------------------------------------------------------------------
# kernel build: a header edit must rebuild
# --------------------------------------------------------------------------

def test_build_digest_covers_headers(tmp_path):
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    names = _build.kernel_names()
    assert {"gather_rows", "skew_kill", "nms_greedy"} <= set(names)
    before = {n: _build.digest(n, csrc) for n in names}
    assert before == {n: _build.digest(n) for n in names}
    header = csrc / "skew_green.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.digest(n, csrc) for n in names}
    assert all(after[n] != before[n] for n in names)
    src = csrc / "nms_greedy.cu"
    src.write_text(src.read_text() + "\n")
    assert _build.digest("nms_greedy", csrc) != after["nms_greedy"]
    assert _build.digest("skew_kill", csrc) == after["skew_kill"]
