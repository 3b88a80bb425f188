"""The port's last modules against the JAX package on the CPU: the
per-head decode for heads of different na, the profiling, device and
plotting utilities, ``count_params`` / ``num_predictions``, the quad IoU
and ``skew_iou_loss``, the host ``iou_poly`` / ``rotated_nms`` bindings,
and the ``kmeans_anchors`` and ``verify_reference`` tools.

The mixed-na cfg is ``cfg/yolov3-tiny-rotate-hrsc.cfg`` with its first
[yolo] masked to two anchors (``mask = 3,4``, head conv ``filters=84``), so
its heads have na = 12 and 18; it is written into each test's ``tmp_path``.

Tolerances: ``decode_gathered`` rtol 1e-6 + atol 1e-5 (the uniform-na
decode test's); detections 1e-3 and scores 1e-4 with masks exact (the
Detector slice test's); one train step: loss terms rtol 1e-4, grad norm
rtol 3e-3; IoU and its gradient 1e-5 (the argsort tests'); the host
bindings, the anchor tool and the integers exact.
"""

import io
import math
import os
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rotate_yolov3_tpu.config.hyp import Hyp as JHyp
from rotate_yolov3_tpu.config.parse import parse_model_cfg as jparse
from rotate_yolov3_tpu.detector import Detector as JaxDetector
from rotate_yolov3_tpu.models import weights_io as jwio
from rotate_yolov3_tpu.models import yolo_head as jyh
from rotate_yolov3_tpu.models.darknet import build_network as jbuild
from rotate_yolov3_tpu.models.darknet import count_params as jcount_params
from rotate_yolov3_tpu.models.darknet import init_params as jinit
from rotate_yolov3_tpu.native import polyiou_native as jnative
from rotate_yolov3_tpu.ops import skew_iou as jsi
from rotate_yolov3_tpu.ops.skew_iou_green import skew_iou_matrix_green
from rotate_yolov3_tpu.train import schedule as jsched
from rotate_yolov3_tpu.train.trainer import (init_train_state as jinit_ts,
                                             make_optimizer as jmake_opt,
                                             make_train_step as jmake_step)
from rotate_yolov3_tpu.utils import profiling as jprof
from rotate_yolov3_tpu_torch import train as train_pkg
from rotate_yolov3_tpu_torch.config.hyp import Hyp
from rotate_yolov3_tpu_torch.config.parse import parse_model_cfg
from rotate_yolov3_tpu_torch.data.synthetic import make_synthetic_dataset
from rotate_yolov3_tpu_torch.detector import Detector
from rotate_yolov3_tpu_torch.models import weights_io as wio
from rotate_yolov3_tpu_torch.models import yolo_head as tyh
from rotate_yolov3_tpu_torch.models.darknet import (build_network,
                                                    count_params,
                                                    init_params)
from rotate_yolov3_tpu_torch.native import polyiou as native
from rotate_yolov3_tpu_torch.ops import skew_iou as si
from rotate_yolov3_tpu_torch.ops.boxes import rbox_corners
from rotate_yolov3_tpu_torch.ops.rotated_nms import non_max_suppression_fused
from rotate_yolov3_tpu_torch.tools import kmeans_anchors as kmeans
from rotate_yolov3_tpu_torch.tools import verify_reference
from rotate_yolov3_tpu_torch.train import schedule as sched
from rotate_yolov3_tpu_torch.train.trainer import (init_train_state,
                                                   make_train_step)
from rotate_yolov3_tpu_torch.utils import device as udevice
from rotate_yolov3_tpu_torch.utils import plotting
from rotate_yolov3_tpu_torch.utils import profiling as prof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_HRSC = os.path.join(ROOT, "cfg/yolov3-tiny-rotate-hrsc.cfg")
CFGS = ("yolov3-rotate-hrsc.cfg", "yolov3-rotate-dota.cfg",
        "yolov3-rotate-tiny.cfg", "yolov3-tiny-rotate-hrsc.cfg")
IMG = 64


def _mixed_cfg(tmp_path) -> str:
    """The tiny HRSC cfg with its first [yolo] masked to anchors 3, 4 (na
    12 and 18 across the two heads)."""
    lines = open(TINY_HRSC).read().split("\n")
    y = lines.index("[yolo]")
    f = max(i for i in range(y) if lines[i].startswith("filters="))
    m = next(i for i in range(y, len(lines)) if lines[i].startswith("mask"))
    lines[f], lines[m] = "filters=84", "mask = 3,4"
    path = str(tmp_path / "mixed.cfg")
    with open(path, "w") as fh:
        fh.write("\n".join(lines))
    return path


def _specs(cfg, img=IMG):
    return jbuild(jparse(cfg), img_size=img), \
        build_network(parse_model_cfg(cfg), img_size=img)


def _jax_weights(jspec, seed=0):
    """Seeded JAX params with non-trivial BN parameters and state, as
    numpy trees."""
    params, state = jinit(jspec, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, params)
    for p in params.values():
        if "bn_scale" in p:
            p["bn_scale"] = rng.uniform(0.8, 1.2, p["bn_scale"].shape
                                        ).astype(np.float32)
            p["bn_bias"] = rng.normal(0, 0.05, p["bn_bias"].shape
                                      ).astype(np.float32)
    state = {k: {"bn_mean": rng.normal(0, 0.05, v["bn_mean"].shape
                                       ).astype(np.float32),
                 "bn_var": rng.uniform(0.8, 1.2, v["bn_var"].shape
                                       ).astype(np.float32)}
             for k, v in state.items()}
    return params, state


# ------------------------------ per-head decode -----------------------------

@pytest.mark.parametrize("field_major", [False, True])
def test_decode_gathered_perhead_matches_jax(tmp_path, field_major):
    """Heads of na 12 and 18: indices at each head's first and last row,
    one past the end and negative."""
    jspec, spec = _specs(_mixed_cfg(tmp_path))
    assert [s.na for s in spec.yolo_specs] == [12, 18]
    rng = np.random.default_rng(4)
    heads = [rng.normal(0, 2, (2, IMG // s.stride, IMG // s.stride,
                               s.na * s.no)).astype(np.float32)
             for s in spec.yolo_specs]
    sizes = [h.shape[1] * h.shape[2] * s.na
             for h, s in zip(heads, spec.yolo_specs)]
    n = sum(sizes)
    idx = np.array([[0, 1, sizes[0] - 1, sizes[0], n - 1, n, -1, 37],
                    [sizes[0] + 17, n - 2, n + 5, -7, 3, 100, sizes[0] - 2,
                     sizes[0] + 1]], np.int32)
    want = np.asarray(jyh.decode_gathered(
        [jnp.asarray(h) for h in heads], jspec.yolo_specs, jnp.asarray(idx),
        field_major))
    got = tyh.decode_gathered([torch.from_numpy(h) for h in heads],
                              spec.yolo_specs, torch.from_numpy(idx),
                              field_major).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    # a row in no head decodes all-zero raw values: empty box, scores 0.5
    np.testing.assert_array_equal(got[0, 5:7], [[0] * 5 + [0.5] * 2] * 2)


def test_mixed_na_detector_matches_jax(tmp_path):
    cfg = _mixed_cfg(tmp_path)
    jspec, _ = _specs(cfg)
    wpath = str(tmp_path / "mixed.weights")
    jwio.save_darknet_weights(jspec, *_jax_weights(jspec, seed=1), wpath)
    kw = dict(weights=wpath, img_size=IMG, conf_thres=1e-4, max_det=32)
    port = Detector(cfg, device="cpu", **kw)
    jdet = JaxDetector(cfg, approx_top_k=False, bake_params=False,
                       iou_matrix_fn=skew_iou_matrix_green, **kw)
    imgs = np.random.default_rng(0).integers(0, 256, (2, IMG, IMG, 3),
                                             dtype=np.uint8)
    dets, mask = (t.numpy() for t in port(imgs))
    jdets, jmask = (np.asarray(t) for t in jdet(jnp.asarray(imgs)))
    assert dets.shape == jdets.shape == (2, 32, 7)
    assert mask.sum() >= 10
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_allclose(dets[..., :5], jdets[..., :5], rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(dets[..., 5], jdets[..., 5], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(dets[..., 6], jdets[..., 6])
    np.testing.assert_allclose(port.predict_raw(imgs).numpy(),
                               np.asarray(jdet.predict_raw(jnp.asarray(imgs))),
                               rtol=1e-3, atol=1e-3)


def test_mixed_na_decode_kernel_takes_the_perhead_path(tmp_path,
                                                       monkeypatch):
    """``decode_kernel=True`` on mixed na never reaches kernel D (as the
    reference's rotated_nms.py:274) and gives the default's detections."""
    import rotate_yolov3_tpu_torch.ops.decode_rows as decode_rows_mod

    cfg = _mixed_cfg(tmp_path)
    det = Detector(cfg, img_size=IMG, conf_thres=1e-3, max_det=32,
                   device="cpu", seed=3)
    heads = det.heads(np.random.default_rng(1).integers(
        0, 256, (2, IMG, IMG, 3), dtype=np.uint8))

    def refuse(*args, **kwargs):
        raise AssertionError("kernel D reached on mixed na")

    monkeypatch.setattr(decode_rows_mod, "decode_rows", refuse)
    outs = [non_max_suppression_fused(
        heads, det.spec.yolo_specs, conf_thres=1e-3, max_det=32,
        approx_top_k=False, field_major=det.field_major_heads,
        decode_kernel=dk) for dk in (False, True)]
    assert int(outs[0][1].sum()) > 0
    assert torch.equal(outs[0][1], outs[1][1])
    assert torch.equal(outs[0][0], outs[1][0])


def test_mixed_na_train_step_matches_jax(tmp_path):
    jspec, spec = _specs(_mixed_cfg(tmp_path))
    jp, js = _jax_weights(jspec, seed=2)
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (2, IMG, IMG, 3)).astype(np.uint8)
    t = np.zeros((2, 6, 6), np.float32)
    v = np.zeros((2, 6), bool)
    for i, n in enumerate((4, 2)):
        t[i, :n, 1:3] = rng.uniform(0.15, 0.85, (n, 2))
        t[i, :n, 3] = rng.uniform(14, 40, n) / IMG
        t[i, :n, 4] = rng.uniform(8, 30, n) / IMG
        t[i, :n, 5] = rng.uniform(-math.pi / 2, math.pi / 2, n)
        v[i, :n] = True
    batch = (imgs, t, v)

    opt = jmake_opt(jsched.darknet_schedule(1e-2, burn_in=1), momentum=0.9,
                    weight_decay=5e-4)
    jts = jinit_ts(jspec, jax.tree.map(jnp.asarray, jp),
                   jax.tree.map(jnp.asarray, js), opt)
    _, jm = jax.jit(jmake_step(jspec, opt, JHyp()))(
        jts, *(jnp.asarray(a) for a in batch))
    ts = init_train_state(spec, *wio.params_from_numpy(jp, js),
                          sched.darknet_schedule(1e-2, burn_in=1),
                          momentum=0.9, weight_decay=5e-4, device="cpu")
    m = make_train_step(spec, Hyp())(ts, *(torch.from_numpy(a)
                                           for a in batch))
    assert float(jm["total"]) > 0
    for k in jm:
        rtol = 3e-3 if k == "grad_norm" else 1e-4
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol,
                                   atol=1e-7, err_msg=k)


def test_mixed_na_weights_round_trip(tmp_path):
    """JAX writer -> port loader -> port writer gives the same bytes, and
    the JAX loader reads the port's file back to the same values."""
    jspec, spec = _specs(_mixed_cfg(tmp_path))
    jp, js = _jax_weights(jspec, seed=4)
    jpath, ppath = str(tmp_path / "j.weights"), str(tmp_path / "p.weights")
    jwio.save_darknet_weights(jspec, jp, js, jpath, seen=99)
    p, s, meta = wio.load_weights_file(spec, *init_params(spec), jpath)
    assert meta.seen == 99
    wio.save_darknet_weights(spec, p, s, ppath, seen=99)
    assert open(ppath, "rb").read() == open(jpath, "rb").read()
    jp2, js2, _ = jwio.load_weights_file(
        jspec, *jinit(jspec, jax.random.PRNGKey(9)), ppath)
    for key in jp:
        for name in jp[key]:
            np.testing.assert_array_equal(np.asarray(jp2[key][name]),
                                          jp[key][name])
    for key in js:
        for name in js[key]:
            np.testing.assert_array_equal(np.asarray(js2[key][name]),
                                          js[key][name])


# ------------------------------ utilities -----------------------------------

@pytest.mark.parametrize("cfg", CFGS)
def test_flops_params_and_predictions_match_jax(cfg):
    """``flops_per_image`` at the cfg's size (608² for HRSC and DOTA),
    ``count_params`` and ``num_predictions``."""
    path = os.path.join(ROOT, "cfg", cfg)
    jspec, spec = _specs(path, img=None)
    assert prof.flops_per_image(spec) == jprof.flops_per_image(jspec)
    assert tyh.num_predictions(spec) == jyh.num_predictions(jspec)
    params, state = init_params(spec)
    jparams, jstate = jinit(jspec, jax.random.PRNGKey(0))
    assert count_params(params) == jcount_params(jparams)
    assert count_params(state) == jcount_params(jstate)


def test_model_info_matches_jax():
    path = os.path.join(ROOT, "cfg", "yolov3-rotate-hrsc.cfg")
    jspec, spec = _specs(path, img=None)
    assert spec.img_size == 608
    got = prof.model_info(spec, init_params(spec)[0])
    assert got == jprof.model_info(jspec, jinit(jspec,
                                                jax.random.PRNGKey(0))[0])
    assert "61,717,594" in got


def test_time_fn_on_cpu():
    x = torch.randn(64, 64)
    r = prof.time_fn(torch.matmul, x, x, iters=5, warmup=1)
    assert set(r) == {"mean_s", "std_s", "min_s", "iters"}
    assert r["iters"] == 5 and r["min_s"] > 0 and r["mean_s"] >= r["min_s"]
    assert prof._cuda_device((x, [x], {"a": x})) is None


def test_select_device_and_device_info_on_cpu():
    assert udevice.select_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        udevice.select_device("mps")
    info = udevice.device_info()
    if torch.cuda.is_available():
        assert info.startswith("backend=cuda n=")
        return
    assert info == "backend=cpu n=1 [cpu]"
    for name in ("cuda", ""):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            udevice.select_device(name)


def test_trace_writes_a_trace_file(tmp_path):
    log_dir = str(tmp_path / "trace")
    with prof.trace(log_dir) as d:
        assert d == log_dir
        torch.randn(32, 32).relu_().sum()
    files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    text = open(os.path.join(log_dir, files[0])).read()
    assert "traceEvents" in text and "aten::relu_" in text


def test_plot_results_from_the_train_cli(tmp_path):
    """results.txt written by the port's train CLI, plotted by the port and
    by the JAX package: the same image."""
    import matplotlib.image as mpimg

    from rotate_yolov3_tpu.utils.plotting import plot_results as jplot

    lst = make_synthetic_dataset(str(tmp_path / "ds"), n_images=4,
                                 img_size=(64, 64), n_boxes=(1, 3), seed=2)
    data = tmp_path / "ds.data"
    data.write_text(f"classes=1\ntrain={lst}\n")
    out = tmp_path / "run"
    train_pkg.train(train_pkg.make_parser().parse_args([
        "--cfg", os.path.join(ROOT, "cfg/yolov3-rotate-tiny.cfg"),
        "--data", str(data), "--epochs", "2", "--batch-size", "2",
        "--img-size", str(IMG), "--max-gt", "8", "--no-augment",
        "--no-tensorboard", "--no-eval", "--out-dir", str(out),
        "--device", "cpu"]))
    results = str(out / "results.txt")
    assert len(open(results).read().splitlines()) == 2
    plotting.plot_results(results, str(tmp_path / "port.png"))
    jplot(results, str(tmp_path / "jax.png"))
    got = mpimg.imread(str(tmp_path / "port.png"))
    assert open(tmp_path / "port.png", "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(got, mpimg.imread(str(tmp_path /
                                                        "jax.png")))


# ------------------------------ geometry ------------------------------------

# the degenerate boxes of tests/test_pallas.py (identical, axis-aligned
# with parallel edges, same-angle shifted, corner touching an edge)
_S2 = math.sqrt(2.0)
_DEGENERATE = np.array([
    [50, 50, 20, 10, 0.8], [50, 50, 20, 10, 0.8],
    [50, 50, 20, 10, 0.0], [55, 50, 20, 10, 0.0], [50, 52, 20, 10, 0.0],
    [30, 30, 16, 8, 0.5], [34, 33, 16, 8, 0.5],
    [-1.0, 0.0, 2.0 * _S2, 2.0 * _S2, math.pi / 4],
    [-0.7, 0.0, 1.7 * _S2, 1.7 * _S2, math.pi / 4],
    [0.0, 0.0, 2.0, 2.0, 0.0]], np.float32)


def _boxes(case):
    if case == "degenerate":
        return _DEGENERATE, _DEGENERATE
    rng = np.random.default_rng(5)

    def draw(n):
        return np.stack([rng.uniform(0, 60, n), rng.uniform(0, 60, n),
                         rng.uniform(5, 30, n), rng.uniform(5, 30, n),
                         rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)
    return draw(17), draw(33)


@pytest.mark.parametrize("case", ["random", "degenerate"])
def test_quad_iou_and_loss_match_jax(case):
    """``quad_area``, ``quad_iou`` (elementwise, both windings),
    ``quad_iou_matrix`` and ``skew_iou_loss``."""
    a, b = _boxes(case)
    qa = rbox_corners(torch.from_numpy(a)).numpy()
    qb = rbox_corners(torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(si.quad_area(torch.from_numpy(qa)).numpy(),
                               np.asarray(jsi.quad_area(jnp.asarray(qa))),
                               rtol=1e-6, atol=1e-5)
    want = np.asarray(jsi.quad_iou_matrix(jnp.asarray(qa), jnp.asarray(qb)))
    got = si.quad_iou_matrix(qa, qb).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # clockwise winding of the first argument: reordered, same IoU
    n = min(len(qa), len(qb))
    cw = qa[:n, ::-1].copy()
    np.testing.assert_allclose(
        si.quad_iou(cw, qb[:n]).numpy(),
        np.asarray(jsi.quad_iou(jnp.asarray(cw), jnp.asarray(qb[:n]))),
        atol=1e-5)
    np.testing.assert_allclose(np.diag(got[:n, :n]),
                               si.quad_iou(cw, qb[:n]).numpy(), atol=1e-5)
    np.testing.assert_allclose(
        si.skew_iou_loss(torch.from_numpy(a[:n]),
                         torch.from_numpy(b[:n])).numpy(),
        np.asarray(jsi.skew_iou_loss(jnp.asarray(a[:n]),
                                     jnp.asarray(b[:n]))), atol=1e-5)
    if case == "degenerate":
        np.testing.assert_allclose(np.diag(got)[:7], 1.0, atol=2e-3)


# the tie cases of test_torch_port_train.py::test_skew_iou_grad_matches_jax
_PAIRS = {
    "random": None,
    "identical": ((50, 50, 20, 10, 0.8), (50, 50, 20, 10, 0.8)),
    "parallel-edge": ((50, 50, 20, 10, 0.0), (55, 50, 20, 10, 0.0)),
    "parallel-rotated": ((30, 30, 16, 8, 0.5), (34, 33, 16, 8, 0.5)),
    "contained": ((50, 50, 40, 30, 0.3), (51, 49, 10, 6, 0.3)),
    "contained-rotated": ((50, 50, 40, 30, 0.3), (52, 50, 8, 5, 1.1)),
    "disjoint": ((10, 10, 6, 4, 0.2), (80, 80, 6, 4, -0.4)),
}


@pytest.mark.parametrize("case", sorted(_PAIRS))
def test_skew_iou_loss_grad_matches_jax(case):
    if _PAIRS[case] is None:
        rng = np.random.default_rng(11)
        a = np.stack([rng.uniform(20, 60, 16), rng.uniform(20, 60, 16),
                      rng.uniform(5, 30, 16), rng.uniform(5, 30, 16),
                      rng.uniform(-1.5, 1.5, 16)], -1)
        b = a + rng.normal(0, 4, a.shape) * [1, 1, 0.5, 0.5, 0.1]
    else:
        a, b = (np.asarray([x], np.float64) for x in _PAIRS[case])
    a, b = a.astype(np.float32), b.astype(np.float32)
    jloss, (ja, jb) = jax.value_and_grad(
        lambda x, y: jnp.sum(jsi.skew_iou_loss(x, y)), argnums=(0, 1))(
            jnp.asarray(a), jnp.asarray(b))
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    loss = si.skew_iou_loss(ta, tb).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-5)
    assert np.isfinite(ta.grad.numpy()).all()


def test_native_iou_poly_and_rotated_nms_bit_equal_jax():
    rng = np.random.default_rng(8)
    boxes = np.concatenate([_DEGENERATE, np.stack(
        [rng.uniform(0, 80, 40), rng.uniform(0, 80, 40),
         rng.uniform(5, 30, 40), rng.uniform(5, 30, 40),
         rng.uniform(-np.pi, np.pi, 40)], 1).astype(np.float32)])
    quads = rbox_corners(torch.from_numpy(boxes)).numpy().astype(np.float64)
    for i in range(len(quads)):
        for j in (0, 3, 7, (i * 7) % len(quads)):
            got = native.iou_poly(quads[i], quads[j].reshape(-1))
            assert got == jnative.iou_poly(quads[i], quads[j].reshape(-1))
    scores = rng.uniform(0, 1, len(boxes)).astype(np.float32)
    scores[1] = scores[0]                           # a tie: stable order
    for thr in (0.1, 0.4, 0.7):
        got = native.rotated_nms(boxes, scores, thr)
        want = jnative.rotated_nms(boxes, scores, thr)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert 0 < len(got) < len(boxes)


# ------------------------------ tools ---------------------------------------

sys.path.insert(0, os.path.join(ROOT, "tools"))
import kmeans_anchors as jkmeans  # noqa: E402  the JAX package's tool


def _clustered_wh(rng, centers, n_per=200, jitter=0.04):
    return np.concatenate([np.stack([
        cw * np.exp(rng.normal(0, jitter, n_per)),
        ch * np.exp(rng.normal(0, jitter, n_per))], axis=1)
        for cw, ch in centers])


@pytest.mark.parametrize("case", [
    "wh_iou", "planted_clusters", "count_and_order", "even_angle_grid",
    "circular_wrap", "collect_and_main"])
def test_kmeans_anchors_matches_jax_tool(tmp_path, case):
    """The cases of tests/test_kmeans_anchors.py, each run through the
    repository's tool and the port's: equal arrays and printed lines."""
    def both(name, *args, **kwargs):
        want = getattr(jkmeans, name)(*args, **kwargs)
        got = getattr(kmeans, name)(*args, **kwargs)
        np.testing.assert_array_equal(got, want)
        return got

    if case == "wh_iou":
        iou = both("wh_iou", np.array([[10.0, 20.0]]),
                   np.array([[10.0, 20.0], [20.0, 10.0], [5.0, 5.0]]))[0]
        assert iou[0] == pytest.approx(1.0)
        assert iou[1] == pytest.approx(100 / 300)
    elif case == "planted_clusters":
        centers = [(20.0, 40.0), (80.0, 30.0), (200.0, 180.0)]
        wh = _clustered_wh(np.random.default_rng(0), centers)
        anchors = both("kmeans_anchors", wh, 3, seed=0)
        want = np.array(sorted(centers, key=lambda c: c[0] * c[1]))
        assert np.all(np.abs(anchors - want) / want < 0.15)
        assert kmeans.mean_best_iou(wh, anchors) == \
            jkmeans.mean_best_iou(wh, anchors)
        assert kmeans.recall_at(wh, anchors, 0.5) == pytest.approx(1.0)
    elif case == "count_and_order":
        wh = np.random.default_rng(1).uniform(5, 300, (500, 2))
        anchors = both("kmeans_anchors", wh, 9, seed=1)
        assert anchors.shape == (9, 2)
        assert np.all(np.diff(anchors.prod(axis=1)) >= 0)
        assert kmeans.format_anchor_line(anchors) == \
            jkmeans.format_anchor_line(anchors)
    elif case == "even_angle_grid":
        for k in (3, 4, 6, 9):
            deg = np.degrees(both("even_angle_grid", k))
        assert np.allclose(np.degrees(kmeans.even_angle_grid(6)),
                           [-60, -30, 0, 30, 60, 90])
        assert kmeans.format_angle_line(kmeans.even_angle_grid(6)) == \
            jkmeans.format_angle_line(jkmeans.even_angle_grid(6))
        assert len(deg) == 9
    elif case == "circular_wrap":
        rng = np.random.default_rng(2)
        a = np.concatenate([rng.normal(np.radians(88), 0.02, 300),
                            rng.normal(np.radians(-88), 0.02, 300),
                            rng.normal(0.0, 0.02, 300)])
        got = np.sort(np.degrees(both("circular_kmeans_angles", a, 2,
                                      seed=0)))
        assert abs(got[0]) < 5 and abs(abs(got[1]) - 90) < 5
    else:
        lst = make_synthetic_dataset(str(tmp_path), n_images=8,
                                     img_size=(160, 160), seed=3)
        wht = both("collect_wh_theta", lst, img_size=416)
        assert wht.shape[1] == 3 and np.all(wht[:, 0] > 0)
        argv = ["--train", lst, "--img-size", "416", "--num", "3",
                "--num-angles", "6"]
        outs = []
        for mod in (jkmeans, kmeans):
            buf = io.StringIO()
            with redirect_stdout(buf):
                outs.append((mod.main(argv), buf.getvalue()))
        (ja, jang), jtext = outs[0]
        (pa, pang), ptext = outs[1]
        np.testing.assert_array_equal(pa, ja)
        np.testing.assert_array_equal(pang, jang)
        assert ptext == jtext and "anchors = " in ptext


def test_verify_reference_self_test_exits_0(capsys):
    assert verify_reference.main(["--self-test"]) == 0
    assert "self-test OK" in capsys.readouterr().out


def test_verify_reference_empty_tree_exits_as_jax_tool(tmp_path,
                                                       monkeypatch):
    import verify_reference as jverify     # the JAX package's tool

    empty = tmp_path / "ref"
    empty.mkdir()
    got = verify_reference.main(["--reference", str(empty)])
    monkeypatch.setattr(sys, "argv", ["verify_reference.py", "--reference",
                                      str(empty)])
    assert got == jverify.main() == 2
    assert verify_reference.main([]) == 2        # no tree given
