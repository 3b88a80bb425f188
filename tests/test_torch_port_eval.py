"""The PyTorch port's evaluation against the JAX package on the CPU.

``match_image``, ``ap_per_class`` and ``summarize`` run on the same random
stats (equal to 1e-12: the same numpy arithmetic and the same native IoU).
``evaluate_dataset`` runs the JAX ``Detector`` and the port's on the same
``.weights`` bytes, f32, exact top-k, Green's-theorem IoU on both sides,
over a synthetic dataset whose labels are half of the JAX detector's own
detections (so AP is not trivially 0): detection counts per image equal,
per-class P/R/AP and mAP within 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rotate_yolov3_tpu.config.parse import parse_model_cfg as jparse
from rotate_yolov3_tpu.data.synthetic import make_synthetic_dataset
from rotate_yolov3_tpu.detector import Detector as JDetector
from rotate_yolov3_tpu.detector import \
    detections_to_numpy as jdetections_to_numpy
from rotate_yolov3_tpu.eval import metrics as jmetrics
from rotate_yolov3_tpu.eval.evaluator import \
    evaluate_dataset as jevaluate_dataset
from rotate_yolov3_tpu.models.darknet import build_network as jbuild
from rotate_yolov3_tpu.models.darknet import init_params as jinit
from rotate_yolov3_tpu.models.weights_io import save_darknet_weights
from rotate_yolov3_tpu.ops.skew_iou_green import skew_iou_matrix_green
from rotate_yolov3_tpu_torch import test as test_cli
from rotate_yolov3_tpu_torch.detector import Detector
from rotate_yolov3_tpu_torch.eval import metrics
from rotate_yolov3_tpu_torch.eval.evaluator import (evaluate_dataset,
                                                    print_eval_table)
from rotate_yolov3_tpu_torch.native import polyiou

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "cfg/yolov3-rotate-tiny.cfg")
IMG = 64
CONF = 0.05


def _boxes(rng, n, spread=60.0):
    return np.stack([rng.uniform(10, spread, n), rng.uniform(10, spread, n),
                     rng.uniform(4, 30, n), rng.uniform(4, 30, n),
                     rng.uniform(-1.6, 1.6, n)], -1).astype(np.float32)


def _random_image(rng, k, g, nc):
    """K score-sorted detections near G GT boxes (some shifted, some
    random), and the GT."""
    gts = _boxes(rng, g)
    near = gts[rng.integers(0, g, k)] + rng.normal(0, 2, (k, 5)).astype(
        np.float32) * [1, 1, 1, 1, 0.05]
    far = _boxes(rng, k)
    pick = rng.uniform(size=k) < 0.6
    d = np.where(pick[:, None], near, far)
    d[:, 2:4] = np.abs(d[:, 2:4]) + 1
    scores = np.sort(rng.uniform(0.05, 1, k))[::-1]
    dets = np.concatenate([d, scores[:, None], rng.integers(
        0, nc, (k, 1))], -1).astype(np.float32)
    return dets, gts, rng.integers(0, nc, g)


@pytest.mark.parametrize("seed", range(4))
def test_match_image_equals_reference(seed):
    rng = np.random.default_rng(seed)
    for k, g in ((0, 3), (5, 0), (12, 4), (40, 9)):
        dets, gts, gcls = _random_image(rng, k, max(g, 1), 2)
        gts, gcls = gts[:g], gcls[:g]
        for thr in (0.3, 0.5):
            np.testing.assert_array_equal(
                metrics.match_image(dets, gts, gcls, thr),
                jmetrics.match_image(dets, gts, gcls, thr))


def _random_stats(seed, n_images=12, nc=3):
    rng = np.random.default_rng(seed)
    stats = []
    for _ in range(n_images):
        k, g = int(rng.integers(0, 15)), int(rng.integers(0, 6))
        stats.append((rng.uniform(size=k) < 0.5, rng.uniform(0, 1, k),
                      rng.integers(0, nc, k), rng.integers(0, nc, g)))
    return stats


@pytest.mark.parametrize("method", ["continuous", "11point"])
@pytest.mark.parametrize("seed", range(3))
def test_ap_per_class_and_summarize_equal_reference(method, seed):
    stats = _random_stats(seed)
    flat = [np.concatenate([s[i] for s in stats]) for i in range(4)]
    want = jmetrics.ap_per_class(*flat, method=method)
    got = metrics.ap_per_class(*flat, method=method)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    names = ("ship", "boat")
    w, g = (m.summarize(stats, names=names, method=method)
            for m in (jmetrics, metrics))
    assert g["per_class"] == w["per_class"]
    for k in ("mp", "mr", "map"):
        assert abs(g[k] - w[k]) <= 1e-12


def test_summarize_edge_cases_equal_reference():
    empty = (np.zeros(0, bool), np.zeros(0), np.zeros(0, int))
    for stats in ([], [empty + (np.zeros(0, int),)],
                  [empty + (np.array([0, 1]),)]):
        assert metrics.summarize(stats) == jmetrics.summarize(stats)


def test_host_iou_fallback_is_the_argsort_skew_iou(monkeypatch):
    """Without the native library the matching IoU comes from the argsort
    skew-IoU (1e-5 of the native one, which the reference uses) and the
    fallback is counted."""
    rng = np.random.default_rng(3)
    a, b = _boxes(rng, 9), _boxes(rng, 5)
    native = metrics._cross_iou_host(a, b)

    def no_lib():
        raise RuntimeError("no g++")

    monkeypatch.setattr(polyiou, "get_lib", no_lib)
    before = metrics._cross_iou_host.fallbacks
    got = metrics._cross_iou_host(a, b)
    assert metrics._cross_iou_host.fallbacks == before + 1
    np.testing.assert_allclose(got, native, rtol=0, atol=1e-5)
    np.testing.assert_allclose(native, jmetrics._cross_iou_host(a, b),
                               rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    """Weights, a 7-image synthetic dataset at the net size (no letterbox
    resize) whose label files hold every other detection of the JAX
    detector (so matches exist), and the .data file."""
    base = tmp_path_factory.mktemp("eval")
    spec = jbuild(jparse(TINY), img_size=IMG)
    params, state = jinit(spec, jax.random.PRNGKey(5))
    rng = np.random.default_rng(5)
    state = {k: {"bn_mean": jnp.asarray(rng.normal(0, 0.05, v["bn_mean"]
                                                   .shape).astype(np.float32)),
                 "bn_var": jnp.asarray(rng.uniform(0.8, 1.2, v["bn_var"]
                                                   .shape).astype(np.float32))}
             for k, v in state.items()}
    wpath = str(base / "w.weights")
    save_darknet_weights(spec, params, state, wpath)
    list_path = make_synthetic_dataset(str(base / "ds"), n_images=7,
                                       img_size=(IMG, IMG), seed=7)
    jdet = _jax_detector(wpath)
    from rotate_yolov3_tpu.data.datasets import LoadImagesAndLabels
    ds = LoadImagesAndLabels(list_path, img_size=IMG, batch_size=7,
                             drop_last=False)
    imgs = next(iter(ds))[0]
    per_image = jdetections_to_numpy(*jdet(jnp.asarray(imgs)))
    img_files = [ln.strip() for ln in open(list_path)]
    n_labels = 0
    for i, d in zip(ds._epoch_indices(), per_image):
        rows = d[::2]
        n_labels += len(rows)
        lbl = img_files[i].replace("/images/", "/labels/").rsplit(
            ".", 1)[0] + ".txt"
        with open(lbl, "w") as f:
            for r in rows:
                f.write(f"0 {r[0] / IMG:.6f} {r[1] / IMG:.6f} "
                        f"{r[2] / IMG:.6f} {r[3] / IMG:.6f} {r[4]:.6f}\n")
    assert n_labels > 0
    data = base / "ds.data"
    data.write_text(f"classes=1\nvalid={list_path}\n")
    return wpath, list_path, str(data)


def _jax_detector(wpath):
    return JDetector(TINY, weights=wpath, img_size=IMG, conf_thres=CONF,
                     nms_thres=0.4, max_det=64, approx_top_k=False,
                     iou_matrix_fn=skew_iou_matrix_green)


def _port_detector(wpath):
    return Detector(TINY, weights=wpath, img_size=IMG, conf_thres=CONF,
                    nms_thres=0.4, max_det=64, approx_top_k=False,
                    device="cpu")


@pytest.mark.parametrize("batch_size", [3, 7])
def test_evaluate_dataset_matches_jax(eval_setup, batch_size):
    wpath, list_path, _ = eval_setup
    kw = dict(batch_size=batch_size, names=("ship",), max_gt=16)
    want = jevaluate_dataset(_jax_detector(wpath), list_path, **kw)
    got = evaluate_dataset(_port_detector(wpath), list_path, **kw)
    assert got["n_images"] == want["n_images"] == 7
    assert got["n_gt"] == want["n_gt"] > 0
    assert got["n_gt_truncated"] == want["n_gt_truncated"] == 0
    assert want["map"] > 0.3
    for k in ("mp", "mr", "map"):
        assert abs(got[k] - want[k]) <= 1e-5, k
    assert [r["class"] for r in got["per_class"]] == \
        [r["class"] for r in want["per_class"]]
    for a, b in zip(got["per_class"], want["per_class"]):
        for k in ("p", "r", "ap"):
            assert abs(a[k] - b[k]) <= 1e-5


def test_detection_counts_per_image_match_jax(eval_setup):
    wpath, list_path, _ = eval_setup
    from rotate_yolov3_tpu_torch.data.datasets import LoadImagesAndLabels
    imgs = next(iter(LoadImagesAndLabels(list_path, img_size=IMG,
                                         batch_size=7, drop_last=False)))[0]
    jd = jdetections_to_numpy(*_jax_detector(wpath)(jnp.asarray(imgs)))
    pd = [d for d in _port_detector(wpath)(torch.from_numpy(imgs))[1]
          .sum(1).tolist()]
    assert pd == [len(d) for d in jd]
    assert sum(pd) > 0


def test_eval_max_images_and_truncation_match_jax(eval_setup, capsys):
    wpath, list_path, _ = eval_setup
    kw = dict(batch_size=3, max_images=4, max_gt=1)
    want = jevaluate_dataset(_jax_detector(wpath), list_path, **kw)
    got = evaluate_dataset(_port_detector(wpath), list_path, **kw)
    assert got["n_images"] == want["n_images"] == 4
    assert got["n_gt_truncated"] == want["n_gt_truncated"] > 0
    assert abs(got["map"] - want["map"]) <= 1e-5
    assert "DROPPED" in capsys.readouterr().err


def test_test_cli_runs_on_the_cpu(eval_setup, capsys):
    """The test.py twin end to end: the table, and the result of
    evaluate_dataset with the same exact-top-k detector; the host IoU
    comes from the native library."""
    wpath, list_path, data = eval_setup
    before = metrics._cross_iou_host.fallbacks
    opt = test_cli.make_parser().parse_args([
        "--cfg", TINY, "--data", data, "--weights", wpath, "--img-size",
        str(IMG), "--conf-thres", str(CONF), "--max-det", "64",
        "--batch-size", "4", "--device", "cpu"])
    assert opt.approx_topk is False
    mp, mr, mAP = test_cli.test(opt)
    out = capsys.readouterr().out
    assert "all" in out and f"{mAP:8.4f}" in out
    want = evaluate_dataset(_port_detector(wpath), list_path, batch_size=4)
    assert (mp, mr, mAP) == (want["mp"], want["mr"], want["map"])
    assert metrics._cross_iou_host.fallbacks == before
    print_eval_table(want)


def test_test_cli_refuses_devices(eval_setup):
    """``--devices 2`` over the 7 images at batch 4: the ragged last batch
    of 3 is padded to 4 and split over two replicas; P, R and mAP equal
    the one-device run's, and ``evaluate_dataset`` scores 7 images."""
    wpath, list_path, data = eval_setup
    args = ["--cfg", TINY, "--data", data, "--weights", wpath, "--img-size",
            str(IMG), "--conf-thres", str(CONF), "--max-det", "64",
            "--batch-size", "4", "--device", "cpu"]
    one = test_cli.test(test_cli.make_parser().parse_args(args))
    two = test_cli.test(test_cli.make_parser().parse_args(
        args + ["--devices", "2"]))
    assert one == two and one[2] > 0
    det = Detector(TINY, weights=wpath, img_size=IMG, conf_thres=CONF,
                   max_det=64, approx_top_k=False, devices=2, device="cpu")
    got = evaluate_dataset(det, list_path, batch_size=4)
    assert got["n_images"] == 7
    assert (got["mp"], got["mr"], got["map"]) == one


def test_cli_default_device_is_cuda():
    opt = test_cli.make_parser().parse_args(["--cfg", TINY, "--data", "x"])
    assert opt.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Detector(TINY, img_size=IMG, device=opt.device)
