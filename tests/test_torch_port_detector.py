"""The PyTorch port's serving slice against the JAX ``Detector`` on the CPU.

Both detectors load the same ``.weights`` bytes (written by the JAX
package's ``save_darknet_weights`` from seeded random params with non-trivial
BN statistics) and see the same uint8 images, in f32 with exact top-k. The
JAX side gets ``iou_matrix_fn=skew_iou_matrix_green``, so both sides use the
Green's-theorem intersection; its ``IoU > thr`` equals the port's
divide-free kill predicate except within FP rounding of ``thr``.

Tolerances: head maps rtol/atol 1e-3 (up to 75 f32 conv layers of summation
order drift between XLA and PyTorch on the CPU), boxes rtol/atol 1e-3,
scores 1e-4; classes and keep masks must be equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rotate_yolov3_tpu.config.parse import parse_model_cfg as jparse
from rotate_yolov3_tpu.detector import Detector as JaxDetector
from rotate_yolov3_tpu.models.darknet import apply_fused
from rotate_yolov3_tpu.models.darknet import build_network as jbuild
from rotate_yolov3_tpu.models.darknet import fuse_bn as jfuse_bn
from rotate_yolov3_tpu.models.darknet import init_params as jinit
from rotate_yolov3_tpu.models.weights_io import save_darknet_weights
from rotate_yolov3_tpu.ops.skew_iou_green import skew_iou_matrix_green
from rotate_yolov3_tpu_torch.config.parse import parse_model_cfg
from rotate_yolov3_tpu_torch.detector import Detector, detections_to_numpy
from rotate_yolov3_tpu_torch.models.darknet import (build_network, fuse_bn,
                                                    init_params)
from rotate_yolov3_tpu_torch.models.weights_io import (load_darknet_weights,
                                                       params_from_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_weights(cfg, img_size, path, seed):
    """Seeded JAX params with non-trivial BN stats -> .weights file."""
    spec = jbuild(jparse(cfg), img_size=img_size)
    params, state = jinit(spec, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    state = {k: {"bn_mean": jnp.asarray(rng.normal(0, 0.05, v["bn_mean"].shape)
                                        .astype(np.float32)),
                 "bn_var": jnp.asarray(rng.uniform(0.8, 1.2, v["bn_var"].shape)
                                       .astype(np.float32))}
             for k, v in state.items()}
    save_darknet_weights(spec, params, state, path)
    return spec, params, state


def test_weights_load_equals_converter(tmp_path):
    """JAX init_params -> save_darknet_weights -> port load gives the same
    params, state and fused params as params_from_numpy."""
    cfg = os.path.join(ROOT, "cfg/yolov3-tiny-rotate-hrsc.cfg")
    wpath = str(tmp_path / "t.weights")
    jspec, jp, js = _write_weights(cfg, 64, wpath, seed=4)
    spec = build_network(parse_model_cfg(cfg), img_size=64)
    p0, s0 = init_params(spec, seed=1)
    p1, s1, seen = load_darknet_weights(spec, p0, s0, wpath)
    assert seen == 0
    cp, cs = params_from_numpy(jax.tree.map(np.asarray, jp),
                               jax.tree.map(np.asarray, js))
    for tree_a, tree_b in ((p1, cp), (s1, cs)):
        assert tree_a.keys() == tree_b.keys()
        for key in tree_a:
            assert tree_a[key].keys() == tree_b[key].keys()
            for name in tree_a[key]:
                np.testing.assert_array_equal(tree_a[key][name].numpy(),
                                              tree_b[key][name].numpy())
    fused = fuse_bn(spec, p1, s1)
    jfused = jfuse_bn(jspec, jp, js)
    for key, entry in fused.items():
        np.testing.assert_allclose(
            entry["kernel"].numpy(),
            np.transpose(np.asarray(jfused[key]["kernel"]), (3, 2, 0, 1)),
            rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(entry["bias"].numpy(),
                                   np.asarray(jfused[key]["bias"]),
                                   rtol=1e-6, atol=1e-7)
    # a truncated file fails loudly
    with open(wpath, "rb") as f:
        data = f.read()
    bad = str(tmp_path / "bad.weights")
    with open(bad, "wb") as f:
        f.write(data[:-8])
    with pytest.raises(ValueError, match="mid-layer"):
        load_darknet_weights(spec, p0, s0, bad)


@pytest.mark.parametrize("cfg,img_size", [
    ("cfg/yolov3-rotate-hrsc.cfg", 96),        # full Darknet-53 width
    ("cfg/yolov3-rotate-dota.cfg", 64),        # nc = 15, class-aware kill
    ("cfg/yolov3-tiny-rotate-hrsc.cfg", 64),   # SAME maxpool (2, stride 1)
])
def test_detector_slice_matches_jax(tmp_path, cfg, img_size):
    cfg = os.path.join(ROOT, cfg)
    wpath = str(tmp_path / "slice.weights")
    _write_weights(cfg, img_size, wpath, seed=7)
    rng = np.random.default_rng(11)
    imgs = rng.integers(0, 256, (2, img_size, img_size, 3), dtype=np.uint8)

    port = Detector(cfg, weights=wpath, img_size=img_size, max_det=64,
                    device="cpu")
    assert not port.approx_top_k
    raw = port.predict_raw(imgs).numpy()
    # threshold between two score quantiles so ~30 candidates per image
    # pass, with a margin from both neighbours
    score = (raw[..., 5] * raw[..., 6:].max(-1)).reshape(-1)
    srt = np.sort(score)[::-1]
    n_pass = 60
    conf = float(0.5 * (srt[n_pass - 1] + srt[n_pass]))
    port.conf_thres = conf

    jdet = JaxDetector(cfg, weights=wpath, img_size=img_size,
                       conf_thres=conf, max_det=64,
                       iou_matrix_fn=skew_iou_matrix_green,
                       approx_top_k=False, bake_params=False)

    @jax.jit
    def jax_slice(fused, x):
        heads = apply_fused(jdet._infer_spec, fused, x.astype(jnp.float32))
        return heads, jdet.infer_fn(fused, x)

    jheads, (jdets, jmask) = jax_slice(jdet.fused_params, jnp.asarray(imgs))
    for h_port, h_jax in zip(port.heads(imgs), jheads):
        assert h_port.shape == h_jax.shape
        np.testing.assert_allclose(h_port.numpy(), np.asarray(h_jax),
                                   rtol=1e-3, atol=1e-3)

    dets, mask = port(imgs)
    dets, mask = dets.numpy(), mask.numpy()
    jdets, jmask = np.asarray(jdets), np.asarray(jmask)
    assert dets.shape == jdets.shape == (2, 64, 7)
    np.testing.assert_array_equal(mask, jmask)
    assert mask.sum() >= 10
    assert mask.sum() < int((score > conf).sum())   # NMS suppressed some
    np.testing.assert_allclose(dets[..., :5], jdets[..., :5],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(dets[..., 5], jdets[..., 5],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(dets[..., 6], jdets[..., 6])
    assert not dets[~mask].any()

    jraw = np.asarray(jdet.predict_raw(jnp.asarray(imgs)))
    assert raw.shape == jraw.shape
    np.testing.assert_allclose(raw, jraw, rtol=1e-3, atol=1e-3)

    per_image = detections_to_numpy(torch.from_numpy(dets),
                                    torch.from_numpy(mask))
    assert [len(d) for d in per_image] == mask.sum(1).tolist()


def test_detector_refuses_unported_options():
    """Every option is ported: ``packed_stem`` is refused only where the
    cfg's stem has no packed form (the tiny cfg's layer 1 is a max-pool;
    the reference asserts there too, and
    ``tests/test_torch_port_packed_stem.py`` holds the packed HRSC stem to
    the JAX package); ``devices=2`` runs two replicas whose gathered
    detections equal one device's; an unknown ``iou_algo`` and a wrong
    image size raise."""
    cfg = os.path.join(ROOT, "cfg/yolov3-tiny-rotate-hrsc.cfg")
    with pytest.raises(ValueError, match="packed form"):
        Detector(cfg, img_size=64, device="cpu", packed_stem=True)
    imgs = np.random.default_rng(3).integers(0, 256, (4, 64, 64, 3),
                                             dtype=np.uint8)
    one, two = (Detector(cfg, img_size=64, conf_thres=0.05, device="cpu",
                         devices=n)(imgs) for n in (0, 2))
    assert int(one[1].sum()) > 0
    assert torch.equal(one[1], two[1])
    torch.testing.assert_close(two[0], one[0], rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="algo"):
        Detector(cfg, img_size=64, device="cpu", iou_algo="green3")
    det = Detector(cfg, img_size=64, device="cpu", iou_algo="green2",
                   iou_matrix_fn=skew_iou_matrix_green)
    assert (det.iou_algo, det.iou_matrix_fn) == ("green2",
                                                 skew_iou_matrix_green)
    with pytest.raises(ValueError, match="letterboxed"):
        det(np.zeros((1, 32, 32, 3), np.uint8))


def test_detector_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Detector(os.path.join(ROOT, "cfg/yolov3-tiny-rotate-hrsc.cfg"),
                 img_size=64)


def test_detect_cli_on_cpu(tmp_path):
    """``python -m rotate_yolov3_tpu_torch.detect`` end to end on the CPU:
    letterbox, detect, rescale, write txt and drawn images."""
    import cv2

    from rotate_yolov3_tpu_torch.detect import detect, make_parser

    src = tmp_path / "imgs"
    src.mkdir()
    rng = np.random.default_rng(2)
    for i, (h, w) in enumerate(((50, 80), (64, 64), (90, 40))):
        cv2.imwrite(str(src / f"im{i}.png"),
                    rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    out = tmp_path / "out"
    opt = make_parser().parse_args([
        "--cfg", os.path.join(ROOT, "cfg/yolov3-tiny-rotate-hrsc.cfg"),
        "--source", str(src), "--output", str(out), "--img-size", "64",
        "--conf-thres", "0.0", "--max-det", "16", "--batch-size", "2",
        "--device", "cpu"])
    detect(opt)
    for i in range(3):
        rows = np.loadtxt(out / f"im{i}.txt", ndmin=2)
        assert rows.shape[1] == 7 and 1 <= len(rows) <= 16
        assert (out / f"im{i}.jpg").exists()
    # two replicas, the last batch of 1 padded to 2: the same files
    detect(make_parser().parse_args([
        "--cfg", os.path.join(ROOT, "cfg/yolov3-tiny-rotate-hrsc.cfg"),
        "--source", str(src), "--output", str(tmp_path / "out2"),
        "--img-size", "64", "--conf-thres", "0.0", "--max-det", "16",
        "--batch-size", "2", "--devices", "2", "--device", "cpu"]))
    for i in range(3):
        np.testing.assert_allclose(
            np.loadtxt(tmp_path / "out2" / f"im{i}.txt", ndmin=2),
            np.loadtxt(out / f"im{i}.txt", ndmin=2), rtol=0, atol=1e-4)
