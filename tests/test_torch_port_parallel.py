"""The PyTorch port's data parallelism against the JAX package on the CPU.

Data-parallel training runs 2 gloo ranks, one spawned process each, one
thread each (``parallel.dryrun.dp_train_steps``); the JAX side runs the
reference's ``shard_map`` step on ``make_mesh(2)`` of the conftest's
virtual CPU devices. Both start from the same weights (non-trivial BN
state) and see the same global batches; rank r takes the r-th contiguous
half. Tolerances: sync-BN heads 1e-5 and running statistics 1e-6 against
one process; the step against the JAX step at the JAX package's own
data-parallel tolerances (``tests/test_train_parallel.py``: total rel 2e-4,
``layer_000`` kernel rtol 2e-3 / atol 2e-5); parameters bit-equal across
ranks. ``Detector(devices=2)`` and the sharded DOTA pipeline: keep masks
exact, values 1e-5 against one device.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rotate_yolov3_tpu.config.hyp import Hyp as JHyp
from rotate_yolov3_tpu.config.parse import parse_model_cfg as jparse
from rotate_yolov3_tpu.data.synthetic import make_synthetic_dataset
from rotate_yolov3_tpu.detector import Detector as JDetector
from rotate_yolov3_tpu.models.darknet import apply_network
from rotate_yolov3_tpu.models.darknet import build_network as jbuild
from rotate_yolov3_tpu.models.darknet import init_params as jinit
from rotate_yolov3_tpu.models.weights_io import save_darknet_weights
from rotate_yolov3_tpu.ops.skew_iou_green import skew_iou_matrix_green
from rotate_yolov3_tpu.parallel import mesh as jmesh
from rotate_yolov3_tpu.train import schedule as jsched
from rotate_yolov3_tpu.train.trainer import init_train_state as jinit_ts
from rotate_yolov3_tpu.train.trainer import make_optimizer as jmake_opt
from rotate_yolov3_tpu.train.trainer import make_train_step as jmake_step
from rotate_yolov3_tpu_torch import train as train_pkg
from rotate_yolov3_tpu_torch.config.hyp import Hyp
from rotate_yolov3_tpu_torch.config.parse import parse_model_cfg
from rotate_yolov3_tpu_torch.data import augment_device as tad
from rotate_yolov3_tpu_torch.data.dota.device_tiles import DeviceTilePipeline
from rotate_yolov3_tpu_torch.detector import Detector
from rotate_yolov3_tpu_torch.models import weights_io as wio
from rotate_yolov3_tpu_torch.models.darknet import Darknet, build_network
from rotate_yolov3_tpu_torch.parallel.dryrun import (DP_LR, dp_train_steps,
                                                     dryrun_multichip)
from rotate_yolov3_tpu_torch.parallel.mesh import make_mesh, shard_batch
from rotate_yolov3_tpu_torch.train import schedule as sched
from rotate_yolov3_tpu_torch.train.trainer import (aug_generator,
                                                   init_train_state,
                                                   make_train_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "cfg/yolov3-rotate-tiny.cfg")
IMG, LR, STEPS = 64, DP_LR, 3
SPAWN_TIMEOUT = 240.0


def _jax_weights(jspec, seed=0):
    """Seeded JAX params with non-trivial BN state, as numpy trees."""
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


def _global_batch(seed, b=4, g=8):
    """(imgs, targets, valid) of B = 4: the first half bright, the second
    dark, so the two ranks' BN moments differ (averaging per-rank variances
    instead of the raw moments would show); one identical GT row per image,
    so each rank's loss normalisation equals the whole batch's."""
    rng = np.random.default_rng(seed)
    imgs = np.concatenate([
        rng.integers(120, 256, (b // 2, IMG, IMG, 3)),
        rng.integers(0, 100, (b - b // 2, IMG, IMG, 3))]).astype(np.uint8)
    t = np.zeros((b, g, 6), np.float32)
    v = np.zeros((b, g), bool)
    t[:, 0] = [0, 0.4, 0.5, 0.3, 0.12, 0.3]
    v[:, 0] = True
    return imgs, t, v


@pytest.fixture(scope="module")
def dp_run():
    """One spawn of 2 gloo ranks: a train-mode forward (sync BN), then
    STEPS data-parallel steps, from the same weights as the references."""
    jspec = jbuild(jparse(TINY), img_size=IMG)
    jp, js = _jax_weights(jspec, seed=1)
    batches = [_global_batch(s) for s in range(STEPS)]
    ranks = dp_train_steps(make_mesh(2, "cpu"), TINY, IMG,
                           *wio.params_from_numpy(jp, js), batches,
                           forward=True, timeout=SPAWN_TIMEOUT)
    return jspec, jp, js, batches, ranks


def _port_one_process(jp, js, batches):
    spec = build_network(parse_model_cfg(TINY), img_size=IMG)
    ts = init_train_state(spec, *wio.params_from_numpy(jp, js),
                          sched.darknet_schedule(LR, burn_in=1),
                          momentum=0.9, weight_decay=5e-4, device="cpu")
    step = make_train_step(spec, Hyp())
    metrics = [{k: float(v) for k, v in step(ts, *(torch.from_numpy(a)
                                                  for a in b)).items()}
               for b in batches]
    return metrics, ts.net.params_state()


def test_sync_bn_forward_matches_one_process_and_jax(dp_run):
    jspec, jp, js, batches, ranks = dp_run
    x = batches[0][0].astype(np.float32) / 255.0
    net = Darknet(build_network(parse_model_cfg(TINY), img_size=IMG),
                  *wio.params_from_numpy(jp, js))
    net.train()
    with torch.no_grad():
        heads = net(torch.from_numpy(x))
    jheads, jstate = apply_network(jspec, jax.tree.map(jnp.asarray, jp),
                                   jax.tree.map(jnp.asarray, js),
                                   jnp.asarray(x), train=True)
    for i, (h, jh) in enumerate(zip(heads, jheads)):
        dp = torch.cat([r["heads"][i] for r in ranks]).numpy()
        np.testing.assert_allclose(dp, h.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(dp, np.asarray(jh), rtol=0, atol=1e-5)
    _, state = net.params_state()
    for r in ranks:
        for key, s in state.items():
            for name in ("bn_mean", "bn_var"):
                got = r["bn_state"][key][name].numpy()
                np.testing.assert_allclose(got, s[name].numpy(), rtol=0,
                                           atol=1e-6, err_msg=key + name)
                np.testing.assert_allclose(got, np.asarray(
                    jstate[key][name]), rtol=0, atol=1e-6)


def test_dp_step_matches_jax_parallel_step(dp_run):
    jspec, jp, js, batches, ranks = dp_run
    opt = jmake_opt(jsched.darknet_schedule(LR, burn_in=1), momentum=0.9,
                    weight_decay=5e-4)
    mesh = jmesh.make_mesh(2)
    pstep = jmesh.make_parallel_train_step(
        jmake_step(jspec, opt, JHyp(), axis_name=jmesh.DATA_AXIS), mesh)
    ts = jmesh.replicate(mesh, jinit_ts(jspec, jax.tree.map(jnp.asarray, jp),
                                        jax.tree.map(jnp.asarray, js), opt))
    for i, b in enumerate(batches):
        ts, m = pstep(ts, *jmesh.shard_batch(mesh, *map(jnp.asarray, b)))
        for r in ranks:
            assert r["metrics"][i]["total"] == pytest.approx(
                float(m["total"]), rel=2e-4)
            assert r["metrics"][i]["grad_norm"] == pytest.approx(
                float(m["grad_norm"]), rel=2e-3)
    assert int(ts.step) == ranks[0]["step"] == STEPS
    want = np.asarray(ts.params["layer_000"]["kernel"]).transpose(3, 2, 0, 1)
    np.testing.assert_allclose(ranks[0]["params"]["layer_000"]["kernel"],
                               want, rtol=2e-3, atol=2e-5)


def test_dp_step_matches_one_process_whole_batch(dp_run):
    _, jp, js, batches, ranks = dp_run
    metrics, (params, state) = _port_one_process(jp, js, batches)
    for got, want in zip(ranks[0]["metrics"], metrics):
        assert got["total"] == pytest.approx(want["total"], rel=2e-4)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=2e-3)
    for key, p in params.items():
        for name, t in p.items():
            np.testing.assert_allclose(ranks[0]["params"][key][name],
                                       t.numpy(), rtol=2e-3, atol=2e-5,
                                       err_msg=f"{key}.{name}")
    for key, s in state.items():
        for name, t in s.items():
            np.testing.assert_allclose(ranks[0]["state"][key][name],
                                       t.numpy(), rtol=2e-3, atol=2e-5)


def test_dp_params_stay_bit_equal_across_ranks(dp_run):
    ranks = dp_run[-1]
    assert [r["step"] for r in ranks] == [STEPS, STEPS]
    for tree in ("params", "state"):
        for key, d in ranks[0][tree].items():
            for name, t in d.items():
                assert torch.equal(t, ranks[1][tree][key][name]), key + name
    assert ranks[0]["metrics"] == ranks[1]["metrics"]


def test_device_aug_step_is_the_step_on_augmented_images():
    """The device_aug step equals the plain step on ``augment_batch``'s
    output under the generator the step draws from; two steps give finite
    losses."""
    jspec = jbuild(jparse(TINY), img_size=IMG)
    jp, js = _jax_weights(jspec, seed=3)
    spec = build_network(parse_model_cfg(TINY), img_size=IMG)
    imgs, t, v = (torch.from_numpy(a) for a in _global_batch(5))
    hyp = Hyp(degrees=60.0)

    def state():
        return init_train_state(spec, *wio.params_from_numpy(jp, js),
                                sched.darknet_schedule(LR, burn_in=1),
                                device="cpu")

    ts_aug, ts_plain = state(), state()
    aug_step = make_train_step(spec, hyp, device_aug=True, aug_seed=7)
    plain_step = make_train_step(spec, hyp)
    for _ in range(2):
        x, ta, va = tad.augment_batch(
            aug_generator(torch.device("cpu"), 7, ts_plain.step), imgs / 255.0,
            t, v, hyp)
        assert not torch.equal(ta, t)
        want = plain_step(ts_plain, x * 255.0, ta, va)
        got = aug_step(ts_aug, imgs, t, v)
        assert torch.isfinite(got["total"])
        for k in want:
            assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5,
                                                  abs=1e-7), k
    assert ts_aug.step == 2
    for a, b in zip(ts_aug.net.parameters(), ts_plain.net.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_dryrun_multichip_on_two_cpu_ranks():
    assert np.isfinite(dryrun_multichip(2, "cpu", timeout=SPAWN_TIMEOUT))


def test_error_paths():
    x = torch.zeros(6, 2)
    assert [s.shape[0] for s in shard_batch(1, 3, x, x)] == [2, 2]
    assert torch.equal(shard_batch(1, 2, torch.arange(4))[0],
                       torch.tensor([2, 3]))
    with pytest.raises(ValueError, match="divisible"):
        shard_batch(0, 4, x)
    assert make_mesh(3, "cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError):
        make_mesh(0, "cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py checks the "
                    "refusal past device_count() there")
    with pytest.raises(ValueError, match="requested 2 devices, have 0"):
        make_mesh(2, "cuda")


# ------------------------------ serving -----------------------------------

@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Seeded JAX weights with non-trivial BN state as a .weights file."""
    path = str(tmp_path_factory.mktemp("dp") / "tiny.weights")
    jspec = jbuild(jparse(TINY), img_size=128)
    save_darknet_weights(jspec, *_jax_weights(jspec, seed=5), path)
    return path


def _detectors(weights, devices, **kw):
    kw = dict(weights=weights, img_size=128, conf_thres=0.2, nms_thres=0.4,
              max_det=32, **kw)
    return (Detector(TINY, devices=devices, approx_top_k=False,
                     device="cpu", **kw),
            JDetector(TINY, devices=devices, approx_top_k=False,
                      iou_matrix_fn=skew_iou_matrix_green,
                      bake_params=False, **kw))


def test_detector_devices_matches_one_device_and_jax(weights):
    """As tests/test_end2end.py's multi-device test: B = 8 over 2 replicas
    against one device and against the JAX Detector(devices=2); an
    indivisible batch raises on both."""
    imgs = np.random.default_rng(7).integers(0, 255, (8, 128, 128, 3),
                                             dtype=np.uint8)
    det2, jdet2 = _detectors(weights, 2)
    det1 = Detector(TINY, weights=weights, img_size=128, conf_thres=0.2,
                    nms_thres=0.4, max_det=32, approx_top_k=False,
                    device="cpu")
    assert len(det2.mesh) == 2 and len(det2.nets) == 2
    d1, m1 = det1(imgs)
    d2, m2 = det2(imgs)
    assert int(m1.sum()) > 8
    assert torch.equal(m1, m2)
    torch.testing.assert_close(d2, d1, rtol=0, atol=1e-5)
    jd, jm = jdet2(imgs)
    np.testing.assert_array_equal(m2.numpy(), np.asarray(jm))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd), rtol=1e-3,
                               atol=1e-3)
    with pytest.raises(AssertionError, match="divisible"):
        jdet2(imgs[:5])
    with pytest.raises(ValueError, match="divisible"):
        det2(imgs[:5])


def _scene(h, w, seed=0):
    """tests/test_device_tiles.py's scene: bright rotated rectangles."""
    import cv2

    rng = np.random.default_rng(seed)
    img = rng.integers(20, 60, (h, w, 3)).astype(np.uint8)
    for _ in range(12):
        cx, cy = rng.uniform(50, w - 50), rng.uniform(50, h - 50)
        bw, bh = rng.uniform(60, 160), rng.uniform(30, 80)
        deg = rng.uniform(-90, 90)
        pts = cv2.boxPoints(((cx, cy), (bw, bh), deg)).astype(np.int32)
        cv2.fillPoly(img, [pts], (230, 230, 230))
    return img


def test_tile_sharding_matches_single_device(weights):
    """The 700 x 900 scene at sub 384 / gap 128 gives 12 tiles; N = 8
    replicas pad them to 16."""
    img = _scene(700, 900, seed=7)
    det1 = Detector(TINY, weights=weights, img_size=128, conf_thres=0.2,
                    max_det=32, device="cpu")
    det8 = Detector(TINY, weights=weights, img_size=128, conf_thres=0.2,
                    max_det=32, devices=8, device="cpu")
    kw = dict(subsize=384, gap=128, merge_nms_thres=0.3, max_merged=256)
    single, sharded = (DeviceTilePipeline(d, **kw) for d in (det1, det8))
    assert single.num_tiles(700, 900) == 12
    lb = sharded.letterbox_tiles(sharded.upload(img))[0]
    assert lb.shape[0] == 16
    d1, m1 = single(img)
    d8, m8 = sharded(img)
    assert m1.sum() >= 5
    np.testing.assert_array_equal(m1, m8)
    np.testing.assert_allclose(d8, d1, rtol=0, atol=1e-5)


# ------------------------------ the CLIs ----------------------------------

def _dataset(tmp_path, n=4):
    list_path = make_synthetic_dataset(str(tmp_path / "ds"), n_images=n,
                                       img_size=(64, 64), n_boxes=(1, 3),
                                       seed=2)
    data = tmp_path / "ds.data"
    data.write_text(f"classes=1\ntrain={list_path}\n")
    return str(data)


def test_train_cli_devices_matches_root_train_py(tmp_path):
    """One epoch of 2 global steps (B = 2, one image per rank) from the same
    --weights: results.txt's loss columns within the CLI tolerance (2e-4)
    of the root train.py with --devices 2 on the virtual mesh. Each rank
    normalises its loss over its own positives, as the reference's pmean
    of per-device losses, so the one-device run is not the reference
    here."""
    sys.path.insert(0, ROOT)
    import train as root_train

    jspec = jbuild(jparse(TINY), img_size=IMG)
    wpath = str(tmp_path / "init.weights")
    save_darknet_weights(jspec, *_jax_weights(jspec, seed=9), wpath)
    data = _dataset(tmp_path)
    args = ["--cfg", TINY, "--data", data, "--epochs", "1",
            "--batch-size", "2", "--img-size", str(IMG), "--max-gt", "8",
            "--burn-in", "2", "--no-augment", "--no-tensorboard",
            "--no-eval", "--weights", wpath, "--seed", "0", "--devices", "2"]
    root_train.train(root_train.make_parser().parse_args(
        args + ["--out-dir", str(tmp_path / "j")]))
    train_pkg.train(train_pkg.make_parser().parse_args(
        args + ["--out-dir", str(tmp_path / "p"), "--device", "cpu"]))
    rows = [np.loadtxt(str(tmp_path / d / "results.txt"))
            for d in ("j", "p")]
    np.testing.assert_allclose(rows[1][1:6], rows[0][1:6], rtol=0,
                               atol=2e-4)
    assert rows[1][5] > 0
    for name in ("last.pt", "last.weights", "ckpt/1.pt"):
        assert (tmp_path / "p" / name).exists(), name
