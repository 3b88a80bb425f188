"""The PyTorch port's training path against the JAX package on the CPU.

Both packages see the same numpy inputs (weights through ``.weights`` files
or ``params_from_numpy``). Tolerances, each the f32 rounding of a sum
taken in another order, or of a transcendental in another library:
  * assignment: indices, masks and class ids exact; float targets 1e-6;
  * loss terms rtol 1e-5; ∂loss/∂heads atol 1e-6 + rtol 1e-4;
  * skew-IoU and its gradient on the degenerate pairs: 1e-5;
  * train-mode forward: heads and BN running stats 1e-4 (8-15 f32 conv
    layers of summation-order drift; PyTorch's BN reduces by Welford, the
    reference by E[y²] − E[y]²);
  * one train step, optax against torch.optim.SGD: loss terms and
    grad_norm rtol 1e-4, updated params and BN state atol 1e-5;
  * the schedules rtol 1e-6 (float32 pow in numpy and XLA);
  * the training CLI: results.txt loss columns (5 decimals) within 2e-4
    after one epoch of 2 steps;
  * ``.weights`` files byte-equal; ``.pt`` tensors equal; resume bit-equal.
"""

import math
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
from rotate_yolov3_tpu.models import weights_io as jwio
from rotate_yolov3_tpu.models.darknet import apply_network
from rotate_yolov3_tpu.models.darknet import build_network as jbuild
from rotate_yolov3_tpu.models.darknet import init_params as jinit
from rotate_yolov3_tpu.ops.skew_iou import skew_iou as jskew_iou
from rotate_yolov3_tpu.train import schedule as jsched
from rotate_yolov3_tpu.train.assign import build_targets as jbuild_targets
from rotate_yolov3_tpu.train.loss import compute_loss as jcompute_loss
from rotate_yolov3_tpu.train.trainer import (init_train_state as jinit_ts,
                                             make_optimizer as jmake_opt,
                                             make_train_step as jmake_step)
from rotate_yolov3_tpu_torch import train as train_pkg
from rotate_yolov3_tpu_torch.config.hyp import Hyp
from rotate_yolov3_tpu_torch.config.parse import parse_model_cfg
from rotate_yolov3_tpu_torch.data.datasets import img2label_path
from rotate_yolov3_tpu_torch.detector import Detector
from rotate_yolov3_tpu_torch.models import weights_io as wio
from rotate_yolov3_tpu_torch.models.darknet import (Darknet, build_network,
                                                    init_params)
from rotate_yolov3_tpu_torch.ops.skew_iou import skew_iou
from rotate_yolov3_tpu_torch.train import schedule as sched
from rotate_yolov3_tpu_torch.train.assign import build_targets
from rotate_yolov3_tpu_torch.train.loss import compute_loss
from rotate_yolov3_tpu_torch.train.trainer import (init_train_state,
                                                   load_checkpoint,
                                                   make_train_step,
                                                   save_checkpoint)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "cfg/yolov3-rotate-tiny.cfg")
IMG = 64


def _specs(img=IMG):
    return jbuild(jparse(TINY), img_size=img), \
        build_network(parse_model_cfg(TINY), img_size=img)


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


def _targets(b=2, g=6, seed=0, img=IMG, n_valid=(4, 2)):
    """(B, G, 6) normalized GT rows sized like the tiny cfg's anchors, with
    padding rows past n_valid[i]."""
    rng = np.random.default_rng(seed)
    t = np.zeros((b, g, 6), np.float32)
    v = np.zeros((b, g), bool)
    for i in range(b):
        n = n_valid[i % len(n_valid)]
        t[i, :n, 0] = 0
        t[i, :n, 1:3] = rng.uniform(0.15, 0.85, (n, 2))
        t[i, :n, 3] = rng.uniform(14, 40, n) / img
        t[i, :n, 4] = rng.uniform(8, 30, n) / img
        t[i, :n, 5] = rng.uniform(-math.pi / 2, math.pi / 2, n)
        v[i, :n] = True
    return t, v


def _heads(jspec, b=2, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    out = []
    for s in jspec.yolo_specs:
        g = IMG // s.stride
        out.append((rng.normal(0, scale, (b, g, g, s.na * s.no))
                    .astype(np.float32)))
    return out


# ------------------------------ assignment ---------------------------------

@pytest.mark.parametrize("img", [64, 96])
def test_build_targets_matches_jax(img):
    jspec, spec = _specs(img)
    t, v = _targets(b=3, g=8, seed=img, img=img, n_valid=(8, 3, 0))
    jt = jbuild_targets(jnp.asarray(t), jnp.asarray(v), jspec.yolo_specs,
                        img, 0.2)
    pt = build_targets(torch.from_numpy(t), torch.from_numpy(v),
                       spec.yolo_specs, img, 0.2)
    n_assigned = 0
    for a, b in zip(jt, pt):
        for name in ("flat_idx", "assigned", "tcls", "obj_target"):
            np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                          getattr(b, name).numpy(), name)
        for name in ("txy", "twh", "tangle", "tbox_abs"):
            np.testing.assert_allclose(getattr(b, name).numpy(),
                                       np.asarray(getattr(a, name)),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
        n_assigned += int(b.assigned.sum())
    assert n_assigned > 0


# ------------------------------ loss -----------------------------------

@pytest.mark.parametrize("rotated", [False, True])
def test_compute_loss_and_head_grads_match_jax(rotated):
    jspec, spec = _specs()
    t, v = _targets(seed=5)
    heads = _heads(jspec, seed=6)
    jhyp, hyp = JHyp(rotated_ignore=rotated), Hyp(rotated_ignore=rotated)

    def jloss(hs):
        return jcompute_loss(hs, jnp.asarray(t), jnp.asarray(v),
                             jspec.yolo_specs, IMG, jhyp)

    (jtotal, jcomp), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        [jnp.asarray(h) for h in heads])
    th = [torch.tensor(h, requires_grad=True) for h in heads]
    total, comp = compute_loss(th, torch.from_numpy(t), torch.from_numpy(v),
                               spec.yolo_specs, IMG, hyp)
    total.backward()
    for k in ("xy", "wh", "angle", "siou", "cls", "obj", "total"):
        np.testing.assert_allclose(comp[k].item(), float(jcomp[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert comp["siou"].item() > 0 and comp["xy"].item() > 0
    for g, jg in zip(th, jgrads):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(jg),
                                   rtol=1e-4, atol=1e-6)


def test_compute_loss_multiclass_matches_jax():
    """nc = 3 heads (one-hot class BCE) on a spec built from the tiny
    cfg's first head."""
    import dataclasses

    jspec, spec = _specs()
    jys = dataclasses.replace(jspec.yolo_specs[0], num_classes=3)
    ys = dataclasses.replace(spec.yolo_specs[0], num_classes=3)
    t, v = _targets(seed=8)
    t[..., 0] = np.random.default_rng(8).integers(0, 3, t.shape[:2])
    g = IMG // ys.stride
    h = np.random.default_rng(9).normal(
        0, 1, (2, g, g, ys.na * ys.no)).astype(np.float32)
    jtotal, jcomp = jcompute_loss([jnp.asarray(h)], jnp.asarray(t),
                                  jnp.asarray(v), [jys], IMG, JHyp())
    total, comp = compute_loss([torch.from_numpy(h)], torch.from_numpy(t),
                               torch.from_numpy(v), [ys], IMG, Hyp())
    for k in ("cls", "obj", "total"):
        np.testing.assert_allclose(float(comp[k]), float(jcomp[k]),
                                   rtol=1e-5, err_msg=k)


# ------------------------------ skew-IoU grads ------------------------------

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
def test_skew_iou_grad_matches_jax(case):
    """∂IoU/∂(both boxes) of the port's argsort skew_iou against jax.grad
    of the reference on degenerate pairs (trouble spots: minimum at ties,
    abs at zero, parallel edges)."""
    if _PAIRS[case] is None:
        rng = np.random.default_rng(11)
        a = np.stack([rng.uniform(20, 60, 16), rng.uniform(20, 60, 16),
                      rng.uniform(5, 30, 16), rng.uniform(5, 30, 16),
                      rng.uniform(-1.5, 1.5, 16)], -1)
        b = a + rng.normal(0, 4, a.shape) * [1, 1, 0.5, 0.5, 0.1]
    else:
        a, b = (np.asarray([x], np.float64) for x in _PAIRS[case])
    a, b = a.astype(np.float32), b.astype(np.float32)

    jiou, (ja, jb) = jax.value_and_grad(
        lambda x, y: jnp.sum(jskew_iou(x, y)), argnums=(0, 1))(
            jnp.asarray(a), jnp.asarray(b))
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    iou = skew_iou(ta, tb).sum()
    iou.backward()
    np.testing.assert_allclose(iou.item(), float(jiou), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-5)
    assert np.isfinite(ta.grad.numpy()).all()


# ------------------------------ schedules ----------------------------------

def test_schedules_match_jax():
    steps = np.arange(0, 2600, 7)
    pairs = [(jsched.darknet_schedule(0.01, 100, (1000, 2000), (0.1, 0.1)),
              sched.darknet_schedule(0.01, 100, (1000, 2000), (0.1, 0.1))),
             (jsched.darknet_schedule(1e-3, 1), sched.darknet_schedule(1e-3,
                                                                       1)),
             (jsched.cosine_schedule(0.01, 2000, 50),
              sched.cosine_schedule(0.01, 2000, 50))]
    for jf, f in pairs:
        want = np.array([float(jf(s)) for s in steps])
        got = np.array([f(int(s)) for s in steps])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ------------------------------ network -------------------------------------

def test_train_mode_forward_and_bn_state_match_jax():
    jspec, spec = _specs()
    jp, js = _jax_weights(jspec, seed=2)
    x = np.random.default_rng(3).uniform(0, 1, (2, IMG, IMG, 3)
                                         ).astype(np.float32)
    jheads, jstate = apply_network(jspec, jax.tree.map(jnp.asarray, jp),
                                   jax.tree.map(jnp.asarray, js),
                                   jnp.asarray(x), train=True)
    net = Darknet(spec, *wio.params_from_numpy(jp, js))
    net.train()
    heads = net(torch.from_numpy(x))
    for h, jh in zip(heads, jheads):
        np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh),
                                   rtol=1e-4, atol=1e-4)
    _, state = net.params_state()
    for key, s in state.items():
        for name in ("bn_mean", "bn_var"):
            np.testing.assert_allclose(s[name].numpy(),
                                       np.asarray(jstate[key][name]),
                                       rtol=1e-4, atol=1e-5)


def test_params_state_round_trip_and_eval_detector(tmp_path):
    """params_state() gives back the loaded dicts, and a Detector refreshed
    from a Darknet equals one loaded from its saved .weights."""
    jspec, spec = _specs()
    p, s = wio.params_from_numpy(*_jax_weights(jspec, seed=4))
    net = Darknet(spec, p, s)
    p2, s2 = net.params_state()
    for a, b in ((p, p2), (s, s2)):
        for key in a:
            for name in a[key]:
                assert torch.equal(a[key][name], b[key][name])
    wpath = str(tmp_path / "net.weights")
    wio.save_darknet_weights(spec, p2, s2, wpath)
    refreshed = Detector(TINY, img_size=IMG, conf_thres=0.05, device="cpu")
    refreshed.refresh_params(p2, s2)
    loaded = Detector(TINY, weights=wpath, img_size=IMG, conf_thres=0.05,
                      device="cpu")
    imgs = np.random.default_rng(5).integers(0, 256, (2, IMG, IMG, 3),
                                             dtype=np.uint8)
    (d0, m0), (d1, m1) = refreshed(imgs), loaded(imgs)
    assert int(m0.sum()) > 0
    assert torch.equal(m0, m1) and torch.equal(d0, d1)


# ------------------------------ one train step ----------------------------

def _jax_step(jspec, jp, js, batch, n_steps=1, lr=1e-2):
    sch = jsched.darknet_schedule(lr, burn_in=1)
    opt = jmake_opt(sch, momentum=0.9, weight_decay=5e-4)
    ts = jinit_ts(jspec, jax.tree.map(jnp.asarray, jp),
                  jax.tree.map(jnp.asarray, js), opt)
    step = jax.jit(jmake_step(jspec, opt, JHyp()))
    out = []
    for _ in range(n_steps):
        ts, m = step(ts, *(jnp.asarray(a) for a in batch))
        out.append({k: float(v) for k, v in m.items()})
    return ts, out


def _port_state(spec, jp, js, lr=1e-2):
    return init_train_state(spec, *wio.params_from_numpy(jp, js),
                            sched.darknet_schedule(lr, burn_in=1),
                            momentum=0.9, weight_decay=5e-4, device="cpu")


def _batch(seed=0, img=IMG):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (2, img, img, 3)).astype(np.uint8)
    t, v = _targets(seed=seed, img=img)
    return imgs, t, v


def test_train_step_matches_jax_optax():
    """Two steps (momentum in play): loss terms, grad_norm, updated params
    and BN running stats against the JAX step with optax."""
    jspec, spec = _specs()
    jp, js = _jax_weights(jspec, seed=1)
    batch = _batch(seed=2)
    jts, jmetrics = _jax_step(jspec, jp, js, batch, n_steps=2)
    ts = _port_state(spec, jp, js)
    step = make_train_step(spec, Hyp())
    for jm in jmetrics:
        m = step(ts, *(torch.from_numpy(a) for a in batch))
        for k in jm:
            np.testing.assert_allclose(float(m[k]), jm[k], rtol=1e-4,
                                       atol=1e-7, err_msg=k)
    assert ts.step == int(jts.step) == 2
    params, state = ts.net.params_state()
    jparams = jax.tree.map(np.asarray, jts.params)
    for key, p in params.items():
        for name, t in p.items():
            np.testing.assert_allclose(t.numpy(), jparams[key][name].transpose(
                3, 2, 0, 1) if name == "kernel" else jparams[key][name],
                rtol=1e-4, atol=1e-5, err_msg=f"{key}.{name}")
    for key, s in state.items():
        for name, t in s.items():
            np.testing.assert_allclose(t.numpy(),
                                       np.asarray(jts.state[key][name]),
                                       rtol=1e-4, atol=1e-5)


def test_optimizer_decays_kernels_only():
    jspec, spec = _specs()
    ts = _port_state(spec, *_jax_weights(jspec))
    decayed = {id(t) for g in ts.optimizer.param_groups
               if g["weight_decay"] > 0 for t in g["params"]}
    for key, conv in ts.net.convs.items():
        assert id(conv.weight) in decayed
        if conv.bias is not None:
            assert id(conv.bias) not in decayed
    for bn in ts.net.bns.values():
        assert id(bn.weight) not in decayed and id(bn.bias) not in decayed


def test_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path):
    jspec, spec = _specs()
    jp, js = _jax_weights(jspec, seed=3)
    batches = [_batch(seed=s) for s in (4, 5, 6)]
    step = make_train_step(spec, Hyp())

    def run(ts, bs):
        return [step(ts, *(torch.from_numpy(a) for a in b)) for b in bs]

    ref = _port_state(spec, jp, js)
    want = run(ref, batches)
    first = _port_state(spec, jp, js)
    run(first, batches[:2])
    save_checkpoint(str(tmp_path / "ckpt"), first, step=2)
    resumed = _port_state(spec, jp, js)
    assert load_checkpoint(str(tmp_path / "ckpt"), resumed) == 2
    assert resumed.step == 2
    got = run(resumed, batches[2:])
    for k in want[-1]:
        assert torch.equal(got[-1][k], want[-1][k]), k
    for a, b in zip(ref.net.state_dict().values(),
                    resumed.net.state_dict().values()):
        assert torch.equal(a, b)


def test_checkpoints_keep_the_newest(tmp_path):
    jspec, spec = _specs()
    ts = _port_state(spec, *_jax_weights(jspec))
    for s in range(1, 6):
        save_checkpoint(str(tmp_path), ts, step=s, keep=3)
    assert sorted(os.listdir(tmp_path)) == ["3.pt", "4.pt", "5.pt"]
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"), ts)


# ------------------------------ checkpoint interchange ----------------------

def test_weights_round_trip_byte_equal(tmp_path):
    """JAX .weights -> port load -> port save: the same bytes; and the
    port's writer on params_from_numpy equals the JAX writer."""
    jspec, spec = _specs()
    jp, js = _jax_weights(jspec, seed=7)
    jpath, ppath, qpath = (str(tmp_path / f"{n}.weights")
                           for n in ("j", "p", "q"))
    jwio.save_darknet_weights(jspec, jp, js, jpath, seen=1234)
    p0, s0 = init_params(spec)
    p, s, meta = wio.load_weights_file(spec, p0, s0, jpath)
    assert meta.seen == 1234 and meta.epoch == -1
    wio.save_darknet_weights(spec, p, s, ppath, seen=1234)
    wio.save_darknet_weights(spec, *wio.params_from_numpy(jp, js), qpath,
                             seen=1234)
    jbytes = open(jpath, "rb").read()
    assert open(ppath, "rb").read() == jbytes
    assert open(qpath, "rb").read() == jbytes


def test_torch_pt_round_trips_across_packages(tmp_path):
    jspec, spec = _specs()
    jp, js = _jax_weights(jspec, seed=8)
    p, s = wio.params_from_numpy(jp, js)
    # port writes, JAX reads
    wio.save_torch_pt(spec, p, s, str(tmp_path / "p.pt"), epoch=3)
    jp2, js2, jepoch = jwio.load_torch_pt(
        jspec, *jinit(jspec, jax.random.PRNGKey(1)), str(tmp_path / "p.pt"))
    assert jepoch == 3
    for key in jp:
        for name in jp[key]:
            np.testing.assert_array_equal(np.asarray(jp2[key][name]),
                                          jp[key][name])
    # JAX writes, port reads (through load_weights_file, by extension)
    jwio.save_torch_pt(jspec, jp, js, str(tmp_path / "j.pt"), epoch=5)
    p3, s3, meta = wio.load_weights_file(spec, *init_params(spec),
                                         str(tmp_path / "j.pt"))
    assert meta.epoch == 5 and meta.seen == 0
    for a, b in ((p, p3), (s, s3)):
        for key in a:
            for name in a[key]:
                assert torch.equal(a[key][name], b[key][name])
    # the two writers' state_dicts are equal
    sd_p = torch.load(str(tmp_path / "p.pt"), weights_only=False)["model"]
    sd_j = torch.load(str(tmp_path / "j.pt"), weights_only=False)["model"]
    assert list(sd_p) == list(sd_j)
    for k in sd_p:
        assert torch.equal(sd_p[k], sd_j[k]), k


def test_torch_pt_shape_mismatch_raises(tmp_path):
    jspec, spec = _specs()
    p, s = wio.params_from_numpy(*_jax_weights(jspec))
    wio.save_torch_pt(spec, p, s, str(tmp_path / "p.pt"))
    other = build_network(parse_model_cfg(
        os.path.join(ROOT, "cfg/yolov3-tiny-rotate-hrsc.cfg")), img_size=64)
    with pytest.raises(ValueError, match="conv layer"):
        wio.load_torch_pt(other, *init_params(other), str(tmp_path / "p.pt"))


# ------------------------------ the CLIs ----------------------------------

def _dataset(tmp_path, n=4, size=(64, 64), valid=False):
    list_path = make_synthetic_dataset(str(tmp_path / "ds"), n_images=n,
                                       img_size=size, n_boxes=(1, 3), seed=2)
    data = tmp_path / "ds.data"
    data.write_text(f"classes=1\ntrain={list_path}\n"
                    + (f"valid={list_path}\n" if valid else ""))
    return str(data)


def test_train_cli_matches_root_train_py(tmp_path):
    """One epoch of 2 steps from the same --weights: results.txt's loss
    columns within 2e-4 of the root train.py's."""
    sys.path.insert(0, ROOT)
    import train as root_train

    jspec, spec = _specs()
    wpath = str(tmp_path / "init.weights")
    jwio.save_darknet_weights(jspec, *_jax_weights(jspec, seed=9), wpath)
    data = _dataset(tmp_path)
    args = ["--cfg", TINY, "--data", data, "--epochs", "1",
            "--batch-size", "2", "--img-size", str(IMG), "--max-gt", "8",
            "--burn-in", "2", "--no-augment", "--no-tensorboard",
            "--no-eval", "--weights", wpath, "--seed", "0"]
    root_train.train(root_train.make_parser().parse_args(
        args + ["--out-dir", str(tmp_path / "j")]))
    train_pkg.train(train_pkg.make_parser().parse_args(
        args + ["--out-dir", str(tmp_path / "p"), "--device", "cpu"]))
    rows = [np.loadtxt(str(tmp_path / d / "results.txt"))
            for d in ("j", "p")]
    np.testing.assert_allclose(rows[1][1:6], rows[0][1:6], rtol=0,
                               atol=2e-4)
    assert rows[1][5] > 0


def test_train_cli_with_eval_writes_checkpoints(tmp_path):
    """The twin with its per-epoch eval on the CPU: results.txt, last/best
    .pt and .weights, the resume checkpoint; a Detector loaded from
    last.weights equals one loaded from last.pt; --resume continues."""
    data = _dataset(tmp_path, valid=True)
    out = tmp_path / "w"
    args = ["--cfg", TINY, "--data", data, "--epochs", "1",
            "--batch-size", "2", "--img-size", str(IMG), "--max-gt", "8",
            "--burn-in", "2", "--no-augment", "--no-tensorboard",
            "--conf-thres", "0.05", "--out-dir", str(out), "--device", "cpu"]
    best = train_pkg.train(train_pkg.make_parser().parse_args(args))
    assert 0.0 <= best <= 1.0
    for name in ("results.txt", "last.pt", "last.weights", "best.pt",
                 "best.weights", "metrics.csv", "ckpt/1.pt"):
        assert (out / name).exists(), name
    imgs = np.random.default_rng(0).integers(0, 256, (2, IMG, IMG, 3),
                                             dtype=np.uint8)
    dets = [Detector(TINY, weights=str(out / f), img_size=IMG,
                     conf_thres=0.05, device="cpu")(imgs)
            for f in ("last.weights", "last.pt")]
    assert torch.equal(dets[0][1], dets[1][1])
    assert torch.equal(dets[0][0], dets[1][0])
    train_pkg.train(train_pkg.make_parser().parse_args(
        args[:5] + ["2"] + args[6:] + ["--resume"]))
    lines = (out / "results.txt").read_text().splitlines()
    assert [ln.split()[0] for ln in lines] == ["0", "1"]


@pytest.mark.parametrize("flag", [["--devices", "2"], ["--device-aug"],
                                  ["--device", "cuda"]])
def test_train_cli_refuses_what_is_not_ported(tmp_path, flag):
    """``--device cuda`` without a card is refused. ``--devices 2`` on a
    dataset of one image repeated (so each rank's loss normalisation equals
    the whole batch's) gives the one-device results.txt within the CLI
    tolerance. ``--device-aug`` trains on augmented batches: finite losses,
    other than the unaugmented run's."""
    if flag == ["--device", "cuda"]:
        if torch.cuda.is_available():
            pytest.skip("a card is present: cuda is a valid device here")
        data = _dataset(tmp_path)
        with pytest.raises(RuntimeError):
            train_pkg.train(train_pkg.make_parser().parse_args(
                ["--cfg", TINY, "--data", data, "--epochs", "1",
                 "--out-dir", str(tmp_path / "w"), "--device", "cuda"]))
        return
    data = _dataset(tmp_path)
    if flag[0] == "--devices":
        with open(data) as f:
            list_path = f.read().split("train=")[1].split()[0]
        with open(list_path) as f:
            paths = f.read().split()
        for p in paths[1:]:
            for a, b in ((paths[0], p),
                         (img2label_path(paths[0]), img2label_path(p))):
                with open(a, "rb") as src, open(b, "wb") as dst:
                    dst.write(src.read())
    args = ["--cfg", TINY, "--data", data, "--epochs", "1",
            "--batch-size", "2", "--img-size", str(IMG), "--max-gt", "8",
            "--burn-in", "2", "--no-augment", "--no-tensorboard",
            "--no-eval", "--device", "cpu"]
    rows = []
    for extra, out in (([], "one"), (flag, "opt")):
        train_pkg.train(train_pkg.make_parser().parse_args(
            args + extra + ["--out-dir", str(tmp_path / out)]))
        rows.append(np.loadtxt(str(tmp_path / out / "results.txt")))
    assert np.isfinite(rows[1]).all() and rows[1][5] > 0
    if flag[0] == "--devices":
        np.testing.assert_allclose(rows[1][1:6], rows[0][1:6], rtol=0,
                                   atol=2e-4)
    else:
        assert not np.allclose(rows[1][1:6], rows[0][1:6], rtol=0,
                               atol=1e-3)
