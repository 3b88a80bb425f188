"""PyTorch port, third slice, path by path against the JAX package on the
CPU: the decoded-input ``non_max_suppression`` (with and without an IoU
hook) and the serving options ``iou_algo``, ``iou_matrix_fn`` and
``decode_kernel`` (with ``fused_greedy``) of ``Detector`` and
``non_max_suppression_fused``.

The JAX side takes its TPU branch where the port's card path runs a kernel:
the Pallas kernels run in interpret mode, composed as the reference's TPU
branch composes them (``_jax_tpu_branch``). On the CPU the port's wrappers
take their plain versions; ``chip_smoke.py`` phase 12 runs the same paths
through the CUDA kernels. Inputs are seeded numpy, shared by both sides.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rotate_yolov3_tpu.config.parse import parse_model_cfg as jparse
from rotate_yolov3_tpu.models import yolo_head as jyh
from rotate_yolov3_tpu.models.darknet import build_network as jbuild
from rotate_yolov3_tpu.models.darknet import init_params as jinit
from rotate_yolov3_tpu.models.weights_io import save_darknet_weights
from rotate_yolov3_tpu.ops.decode_pallas import decode_rows_pallas
from rotate_yolov3_tpu.ops.decode_pallas import heads_meta as jheads_meta
from rotate_yolov3_tpu.ops.nms_pallas import nms_greedy_pallas
from rotate_yolov3_tpu.ops.rotated_nms import _nms_keep as jax_nms_keep
from rotate_yolov3_tpu.ops.rotated_nms import \
    greedy_suppress_fixpoint_kill as jax_fixpoint_kill
from rotate_yolov3_tpu.ops.rotated_nms import \
    non_max_suppression as jax_nms
from rotate_yolov3_tpu.ops.skew_iou import skew_iou_matrix as jax_argsort
from rotate_yolov3_tpu.ops.skew_iou_pallas import (skew_iou_matrix_pallas,
                                                   skew_kill_matrix_pallas)
from rotate_yolov3_tpu.ops.topk import select_topk as jax_select_topk
from rotate_yolov3_tpu_torch.config.parse import parse_model_cfg
from rotate_yolov3_tpu_torch.detector import Detector
from rotate_yolov3_tpu_torch.models.darknet import build_network
from rotate_yolov3_tpu_torch.ops.rotated_nms import (
    greedy_suppress, greedy_suppress_fixpoint, non_max_suppression,
    non_max_suppression_fused)
from rotate_yolov3_tpu_torch.ops.skew_iou import skew_iou_matrix as argsort
from rotate_yolov3_tpu_torch.ops.skew_iou_cuda import (
    skew_iou_matrix, skew_iou_matrix_auto_nms)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(ROOT, "cfg/yolov3-tiny-rotate-hrsc.cfg")
DOTA_CFG = os.path.join(ROOT, "cfg/yolov3-rotate-dota.cfg")
OPT_THR = 0.15  # NMS threshold of the option tests: suppresses at 64 px


def _random_boxes(rng, n, spread=60.0):
    return np.stack([
        rng.uniform(0, spread, n), rng.uniform(0, spread, n),
        rng.uniform(5, 30, n), rng.uniform(5, 30, n),
        rng.uniform(-np.pi, np.pi, n)], axis=1).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# --------------------------------------------------------------------------
# the decoded-input NMS and the greedy passes
# --------------------------------------------------------------------------

def test_greedy_suppress_equals_fixpoint():
    rng = np.random.default_rng(6)
    iou = rng.uniform(0, 0.6, (3, 40, 40)).astype(np.float32)
    valid = rng.uniform(size=(3, 40)) > 0.2
    a = greedy_suppress(_t(iou), _t(valid), 0.45)
    b = greedy_suppress_fixpoint(_t(iou), _t(valid), 0.45)
    assert torch.equal(a, b) and 0 < int(a.sum()) < int(valid.sum())


def _decoded_preds(nc, seed=7, b=2, n=300):
    """Decoded (B, N, 6+nc) rows with distinct scores."""
    rng = np.random.default_rng(seed)
    boxes = np.stack([_random_boxes(rng, n, 150.0) for _ in range(b)])
    obj = rng.uniform(0.0, 1.0, (b, n, 1))
    cls = rng.uniform(0.0, 1.0, (b, n, max(nc, 1)))
    return np.concatenate([boxes, obj, cls], -1).astype(np.float32)


@pytest.mark.parametrize("hook,nc", [("none", 1), ("none", 4),
                                     ("argsort", 4), ("kernel_e", 1)])
def test_non_max_suppression_matches_jax(hook, nc):
    """The decoded-input entry == the JAX ``non_max_suppression`` on the
    same predictions: without a hook the port's kill mask (plain kernel B)
    against the reference's CPU oracle, or both sides through the argsort
    oracle, or kernel E's plain version against skew_iou_matrix_pallas
    (interpret). Keep and classes exact, boxes and scores bit for bit."""
    pred = _decoded_preds(nc)
    kw = dict(conf_thres=0.3, nms_thres=0.35, max_det=64)
    jfn = {"none": None, "argsort": jax_argsort,
           "kernel_e": functools.partial(skew_iou_matrix_pallas,
                                         interpret=True)}[hook]
    tfn = {"none": None, "argsort": argsort,
           "kernel_e": skew_iou_matrix}[hook]
    jd, jm = jax_nms(jnp.asarray(pred), iou_matrix_fn=jfn, **kw)
    td, tm = non_max_suppression(_t(pred), iou_matrix_fn=tfn, **kw)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    score = pred[..., 5] * pred[..., 6:].max(-1)
    passing = np.minimum((score > kw["conf_thres"]).sum(-1), 64)
    assert (tm.sum(-1).numpy() >= 10).all()
    assert (tm.sum(-1).numpy() < passing).all()     # NMS suppressed some


# --------------------------------------------------------------------------
# the serving options against the reference's TPU branch
# --------------------------------------------------------------------------

def _jax_tpu_branch(heads, specs, conf, thr, max_det, algo="green",
                    decode_kernel=False, fused_greedy=False,
                    iou_matrix_fn=None):
    """``rotate_yolov3_tpu.ops.rotated_nms.non_max_suppression_fused`` as
    its TPU branch runs (rotated_nms.py:259-334), the Pallas kernels in
    interpret mode; field-major heads, exact top-k."""
    jh = [jnp.asarray(h) for h in heads]
    scores = jnp.concatenate([jyh.head_scores(r, s, field_major=True)
                              for r, s in zip(jh, specs)], axis=1)
    ranked = jnp.where(scores >= conf, scores, 0.0)
    k = min(max_det, scores.shape[1])
    top_s, top_i = jax_select_topk(ranked, k, False)
    valid = top_s > max(conf, 0.0)
    na, no, nc = specs[0].na, specs[0].no, specs[0].num_classes
    if decode_kernel and iou_matrix_fn is None:
        cells = jnp.concatenate([r.reshape(r.shape[0], -1, na * no)
                                 for r in jh], axis=1)
        aos = decode_rows_pallas(cells, top_i, valid,
                                 jheads_meta(specs, [r.shape for r in jh]),
                                 na=na, nc=nc, field_major=True,
                                 interpret=True)
        boxes, cls = aos[..., :5], aos[..., 5].astype(jnp.int32)
    else:
        rows = jyh.decode_gathered(jh, specs, top_i, field_major=True)
        boxes = jnp.where(valid[..., None], rows[..., :5], 0.0)
        cls = (jnp.argmax(rows[..., 6:], axis=-1) if nc > 1
               else jnp.zeros(rows.shape[:2], jnp.int32))
    if fused_greedy and iou_matrix_fn is None:
        keep = nms_greedy_pallas(boxes, cls if nc > 1 else None, valid,
                                 iou_thr=thr, interpret=True, algo=algo)
    else:
        keeps = []
        for i in range(boxes.shape[0]):
            if iou_matrix_fn is None:
                kill = skew_kill_matrix_pallas(
                    boxes[i], cls[i] if nc > 1 else None, iou_thr=thr,
                    interpret=True, algo=algo)
                keeps.append(jax_fixpoint_kill(kill != 0, valid[i]))
            else:
                keeps.append(jax_nms_keep(iou_matrix_fn, boxes[i], cls[i],
                                          valid[i], thr, use_cls=nc > 1))
        keep = jnp.stack(keeps)
    out = jnp.concatenate([boxes, top_s[..., None],
                           cls[..., None].astype(jnp.float32)], axis=-1)
    return np.asarray(jnp.where(keep[..., None], out, 0.0)), \
        np.asarray(keep)


@pytest.fixture(scope="module")
def detectors(tmp_path_factory):
    """Port detectors on the CPU, the tiny HRSC cfg (nc = 1) and the DOTA
    cfg (nc = 15) at 64 px, loading seeded JAX params with non-trivial BN
    statistics (``.weights``), each with the heads of two seeded images and
    a conf threshold that passes ~40 candidates per image with a margin
    from its neighbours."""
    out = {}
    rng = np.random.default_rng(8)
    for name, cfg in (("tiny", TINY_CFG), ("dota", DOTA_CFG)):
        wpath = str(tmp_path_factory.mktemp(name) / "w.weights")
        _write_weights(cfg, 64, wpath, seed=5)
        det = Detector(cfg, weights=wpath, img_size=64, max_det=32,
                       device="cpu")
        imgs = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
        heads = [h.numpy() for h in det.heads(imgs)]
        raw = det.predict_raw(imgs).numpy()
        score = np.sort((raw[..., 5] * raw[..., 6:].max(-1)).reshape(-1))
        score = score[::-1]
        cut = 60 + int(np.argmax(score[60:100] - score[61:101]))
        conf = float(0.5 * (score[cut] + score[cut + 1]))
        assert score[cut] - score[cut + 1] > 1e-5
        specs = jbuild(jparse(cfg), img_size=64).yolo_specs
        out[name] = (cfg, wpath, imgs, heads, conf, specs)
    return out


def _write_weights(cfg, img_size, path, seed):
    """Seeded JAX params with BN statistics off their identity values,
    written as a darknet .weights file."""
    spec = jbuild(jparse(cfg), img_size=img_size)
    params, state = jinit(spec, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    state = {k: {"bn_mean": jnp.asarray(rng.normal(0, 0.05, v["bn_mean"].shape)
                                        .astype(np.float32)),
                 "bn_var": jnp.asarray(rng.uniform(0.8, 1.2, v["bn_var"].shape)
                                       .astype(np.float32))}
             for k, v in state.items()}
    save_darknet_weights(spec, params, state, path)


@pytest.mark.parametrize("name,kw", [
    ("tiny", {"iou_algo": "green2"}),
    ("dota", {"iou_algo": "candidates"}),
    ("dota", {"iou_matrix_fn": "auto_nms"}),
    ("tiny", {"iou_matrix_fn": "kernel_e"}),
])
def test_detector_options_match_jax_tpu_branch(detectors, name, kw):
    """``Detector(iou_algo=...)`` and ``Detector(iou_matrix_fn=...)`` on the
    CPU == the reference's TPU branch on the same heads: kill kernel
    (interpret) with that algo, or the hook. ``skew_iou_matrix_auto_nms``
    takes the argsort oracle on the CPU, as the reference does off the
    TPU; kernel E's plain version stands against the Pallas kernel."""
    cfg, wpath, imgs, heads, conf, specs = detectors[name]
    hook = kw.get("iou_matrix_fn")
    port_hook = {"auto_nms": skew_iou_matrix_auto_nms,
                 "kernel_e": skew_iou_matrix, None: None}[hook]
    jax_hook = {"auto_nms": jax_argsort,
                "kernel_e": functools.partial(skew_iou_matrix_pallas,
                                              interpret=True),
                None: None}[hook]
    algo = kw.get("iou_algo", "green")
    det = Detector(cfg, weights=wpath, img_size=64, max_det=32,
                   conf_thres=conf, nms_thres=OPT_THR, iou_algo=algo,
                   iou_matrix_fn=port_hook, device="cpu")
    dets, mask = det(imgs)
    want, wkeep = _jax_tpu_branch(heads, specs, conf, OPT_THR, 32, algo=algo,
                                  iou_matrix_fn=jax_hook)
    np.testing.assert_array_equal(mask.numpy(), wkeep)
    np.testing.assert_allclose(dets.numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(dets.numpy()[..., 6], want[..., 6])
    assert 5 <= int(mask.sum()) < 64


@pytest.mark.parametrize("algo,fused", [("green", False), ("green", True),
                                        ("green2", True),
                                        ("candidates", False)])
def test_decode_kernel_matches_jax_tpu_branch(detectors, algo, fused):
    """``non_max_suppression_fused(decode_kernel=True[, fused_greedy])`` ==
    the TPU branch with decode_rows_pallas and, fused, nms_greedy_pallas
    (both interpret), DOTA heads (nc = 15, class-aware)."""
    cfg, _, imgs, heads, conf, specs = detectors["dota"]
    tspecs = build_network(parse_model_cfg(cfg), img_size=64).yolo_specs
    dets, mask = non_max_suppression_fused(
        [_t(h) for h in heads], tspecs, conf_thres=conf, nms_thres=OPT_THR,
        max_det=32, approx_top_k=False, field_major=True, iou_algo=algo,
        fused_greedy=fused, decode_kernel=True)
    want, wkeep = _jax_tpu_branch(heads, specs, conf, OPT_THR, 32, algo=algo,
                                  decode_kernel=True, fused_greedy=fused)
    np.testing.assert_array_equal(mask.numpy(), wkeep)
    np.testing.assert_allclose(dets.numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(dets.numpy()[..., 6], want[..., 6])
    assert 5 <= int(mask.sum()) < 64
    # the hook overrides decode_kernel and fused_greedy
    hooked = non_max_suppression_fused(
        [_t(h) for h in heads], tspecs, conf_thres=conf, nms_thres=OPT_THR,
        max_det=32, approx_top_k=False, field_major=True, iou_algo=algo,
        fused_greedy=fused, decode_kernel=True, iou_matrix_fn=argsort)
    plain = non_max_suppression_fused(
        [_t(h) for h in heads], tspecs, conf_thres=conf, nms_thres=OPT_THR,
        max_det=32, approx_top_k=False, field_major=True,
        iou_matrix_fn=argsort)
    assert torch.equal(hooked[0], plain[0]) and torch.equal(hooked[1],
                                                            plain[1])
