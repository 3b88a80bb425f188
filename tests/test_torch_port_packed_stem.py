"""The port's packed stem (``models/packed_stem.py``) and
``Detector(packed_stem=True)`` against the JAX package on the CPU.

The counterpart of ``tests/test_packed_stem.py``, on the HRSC cfg at 96²
with randomised BN statistics. Tolerances: the packed kernels and biases
bit-equal to the JAX ``pack_stem``'s after the HWIO -> OIHW transpose (the
same f32 products, scattered); layer-1 output 1e-5 of the canonical stem
(float reassociation); the heads 1e-4 of the JAX ``apply_fused`` on the
packed spec; detections 1e-3, masks exact (the reference test's).
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rotate_yolov3_tpu.config.parse import parse_model_cfg as jparse
from rotate_yolov3_tpu.detector import Detector as JaxDetector
from rotate_yolov3_tpu.models import apply_fused
from rotate_yolov3_tpu.models import build_network as jbuild
from rotate_yolov3_tpu.models import can_pack_stem as jcan_pack_stem
from rotate_yolov3_tpu.models import fuse_bn as jfuse_bn
from rotate_yolov3_tpu.models import init_params as jinit
from rotate_yolov3_tpu.models import pack_stem as jpack_stem
from rotate_yolov3_tpu.models.weights_io import save_darknet_weights
from rotate_yolov3_tpu.ops.skew_iou_green import skew_iou_matrix_green
from rotate_yolov3_tpu_torch.config.parse import parse_model_cfg
from rotate_yolov3_tpu_torch.detector import Detector
from rotate_yolov3_tpu_torch.models.darknet import (FusedDarknet, _activate,
                                                    _conv2d, build_network,
                                                    layer_key)
from rotate_yolov3_tpu_torch.models.packed_stem import (can_pack_stem,
                                                        pack_stem)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "cfg/yolov3-rotate-hrsc.cfg")
IMG = 96


def _jax_fused(img=IMG):
    """The JAX spec and its BN-fused params (numpy), BN statistics
    randomised as ``tests/test_packed_stem.py`` does."""
    spec = jbuild(jparse(CFG), img_size=img)
    params, state = jinit(spec, jax.random.PRNGKey(3))
    state = jax.tree.map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(4),
                                               a.shape), state)
    state = {k: {"bn_mean": v["bn_mean"],
                 "bn_var": jnp.abs(v["bn_var"]) + 0.1}
             for k, v in state.items()}
    return spec, jax.tree.map(np.asarray, jfuse_bn(spec, params, state))


def _port_fused(jfused):
    """The same fused values in the port's layout (OIHW kernels)."""
    return {k: {"kernel": torch.from_numpy(np.ascontiguousarray(
                    v["kernel"].transpose(3, 2, 0, 1))),
                "bias": torch.from_numpy(v["bias"].copy())}
            for k, v in jfused.items()}


def _spec(img=IMG):
    return build_network(parse_model_cfg(CFG), img_size=img)


@pytest.mark.parametrize("cfg,img_size", [
    *((os.path.basename(p), None)
      for p in sorted(glob.glob(os.path.join(ROOT, "cfg", "*.cfg")))),
    ("yolov3-rotate-hrsc.cfg", 97),          # odd input: no packed form
])
def test_can_pack_stem_matches_jax(cfg, img_size):
    path = os.path.join(ROOT, "cfg", cfg)
    got = can_pack_stem(build_network(parse_model_cfg(path), img_size))
    assert got == jcan_pack_stem(jbuild(jparse(path), img_size))
    if img_size == 97:
        assert not got


@pytest.mark.parametrize("input_scale", [1.0, 1.0 / 255.0])
def test_pack_stem_kernels_bit_equal_jax(input_scale):
    jspec, jfused = _jax_fused()
    fused = _port_fused(jfused)
    jpspec, jpfused = jpack_stem(jspec, jfused, input_scale=input_scale)
    pspec, pfused = pack_stem(_spec(), fused, input_scale=input_scale)
    assert tuple(pfused[layer_key(0)]["kernel"].shape) == (128, 3, 4, 4)
    assert tuple(pfused[layer_key(1)]["kernel"].shape) == (64, 128, 2, 2)
    for i in (0, 1):
        key = layer_key(i)
        np.testing.assert_array_equal(
            pfused[key]["kernel"].numpy(),
            np.asarray(jpfused[key]["kernel"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(pfused[key]["bias"].numpy(),
                                      np.asarray(jpfused[key]["bias"]))
        assert (pspec.layers[i].size, pspec.layers[i].stride,
                pspec.layers[i].pad) == (jpspec.layers[i].size,
                                         jpspec.layers[i].stride,
                                         jpspec.layers[i].pad)
    # later layers are shared, not copied
    assert pfused[layer_key(2)]["kernel"] is fused[layer_key(2)]["kernel"]
    assert pspec.layers[2:] == _spec().layers[2:]


def _stem(spec, fused, x):
    for layer in spec.layers[:2]:
        e = fused[layer_key(layer.index)]
        x = _activate(_conv2d(layer, x, e["kernel"], e["bias"]),
                      layer.activation)
    return x


def test_packed_stem_layer1_output_matches_canonical():
    """The s2d layout never leaves the kernels: layer 1 equals the
    canonical stem's, on inputs with content up to the edges."""
    _, jfused = _jax_fused()
    spec, fused = _spec(), _port_fused(jfused)
    pspec, pfused = pack_stem(spec, fused)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (2, 3, IMG, IMG)).astype(np.float32))
    ref, packed = _stem(spec, fused, x), _stem(pspec, pfused, x)
    assert ref.shape == packed.shape == (2, 64, IMG // 2, IMG // 2)
    torch.testing.assert_close(packed, ref, rtol=1e-5, atol=1e-5)


def test_packed_network_heads_match_jax():
    jspec, jfused = _jax_fused()
    jpspec, jpfused = jpack_stem(jspec, jfused)
    pspec, pfused = pack_stem(_spec(), _port_fused(jfused))
    x = np.random.default_rng(1).uniform(0, 1, (1, IMG, IMG, 3)
                                         ).astype(np.float32)
    want = apply_fused(jpspec, jpfused, jnp.asarray(x))
    got = FusedDarknet(pspec, pfused)(torch.from_numpy(x))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("layer,size", [(0, IMG), (0, 608), (1, IMG)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_conv_padding_equals_explicit_pad(layer, size, dtype):
    """conv0' runs with the symmetric pad 1 (no ``F.pad``) and conv1' with
    pad 1 and its last row and column dropped: both equal the explicit
    one-sided pad of the spec bit for bit."""
    _, jfused = _jax_fused()
    pspec, pfused = pack_stem(_spec(), _port_fused(jfused))
    spec_l = pspec.layers[layer]
    e = pfused[layer_key(layer)]
    w = e["kernel"].to(dtype).contiguous(memory_format=torch.channels_last)
    b = e["bias"].to(dtype)
    side = size if layer == 0 else size // 2
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 255, (1, spec_l.in_c, side, side)).astype(np.float32)).to(
            dtype).contiguous(memory_format=torch.channels_last)
    (top, bottom), (left, right) = spec_l.pad
    want = F.conv2d(F.pad(x, (left, right, top, bottom)), w, b,
                    spec_l.stride)
    got = _conv2d(spec_l, x, w, b)
    assert got.shape == want.shape == (1, spec_l.out_c, size // 2, size // 2)
    assert torch.equal(got, want)


def _write_weights(path, img=IMG, seed=7):
    """Seeded JAX params with non-trivial BN statistics -> .weights."""
    spec = jbuild(jparse(CFG), img_size=img)
    params, state = jinit(spec, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    state = {k: {"bn_mean": jnp.asarray(rng.normal(0, 0.05, v["bn_mean"].shape)
                                        .astype(np.float32)),
                 "bn_var": jnp.asarray(rng.uniform(0.8, 1.2, v["bn_var"].shape)
                                       .astype(np.float32))}
             for k, v in state.items()}
    save_darknet_weights(spec, params, state, path)


def test_packed_detector_matches_jax_and_canonical(tmp_path):
    """Product level: the port's packed Detector against the JAX packed
    Detector and against the port's canonical one, f32."""
    wpath = str(tmp_path / "w.weights")
    _write_weights(wpath)
    kw = dict(weights=wpath, img_size=IMG, conf_thres=1e-4, max_det=32)
    packed = Detector(CFG, packed_stem=True, device="cpu", **kw)
    canon = Detector(CFG, device="cpu", **kw)
    jdet = JaxDetector(CFG, packed_stem=True, approx_top_k=False,
                       iou_matrix_fn=skew_iou_matrix_green,
                       bake_params=False, **kw)
    assert packed.packed_stem and jdet.packed_stem
    assert packed.net.spec.layers[0].size == 4
    assert packed.spec == canon.spec       # training and IO stay canonical
    imgs = np.random.default_rng(2).integers(0, 256, (2, IMG, IMG, 3),
                                             dtype=np.uint8)
    dets, mask = (t.numpy() for t in packed(imgs))
    jdets, jmask = (np.asarray(t) for t in jdet(jnp.asarray(imgs)))
    cdets, cmask = (t.numpy() for t in canon(imgs))
    assert mask.sum() >= 10
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_allclose(dets, jdets, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(mask, cmask)
    np.testing.assert_allclose(dets, cdets, rtol=1e-3, atol=1e-3)


def test_packed_detector_two_replicas_equal_one(tmp_path):
    wpath = str(tmp_path / "w.weights")
    _write_weights(wpath, seed=5)
    imgs = np.random.default_rng(3).integers(0, 256, (4, IMG, IMG, 3),
                                             dtype=np.uint8)
    one, two = (Detector(CFG, weights=wpath, img_size=IMG, conf_thres=0.05,
                         max_det=32, packed_stem=True, devices=n,
                         device="cpu")(imgs) for n in (0, 2))
    assert int(one[1].sum()) > 0
    assert torch.equal(one[1], two[1])
    torch.testing.assert_close(two[0], one[0], rtol=0, atol=1e-5)


def test_detector_defaults_to_canonical_stem():
    for dtype in (torch.float32, torch.bfloat16):
        det = Detector(CFG, img_size=IMG, compute_dtype=dtype, device="cpu")
        assert not det.packed_stem
        assert det.net.spec is det.spec
        assert det.net.spec.layers[0].size == 3
