"""The conv epilogue (``ops/conv_epilogue.py``) and the fused backbone walk
(``models/darknet.py``) on the CPU.

``conv_epilogue`` finishes a convolution's output in one pass: + bias, the
activation, + the residual of a [shortcut] that follows. Its CUDA kernel
runs only on the card (``chip_smoke.py`` phase 17 holds it to the plain
version there, bit for bit); on the CPU the wrapper takes the plain
version, ``conv_epilogue_ref``. Held here:

* the plain version against the forward as it ran before the epilogue
  (``F.conv2d`` with its bias, ``F.leaky_relu``, the walk's add) and
  against a numpy mirror of the kernel's arithmetic (f32 operations, a
  round to the dtype after each of the three steps), bit for bit, with
  NaN and +-inf planted (NaN in the same places);
* the same ops of the JAX package (``apply_fused``'s bias add,
  ``jax.nn.leaky_relu``, the shortcut add) on the same numpy inputs: f32
  bit for bit; bf16 within two bf16 roundings of the value (JAX multiplies
  by the slope rounded to bf16, 0.10009765625);
* ``FusedDarknet.forward`` (shortcuts fused into the conv before them) on
  a narrow net with the HRSC cfg's stem, shortcuts, an odd channel count,
  a route, an upsample and two heads of 126 lanes: bit-equal to the
  3-argument walk the bench's check (b) runs, to the forward as it ran
  before, and in f32 within 1e-4 of the JAX ``apply_fused``;
* ``Detector(packed_stem=True)``'s heads bit-equal to the forward as it
  ran before.

"The forward as it ran before" is ``F.conv2d`` with the bias and
``_activate`` per conv layer, walked with the 3-argument ``_walk``. In f32
it is that code as it stands; in bf16 it is that code as the card runs it
(the convolution, then ``output.add_(bias)``): the CPU's bf16 convolution
adds the bias before its one rounding, the card's after.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rotate_yolov3_tpu.config.parse import parse_model_cfg as jparse
from rotate_yolov3_tpu.models import apply_fused
from rotate_yolov3_tpu.models import build_network as jbuild
from rotate_yolov3_tpu.models import fuse_bn as jfuse_bn
from rotate_yolov3_tpu.models import init_params as jinit
from rotate_yolov3_tpu_torch.config.parse import parse_model_cfg
from rotate_yolov3_tpu_torch.detector import Detector
from rotate_yolov3_tpu_torch.models import darknet
from rotate_yolov3_tpu_torch.models.darknet import (ConvSpec, FusedDarknet,
                                                    _activate, _conv2d,
                                                    _fused_shortcuts, _walk,
                                                    build_network, layer_key)
from rotate_yolov3_tpu_torch.ops.conv_epilogue import (conv_epilogue,
                                                       conv_epilogue_ref)

IMG = 64
_YOLO = """
[yolo]
mask = {mask}
anchors = 10,13, 16,30, 33,23, 30,61, 62,45, 59,119
angles = -60,-30,0,30,60,90
classes=1
num=6
ignore_thresh = 0.5
"""

def _conv(filters, size=1, stride=1, bn=1, act="leaky"):
    return (f"\n[convolutional]\nbatch_normalize={bn}\nfilters={filters}\n"
            f"size={size}\nstride={stride}\npad=1\nactivation={act}\n")


# layer: 0-1 the HRSC stem (packable), 2-4 and 5-7 residual blocks (their
# shortcuts fused into convs 3 and 6; 7's residual is shortcut 4's sum),
# 8-10 an odd channel count and a shortcut from its own conv (x + x, not
# fused: conv 9 is cached), 11-13 a head, 14-19 route, upsample, route of
# two layers, a second head
MINI_CFG = (f"[net]\nwidth={IMG}\nheight={IMG}\nchannels=3\n"
            + _conv(8, 3) + _conv(16, 3, 2)
            + _conv(8) + _conv(16, 3) + "\n[shortcut]\nfrom=-3\n"
            + _conv(8) + _conv(16, 3) + "\n[shortcut]\nfrom=-3\n"
            + _conv(13) + _conv(13, 3) + "\n[shortcut]\nfrom=-1\n"
            + _conv(32, 3, 2) + _conv(126, bn=0, act="linear")
            + _YOLO.format(mask="3,4,5")
            + "\n[route]\nlayers=-3\n" + _conv(16)
            + "\n[upsample]\nstride=2\n" + "\n[route]\nlayers=-1,-10\n"
            + _conv(126, bn=0, act="linear") + _YOLO.format(mask="0,1,2"))


@pytest.fixture(scope="module")
def mini_cfg(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "mini.cfg"
    path.write_text(MINI_CFG)
    return str(path)


def _same(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Bit for bit, NaN in the same places (any NaN payload)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        return False
    ints = torch.int16 if got.element_size() == 2 else torch.int32
    return torch.equal(got.masked_fill(nan, 0).view(ints),
                       want.masked_fill(nan, 0).view(ints))


def _round_np(v: np.ndarray, dtype: str) -> np.ndarray:
    """float32 values rounded to ``dtype`` (bf16: to nearest even) and
    back to float32."""
    if dtype == "float32":
        return v.astype(np.float32)
    bits = v.astype(np.float32).view(np.uint32).astype(np.uint64)
    bits = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16 << 16)
    out = bits.astype(np.uint32).view(np.float32)
    return np.where(np.isnan(v), np.float32(np.nan), out)


def _mirror(y, b, act, res, dtype, slope=np.float32(0.1)):
    """The kernel's arithmetic in numpy: f32 operations, a round after each
    step. ``y``, ``res`` (B, C, H, W) and ``b`` (C,) float32 values of
    ``dtype``."""
    with np.errstate(invalid="ignore", over="ignore"):
        t = _round_np(y + b[None, :, None, None], dtype)
        if act == "leaky":
            t = _round_np(np.where(t > 0, t, t * slope), dtype)
        if res is not None:
            t = _round_np(t + res, dtype)
    return t


def _case(rng, c, dtype, plant):
    """A (2, c, 5, 7) channels_last convolution output, its bias and a
    residual in ``dtype``; ``plant`` puts NaN and +-inf into the output,
    the bias and the residual."""
    x = rng.normal(size=(2, 4, 5, 7)).astype(np.float32)
    w = rng.normal(size=(c, 4, 3, 3)).astype(np.float32)
    b = rng.normal(size=(c,)).astype(np.float32)
    r = rng.normal(size=(2, c, 5, 7)).astype(np.float32)
    dt = getattr(torch, dtype)
    cl = torch.channels_last
    xt = torch.from_numpy(x).to(dt).contiguous(memory_format=cl)
    wt = torch.from_numpy(w).to(dt).contiguous(memory_format=cl)
    y = F.conv2d(xt, wt, None, 1, 1)
    bt, rt = torch.from_numpy(b).to(dt), torch.from_numpy(r).to(dt)
    rt = rt.contiguous(memory_format=cl)
    if plant:
        y[0, 0, 0, :3] = torch.tensor([np.nan, np.inf, -np.inf], dtype=dt)
        y[1, c - 1, 4, 6] = np.nan
        bt[c // 2] = np.inf
        rt[0, 0, 1, :3] = torch.tensor([np.nan, -np.inf, np.inf], dtype=dt)
        rt[1, 1, 2, 2] = -np.inf
    return xt, wt, y, bt, rt


@pytest.mark.parametrize("plant", [False, True], ids=["finite", "nan-inf"])
@pytest.mark.parametrize("c", [32, 126, 13])
@pytest.mark.parametrize("residual", [False, True],
                         ids=["no-residual", "residual"])
@pytest.mark.parametrize("act", ["leaky", "linear"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_equals_eager_sequence(dtype, act, residual, c, plant):
    rng = np.random.default_rng(c + 7 * residual)
    xt, wt, y, bt, rt = _case(rng, c, dtype, plant)
    res = rt if residual else None
    got = conv_epilogue_ref(y.clone(), bt, act, res)
    assert got.is_contiguous(memory_format=torch.channels_last)

    # the eager sequence: the convolution's bias add, the activation, the
    # walk's shortcut add
    want = _activate(y.clone().add_(bt.view(1, -1, 1, 1)), act)
    want = want + rt if residual else want
    assert _same(got, want)
    # the kernel's arithmetic, mirrored in numpy
    mirror = _mirror(y.float().numpy(), bt.float().numpy(), act,
                     rt.float().numpy() if residual else None, dtype)
    assert _same(got.float(), torch.from_numpy(mirror))
    # through the wrapper, which takes the plain version on the CPU
    assert _same(conv_epilogue(y.clone(), bt, act, res), got)
    if dtype == "float32" and not plant:
        # the forward as it ran before: F.conv2d with its bias
        before = _activate(F.conv2d(xt, wt, bt, 1, 1), act)
        assert _same(got, before + rt if residual else before)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True],
                         ids=["no-residual", "residual"])
@pytest.mark.parametrize("act", ["leaky", "linear"])
def test_epilogue_matches_jax(act, residual, dtype):
    """The JAX package's ops on the same numpy inputs (NHWC there)."""
    rng = np.random.default_rng(3)
    y = rng.normal(size=(2, 9, 11, 32)).astype(np.float32)
    b = rng.normal(size=(32,)).astype(np.float32)
    r = rng.normal(size=(2, 9, 11, 32)).astype(np.float32)
    jd = getattr(jnp, dtype)
    want = jnp.asarray(y, jd) + jnp.asarray(b).astype(jd)
    if act == "leaky":
        want = jax.nn.leaky_relu(want, darknet._LEAKY_SLOPE)
    if residual:
        want = want + jnp.asarray(r, jd)
    want = np.asarray(want.astype(jnp.float32))

    dt = getattr(torch, dtype)
    nchw = lambda a: torch.from_numpy(a.copy()).to(dt).permute(0, 3, 1, 2)
    got = conv_epilogue(nchw(y), torch.from_numpy(b).to(dt), act,
                        nchw(r) if residual else None)
    got = got.permute(0, 2, 3, 1).float().numpy()
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
    else:
        scale = np.abs(y + b).max() + (np.abs(r).max() if residual else 0)
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * 2.0**-7 * scale)


def test_epilogue_rejects_bad_inputs():
    y = torch.zeros(2, 4, 3, 3).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="unknown activation"):
        conv_epilogue(y, torch.zeros(4), "mish")
    with pytest.raises(ValueError, match="not \\(B, C, H, W\\)"):
        conv_epilogue(y, torch.zeros(3), "leaky")
    with pytest.raises(ValueError, match="not \\(B, C, H, W\\)"):
        conv_epilogue(y, torch.zeros(4), "leaky", torch.zeros(2, 4, 3, 2))
    # a tensor off the CPU is the kernel's, never the plain version's
    with pytest.raises(ValueError, match="one CUDA device"):
        conv_epilogue(y.to("meta"), torch.zeros(4, device="meta"), "leaky")


def _net(cfg, dtype, seed=0):
    """FusedDarknet of ``cfg`` at IMG² with seeded weights and randomised
    BN statistics, in ``dtype``."""
    spec = build_network(parse_model_cfg(cfg), img_size=IMG)
    gen = torch.Generator().manual_seed(seed)
    fused = {}
    for layer in spec.conv_specs:
        k = layer.in_c * layer.size ** 2
        fused[layer_key(layer.index)] = {
            "kernel": torch.randn(layer.out_c, layer.in_c, layer.size,
                                  layer.size, generator=gen) * (2 / k) ** 0.5,
            "bias": 0.3 * torch.randn(layer.out_c, generator=gen)}
    return spec, FusedDarknet(spec, fused).to(dtype=dtype)


def _before(net, x_nchw, dtype):
    """The heads of the forward as it ran before the epilogue (module
    docstring)."""
    def conv(layer, h):
        key = layer_key(layer.index)
        k, b = net.kernels[key], net.biases[key]
        if dtype == torch.float32:
            y = _conv2d(layer, h, k, b)
        else:
            y = _conv2d(layer, h, k, None).add_(b.view(1, -1, 1, 1))
        return _activate(y, layer.activation)

    return _walk(net.spec, x_nchw, conv)


def _images(b, seed=1):
    return np.random.default_rng(seed).uniform(0, 1, (b, IMG, IMG, 3)
                                               ).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_fused_walk_equals_three_argument_walk(mini_cfg, dtype):
    spec, net = _net(mini_cfg, dtype)
    assert {i: sc.index for i, sc in _fused_shortcuts(spec).items()} == \
        {3: 4, 6: 7}
    x = torch.from_numpy(_images(2)).to(dtype)
    calls = {"conv": 0, "conv_shortcut": 0}

    def count(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    fused = _walk(spec, x.permute(0, 3, 1, 2), count("conv", net._conv),
                  conv_shortcut=count("conv_shortcut", net._conv_shortcut))
    assert calls == {"conv": len(spec.conv_specs) - 2, "conv_shortcut": 2}
    heads = net(x)
    # the bench's check (b) form: every conv layer through net._conv
    walked = _walk(spec, x.permute(0, 3, 1, 2), net._conv)
    before = _before(net, x.permute(0, 3, 1, 2), dtype)
    assert [tuple(h.shape) for h in heads] == [(2, 16, 16, 126),
                                               (2, 32, 32, 126)]
    for got, f, w, b in zip(heads, fused, walked, before):
        assert _same(got, f) and _same(got, w) and _same(got, b)
        assert bool(torch.isfinite(got).all())


def test_fused_network_matches_jax(mini_cfg):
    """The fused forward on the JAX package's fused weights, f32."""
    jspec = jbuild(jparse(mini_cfg), img_size=IMG)
    params, state = jinit(jspec, jax.random.PRNGKey(5))
    state = jax.tree.map(lambda a: a + 0.05 * jax.random.normal(
        jax.random.PRNGKey(6), a.shape), state)
    state = {k: {"bn_mean": v["bn_mean"], "bn_var": jnp.abs(v["bn_var"])
                 + 0.1} for k, v in state.items()}
    jfused = jax.tree.map(np.asarray, jfuse_bn(jspec, params, state))
    fused = {k: {"kernel": torch.from_numpy(np.ascontiguousarray(
                     v["kernel"].transpose(3, 2, 0, 1))),
                 "bias": torch.from_numpy(v["bias"].copy())}
             for k, v in jfused.items()}
    x = _images(2, seed=2)
    want = apply_fused(jspec, jfused, jnp.asarray(x))
    net = FusedDarknet(build_network(parse_model_cfg(mini_cfg), IMG), fused)
    got = net(torch.from_numpy(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_packed_stem_heads_unchanged(mini_cfg, dtype):
    det = Detector(mini_cfg, img_size=IMG, compute_dtype=dtype, seed=4,
                   packed_stem=True, device="cpu")
    assert isinstance(det.net.spec.layers[1], ConvSpec) and \
        det.net.spec.layers[1].pad == ((1, 0), (1, 0))
    imgs = np.random.default_rng(5).integers(0, 255, (2, IMG, IMG, 3),
                                             dtype=np.uint8)
    heads = det.heads(imgs)
    with torch.inference_mode():
        before = _before(det.net, det._images(imgs).permute(0, 3, 1, 2),
                         dtype)
    for got, want in zip(heads, before):
        assert _same(got, want)
