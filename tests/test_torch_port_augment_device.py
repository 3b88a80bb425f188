"""The PyTorch port's on-device augmentation against the JAX package on the
CPU.

The JAX ops draw from ``jax.random`` keys; the port's ops take their draws
as tensors (``AugDraws``). Each test draws with ``jax.random`` from the same
keys, in the same splits, as ``rotate_yolov3_tpu/data/augment_device.py``
does, runs the JAX op on the key and the port's op on those draws, and
compares: images (floats in [0, 1]) and labels within 1e-5 absolute (the two
frameworks' tan/sin/cos and summation orders differ in the last bits),
validity masks and mosaic crops exact.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rotate_yolov3_tpu.config.hyp import Hyp as JHyp
from rotate_yolov3_tpu.data import augment_device as jad
from rotate_yolov3_tpu_torch.config.hyp import Hyp
from rotate_yolov3_tpu_torch.data import augment_device as tad

TOL = 1e-5
DEG = math.pi / 180.0


def _batch(b=4, size=64, g=6, n_valid=3, seed=0):
    """Random images in [0, 1] with bright boxes, and (B, G, 6) labels with
    ``n_valid`` rows per image (one with zero width)."""
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 0.3, (b, size, size, 3)).astype(np.float32)
    t = np.zeros((b, g, 6), np.float32)
    v = np.zeros((b, g), bool)
    for i in range(b):
        for j in range(n_valid):
            cx, cy = rng.uniform(0.2, 0.8, 2)
            w, h = rng.uniform(0.1, 0.3, 2)
            x0, x1 = int((cx - w / 2) * size), int((cx + w / 2) * size)
            y0, y1 = int((cy - h / 2) * size), int((cy + h / 2) * size)
            imgs[i, y0:y1, x0:x1] = rng.uniform(0.6, 1.0, 3)
            t[i, j] = [j % 2, cx, cy, w if j else 0.0, h,
                       rng.uniform(-1.5, 1.5)]
            v[i, j] = True
    return imgs, t, v


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _close(got, want, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL, err_msg=what)


def _jax_draws(key, b, size, hyp, use_mosaic=True, use_hsv=True,
               use_flip=True, use_rotate=True, use_scale_translate=True):
    """The draws of ``augment_batch(key, ...)``, made with jax.random in
    the reference's key splits, as the port's ``AugDraws``."""
    k_mosaic, k_rot, k_st, k_flip, k_hsv = jax.random.split(key, 5)
    d = tad.AugDraws()
    if use_mosaic:
        off = jax.vmap(lambda k: jax.random.randint(k, (2,), 0, size + 1))(
            jax.random.split(k_mosaic, b))
        d.off = torch.from_numpy(np.asarray(off).astype(np.int64))
    if use_rotate:
        d.phi = _t(_jax_phis(jax.random.split(k_rot, b), hyp.degrees))[0]
    if use_scale_translate and (hyp.scale > 0 or hyp.translate > 0):
        s, shift = _jax_scale_shift(jax.random.split(k_st, b), hyp.scale,
                                    hyp.translate, size)
        d.scale, d.shift = _t(s, shift)
    if use_flip:
        d.flip = _t(jax.random.bernoulli(k_flip, 0.5, (b,)))[0]
    if use_hsv:
        d.hsv = _t(_jax_gains(jax.random.split(k_hsv, b), hyp.hsv_h,
                              hyp.hsv_s, hyp.hsv_v))[0]
    return d


def _jax_phis(keys, degrees):
    return jax.vmap(lambda k: jax.random.uniform(
        k, (), minval=-degrees, maxval=degrees) * (math.pi / 180.0))(keys)


def _jax_scale_shift(keys, scale, translate, size):
    def one(key):
        k1, k2 = jax.random.split(key)
        s = jax.random.uniform(k1, (), minval=1.0 - scale,
                               maxval=1.0 + scale)
        shift = jax.random.uniform(k2, (2,), minval=-translate,
                                   maxval=translate) * size
        return s, shift
    return jax.vmap(one)(keys)


def _jax_gains(keys, h, s, v):
    return jax.vmap(lambda k: 1.0 + jax.random.uniform(
        k, (3,), minval=-1.0, maxval=1.0) * jnp.asarray([h, s, v]))(keys)


# ------------------------------ single ops ---------------------------------

def test_hsv_jitter_matches_jax():
    imgs = np.random.default_rng(1).uniform(0, 1, (4, 24, 24, 3)
                                            ).astype(np.float32)
    imgs[0, :4] = imgs[0, :4, :, :1]            # grey pixels: d = 0
    imgs[1, :2] = 0.0                           # black: mx = 0
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    gains = _jax_gains(keys, 0.3, 0.7, 0.5)
    got = tad.hsv_jitter(*_t(imgs, gains))
    want = np.stack([np.asarray(jad.hsv_jitter(k, jnp.asarray(im), 0.3, 0.7,
                                               0.5))
                     for k, im in zip(keys, imgs)])
    _close(got, want)
    back = tad._hsv_to_rgb(tad._rgb_to_hsv(torch.from_numpy(imgs)))
    _close(back, imgs)


def test_flip_lr_matches_jax():
    imgs, t, _ = _batch(b=3, seed=2)
    flips = np.array([True, False, True])
    got_img, got_t = tad.flip_lr(*_t(flips, imgs, t))
    for i in range(3):
        wi, wt = jad.flip_lr(jnp.asarray(flips[i]), jnp.asarray(imgs[i]),
                             jnp.asarray(t[i]))
        np.testing.assert_array_equal(got_img[i].numpy(), np.asarray(wi))
        np.testing.assert_array_equal(got_t[i].numpy(), np.asarray(wt))


def test_rotate_scale_matches_jax():
    imgs, t, v = _batch(b=4, size=48, seed=3)
    keys = jax.random.split(jax.random.PRNGKey(4), 4)
    phi, s = [], []
    for k in keys:
        k1, k2 = jax.random.split(k)
        phi.append(jax.random.uniform(k1, (), minval=-35.0, maxval=35.0)
                   * (math.pi / 180.0))
        s.append(jax.random.uniform(k2, (), minval=0.7, maxval=1.3))
    got = tad.rotate_scale(*_t(imgs, t, v, np.stack(phi), np.stack(s)))
    for i, k in enumerate(keys):
        want = jad.rotate_scale(k, jnp.asarray(imgs[i]), jnp.asarray(t[i]),
                                jnp.asarray(v[i]), degrees=35.0, scale=0.3)
        _close(got[0][i], want[0], "image")
        _close(got[1][i], want[1], "labels")
        np.testing.assert_array_equal(got[2][i].numpy(), np.asarray(want[2]))


ANGLES = (0.0, 30.0, -30.0, 45.0, -45.0, 135.0, -135.0)


@pytest.mark.parametrize("size", [64, 65])
@pytest.mark.parametrize("angles", ["listed", "full_circle"])
def test_rotate_shear_matches_jax(size, angles):
    """The quadrant turn plus three shears at the listed angles, and at the
    angles the reference's full-circle test draws (seeds 0-5, 180°)."""
    if angles == "listed":
        phi = np.asarray([a * DEG for a in ANGLES], np.float32)
    else:
        phi = np.concatenate([np.asarray(_jax_phis(
            jax.random.PRNGKey(seed)[None], 180.0)) for seed in range(6)])
    b = len(phi)
    imgs, t, v = _batch(b=b, size=size, seed=5)
    got = tad.rotate_shear(*_t(imgs, t, v, phi))
    bits = jad._rotation_shift_bits(size, 45.0)
    for i in range(b):
        p = jnp.float32(phi[i])
        want = jad._warp_rotate(jnp.asarray(imgs[i]), p, bits, 0.5)
        want_t, want_v = jad._rotate_labels(jnp.asarray(t[i]),
                                            jnp.asarray(v[i]), p,
                                            jnp.float32(1.0), size)
        _close(got[0][i], want, f"image at {float(phi[i]) / DEG:.1f} deg")
        _close(got[1][i], want_t, "labels")
        np.testing.assert_array_equal(got[2][i].numpy(), np.asarray(want_v))
    if angles == "full_circle":
        key_imgs = [jad.rotate_shear(jax.random.PRNGKey(seed),
                                     jnp.asarray(imgs[seed]),
                                     jnp.asarray(t[seed]),
                                     jnp.asarray(v[seed]), degrees=180.0)[0]
                    for seed in range(6)]
        _close(got[0], np.stack(key_imgs), "rotate_shear from the keys")


def test_scale_translate_matches_jax():
    imgs, t, v = _batch(b=4, size=48, seed=6)
    keys = jax.random.split(jax.random.PRNGKey(7), 4)
    s, shift = _jax_scale_shift(keys, 0.25, 0.15, 48)
    got = tad.scale_translate(*_t(imgs, t, v, s, shift))
    for i, k in enumerate(keys):
        want = jad.scale_translate(k, jnp.asarray(imgs[i]),
                                   jnp.asarray(t[i]), jnp.asarray(v[i]),
                                   scale=0.25, translate=0.15)
        _close(got[0][i], want[0], "image")
        _close(got[1][i], want[1], "labels")
        np.testing.assert_array_equal(got[2][i].numpy(), np.asarray(want[2]))
    assert not got[2].all() and got[2].any()


def test_mosaic_matches_jax():
    """4 images of 3 valid rows each, G = 3: up to 12 candidates per crop,
    so the valid-first truncation to G bites."""
    imgs, t, v = _batch(b=4, size=40, g=3, n_valid=3, seed=8)
    key = jax.random.PRNGKey(9)
    want = jad.mosaic(key, *(jnp.asarray(a) for a in (imgs, t, v)))
    off = jax.vmap(lambda k: jax.random.randint(k, (2,), 0, 41))(
        jax.random.split(key, 4))
    got = tad.mosaic(*_t(imgs, t, v), torch.from_numpy(
        np.asarray(off).astype(np.int64)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1], want[1], "labels")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # more than G candidates survived the crop somewhere
    cand = np.zeros(4, int)
    for i in range(4):
        for q in range(4):
            j = (i + q) % 4
            ox, oy = int(off[i, 1]), int(off[i, 0])
            cx = (t[j, :, 1] + q % 2) * 40 - ox
            cy = (t[j, :, 2] + q // 2) * 40 - oy
            cand[i] += int((v[j] & (cx > 0) & (cx < 40) & (cy > 0)
                            & (cy < 40)).sum())
    assert cand.max() > 3


STAGES = ("all", "mosaic", "rotate", "scale_translate", "flip", "hsv")


@pytest.mark.parametrize("stage", STAGES)
def test_augment_batch_matches_jax(stage):
    """``augment_batch`` with every stage on, and each stage alone, against
    the JAX function on the same key."""
    flags = {f"use_{s}": stage in ("all", s) for s in STAGES[1:]}
    # rotations past 45 deg take the quadrant turn
    jhyp = JHyp(degrees=100.0) if stage == "rotate" else JHyp()
    hyp = Hyp(degrees=jhyp.degrees)
    imgs, t, v = _batch(b=4, size=48, seed=10)
    key = jax.random.PRNGKey(11)
    want = jax.jit(lambda k, i, tt, vv: jad.augment_batch(
        k, i, tt, vv, jhyp, **flags))(key, *(jnp.asarray(a)
                                             for a in (imgs, t, v)))
    draws = _jax_draws(key, 4, 48, hyp, **flags)
    got = tad.apply_augment(draws, *_t(imgs, t, v))
    _close(got[0], want[0], "image")
    _close(got[1], want[1], "labels")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if stage != "flip":
        assert not np.array_equal(got[0].numpy(), imgs)


def test_draw_augment_ranges_and_determinism():
    """The port's own draws: the reference's ranges, the same generator
    seed gives the same batch, another seed another; a stage is drawn only
    where it acts."""
    hyp = Hyp(degrees=30.0, scale=0.2, translate=0.1)
    d = tad.draw_augment(torch.Generator().manual_seed(0), 512, 64, hyp)
    assert d.off.dtype == torch.int64 and 0 <= d.off.min() \
        and d.off.max() <= 64
    assert d.phi.abs().max() <= 30 * DEG
    assert ((d.scale >= 0.8) & (d.scale <= 1.2)).all()
    assert d.shift.abs().max() <= 0.1 * 64
    assert 0.3 < d.flip.float().mean() < 0.7
    gains = torch.tensor([hyp.hsv_h, hyp.hsv_s, hyp.hsv_v])
    assert ((d.hsv - 1).abs() <= gains).all()
    assert tad.draw_augment(torch.Generator(), 2, 64,
                            Hyp(scale=0.0, translate=0.0)).scale is None

    imgs, t, v = _t(*_batch(b=4, size=48, seed=12))
    out = [tad.augment_batch(torch.Generator().manual_seed(s), imgs, t, v)
           for s in (1, 1, 2)]
    assert out[0][0].shape == imgs.shape and out[0][1].shape == t.shape
    assert torch.isfinite(out[0][0]).all()
    for a, b in zip(out[0], out[1]):
        assert torch.equal(a, b)
    assert not torch.equal(out[0][0], out[2][0])
