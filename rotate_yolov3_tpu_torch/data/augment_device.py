"""On-device batch augmentation: mosaic, rotation, scale + translation,
flip and HSV jitter of a (B, S, S, 3) float batch in [0, 1].

Counterpart of ``rotate_yolov3_tpu/data/augment_device.py``: the same
stages in the same order (mosaic -> rotation -> scale/translate -> flip ->
HSV), the same label rewrites and the same pixel values. Each op works on
the whole batch with plain tensor ops on fixed shapes, on the batch's
device.

Drawing is split from applying. ``draw_augment`` draws every random number
of ``augment_batch`` from a ``torch.Generator`` into an ``AugDraws`` (per
image: the mosaic offsets, the rotation angle, the scale and shift, the
flip and the HSV gains); ``apply_augment`` and the ops below take those
draws as tensors. The JAX package draws from ``jax.random`` keys, a stream
PyTorch cannot reproduce, so the two packages are held to each other
through the draws: the same draws give the same images and labels.

What changes from the reference is only how a value is computed where the
reference's form was chosen for the TPU:
  * ``_shear`` reads its two bilinear taps ``in[x - f]`` and
    ``in[x - f - 1]`` (``f = floor(shift)``) by index; the reference builds
    them from a ladder of ``roll``s over the bits of ``f`` (gather-free).
    Where the output is not padded the first tap is in range, and the
    second is out of range only at ``x - f = 0``, where its weight ``t`` is
    exactly 0 (clamped here, wrapped there; either way it adds +0);
  * the quadrant turn of ``_warp_rotate`` is an index map per image, where
    the reference switches between ``rot90``s;
  * ``rotate_scale`` computes ``map_coordinates(order=1, mode="constant")``
    directly: four taps, each replaced by ``pad_value`` where it falls
    outside the image (zero padding plus a fill would give another border).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..config.hyp import Hyp
from ..ops.boxes import normalize_angle

_HALF_PI = math.pi / 2.0


@dataclasses.dataclass
class AugDraws:
    """Every random number of one ``augment_batch`` call, per image; a
    stage whose field is None is skipped.

    ``off``: (B, 2) int64 mosaic crop offsets (oy, ox) in [0, S];
    ``phi``: (B,) f32 rotation angles in radians; ``scale``: (B,) f32 scale
    factors and ``shift``: (B, 2) f32 translations (sx, sy) in pixels;
    ``flip``: (B,) bool; ``hsv``: (B, 3) f32 gains of hue, saturation and
    value.
    """
    off: Optional[torch.Tensor] = None
    phi: Optional[torch.Tensor] = None
    scale: Optional[torch.Tensor] = None
    shift: Optional[torch.Tensor] = None
    flip: Optional[torch.Tensor] = None
    hsv: Optional[torch.Tensor] = None


def draw_augment(gen: torch.Generator, b: int, size: int,
                 hyp: Optional[Hyp] = None, use_mosaic: bool = True,
                 use_hsv: bool = True, use_flip: bool = True,
                 use_rotate: bool = True, use_scale_translate: bool = True
                 ) -> AugDraws:
    """Draw the random numbers of ``augment_batch`` for B images of S² on
    the generator's device, with the distributions of the reference:
    offsets uniform on [0, S], angle U(-degrees, degrees), scale
    U(1 - scale, 1 + scale), shift U(-translate, translate)·S per axis,
    flip with probability 1/2, gains 1 + U(-1, 1)·(hsv_h, hsv_s, hsv_v).
    Scale/translate is drawn only when ``hyp.scale`` or ``hyp.translate``
    is positive, as the reference applies it."""
    hyp = hyp or Hyp()
    dev = gen.device

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    d = AugDraws()
    if use_mosaic:
        d.off = torch.randint(0, size + 1, (b, 2), generator=gen, device=dev)
    if use_rotate:
        d.phi = uniform((b,), -hyp.degrees, hyp.degrees) * (math.pi / 180.0)
    if use_scale_translate and (hyp.scale > 0 or hyp.translate > 0):
        d.scale = uniform((b,), 1.0 - hyp.scale, 1.0 + hyp.scale)
        d.shift = uniform((b, 2), -hyp.translate, hyp.translate) * size
    if use_flip:
        d.flip = torch.rand((b,), generator=gen, device=dev) < 0.5
    if use_hsv:
        gains = torch.tensor([hyp.hsv_h, hyp.hsv_s, hyp.hsv_v], device=dev)
        d.hsv = 1.0 + uniform((b, 3), -1.0, 1.0) * gains
    return d


def apply_augment(d: AugDraws, imgs: torch.Tensor, targets: torch.Tensor,
                  valid: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The stages whose draws ``d`` holds, in the reference's order, on a
    (B, S, S, 3) f32 batch in [0, 1], (B, G, 6) normalized labels and
    (B, G) validity. Returns (imgs, targets, valid) of the same shapes."""
    if d.off is not None:
        imgs, targets, valid = mosaic(imgs, targets, valid, d.off)
    if d.phi is not None:
        imgs, targets, valid = rotate_shear(imgs, targets, valid, d.phi)
    if d.scale is not None:
        imgs, targets, valid = scale_translate(imgs, targets, valid,
                                               d.scale, d.shift)
    if d.flip is not None:
        imgs, targets = flip_lr(d.flip, imgs, targets)
    if d.hsv is not None:
        imgs = hsv_jitter(imgs, d.hsv)
    return imgs, targets, valid


def augment_batch(gen: torch.Generator, imgs: torch.Tensor,
                  targets: torch.Tensor, valid: torch.Tensor,
                  hyp: Optional[Hyp] = None, use_mosaic: bool = True,
                  use_hsv: bool = True, use_flip: bool = True,
                  use_rotate: bool = True, use_scale_translate: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full on-device augmentation of a (B, S, S, 3) float [0, 1] batch:
    ``draw_augment`` from ``gen``, then ``apply_augment``."""
    d = draw_augment(gen, imgs.shape[0], imgs.shape[1], hyp,
                     use_mosaic=use_mosaic, use_hsv=use_hsv,
                     use_flip=use_flip, use_rotate=use_rotate,
                     use_scale_translate=use_scale_translate)
    return apply_augment(d, imgs, targets, valid)


# ------------------------------- HSV ---------------------------------------

def _rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = rgb.amax(-1)
    mn = rgb.amin(-1)
    d = mx - mn
    safe = torch.where(d > 0, d, 1.0)
    h = torch.where(
        mx == r, torch.remainder((g - b) / safe, 6.0),
        torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0))
    h = torch.where(d > 0, h / 6.0, 0.0)
    s = torch.where(mx > 0, d / torch.where(mx > 0, mx, 1.0), 0.0)
    return torch.stack([h, s, mx], dim=-1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def hsv_jitter(imgs: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """Per-image HSV gains (B, 3) on a (B, S, S, 3) float batch in [0, 1]:
    hue multiplied in continuous [0, 1) space with mod-1 wrap, saturation
    and value multiplied and clipped to [0, 1] (the reference's documented
    divergence from the host path's uint8 LUT)."""
    hsv = _rgb_to_hsv(imgs)
    g = gains[:, None, None, :]
    h = torch.remainder(hsv[..., 0] * g[..., 0], 1.0)
    s = torch.clip(hsv[..., 1] * g[..., 1], 0.0, 1.0)
    v = torch.clip(hsv[..., 2] * g[..., 2], 0.0, 1.0)
    return _hsv_to_rgb(torch.stack([h, s, v], dim=-1))


# ------------------------------- flip --------------------------------------

def flip_lr(flip: torch.Tensor, imgs: torch.Tensor, targets: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Horizontal flip of the images where ``flip`` (B,) is set, with their
    labels: x mirrored on rows with a positive width, theta negated."""
    f = flip[:, None]
    out = torch.where(flip[:, None, None, None], imgs.flip(2), imgs)
    fx = torch.where(f & (targets[..., 3] > 0), 1.0 - targets[..., 1],
                     targets[..., 1])
    fth = torch.where(f, -targets[..., 5], targets[..., 5])
    targets = torch.cat([targets[..., :1], fx[..., None],
                         targets[..., 2:5], fth[..., None]], dim=-1)
    return out, targets


# ------------------------------ rotation -----------------------------------

def _gather_pixels(imgs: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor
                   ) -> torch.Tensor:
    """``out[b, i, j] = imgs[b, sy[b, i, j], sx[b, i, j]]`` for in-range
    (B, S, S) index maps."""
    b, s, _, c = imgs.shape
    flat = (sy * s + sx).reshape(b, s * s, 1).expand(b, s * s, c)
    return imgs.reshape(b, s * s, c).gather(1, flat).reshape(b, s, s, c)


def _rotate_labels(targets, valid, phi, s, size: int):
    """Forward-map labels under rotate(phi) + scale(s) about the center,
    per image ((B,) phi and s); rows whose center leaves the image become
    invalid and zero."""
    c = (size - 1) / 2.0
    cos, sin = torch.cos(phi)[:, None], torch.sin(phi)[:, None]
    s = s[:, None]
    x = targets[..., 1] * size - c
    y = targets[..., 2] * size - c
    nx = (cos * x - sin * y) * s + c
    ny = (sin * x + cos * y) * s + c
    nw = targets[..., 3] * s
    nh = targets[..., 4] * s
    nth = normalize_angle(targets[..., 5] + phi[:, None])
    new_t = torch.stack([targets[..., 0], nx / size, ny / size, nw, nh,
                         nth], dim=-1)
    inside = ((nx / size > 0.0) & (nx / size < 1.0)
              & (ny / size > 0.0) & (ny / size < 1.0))
    new_valid = valid & inside
    return torch.where(new_valid[..., None], new_t, 0.0), new_valid


def rotate_scale(imgs: torch.Tensor, targets: torch.Tensor,
                 valid: torch.Tensor, phi: torch.Tensor, s: torch.Tensor,
                 pad_value: float = 0.5
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rotation by ``phi`` and scale by ``s`` (both (B,)) about each image's
    center, by the exact bilinear inverse map: the reference's
    ``map_coordinates(order=1, mode="constant", cval=pad_value)``, each of
    the four taps replaced by ``pad_value`` where it lies outside the
    image."""
    b, size = imgs.shape[0], imgs.shape[1]
    c = (size - 1) / 2.0
    cos = torch.cos(phi)[:, None, None]
    sin = torch.sin(phi)[:, None, None]
    sc = s[:, None, None]
    line = torch.arange(size, dtype=torch.float32, device=imgs.device) - c
    yy, xx = line[None, :, None], line[None, None, :]
    src_x = (cos * xx + sin * yy) / sc + c
    src_y = (-sin * xx + cos * yy) / sc + c
    y0, x0 = torch.floor(src_y), torch.floor(src_x)
    wy1, wx1 = src_y - y0, src_x - x0
    taps_y = ((y0.to(torch.int64), 1 - wy1), (y0.to(torch.int64) + 1, wy1))
    taps_x = ((x0.to(torch.int64), 1 - wx1), (x0.to(torch.int64) + 1, wx1))
    out = None
    for iy, wy in taps_y:
        for ix, wx in taps_x:
            ok = ((iy >= 0) & (iy < size) & (ix >= 0) & (ix < size))
            tap = _gather_pixels(imgs, iy.clamp(0, size - 1),
                                 ix.clamp(0, size - 1))
            tap = torch.where(ok[..., None], tap, pad_value)
            term = (wy * wx)[..., None] * tap
            out = term if out is None else out + term
    new_t, new_valid = _rotate_labels(targets, valid, phi, s, size)
    return out, new_t, new_valid


def _shear(imgs: torch.Tensor, shift: torch.Tensor, axis: int,
           pad_value: float) -> torch.Tensor:
    """Shift each image along ``axis`` (1: x, per row; 0: y, per column) by
    per-line amounts ``shift`` (B, S): ``out[y, x] = in[y, x - shift[y]]``
    for axis 1, bilinear, ``pad_value`` where the source falls outside."""
    b, size = imgs.shape[0], imgs.shape[1]
    f = torch.floor(shift)
    t = shift - f
    pos = torch.arange(size, dtype=torch.float32, device=imgs.device)
    ipos = torch.arange(size, device=imgs.device)
    if axis == 1:
        t_b, f_b = t[:, :, None, None], f.to(torch.int64)[:, :, None]
        src = pos[None, None, :] - shift[:, :, None]            # (B, y, x)
        i0 = ipos[None, None, :] - f_b
        rows = ipos[None, :, None].expand(b, size, size)
    else:
        t_b, f_b = t[:, None, :, None], f.to(torch.int64)[:, None, :]
        src = pos[None, :, None] - shift[:, None, :]
        i0 = ipos[None, :, None] - f_b
        cols = ipos[None, None, :].expand(b, size, size)
    inb = ((src >= 0) & (src <= size - 1))[..., None]
    taps = []
    for i in (i0, i0 - 1):
        i = i.clamp(0, size - 1)
        taps.append(_gather_pixels(imgs, rows, i) if axis == 1
                    else _gather_pixels(imgs, i, cols))
    out = taps[0] * (1.0 - t_b) + taps[1] * t_b
    return torch.where(inb, out, pad_value)


def _quadrant_turn(imgs: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Exact content rotation of each image by k·90° in image space (y
    down): ``B[i, j] = A[S-1-j, i]`` for k = 1 (``rot90(A, 3)``), the
    reference's ``rot90`` for every k mod 4."""
    size = imgs.shape[1]
    q = torch.remainder(k, 4)[:, None, None]
    ii = torch.arange(size, device=imgs.device)[None, :, None]
    jj = torch.arange(size, device=imgs.device)[None, None, :]
    last = size - 1
    sy = torch.where(q == 0, ii, torch.where(
        q == 1, last - jj, torch.where(q == 2, last - ii, jj)))
    sx = torch.where(q == 0, jj, torch.where(
        q == 1, ii, torch.where(q == 2, last - jj, last - ii)))
    return _gather_pixels(imgs, sy, sx)


def _warp_rotate(imgs: torch.Tensor, phi: torch.Tensor,
                 pad_value: float) -> torch.Tensor:
    """Rotate each (S, S, C) image by ``phi`` (B,) radians about its center:
    an exact quadrant turn, then the residual in [-45°, 45°] as three
    shears, x by -tan(r/2), y by sin(r), x again (the quadrant turn decides
    which corner pixels the shears clip)."""
    size = imgs.shape[1]
    k = torch.round(phi / _HALF_PI).to(torch.int32)
    r = phi - k.to(torch.float32) * _HALF_PI
    imgs = _quadrant_turn(imgs, k)
    c = (size - 1) / 2.0
    lines = torch.arange(size, dtype=torch.float32, device=imgs.device) - c
    # the coefficients in float64, rounded once: the correctly rounded f32
    # values on every device (the warp is discontinuous in them where a
    # pixel crosses the frame, and an ulp of tan moves such pixels by up
    # to ~2e-3 after the later shears)
    r64 = r.double()
    a = (-torch.tan(r64 / 2.0)).float()[:, None]
    b = torch.sin(r64).float()[:, None]
    out = _shear(imgs, a * lines, 1, pad_value)
    out = _shear(out, b * lines, 0, pad_value)
    return _shear(out, a * lines, 1, pad_value)


def rotate_shear(imgs: torch.Tensor, targets: torch.Tensor,
                 valid: torch.Tensor, phi: torch.Tensor,
                 pad_value: float = 0.5
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rotation of each image by ``phi`` (B,) radians about its center
    (``_warp_rotate``); labels get the exact rotation."""
    out = _warp_rotate(imgs, phi, pad_value)
    new_t, new_valid = _rotate_labels(targets, valid, phi,
                                      torch.ones_like(phi), imgs.shape[1])
    return out, new_t, new_valid


# -------------------------- scale + translate ------------------------------

def _resample_matrix(size: int, s: torch.Tensor, shift: torch.Tensor):
    """(B, S, S) bilinear resample matrices and (B, S) coverage of the 1D
    inverse maps ``src(i) = (i - c - shift) / s + c``, per image."""
    c = (size - 1) / 2.0
    idx = torch.arange(size, dtype=torch.float32, device=s.device)
    src = (idx[None, :] - c - shift[:, None]) / s[:, None] + c
    d = torch.abs(src[:, :, None] - idx[None, None, :])
    r = torch.clamp_min(1.0 - d, 0.0)
    return r, r.sum(2)


def scale_translate(imgs: torch.Tensor, targets: torch.Tensor,
                    valid: torch.Tensor, s: torch.Tensor,
                    shift: torch.Tensor, pad_value: float = 0.5
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Isotropic scale ``s`` (B,) about the center plus translation
    ``shift`` (B, 2) = (sx, sy) pixels, as two separable resample products
    (y, then x); out-of-frame rows and columns blend to ``pad_value`` by
    their missing coverage. Labels: centers mapped, w/h scaled, theta
    kept."""
    size = imgs.shape[1]
    ry, covy = _resample_matrix(size, s, shift[:, 1])
    rx, covx = _resample_matrix(size, s, shift[:, 0])
    tmp = torch.einsum("bij,bjxc->bixc", ry, imgs)
    tmp = tmp + (1.0 - covy)[:, :, None, None] * pad_value
    out = torch.einsum("bxj,bijc->bixc", rx, tmp)
    out = out + (1.0 - covx)[:, None, :, None] * pad_value

    c = (size - 1) / 2.0
    sc = s[:, None]
    nx = (targets[..., 1] * size - c) * sc + c + shift[:, 0, None]
    ny = (targets[..., 2] * size - c) * sc + c + shift[:, 1, None]
    new_t = torch.stack([targets[..., 0], nx / size, ny / size,
                         targets[..., 3] * sc, targets[..., 4] * sc,
                         targets[..., 5]], dim=-1)
    inside = ((nx / size > 0.0) & (nx / size < 1.0)
              & (ny / size > 0.0) & (ny / size < 1.0))
    new_valid = valid & inside
    return (out, torch.where(new_valid[..., None], new_t, 0.0), new_valid)


# ------------------------------- mosaic ------------------------------------

def mosaic(imgs: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor,
           off: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched 4-image mosaic with fixed shapes. For image i the 2S x 2S
    canvas holds images i, i+1 (right), i+2 (below), i+3 (below right),
    mod B; the output is its S x S crop at ``off`` (B, 2) = (oy, ox).
    Labels of all four are shifted into the crop, re-validated, and the
    first G valid rows kept in their order (the rest zero)."""
    b, s = imgs.shape[0], imgs.shape[1]
    g = targets.shape[1]
    dev = imgs.device
    oy, ox = off[:, 0, None, None], off[:, 1, None, None]
    yy = torch.arange(s, device=dev)[None, :, None] + oy        # (B, S, 1)
    xx = torch.arange(s, device=dev)[None, None, :] + ox        # (B, 1, S)
    below, right = yy >= s, xx >= s
    src = (torch.arange(b, device=dev)[:, None, None]
           + 2 * below.to(torch.int64) + right.to(torch.int64)) % b
    sy = (yy - s * below.to(torch.int64)).expand(b, s, s)
    sx = (xx - s * right.to(torch.int64)).expand(b, s, s)
    flat = ((src * s + sy) * s + sx).reshape(-1)
    crop = imgs.reshape(b * s * s, -1)[flat].reshape(imgs.shape)

    idx = (torch.arange(b, device=dev)[:, None]
           + torch.arange(4, device=dev)[None, :]) % b          # (B, 4)
    t4, v4 = targets[idx], valid[idx]                            # (B,4,G,.)
    qx = torch.tensor([0.0, 1.0, 0.0, 1.0], device=dev)[None, :, None]
    qy = torch.tensor([0.0, 0.0, 1.0, 1.0], device=dev)[None, :, None]
    cx = (t4[..., 1] + qx) * s - off[:, 1, None, None]
    cy = (t4[..., 2] + qy) * s - off[:, 0, None, None]
    nt = torch.stack([t4[..., 0], cx / s, cy / s, t4[..., 3], t4[..., 4],
                      t4[..., 5]], dim=-1).reshape(b, 4 * g, 6)
    inside = ((cx / s > 0.0) & (cx / s < 1.0)
              & (cy / s > 0.0) & (cy / s < 1.0))
    nv = (v4 & inside).reshape(b, 4 * g)
    order = torch.argsort((~nv).to(torch.uint8), dim=1, stable=True)[:, :g]
    keep = nv.gather(1, order)
    rows = nt.gather(1, order[..., None].expand(b, g, 6))
    return crop, torch.where(keep[..., None], rows, 0.0), keep
