"""Letterbox resize: aspect-preserving resize + gray padding to square.

Counterparts of ``rotate_yolov3_tpu/data/letterbox.py``: the host-side
(numpy/cv2) ``letterbox`` for the CLI file-loading path, and
``letterbox_torch``, the on-device letterbox of a fixed-shape batch (the
twin of ``letterbox_jax``) that the DOTA tile pipeline runs. Both return
the resized image plus (ratio, pad) for inverse coordinate mapping.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_PAD_VALUE = 128


def letterbox(img: np.ndarray, new_shape: int = 608,
              color: Tuple[int, int, int] = (_PAD_VALUE,) * 3
              ) -> Tuple[np.ndarray, float, Tuple[float, float]]:
    """Resize HWC uint8 image to (new_shape, new_shape) preserving aspect.

    Returns (letterboxed image, ratio, (pad_x, pad_y)); the inverse map for
    detections is ``ops.boxes.scale_coords_rotated``. cv2 is needed only
    for a resize; the constant padding is numpy, equal to the reference's
    ``cv2.copyMakeBorder`` (``color`` filling the first channels, 0 the
    rest, as cv2 fills from its 4-value scalar).
    """
    h, w = img.shape[:2]
    ratio = min(new_shape / h, new_shape / w)
    new_w, new_h = int(round(w * ratio)), int(round(h * ratio))
    if (new_w, new_h) != (w, h):
        import cv2

        img = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    pad_x = (new_shape - new_w) / 2
    pad_y = (new_shape - new_h) / 2
    top, bottom = int(round(pad_y - 0.1)), int(round(pad_y + 0.1))
    left, right = int(round(pad_x - 0.1)), int(round(pad_x + 0.1))
    out = np.empty((new_h + top + bottom, new_w + left + right)
                   + img.shape[2:], img.dtype)
    fill = np.zeros(4)
    fill[:len(color)] = color
    out[...] = fill[:img.shape[2]] if img.ndim == 3 else fill[0]
    out[top:top + new_h, left:left + new_w] = img
    return out, ratio, (left, top)


def letterbox_torch(img, new_shape: int = 608):
    """On-device letterbox for fixed-shape batched images.

    Args:
      img: (B, H, W, C) float32 tensor (any range), or uint8 (taken as
        ``img.float()``), on any device.
      new_shape: target square size.
    Returns:
      (B, new_shape, new_shape, C) float tensor, ratio (python float) and
      (pad_x, pad_y) (python ints), known from the static input shape.

    The resize is the one ``letterbox_jax`` runs, ``jax.image.resize(
    method="linear")``: bilinear with antialiasing when it downsamples (a
    plain bilinear resize of a 1024 -> 608 tile differs by up to 162 of
    255). PyTorch's ``interpolate(mode="bilinear", antialias=True)`` is
    that resize; the card's and the CPU's implementations round
    differently, by a few 1e-3 on 0-255 values.
    """
    import torch
    import torch.nn.functional as F

    b, h, w, c = img.shape
    ratio = min(new_shape / h, new_shape / w)
    new_w, new_h = int(round(w * ratio)), int(round(h * ratio))
    resized = img if img.is_floating_point() else img.float()
    if (new_h, new_w) != (h, w):
        resized = F.interpolate(resized.permute(0, 3, 1, 2), (new_h, new_w),
                                mode="bilinear", align_corners=False,
                                antialias=True).permute(0, 2, 3, 1)
    pad_y = (new_shape - new_h) / 2
    pad_x = (new_shape - new_w) / 2
    top, left = int(round(pad_y - 0.1)), int(round(pad_x - 0.1))
    out = torch.full((b, new_shape, new_shape, c), float(_PAD_VALUE),
                     dtype=resized.dtype, device=img.device)
    out[:, top:top + new_h, left:left + new_w] = resized
    return out, ratio, (left, top)
