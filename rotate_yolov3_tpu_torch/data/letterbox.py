"""Letterbox resize: aspect-preserving resize + gray padding to square.

Host-side (numpy/cv2) letterbox of ``rotate_yolov3_tpu/data/letterbox.py``
for the CLI file-loading path: returns the resized image plus (ratio, pad)
for inverse coordinate mapping. The on-device ``letterbox_jax`` waits for
the DOTA port (ROADMAP queue 1, item 9).
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
    detections is ``ops.boxes.scale_coords_rotated``.
    """
    import cv2

    h, w = img.shape[:2]
    ratio = min(new_shape / h, new_shape / w)
    new_w, new_h = int(round(w * ratio)), int(round(h * ratio))
    if (new_w, new_h) != (w, h):
        img = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    pad_x = (new_shape - new_w) / 2
    pad_y = (new_shape - new_h) / 2
    top, bottom = int(round(pad_y - 0.1)), int(round(pad_y + 0.1))
    left, right = int(round(pad_x - 0.1)), int(round(pad_x + 0.1))
    img = cv2.copyMakeBorder(img, top, bottom, left, right,
                             cv2.BORDER_CONSTANT, value=color)
    return img, ratio, (left, top)
