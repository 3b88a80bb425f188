"""Label-aware augmentation on the host: HSV jitter, random affine with
rotation, flips.

A copy of ``rotate_yolov3_tpu/data/augment.py`` (numpy; cv2 imported inside
the functions that need it, so the module imports without it). The affine
rotates the label angles too: the 4 box corners go through the affine
matrix and the rotated rect is re-derived from the transformed edge
vectors, exact under rotation, scale and translation (shear defaults to 0).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def augment_hsv(img: np.ndarray, h_gain: float, s_gain: float,
                v_gain: float, rng: np.random.Generator) -> np.ndarray:
    """Random HSV jitter (in-place safe: returns a new image)."""
    import cv2

    r = rng.uniform(-1, 1, 3) * [h_gain, s_gain, v_gain] + 1
    hue, sat, val = cv2.split(cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
    dtype = img.dtype
    x = np.arange(0, 256, dtype=np.int16)
    lut_hue = ((x * r[0]) % 180).astype(dtype)
    lut_sat = np.clip(x * r[1], 0, 255).astype(dtype)
    lut_val = np.clip(x * r[2], 0, 255).astype(dtype)
    img_hsv = cv2.merge((cv2.LUT(hue, lut_hue), cv2.LUT(sat, lut_sat),
                         cv2.LUT(val, lut_val)))
    return cv2.cvtColor(img_hsv, cv2.COLOR_HSV2BGR)


def _labels_to_corners(labels: np.ndarray, size: int) -> np.ndarray:
    """(N, 6) normalized (cls,x,y,w,h,th) -> (N, 4, 2) pixel corners."""
    cx, cy = labels[:, 1] * size, labels[:, 2] * size
    w, h = labels[:, 3] * size, labels[:, 4] * size
    th = labels[:, 5]
    cos, sin = np.cos(th), np.sin(th)
    corners = np.zeros((len(labels), 4, 2), np.float32)
    for k, (sx, sy) in enumerate(((-1, -1), (1, -1), (1, 1), (-1, 1))):
        dx, dy = sx * w / 2, sy * h / 2
        corners[:, k, 0] = cx + dx * cos - dy * sin
        corners[:, k, 1] = cy + dx * sin + dy * cos
    return corners


def _corners_to_labels(corners: np.ndarray, cls: np.ndarray,
                       size: int) -> np.ndarray:
    """(N, 4, 2) pixel corners -> (N, 6) normalized labels.

    Re-derives (w, h, theta) from the transformed edge vectors: exact when
    the affine is a similarity transform (rotation/scale/translation)."""
    center = corners.mean(axis=1)
    e_w = corners[:, 1] - corners[:, 0]     # w-axis edge
    e_h = corners[:, 3] - corners[:, 0]     # h-axis edge
    w = np.linalg.norm(e_w, axis=1)
    h = np.linalg.norm(e_h, axis=1)
    th = np.arctan2(e_w[:, 1], e_w[:, 0])
    out = np.zeros((len(corners), 6), np.float32)
    out[:, 0] = cls
    out[:, 1] = center[:, 0] / size
    out[:, 2] = center[:, 1] / size
    out[:, 3] = w / size
    out[:, 4] = h / size
    out[:, 5] = th
    return out


def random_affine(img: np.ndarray, labels: np.ndarray,
                  degrees: float, translate: float, scale: float,
                  shear: float, rng: np.random.Generator,
                  border_value: int = 128
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Random rotation/scale/translation (+optional shear) of image+labels.

    ``img`` must be square (letterboxed); ``labels`` (N, 6) normalized.
    Returns the warped image and transformed labels; boxes whose centers
    leave the image or that collapse below 2px are dropped.
    """
    import cv2

    size = img.shape[0]
    ang = rng.uniform(-degrees, degrees)
    scl = rng.uniform(1 - scale, 1 + scale)
    rot = cv2.getRotationMatrix2D((size / 2, size / 2), ang, scl)
    rot[0, 2] += rng.uniform(-translate, translate) * size
    rot[1, 2] += rng.uniform(-translate, translate) * size
    if shear:
        sh = math.tan(math.radians(rng.uniform(-shear, shear)))
        shear_m = np.array([[1, sh, 0], [0, 1, 0]], np.float32)
        m3 = np.vstack([rot, [0, 0, 1]]) @ np.vstack([shear_m, [0, 0, 1]])
        rot = m3[:2]

    out = cv2.warpAffine(img, rot, (size, size), flags=cv2.INTER_LINEAR,
                         borderValue=(border_value,) * 3)
    if len(labels) == 0:
        return out, labels

    corners = _labels_to_corners(labels, size)
    flat = corners.reshape(-1, 2)
    warped = (flat @ rot[:, :2].T + rot[:, 2]).reshape(-1, 4, 2)
    new = _corners_to_labels(warped, labels[:, 0], size)

    keep = ((new[:, 1] > 0) & (new[:, 1] < 1)
            & (new[:, 2] > 0) & (new[:, 2] < 1)
            & (new[:, 3] * size > 2) & (new[:, 4] * size > 2))
    return out, new[keep]


def flip_lr(img: np.ndarray, labels: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Horizontal flip with angle fix-up (theta -> -theta)."""
    img = np.ascontiguousarray(img[:, ::-1])
    if len(labels):
        labels = labels.copy()
        labels[:, 1] = 1.0 - labels[:, 1]
        labels[:, 5] = -labels[:, 5]
    return img, labels


def flip_ud(img: np.ndarray, labels: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Vertical flip with angle fix-up."""
    img = np.ascontiguousarray(img[::-1])
    if len(labels):
        labels = labels.copy()
        labels[:, 2] = 1.0 - labels[:, 2]
        labels[:, 5] = -labels[:, 5]
    return img, labels
