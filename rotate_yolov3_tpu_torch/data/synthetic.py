"""Synthetic rotated-box dataset generator.

A copy of ``rotate_yolov3_tpu/data/synthetic.py``: for the same arguments it
writes the same files, byte for byte. Dark backgrounds with bright filled
rotated rectangles, labels derived exactly from the drawn geometry, in the
reference's dataset layout (images/ + labels/ + a list .txt), so tests and
smoke runs exercise the real loading path without a downloaded dataset.
Needs cv2 (drawing and JPEG encoding).
"""

from __future__ import annotations

import math
import os
from typing import Tuple

import numpy as np


def make_synthetic_dataset(root: str, n_images: int = 32,
                           img_size: Tuple[int, int] = (320, 320),
                           n_boxes: Tuple[int, int] = (1, 4),
                           n_classes: int = 1, seed: int = 0) -> str:
    """Write a synthetic dataset under ``root``; returns the list-file path.

    Class c is drawn with intensity bright-to-dark by class id so multiclass
    is learnable in principle.
    """
    import cv2

    img_dir = os.path.join(root, "images")
    lbl_dir = os.path.join(root, "labels")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lbl_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    h, w = img_size
    paths = []
    for i in range(n_images):
        img = rng.integers(20, 60, (h, w, 3)).astype(np.uint8)
        rows = []
        for _ in range(int(rng.integers(n_boxes[0], n_boxes[1] + 1))):
            bw = rng.uniform(0.12, 0.3) * w
            bh = rng.uniform(0.05, 0.15) * h
            cx = rng.uniform(0.2, 0.8) * w
            cy = rng.uniform(0.2, 0.8) * h
            th = rng.uniform(-math.pi / 2, math.pi / 2)
            cls = int(rng.integers(0, n_classes))
            deg = math.degrees(th)
            pts = cv2.boxPoints(((cx, cy), (bw, bh), deg)).astype(np.int32)
            shade = 230 - cls * (150 // max(n_classes, 1))
            cv2.fillPoly(img, [pts], (shade, shade, shade))
            rows.append(f"{cls} {cx / w:.6f} {cy / h:.6f} {bw / w:.6f} "
                        f"{bh / h:.6f} {th:.6f}")
        name = f"im{i:04d}"
        cv2.imwrite(os.path.join(img_dir, name + ".jpg"), img)
        with open(os.path.join(lbl_dir, name + ".txt"), "w") as f:
            f.write("\n".join(rows) + ("\n" if rows else ""))
        paths.append(os.path.join(img_dir, name + ".jpg"))
    list_path = os.path.join(root, "train.txt")
    with open(list_path, "w") as f:
        f.write("\n".join(paths) + "\n")
    return list_path
