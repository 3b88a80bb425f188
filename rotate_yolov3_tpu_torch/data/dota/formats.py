"""DOTA annotation format IO.

Copy of ``rotate_yolov3_tpu/data/dota/formats.py`` (numpy/cv2,
framework-free). DOTA labels each object as an 8-coordinate quadrilateral
+ category name + difficulty flag, one per line. These helpers convert
between that format and the framework's (cls, cx, cy, w, h, theta)
rotated-box convention (quad -> min-area enclosing rotated rect via cv2,
the standard reduction).
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np


def parse_dota_annotation(path: str) -> List[Dict]:
    """Read a DOTA .txt: lines of 'x1 y1 x2 y2 x3 y3 x4 y4 category difficult'.

    Header lines (imagesource:/gsd:) are skipped. Returns dicts with
    'poly' (4, 2) float32, 'name' str, 'difficult' int.
    """
    objs = []
    if not os.path.exists(path):
        return objs
    with open(path, "r") as f:
        for raw in f:
            parts = raw.strip().split()
            if not parts or parts[0].startswith(("imagesource", "gsd")):
                continue
            if len(parts) < 9:
                continue
            poly = np.array([float(v) for v in parts[:8]],
                            np.float32).reshape(4, 2)
            name = parts[8]
            difficult = int(parts[9]) if len(parts) > 9 else 0
            objs.append({"poly": poly, "name": name, "difficult": difficult})
    return objs


def write_dota_annotation(path: str, objs: Sequence[Dict]) -> None:
    with open(path, "w") as f:
        for o in objs:
            coords = " ".join(f"{v:.1f}" for v in
                              np.asarray(o["poly"]).reshape(-1))
            f.write(f"{coords} {o['name']} {o.get('difficult', 0)}\n")


def poly_to_rbox(poly: np.ndarray) -> Tuple[float, float, float, float,
                                            float]:
    """(4, 2) quad -> min-area enclosing (cx, cy, w, h, theta[rad])."""
    import cv2

    (cx, cy), (w, h), ang = cv2.minAreaRect(
        np.asarray(poly, np.float32).reshape(-1, 1, 2))
    return float(cx), float(cy), float(w), float(h), math.radians(ang)


def rbox_to_poly(cx: float, cy: float, w: float, h: float,
                 theta: float) -> np.ndarray:
    """(cx, cy, w, h, theta) -> (4, 2) corner quad."""
    cos, sin = math.cos(theta), math.sin(theta)
    pts = []
    for sx, sy in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
        dx, dy = sx * w / 2, sy * h / 2
        pts.append((cx + dx * cos - dy * sin, cy + dx * sin + dy * cos))
    return np.array(pts, np.float32)


def objs_to_labels(objs: Sequence[Dict], class_names: Sequence[str],
                   img_w: int, img_h: int,
                   skip_difficult: bool = False) -> np.ndarray:
    """DOTA objects -> (N, 6) normalized framework labels."""
    rows = []
    name_to_id = {n: i for i, n in enumerate(class_names)}
    for o in objs:
        if o["name"] not in name_to_id:
            continue
        if skip_difficult and o.get("difficult", 0):
            continue
        cx, cy, w, h, th = poly_to_rbox(o["poly"])
        rows.append([name_to_id[o["name"]], cx / img_w, cy / img_h,
                     w / img_w, h / img_h, th])
    return (np.asarray(rows, np.float32) if rows
            else np.zeros((0, 6), np.float32))
