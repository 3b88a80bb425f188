"""Rotated-box drawing and the training-curve plot.

The counterparts of ``rotate_yolov3_tpu/utils/plotting.py``: rotated
rectangles drawn on images for detect (``draw_detections``, cv2 imported
lazily) and the plot of the per-epoch ``results.txt`` that the train CLI
appends (``plot_results``, matplotlib imported lazily).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np


def _color_for_class(c: int):
    rng = np.random.default_rng(c + 12345)
    return tuple(int(v) for v in rng.integers(60, 255, 3))


def rbox_points(box) -> np.ndarray:
    """(cx, cy, w, h, theta) -> (4, 2) int corner points for drawing."""
    cx, cy, w, h, th = [float(v) for v in box[:5]]
    cos, sin = math.cos(th), math.sin(th)
    pts = []
    for dx, dy in ((-w, -h), (w, -h), (w, h), (-w, h)):
        dx, dy = dx / 2, dy / 2
        pts.append((cx + dx * cos - dy * sin, cy + dx * sin + dy * cos))
    return np.array(pts, dtype=np.int32)


def draw_detections(img: np.ndarray, dets: np.ndarray,
                    names: Optional[Sequence[str]] = None,
                    thickness: int = 2) -> np.ndarray:
    """Draw (N, 7) rotated detections (cx,cy,w,h,theta,score,cls) on HWC img."""
    import cv2

    out = np.ascontiguousarray(img.copy())
    for det in dets:
        cls = int(det[6])
        color = _color_for_class(cls)
        pts = rbox_points(det)
        cv2.polylines(out, [pts.reshape(-1, 1, 2)], True, color, thickness)
        label = (f"{names[cls]} " if names and cls < len(names) else
                 f"c{cls} ") + f"{float(det[5]):.2f}"
        org = (int(pts[:, 0].min()), max(12, int(pts[:, 1].min()) - 4))
        cv2.putText(out, label, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1,
                    cv2.LINE_AA)
    return out


def plot_results(results_path: str = "results.txt",
                 out_path: str = "results.png") -> None:
    """Plot the per-epoch results table the train CLI appends (loss terms,
    P, R, mAP) into ``out_path``."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = np.loadtxt(results_path, ndmin=2)
    if data.size == 0:
        return
    cols = ["box", "obj", "cls", "angle", "total", "P", "R", "mAP"]
    fig, axes = plt.subplots(2, 4, figsize=(14, 6))
    for i, (ax, name) in enumerate(zip(axes.flat, cols)):
        if 1 + i < data.shape[1]:
            ax.plot(data[:, 0], data[:, 1 + i])
        ax.set_title(name)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
