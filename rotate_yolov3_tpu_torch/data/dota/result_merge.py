"""Cross-tile detection merge: per-tile results -> source-image results.

Counterpart of ``rotate_yolov3_tpu/data/dota/result_merge.py``, the
equivalent of the DOTA devkit's ``ResultMerge.py``: map per-tile detections
back to source-image coordinates using the ``base__scale__x___y`` tile
naming, then run per-class cross-tile rotated NMS on the host with the exact
polygon IoU of ``native.polyiou`` (C++, as the devkit's merge is).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

from ...native.polyiou import rbox_iou_matrix
from .img_split import parse_tile_name


def merge_tile_detections(
        tile_dets: Dict[str, np.ndarray],
        nms_thres: float = 0.3) -> Dict[str, np.ndarray]:
    """Merge per-tile detections into per-source-image detections.

    Args:
      tile_dets: {tile_name: (N, 7) array (cx,cy,w,h,theta,score,cls)} in
        tile coordinates.
    Returns:
      {source_image_base: (M, 7)} in source coordinates, cross-tile NMS'd
      per class.
    """
    per_image: Dict[str, List[np.ndarray]] = defaultdict(list)
    for tname, dets in tile_dets.items():
        if len(dets) == 0:
            continue
        base, scale, x0, y0 = parse_tile_name(tname)
        d = np.asarray(dets, np.float32).copy()
        # Devkit semantics: in 'base__scale__x___y' the origin (x0, y0) is
        # in RESIZED-image coordinates, so tile->source is
        # (coord + origin) / scale (ResultMerge poly2origpoly), NOT
        # coord/scale + origin.
        d[:, 0] = (d[:, 0] + x0) / scale
        d[:, 1] = (d[:, 1] + y0) / scale
        d[:, 2] /= scale
        d[:, 3] /= scale
        per_image[base].append(d)

    out: Dict[str, np.ndarray] = {}
    for base, chunks in per_image.items():
        all_dets = np.concatenate(chunks, axis=0)
        out[base] = nms_rotated_np(all_dets, nms_thres)
    return out


def nms_rotated_np(dets: np.ndarray, nms_thres: float) -> np.ndarray:
    """Per-class greedy rotated NMS on host arrays, with the exact IoU
    matrix of the native C++ polyiou."""
    if len(dets) == 0:
        return dets
    keep_rows = []
    for c in np.unique(dets[:, 6]):
        d = dets[dets[:, 6] == c]
        order = np.argsort(-d[:, 5], kind="stable")
        d = d[order]
        iou = rbox_iou_matrix(d[:, :5])
        alive = np.ones(len(d), bool)
        for i in range(len(d)):
            if not alive[i]:
                continue
            kill = (iou[i] > nms_thres) & (np.arange(len(d)) > i)
            alive &= ~kill
        keep_rows.append(d[alive])
    merged = np.concatenate(keep_rows, axis=0)
    return merged[np.argsort(-merged[:, 5], kind="stable")]


def write_task1_results(merged: Dict[str, np.ndarray],
                        class_names: Sequence[str], out_dir: str) -> None:
    """Write DOTA Task-1 submission files: Task1_{class}.txt with lines
    'image score x1 y1 ... x4 y4' (the devkit output format)."""
    import os

    from .formats import rbox_to_poly

    os.makedirs(out_dir, exist_ok=True)
    files = {c: open(os.path.join(out_dir, f"Task1_{name}.txt"), "w")
             for c, name in enumerate(class_names)}
    try:
        for base, dets in sorted(merged.items()):
            for row in dets:
                c = int(row[6])
                if c not in files:
                    continue
                poly = rbox_to_poly(*row[:5]).reshape(-1)
                coords = " ".join(f"{v:.2f}" for v in poly)
                files[c].write(f"{base} {row[5]:.4f} {coords}\n")
    finally:
        for f in files.values():
            f.close()
