"""DOTA tile cropping: huge aerial images -> overlapping tiles + remapped labels.

Copy of ``rotate_yolov3_tpu/data/dota/img_split.py`` (numpy/cv2,
framework-free), the equivalent of the DOTA devkit's ``ImgSplit.py``:
split into subsize x subsize tiles with ``gap`` overlap, shift each
object's polygon into tile coordinates, keep objects whose clipped-area
fraction inside the tile exceeds ``keep_frac`` (truncated remainders marked
difficult, matching the devkit's behavior). Tile names follow the devkit
convention ``{base}__{scale}__{x}___{y}`` that ``result_merge`` parses
back.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np


def tile_origins(w: int, h: int, subsize: int, gap: int
                 ) -> List[Tuple[int, int]]:
    """Top-left corners of the overlapping tile grid covering (w, h)."""
    slide = subsize - gap
    xs = list(range(0, max(w - subsize, 0) + 1, slide))
    if not xs or xs[-1] + subsize < w:
        xs.append(max(w - subsize, 0))
    ys = list(range(0, max(h - subsize, 0) + 1, slide))
    if not ys or ys[-1] + subsize < h:
        ys.append(max(h - subsize, 0))
    return [(x, y) for y in sorted(set(ys)) for x in sorted(set(xs))]


def _clip_poly_to_rect(poly: np.ndarray, x0: float, y0: float,
                       x1: float, y1: float) -> float:
    """Area of polygon clipped to an axis-aligned rect (Sutherland-Hodgman).

    Small host-side helper for the keep-fraction test."""
    pts = [tuple(p) for p in poly]
    for edge in range(4):
        if not pts:
            return 0.0
        out = []
        n = len(pts)
        for i in range(n):
            px, py = pts[i]
            qx, qy = pts[(i + 1) % n]
            if edge == 0:
                p_in, q_in = px >= x0, qx >= x0
                t = lambda: (x0, py + (qy - py) * (x0 - px) / (qx - px))
            elif edge == 1:
                p_in, q_in = px <= x1, qx <= x1
                t = lambda: (x1, py + (qy - py) * (x1 - px) / (qx - px))
            elif edge == 2:
                p_in, q_in = py >= y0, qy >= y0
                t = lambda: (px + (qx - px) * (y0 - py) / (qy - py), y0)
            else:
                p_in, q_in = py <= y1, qy <= y1
                t = lambda: (px + (qx - px) * (y1 - py) / (qy - py), y1)
            if p_in:
                out.append((px, py))
            if p_in != q_in:
                out.append(t())
        pts = out
    if len(pts) < 3:
        return 0.0
    arr = np.asarray(pts)
    x, y = arr[:, 0], arr[:, 1]
    return 0.5 * abs(float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)))


def split_image(img: np.ndarray, objs: Sequence[Dict], subsize: int = 1024,
                gap: int = 200, keep_frac: float = 0.7
                ) -> List[Tuple[Tuple[int, int], np.ndarray, List[Dict]]]:
    """Split one image + DOTA objects into tiles.

    Returns [(origin, tile_img, tile_objs)] where tile_objs polygons are in
    tile coordinates; objects kept if >= keep_frac of their area lies inside
    the tile (partially-truncated survivors flagged difficult, like the
    devkit).
    """
    h, w = img.shape[:2]
    out = []
    for (x0, y0) in tile_origins(w, h, subsize, gap):
        x1, y1 = min(x0 + subsize, w), min(y0 + subsize, h)
        tile = img[y0:y1, x0:x1]
        if tile.shape[0] < subsize or tile.shape[1] < subsize:
            pad = np.zeros((subsize, subsize) + tile.shape[2:],
                           tile.dtype)
            pad[:tile.shape[0], :tile.shape[1]] = tile
            tile = pad
        tile_objs = []
        for o in objs:
            poly = np.asarray(o["poly"], np.float32)
            full = _clip_poly_to_rect(poly, -1e9, -1e9, 1e9, 1e9)
            inside = _clip_poly_to_rect(poly, x0, y0, x1, y1)
            if full <= 0 or inside / full < keep_frac:
                continue
            shifted = poly - np.array([x0, y0], np.float32)
            tile_objs.append({
                "poly": shifted, "name": o["name"],
                "difficult": o.get("difficult", 0)
                if inside / full > 0.999 else 1})
        out.append(((x0, y0), tile, tile_objs))
    return out


def tile_name(base: str, x: int, y: int, scale: float = 1.0) -> str:
    """Devkit naming: base__scale__x___y (parsed by result_merge)."""
    return f"{base}__{scale:g}__{x}___{y}"


def parse_tile_name(name: str) -> Tuple[str, float, int, int]:
    base, rest = name.split("__", 1)
    scale_s, xy = rest.split("__", 1)
    x_s, y_s = xy.split("___")
    return base, float(scale_s), int(x_s), int(y_s)


def split_dataset(src_img_dir: str, src_label_dir: str, dst_dir: str,
                  subsize: int = 1024, gap: int = 200,
                  keep_frac: float = 0.7, exts=(".png", ".jpg", ".tif")
                  ) -> List[str]:
    """Offline dataset splitting (the devkit CLI role). Returns tile paths."""
    import cv2

    from .formats import parse_dota_annotation, write_dota_annotation

    img_out = os.path.join(dst_dir, "images")
    lbl_out = os.path.join(dst_dir, "labelTxt")
    os.makedirs(img_out, exist_ok=True)
    os.makedirs(lbl_out, exist_ok=True)
    written = []
    for fname in sorted(os.listdir(src_img_dir)):
        stem, ext = os.path.splitext(fname)
        if ext.lower() not in exts:
            continue
        img = cv2.imread(os.path.join(src_img_dir, fname))
        if img is None:
            continue
        objs = parse_dota_annotation(
            os.path.join(src_label_dir, stem + ".txt"))
        for (x0, y0), tile, tile_objs in split_image(
                img, objs, subsize, gap, keep_frac):
            tname = tile_name(stem, x0, y0)
            tpath = os.path.join(img_out, tname + ".png")
            cv2.imwrite(tpath, tile)
            write_dota_annotation(
                os.path.join(lbl_out, tname + ".txt"), tile_objs)
            written.append(tpath)
    return written
