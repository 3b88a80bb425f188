"""Rotated-box helpers. Boxes are ``(cx, cy, w, h, theta)``, theta in
radians (counterpart of ``rotate_yolov3_tpu/ops/boxes.py``)."""

from __future__ import annotations

import math

import torch


def rbox_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) rotated boxes -> (..., 4, 2) corner points, CCW in standard
    math orientation: (-w/2,-h/2), (w/2,-h/2), (w/2,h/2), (-w/2,h/2) rotated
    by theta and translated to the center."""
    cx, cy, w, h, th = (boxes[..., i] for i in range(5))
    cos, sin = torch.cos(th), torch.sin(th)
    dx = torch.stack([-w, w, w, -w], dim=-1) * 0.5   # (..., 4)
    dy = torch.stack([-h, -h, h, h], dim=-1) * 0.5
    x = cx[..., None] + dx * cos[..., None] - dy * sin[..., None]
    y = cy[..., None] + dx * sin[..., None] + dy * cos[..., None]
    return torch.stack([x, y], dim=-1)               # (..., 4, 2)


def rbox_area(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) -> (...,) rectangle areas (w*h)."""
    return boxes[..., 2] * boxes[..., 3]


def poly_area(pts: torch.Tensor) -> torch.Tensor:
    """Shoelace area of (..., K, 2) closed polygons (vertices in order)."""
    x, y = pts[..., 0], pts[..., 1]
    xn, yn = torch.roll(x, -1, dims=-1), torch.roll(y, -1, dims=-1)
    return 0.5 * torch.abs(torch.sum(x * yn - xn * y, dim=-1))


def rbox_aabb(boxes: torch.Tensor) -> torch.Tensor:
    """Axis-aligned bounding box of rotated boxes: (..., 4) = x1,y1,x2,y2."""
    c = rbox_corners(boxes)
    return torch.cat([c.amin(dim=-2), c.amax(dim=-2)], dim=-1)


def normalize_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angles into [-pi/2, pi/2) using the rect's 180° symmetry."""
    return torch.remainder(theta + math.pi / 2, math.pi) - math.pi / 2


def scale_coords_rotated(boxes: torch.Tensor, ratio, pad) -> torch.Tensor:
    """Map rotated boxes from letterboxed coords back to the original image:
    subtract the padding, divide by the resize ratio. Angles pass through
    (letterbox is isotropic), as do trailing channels (score, class).

    Args:
      boxes: (..., 5+) with (cx, cy, w, h, theta) first.
      ratio: scalar resize ratio (new/old).
      pad:   (pad_x, pad_y) letterbox padding in letterboxed pixels.
    """
    pad = torch.as_tensor(pad, dtype=boxes.dtype, device=boxes.device)
    cx = (boxes[..., 0] - pad[0]) / ratio
    cy = (boxes[..., 1] - pad[1]) / ratio
    w = boxes[..., 2] / ratio
    h = boxes[..., 3] / ratio
    out = torch.stack([cx, cy, w, h, boxes[..., 4]], dim=-1)
    if boxes.shape[-1] > 5:
        out = torch.cat([out, boxes[..., 5:]], dim=-1)
    return out
