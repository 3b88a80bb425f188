"""Rotated-box helpers. Boxes are ``(cx, cy, w, h, theta)``, theta in
radians (counterpart of ``rotate_yolov3_tpu/ops/boxes.py``)."""

from __future__ import annotations

import torch


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
