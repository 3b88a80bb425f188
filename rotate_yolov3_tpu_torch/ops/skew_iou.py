"""Exact skew-IoU (rotated-rectangle IoU) by candidate points and argsort.

Torch counterpart of ``rotate_yolov3_tpu/ops/skew_iou.py`` (``skew_iou``,
``skew_iou_matrix``), with the same branch-free formulation: the
intersection of two convex quads has <= 8 vertices, each an edge-pair
intersection (16 candidates) or a vertex of one rect inside the other (8
candidates); the valid candidates are sorted by angle around their
centroid and the masked shoelace gives the area.

This is the reference's off-TPU IoU oracle, and the default
``iou_matrix_fn`` that ``skew_iou_cuda.skew_iou_matrix_auto`` takes for a
tensor on the CPU. Every selection is a ``torch.where``, so autograd
differentiates it almost everywhere: ``skew_iou_loss`` is the skew-IoU
regression loss. The intersection makes no rectangle assumption, so
``quad_iou`` / ``quad_iou_matrix`` give the exact IoU of convex quads
(the DOTA devkit's polygon IoU).
"""

from __future__ import annotations

import torch

from .boxes import rbox_corners

_EPS = 1e-8
# inclusive inside/on-segment tolerance: keeps vertex-on-edge degeneracies
# (identical boxes, shared edges) stable
_TOL = 1e-6


def _cross(ax, ay, bx, by):
    return ax * by - ay * bx


def _pair_intersection_area(c1: torch.Tensor, c2: torch.Tensor
                            ) -> torch.Tensor:
    """Intersection area of two convex CCW quads given corners (..., 4, 2);
    broadcasts over leading dims."""
    # candidate set A: 16 edge-pair intersection points
    p1, p2 = c1, torch.roll(c1, -1, dims=-2)
    q1, q2 = c2, torch.roll(c2, -1, dims=-2)
    p1x, p1y = p1[..., :, None, 0], p1[..., :, None, 1]
    d1x = (p2 - p1)[..., :, None, 0]
    d1y = (p2 - p1)[..., :, None, 1]
    q1x, q1y = q1[..., None, :, 0], q1[..., None, :, 1]
    d2x = (q2 - q1)[..., None, :, 0]
    d2y = (q2 - q1)[..., None, :, 1]

    denom = _cross(d1x, d1y, d2x, d2y)                     # (..., 4, 4)
    denom_ok = torch.abs(denom) > _EPS
    safe_denom = torch.where(denom_ok, denom, torch.ones_like(denom))
    rx, ry = q1x - p1x, q1y - p1y
    t = _cross(rx, ry, d2x, d2y) / safe_denom
    u = _cross(rx, ry, d1x, d1y) / safe_denom
    inter_ok = (denom_ok & (t >= -_TOL) & (t <= 1 + _TOL)
                & (u >= -_TOL) & (u <= 1 + _TOL))
    zero = denom.new_zeros(())
    ix = torch.where(inter_ok, p1x + t * d1x, zero)
    iy = torch.where(inter_ok, p1y + t * d1y, zero)
    cand_a = torch.stack([ix, iy], dim=-1).reshape(*ix.shape[:-2], 16, 2)
    mask_a = inter_ok.reshape(*inter_ok.shape[:-2], 16)

    # candidate set B: vertices of each quad inside the other
    def _inside(pts, quad):
        a = quad
        b = torch.roll(quad, -1, dims=-2)
        ex = (b - a)[..., None, :, 0]                      # (..., 1, 4)
        ey = (b - a)[..., None, :, 1]
        px = pts[..., :, None, 0] - a[..., None, :, 0]     # (..., 4, 4)
        py = pts[..., :, None, 1] - a[..., None, :, 1]
        crs = _cross(ex, ey, px, py)
        tol = _TOL * torch.sqrt(ex * ex + ey * ey + _EPS)
        return torch.all(crs >= -tol, dim=-1)

    c1b, c2b = torch.broadcast_tensors(c1, c2)
    cand = torch.cat([cand_a, c1b, c2b], dim=-2)           # (..., 24, 2)
    mask = torch.cat([mask_a, _inside(c1, c2), _inside(c2, c1)], dim=-1)

    # convex angular ordering + masked shoelace
    maskf = mask.to(cand.dtype)
    n_valid = torch.sum(maskf, dim=-1)
    centroid = (torch.sum(cand * maskf[..., None], dim=-2)
                / torch.clamp(n_valid, min=1.0)[..., None])
    rel = cand - centroid[..., None, :]
    ang = torch.atan2(rel[..., 1], rel[..., 0])
    key = torch.where(mask, ang, torch.full_like(ang, 1e4))
    order = torch.argsort(key, dim=-1, stable=True)
    sorted_rel = torch.take_along_dim(rel, order[..., None], dim=-2)
    sorted_msk = torch.take_along_dim(maskf, order, dim=-1)

    idx = torch.arange(24, device=cand.device)
    nv = torch.clamp(n_valid, min=1.0)[..., None]
    nxt = torch.where(idx + 1 >= nv, 0, idx + 1).long()
    nxt_rel = torch.take_along_dim(sorted_rel, nxt[..., None], dim=-2)
    crs = _cross(sorted_rel[..., 0], sorted_rel[..., 1], nxt_rel[..., 0],
                 nxt_rel[..., 1])
    area = 0.5 * torch.abs(torch.sum(crs * sorted_msk, dim=-1))
    return torch.where(n_valid >= 3, area, zero)


def rbox_intersection_area(b1: torch.Tensor, b2: torch.Tensor
                           ) -> torch.Tensor:
    """Elementwise intersection area of (..., 5) rotated-box arrays."""
    return _pair_intersection_area(rbox_corners(b1), rbox_corners(b2))


def skew_iou(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Elementwise exact IoU of broadcastable (..., 5) rotated boxes."""
    b1, b2 = torch.broadcast_tensors(b1.float(), b2.float())
    inter = rbox_intersection_area(b1, b2)
    a1 = b1[..., 2] * b1[..., 3]
    a2 = b2[..., 2] * b2[..., 3]
    # the clamp also makes a zero-area box (a point) intersect nothing
    inter = torch.minimum(inter, torch.minimum(a1, a2))
    return inter / (a1 + a2 - inter + _EPS)


def skew_iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise exact IoU matrix: (N, 5) x (M, 5) -> (N, M), or batched
    (B, N, 5) x (B, M, 5) -> (B, N, M)."""
    return skew_iou(a[..., :, None, :], b[..., None, :, :])


def skew_iou_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 - skew-IoU regression loss of broadcastable (..., 5) boxes,
    differentiable almost everywhere."""
    return 1.0 - skew_iou(pred, target)


def quad_area(quads: torch.Tensor) -> torch.Tensor:
    """Shoelace area of (..., 4, 2) quads (vertices in order)."""
    x, y = quads[..., 0], quads[..., 1]
    xn = torch.roll(x, -1, dims=-1)
    yn = torch.roll(y, -1, dims=-1)
    return 0.5 * torch.abs(torch.sum(x * yn - xn * y, dim=-1))


def _ccw_quads(quads: torch.Tensor) -> torch.Tensor:
    """Each quad in counter-clockwise order (the inside tests assume it)."""
    x, y = quads[..., 0], quads[..., 1]
    signed = 0.5 * torch.sum(x * torch.roll(y, -1, dims=-1)
                             - torch.roll(x, -1, dims=-1) * y, dim=-1)
    return torch.where((signed >= 0)[..., None, None], quads,
                       torch.flip(quads, dims=(-2,)))


def quad_iou(q1, q2) -> torch.Tensor:
    """Elementwise exact IoU of broadcastable (..., 4, 2) convex quads."""
    q1 = _ccw_quads(torch.as_tensor(q1, dtype=torch.float32))
    q2 = _ccw_quads(torch.as_tensor(q2, dtype=torch.float32))
    q1, q2 = torch.broadcast_tensors(q1, q2)
    inter = _pair_intersection_area(q1, q2)
    a1, a2 = quad_area(q1), quad_area(q2)
    inter = torch.minimum(inter, torch.minimum(a1, a2))
    return inter / (a1 + a2 - inter + _EPS)


def quad_iou_matrix(a, b) -> torch.Tensor:
    """Pairwise exact quad IoU: (N, 4, 2) x (M, 4, 2) -> (N, M)."""
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32)
    return quad_iou(a[:, None], b[None, :])
