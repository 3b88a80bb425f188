"""Exact rotated-rectangle intersection by Green's-theorem slab clipping.

Torch counterpart of ``rotate_yolov3_tpu/ops/skew_iou_green.py``
(``inter_area_green``, ``inter_area_green_bframe``, ``skew_iou_green``,
``skew_iou_matrix_green``), with the same operations in the same order; see
that module for the derivation:

    area(A ∩ B) = ∮ (x dy − y dx) / 2 over the pieces of A's edges inside B
                  and of B's edges inside A,

each piece found by slab (Liang–Barsky) clipping against the other rect.
A's edges clip against B expanded by σ and B's edges against A shrunk by σ,
so a boundary shared by both rects counts once. Edges parallel to a slab
give IEEE ±inf crossings and land in an empty or unconstrained window on
their own; ``torch.minimum``/``torch.maximum`` propagate NaN, so a NaN in a
window (0·inf) makes ``hi > lo`` false, as in the reference.

These functions are the plain versions of the ``"green"`` and ``"green2"``
pair algos of kernels B, C and E (``ops.skew_iou_cuda``,
``ops.nms_greedy``).
"""

from __future__ import annotations

import torch

_EPS = 1e-8
_SIG_REL = 1e-5

# corner sign pattern, CCW in standard orientation
_SIGNS = ((-1, -1), (1, -1), (1, 1), (-1, 1))


def _corner_offsets(w, h, ux, uy):
    """Corner offsets relative to the rect center: lists of 4 x / 4 y."""
    hw, hh = w * 0.5, h * 0.5
    xs = [sx * hw * ux - sy * hh * uy for sx, sy in _SIGNS]
    ys = [sx * hw * uy + sy * hh * ux for sx, sy in _SIGNS]
    return xs, ys


def _rect_dists(px, py, ux, uy, hw, hh):
    """Signed distances (positive inside) of point p, relative to the rect
    center, to the rect's 4 half-planes."""
    s = px * ux + py * uy
    t = -px * uy + py * ux
    return (hw - s, hw + s, hh - t, hh + t)


def _edge_contrib(p0x, p0y, p1x, p1y, d0, recips):
    """Green's line integral of edge p0→p1 clipped to the 4 half-planes
    (2 slabs); ``d0`` are the start point's distances, ``recips`` the
    per-axis crossing reciprocals."""
    rs, rt = recips
    tc0 = d0[0] * rs
    tc1 = -(d0[1] * rs)
    tc2 = d0[2] * rt
    tc3 = -(d0[3] * rt)
    zero = tc0.new_zeros(())
    lo = torch.maximum(torch.maximum(torch.minimum(tc0, tc1),
                                     torch.minimum(tc2, tc3)), zero)
    hi = torch.minimum(torch.minimum(torch.maximum(tc0, tc1),
                                     torch.maximum(tc2, tc3)),
                       tc0.new_ones(()))
    c = 0.5 * (hi - lo) * (p0x * p1y - p0y * p1x)
    return torch.where(hi > lo, c, zero)


def inter_area_green(acx, acy, aw, ah, ath, bcx, bcy, bw, bh, bth):
    """Exact rect∩rect area, elementwise over broadcastable f32 fields."""
    uax, uay = torch.cos(ath), torch.sin(ath)
    ubx, uby = torch.cos(bth), torch.sin(bth)
    ahw, ahh = aw * 0.5, ah * 0.5
    bhw, bhh = bw * 0.5, bh * 0.5
    arx, ary = _corner_offsets(aw, ah, uax, uay)   # rel. own center
    brx, bry = _corner_offsets(bw, bh, ubx, uby)
    ox, oy = acx - bcx, acy - bcy                  # A center rel. B center

    sig = _SIG_REL * (0.5 * (aw + ah + bw + bh)
                      + torch.abs(ox) + torch.abs(oy))
    bhw_r, bhh_r = bhw + sig, bhh + sig          # B expanded (relaxed)
    ahw_s, ahh_s = ahw - sig, ahh - sig          # A shrunk (strict)

    pax = [arx[k] + ox for k in range(4)]
    pay = [ary[k] + oy for k in range(4)]
    da = [_rect_dists(pax[k], pay[k], ubx, uby, bhw_r, bhh_r)
          for k in range(4)]
    qax = [brx[k] - ox for k in range(4)]
    qay = [bry[k] - oy for k in range(4)]
    db = [_rect_dists(qax[k], qay[k], uax, uay, ahw_s, ahh_s)
          for k in range(4)]

    # reciprocals shared by opposite edges (e₂ = −e₀, e₃ = −e₁ exactly)
    def _recips(e0x, e0y, ux, uy):
        return (1.0 / (e0x * ux + e0y * uy),
                1.0 / (-e0x * uy + e0y * ux))

    ra = [_recips(arx[k + 1] - arx[k], ary[k + 1] - ary[k], ubx, uby)
          for k in (0, 1)]
    ra += [(-ra[0][0], -ra[0][1]), (-ra[1][0], -ra[1][1])]
    rb = [_recips(brx[k + 1] - brx[k], bry[k + 1] - bry[k], uax, uay)
          for k in (0, 1)]
    rb += [(-rb[0][0], -rb[0][1]), (-rb[1][0], -rb[1][1])]

    area = torch.zeros_like(ox)
    for k in range(4):
        n = (k + 1) % 4
        area = area + _edge_contrib(pax[k], pay[k], pax[n], pay[n],
                                    da[k], ra[k])
        area = area + _edge_contrib(brx[k], bry[k], brx[n], bry[n],
                                    db[k], rb[k])
    return torch.maximum(area, area.new_zeros(()))


def inter_area_green_bframe(acx, acy, aw, ah, ath, bcx, bcy, bw, bh, bth):
    """``inter_area_green`` computed in B's rotated frame (the reference's
    ``"green2"`` algo): B's slabs are axis-aligned, B's corners are the
    constants (±bhw, ±bhh), every clip reciprocal is 1/(2·m) of a half-dim
    × cos/sin product, and all four of B's edge cross products are
    2·bhw·bhh. Same area within FP reassociation."""
    uax, uay = torch.cos(ath), torch.sin(ath)
    ubx, uby = torch.cos(bth), torch.sin(bth)
    ca = uax * ubx + uay * uby                   # cos(θa − θb)
    sa = uay * ubx - uax * uby                   # sin(θa − θb)
    ox, oy = acx - bcx, acy - bcy
    os_ = ox * ubx + oy * uby                    # A center in B frame
    ot = -ox * uby + oy * ubx

    ahw, ahh = aw * 0.5, ah * 0.5
    bhw, bhh = bw * 0.5, bh * 0.5
    sig = _SIG_REL * (0.5 * (aw + ah + bw + bh)
                      + torch.abs(ox) + torch.abs(oy))
    bhw_r, bhh_r = bhw + sig, bhh + sig          # B expanded (relaxed)
    ahw_s, ahh_s = ahw - sig, ahh - sig          # A shrunk (strict)

    m1, m2 = ahw * ca, ahh * sa
    m3, m4 = ahw * sa, ahh * ca
    # A corners in B frame, signs per _SIGNS
    p, q = m1 - m2, m1 + m2
    r, w_ = m3 + m4, m3 - m4
    s_ = [os_ - p, os_ + q, os_ + p, os_ - q]
    t_ = [ot - r, ot + w_, ot + r, ot - w_]
    da = [(bhw_r - s_[k], bhw_r + s_[k], bhh_r - t_[k], bhh_r + t_[k])
          for k in range(4)]
    # A edge directions: e0 = (2m1, 2m3), e1 = (−2m2, 2m4), e2/e3 negated
    ra = [(0.5 / m1, 0.5 / m3), (-0.5 / m2, 0.5 / m4)]
    ra += [(-ra[0][0], -ra[0][1]), (-ra[1][0], -ra[1][1])]

    n1, n2 = bhw * ca, bhh * sa
    n3, n4 = bhw * sa, bhh * ca
    # B corners projected on A's axes, A-centered
    cu = os_ * ca + ot * sa
    cv = -os_ * sa + ot * ca
    pu, qu = n1 - n2, n1 + n2
    rv, wv = n4 - n3, n4 + n3
    u_ = [-qu - cu, pu - cu, qu - cu, -pu - cu]
    v_ = [-rv - cv, -wv - cv, rv - cv, wv - cv]
    db = [(ahw_s - u_[k], ahw_s + u_[k], ahh_s - v_[k], ahh_s + v_[k])
          for k in range(4)]
    # B edge directions on A's axes: e0 -> (2n1, −2n3), e1 -> (2n2, 2n4)
    rb = [(0.5 / n1, -0.5 / n3), (0.5 / n2, 0.5 / n4)]
    rb += [(-rb[0][0], -rb[0][1]), (-rb[1][0], -rb[1][1])]

    bcross = 2.0 * bhw * bhh    # p0 × p1 of each of B's edges, in B frame

    area = torch.zeros_like(os_)
    for k in range(4):
        n = (k + 1) % 4
        area = area + _edge_contrib(s_[k], t_[k], s_[n], t_[n], da[k], ra[k])
        area = area + _edge_contrib_cross(bcross, db[k], rb[k])
    return torch.maximum(area, area.new_zeros(()))


def _edge_contrib_cross(cross, d0, recips):
    """``_edge_contrib`` with the p0×p1 cross product precomputed."""
    rs, rt = recips
    tc0 = d0[0] * rs
    tc1 = -(d0[1] * rs)
    tc2 = d0[2] * rt
    tc3 = -(d0[3] * rt)
    zero = tc0.new_zeros(())
    lo = torch.maximum(torch.maximum(torch.minimum(tc0, tc1),
                                     torch.minimum(tc2, tc3)), zero)
    hi = torch.minimum(torch.minimum(torch.maximum(tc0, tc1),
                                     torch.maximum(tc2, tc3)),
                       tc0.new_ones(()))
    c = 0.5 * (hi - lo) * cross
    return torch.where(hi > lo, c, zero)


def skew_iou_green(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Elementwise exact skew-IoU of broadcastable (..., 5) rotated boxes."""
    b1, b2 = torch.broadcast_tensors(b1.float(), b2.float())
    inter = inter_area_green(
        b1[..., 0], b1[..., 1], b1[..., 2], b1[..., 3], b1[..., 4],
        b2[..., 0], b2[..., 1], b2[..., 2], b2[..., 3], b2[..., 4])
    a1 = b1[..., 2] * b1[..., 3]
    a2 = b2[..., 2] * b2[..., 3]
    inter = torch.minimum(inter, torch.minimum(a1, a2))
    return inter / (a1 + a2 - inter + _EPS)


def skew_iou_matrix_green(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise (N, 5) × (M, 5) → (N, M) exact IoU matrix."""
    return skew_iou_green(a[:, None, :], b[None, :, :])
