"""Deterministic binned top-k for detection score selection.

Torch counterpart of ``rotate_yolov3_tpu/ops/topk.py`` with the same
semantics (see that module for why the bins are strided):

* flat index ``i`` goes to bin ``i % num_bins``, ``num_bins`` defaulting to
  max(512, 4k) rounded up to a multiple of 128, so adjacent cells and
  anchors land in different bins;
* each bin keeps its top-2 (max, then the max with the first argmax masked);
* the ``2 * num_bins`` survivors go through an exact top-k, and indices are
  clamped to ``n - 1``.

The exact top-k here is a stable descending sort, so equal scores keep the
lower index first, as ``lax.top_k`` orders them (``torch.topk`` does not
promise an order for ties).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def exact_topk(scores: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k values and indices over the last axis, descending; ties keep
    the lower index first."""
    v, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def strided_topk(scores: torch.Tensor, k: int,
                 num_bins: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k values + flat indices over the last axis, strided-bin reduced.

    Exact whenever N <= 2 * num_bins; otherwise exact up to the
    three-congruent-candidates collision of the reference.
    """
    if num_bins is None:
        num_bins = -(-max(512, 4 * k) // 128) * 128
    lead, n = scores.shape[:-1], scores.shape[-1]
    if n <= 2 * num_bins:
        return exact_topk(scores, min(k, n))
    s = scores.reshape(-1, n)
    b = s.shape[0]
    rows = -(-n // num_bins)
    pad = rows * num_bins - n
    neg = torch.finfo(s.dtype).min
    v = torch.nn.functional.pad(s, (0, pad), value=neg)
    v = v.reshape(b, rows, num_bins)          # element (r, c) = flat r*nb+c
    # per-bin top-2: n > 2*nb puts >= 2 real elements in every bin
    # (argmax returns the first maximal index, as jnp.argmax does)
    m1, a1 = v.amax(dim=1), v.argmax(dim=1)
    ri = torch.arange(rows, device=s.device)[None, :, None]
    v2 = torch.where(ri == a1[:, None, :], torch.full_like(v, neg), v)
    m2, a2 = v2.amax(dim=1), v2.argmax(dim=1)
    ci = torch.arange(num_bins, device=s.device)[None, :]
    cand_v = torch.cat([m1, m2], dim=1)                         # (B, 2*nb)
    cand_i = torch.cat([a1 * num_bins + ci, a2 * num_bins + ci], dim=1)
    tv, ti = exact_topk(cand_v, k)
    idx = torch.gather(cand_i, 1, ti)
    idx = torch.clamp(idx, max=n - 1)         # clamp padded-slot indices
    return tv.reshape(lead + (k,)), idx.reshape(lead + (k,))


def select_topk(scores: torch.Tensor, k: int, approx: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The NMS-path candidate selector: ``strided_topk`` when ``approx``
    (the default on the card), else the exact top-k."""
    if approx:
        return strided_topk(scores, k)
    return exact_topk(scores, min(k, scores.shape[-1]))
