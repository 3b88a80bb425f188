"""Rotated-detection evaluation: skew-IoU matching + VOC-style AP.

Counterpart of ``rotate_yolov3_tpu/eval/metrics.py``: detections are matched
to ground truth by rotated IoU >= 0.5, then per-class P/R/AP and mAP. The
IoU matrices are computed on the host by the port's C++ polygon IoU
(``native/polyiou.py``), with the argsort skew-IoU (``ops/skew_iou.py``) as
the fallback where the library cannot be built; the greedy matching and AP
integration are small numpy.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def _cross_iou_host(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact (K, G) rotated-IoU matrix on the host, by the native polygon
    IoU; if that library cannot be built or loaded, by the argsort
    skew-IoU in torch on the CPU (counted in ``_cross_iou_host.fallbacks``).
    """
    try:
        from ..native import polyiou

        polyiou.get_lib()
    except (OSError, RuntimeError):
        _cross_iou_host.fallbacks += 1
        import torch

        from ..ops.skew_iou import skew_iou_matrix
        return skew_iou_matrix(
            torch.from_numpy(np.ascontiguousarray(a[:, :5], np.float32)),
            torch.from_numpy(np.ascontiguousarray(b[:, :5], np.float32))
        ).numpy()
    from ..data.dota.formats import rbox_to_poly
    qa = np.stack([rbox_to_poly(*r[:5]) for r in a])
    qb = np.stack([rbox_to_poly(*r[:5]) for r in b])
    return polyiou.quad_iou_matrix(qa, qb)


_cross_iou_host.fallbacks = 0


def match_image(dets: np.ndarray, gts: np.ndarray, gt_cls: np.ndarray,
                iou_thr: float = 0.5) -> np.ndarray:
    """Greedy TP assignment for one image.

    Args:
      dets: (K, 7) valid detections (cx,cy,w,h,th,score,cls), score-sorted.
      gts: (G, 5) ground-truth rotated boxes (pixels); gt_cls: (G,).
    Returns: (K,) bool TP flags (each GT matched at most once, same-class
    only) — the reference's matching rule (SURVEY.md §3.3).
    """
    k, g = len(dets), len(gts)
    tp = np.zeros(k, bool)
    if k == 0 or g == 0:
        return tp
    iou = _cross_iou_host(dets, gts)
    used = np.zeros(g, bool)
    det_cls = dets[:, 6].astype(int)
    for i in range(k):
        same = (gt_cls == det_cls[i]) & ~used
        if not same.any():
            continue
        j = np.argmax(np.where(same, iou[i], -1.0))
        if iou[i, j] >= iou_thr and same[j]:
            tp[i] = True
            used[j] = True
    return tp


def compute_ap(recall: np.ndarray, precision: np.ndarray,
               method: str = "continuous") -> float:
    """Average precision from the PR curve.

    ``continuous``: area under the precision envelope (the 2019-lineage
    ``compute_ap``); ``11point``: VOC2007 11-point interpolation (the DOTA
    devkit default, SURVEY.md §2 "DOTA eval")."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[1.0], precision, [0.0]])
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    if method == "11point":
        return float(np.mean([mpre[mrec >= t].max() if (mrec >= t).any()
                              else 0.0 for t in np.linspace(0, 1, 11)]))
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def ap_per_class(tp: np.ndarray, conf: np.ndarray, pred_cls: np.ndarray,
                 target_cls: np.ndarray, method: str = "continuous"
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                            np.ndarray]:
    """Per-class precision/recall/AP over the whole dataset.

    Args are flat arrays across all images. Returns (p, r, ap, f1, classes).
    """
    order = np.argsort(-conf, kind="stable")
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]

    classes = np.unique(np.concatenate([pred_cls, target_cls])).astype(int)
    p, r, ap = [], [], []
    for c in classes:
        sel = pred_cls == c
        n_gt = int((target_cls == c).sum())
        n_p = int(sel.sum())
        if n_p == 0 and n_gt == 0:
            continue
        if n_p == 0 or n_gt == 0:
            p.append(0.0)
            r.append(0.0)
            ap.append(0.0)
            continue
        fpc = np.cumsum(~tp[sel])
        tpc = np.cumsum(tp[sel])
        recall = tpc / (n_gt + 1e-16)
        precision = tpc / (tpc + fpc)
        ap.append(compute_ap(recall, precision, method))
        p.append(float(precision[-1]))
        r.append(float(recall[-1]))
    return (np.asarray(p), np.asarray(r), np.asarray(ap),
            2 * np.asarray(p) * np.asarray(r)
            / (np.asarray(p) + np.asarray(r) + 1e-16),
            classes)


def summarize(stats: List[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]],
              names: Sequence[str] = (), method: str = "continuous"
              ) -> Dict[str, object]:
    """Aggregate per-image (tp, conf, pred_cls, target_cls) stats into the
    reference's P/R/mAP table."""
    if not stats:
        return {"mp": 0.0, "mr": 0.0, "map": 0.0, "per_class": []}
    tp = np.concatenate([s[0] for s in stats])
    conf = np.concatenate([s[1] for s in stats])
    pred_cls = np.concatenate([s[2] for s in stats])
    target_cls = np.concatenate([s[3] for s in stats])
    if len(tp) == 0:
        return {"mp": 0.0, "mr": 0.0,
                "map": 0.0 if len(target_cls) else 1.0, "per_class": []}
    p, r, ap, f1, classes = ap_per_class(tp, conf, pred_cls, target_cls,
                                         method)
    per_class = [{"class": int(c),
                  "name": names[int(c)] if int(c) < len(names) else str(c),
                  "p": float(pi), "r": float(ri), "ap": float(api)}
                 for c, pi, ri, api in zip(classes, p, r, ap)]
    return {"mp": float(p.mean()) if len(p) else 0.0,
            "mr": float(r.mean()) if len(r) else 0.0,
            "map": float(ap.mean()) if len(ap) else 0.0,
            "per_class": per_class}
