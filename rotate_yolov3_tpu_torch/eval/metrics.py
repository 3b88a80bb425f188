"""Detection metrics: VOC-style average precision.

Counterpart of ``rotate_yolov3_tpu/eval/metrics.py``; only ``compute_ap``
is ported so far, for the DOTA Task-1 evaluation. The matching and
per-class tables wait for the eval port (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import numpy as np


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
