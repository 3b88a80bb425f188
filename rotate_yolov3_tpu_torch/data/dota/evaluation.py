"""DOTA Task-1 evaluation: oriented AP per class from submission files.

Counterpart of ``rotate_yolov3_tpu/data/dota/evaluation.py``, the
equivalent of the DOTA devkit's ``dota_evaluation_task1.py``: read
Task1_{class}.txt detections + per-image DOTA GT annotations, match by exact
polygon IoU (``native.polyiou``, C++ as in the devkit), VOC AP per class.
Difficult GT are excluded from the GT count and matched detections against
them are neither TP nor FP, per the devkit protocol.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

from ...eval.metrics import compute_ap
from ...native.polyiou import quad_iou_matrix
from .formats import parse_dota_annotation


def load_task1_detections(path: str) -> Dict[str, np.ndarray]:
    """Task1_{class}.txt -> {image: (N, 9) [score, x1..y4]}."""
    per_img: Dict[str, List[List[float]]] = defaultdict(list)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        for raw in f:
            parts = raw.split()
            if len(parts) != 10:
                continue
            per_img[parts[0]].append([float(v) for v in parts[1:]])
    return {k: np.asarray(v, np.float32) for k, v in per_img.items()}


def evaluate_task1(det_dir: str, gt_dir: str, class_names: Sequence[str],
                   iou_thr: float = 0.5, method: str = "11point"
                   ) -> Dict[str, object]:
    """Evaluate DOTA Task-1 submissions against GT annotation files."""
    gt_cache: Dict[str, List[dict]] = {}

    def gts_for(image: str):
        if image not in gt_cache:
            gt_cache[image] = parse_dota_annotation(
                os.path.join(gt_dir, image + ".txt"))
        return gt_cache[image]

    aps, per_class = [], []
    for name in class_names:
        dets = load_task1_detections(
            os.path.join(det_dir, f"Task1_{name}.txt"))
        # gather all images that have either dets or GT of this class
        images = set(dets)
        for f in os.listdir(gt_dir):
            if f.endswith(".txt"):
                images.add(f[:-4])

        records = []   # (score, is_tp, is_counted)
        n_gt = 0
        for image in sorted(images):
            objs = [o for o in gts_for(image) if o["name"] == name]
            easy = [o for o in objs if not o.get("difficult", 0)]
            hard = [o for o in objs if o.get("difficult", 0)]
            n_gt += len(easy)
            d = dets.get(image)
            if d is None or len(d) == 0:
                continue
            order = np.argsort(-d[:, 0], kind="stable")
            d = d[order]
            det_quads = d[:, 1:9].reshape(-1, 4, 2)
            gt_quads = (np.stack([o["poly"] for o in easy + hard])
                        if objs else np.zeros((0, 4, 2), np.float32))
            iou = (quad_iou_matrix(det_quads, gt_quads)
                   if len(gt_quads) else
                   np.zeros((len(d), 0), np.float32))
            used = np.zeros(len(gt_quads), bool)
            n_easy = len(easy)
            for i in range(len(d)):
                j = int(np.argmax(iou[i])) if iou.shape[1] else -1
                if j >= 0 and iou[i, j] >= iou_thr and not used[j]:
                    used[j] = True
                    if j < n_easy:
                        records.append((d[i, 0], True, True))
                    else:
                        records.append((d[i, 0], False, False))  # difficult
                else:
                    records.append((d[i, 0], False, True))

        counted = [(s, t) for s, t, c in records if c]
        if n_gt == 0:
            ap = 0.0
            p = r = 0.0
        elif not counted:
            ap = p = r = 0.0
        else:
            counted.sort(key=lambda x: -x[0])
            tp = np.array([t for _, t in counted])
            tpc = np.cumsum(tp)
            fpc = np.cumsum(~tp)
            recall = tpc / n_gt
            precision = tpc / (tpc + fpc)
            ap = compute_ap(recall, precision, method)
            p, r = float(precision[-1]), float(recall[-1])
        aps.append(ap)
        per_class.append({"name": name, "ap": float(ap), "p": p, "r": r,
                          "n_gt": n_gt})
    return {"map": float(np.mean(aps)) if aps else 0.0,
            "per_class": per_class}
