"""Dataset evaluation loop: model -> rotated NMS -> mAP.

Counterpart of ``rotate_yolov3_tpu/eval/evaluator.py``: run a ``Detector``
over an image-list dataset (its ``__call__``, so kernels A and B on the
card), match to the ground truth by skew-IoU >= ``iou_thr``, report
per-class P/R/AP and mAP. Called by the ``test`` CLI and by the training
CLI once per epoch.

The reference pads a ragged last batch to the full batch size (repeating
its last sample) so its compiled detector sees one shape. Each image's
detections do not depend on the others in its batch, and PyTorch runs any
batch size, so the port passes the last batch as it is to a one-device
detector; a data-parallel one (``Detector(devices=N)``) splits each batch
over N replicas, so there the last batch is padded as the reference pads
it. Padded rows are not scored.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..data.datasets import LoadImagesAndLabels
from ..detector import detections_to_numpy
from .metrics import match_image, summarize


def evaluate_dataset(detector, list_path: str, batch_size: int = 8,
                     iou_thr: float = 0.5,
                     max_images: Optional[int] = None,
                     names: Sequence[str] = (),
                     method: str = "continuous",
                     max_gt: int = 512, cache_images: str = "",
                     workers: int = 1) -> Dict[str, object]:
    """Evaluate a Detector over an image-list dataset.

    Ground truth is loaded through the same ``LoadImagesAndLabels``
    pipeline (augment off), so letterboxing matches inference exactly.

    ``max_gt`` is the per-image GT capacity of the fixed-shape batch; any
    image with more labels is truncated, which inflates mAP (the dropped GT
    cannot be missed), so truncation is counted, reported on stderr and in
    the ``n_gt_truncated`` result field.
    """
    img_size = detector.img_size
    ds = LoadImagesAndLabels(list_path, img_size=img_size,
                             batch_size=batch_size, augment=False,
                             max_gt=max_gt, drop_last=False, prefetch=2,
                             cache_images=cache_images, workers=workers)
    stats = []
    n_done = 0
    pad_last = len(detector.mesh) > 1
    for imgs, tgts, valid in ds:
        n_real = len(imgs)
        if pad_last and n_real < batch_size:
            imgs = np.concatenate(
                [imgs, np.repeat(imgs[-1:], batch_size - n_real, axis=0)])
        dets, mask = detector(torch.from_numpy(imgs))
        per_image = detections_to_numpy(dets, mask)
        for b in range(n_real):
            if max_images is not None and n_done >= max_images:
                break
            n_done += 1
            gt = tgts[b][valid[b]]
            gt_boxes = gt[:, 1:6].copy()
            gt_boxes[:, :4] *= img_size         # normalized -> pixels
            gt_cls = gt[:, 0].astype(int)
            d = per_image[b]
            tp = match_image(d, gt_boxes, gt_cls, iou_thr)
            stats.append((tp, d[:, 5], d[:, 6].astype(int), gt_cls))
        if max_images is not None and n_done >= max_images:
            break
    result = summarize(stats, names=names, method=method)
    result["n_images"] = n_done
    result["n_gt"] = int(sum(len(s[3]) for s in stats))
    result["n_gt_truncated"] = int(ds.truncated_labels)
    if ds.truncated_labels:
        print(
            f"WARNING: {ds.truncated_labels} ground-truth boxes across "
            f"{ds.truncated_images} images exceeded max_gt={max_gt} and "
            f"were DROPPED from matching — the reported mAP is inflated. "
            f"Re-run with a larger --max-gt.", file=sys.stderr)
    return result


def print_eval_table(result: Dict[str, object]) -> None:
    print(f"{'class':>20} {'P':>8} {'R':>8} {'AP':>8}")
    for row in result["per_class"]:
        print(f"{row['name']:>20} {row['p']:8.4f} {row['r']:8.4f} "
              f"{row['ap']:8.4f}")
    print(f"{'all':>20} {result['mp']:8.4f} {result['mr']:8.4f} "
          f"{result['map']:8.4f}")
