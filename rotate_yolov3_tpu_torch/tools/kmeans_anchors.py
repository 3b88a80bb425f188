"""Rotated-anchor generation: IoU-metric k-means over dataset labels.

The port's counterpart of the repository's ``tools/kmeans_anchors.py``,
with the same flags, the same arithmetic and the same printed lines, on
the port's own cfg parser and label reader, so it needs no jax:

  * k-means over GT (w, h) in net-input pixels with the d = 1 - IoU(box,
    anchor) metric (axis-aligned, centred: the metric the assignment's
    wh-fit uses);
  * the angles mod pi: an even grid (the reference's choice, default) or
    1-D circular k-means over the labels' theta;
  * the mean best IoU and recall@thr, and the ``anchors = ...`` /
    ``angles = ...`` lines to paste into a [yolo] cfg block.

Pure numpy, deterministic (seeded k-means++ init).

Usage:
  python -m rotate_yolov3_tpu_torch.tools.kmeans_anchors \
      --data datacfg/hrsc2016.data --img-size 608 --num 9 --num-angles 6
  python -m rotate_yolov3_tpu_torch.tools.kmeans_anchors \
      --train path/to/train.txt ...
"""

from __future__ import annotations

import argparse

import numpy as np

from ..config.parse import parse_data_cfg
from ..data.datasets import img2label_path, load_labels


def collect_wh_theta(train_list: str, img_size: int) -> np.ndarray:
    """Gather (w, h, theta) for every GT box, w/h scaled to net pixels.

    Labels are normalized to image dims; like the reference's clustering
    scripts we scale by the net input size (letterbox preserves aspect, so
    this is exact for square sources and a close proxy otherwise).
    """
    with open(train_list) as f:
        img_paths = [l.strip() for l in f if l.strip()]
    rows = []
    for p in img_paths:
        lb = load_labels(img2label_path(p))
        if len(lb):
            rows.append(lb[:, 3:6])
    if not rows:
        raise SystemExit(f"no labels found for {len(img_paths)} images "
                         f"listed in {train_list}")
    wht = np.concatenate(rows, axis=0).astype(np.float64)
    wht[:, :2] *= img_size
    return wht


def wh_iou(wh: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """Centered axis-aligned IoU between (N,2) boxes and (K,2) anchors."""
    inter = (np.minimum(wh[:, None, 0], anchors[None, :, 0])
             * np.minimum(wh[:, None, 1], anchors[None, :, 1]))
    union = (wh[:, 0] * wh[:, 1])[:, None] + \
            (anchors[:, 0] * anchors[:, 1])[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def _kmeans_pp_init(wh: np.ndarray, k: int,
                    rng: np.random.Generator) -> np.ndarray:
    """k-means++ seeding under the 1-IoU distance."""
    centers = [wh[rng.integers(len(wh))]]
    for _ in range(1, k):
        d = 1.0 - wh_iou(wh, np.asarray(centers)).max(axis=1)
        probs = d / max(d.sum(), 1e-12)
        centers.append(wh[rng.choice(len(wh), p=probs)])
    return np.asarray(centers)


def kmeans_anchors(wh: np.ndarray, k: int, iters: int = 300,
                   seed: int = 0) -> np.ndarray:
    """IoU-metric k-means over (N, 2) box sizes -> (k, 2) anchors,
    sorted by area ascending (the cfg/mask convention: small->large)."""
    rng = np.random.default_rng(seed)
    anchors = _kmeans_pp_init(wh, k, rng)
    assign = np.full(len(wh), -1)
    for _ in range(iters):
        new_assign = wh_iou(wh, anchors).argmax(axis=1)
        if np.array_equal(new_assign, assign):
            break
        assign = new_assign
        for j in range(k):
            members = wh[assign == j]
            if len(members):
                # median is the lineage's estimator: robust to the long
                # tail of huge DOTA boxes
                anchors[j] = np.median(members, axis=0)
    return anchors[np.argsort(anchors.prod(axis=1))]


def circular_kmeans_angles(theta: np.ndarray, k: int, iters: int = 300,
                           seed: int = 0) -> np.ndarray:
    """1-D k-means over angles on the mod-pi circle (rect symmetry).

    Angles are doubled onto the full circle (theta and theta+pi are the
    same rectangle orientation), clustered with unit-vector means, then
    halved back. Returns k angles in (-pi/2, pi/2], sorted."""
    rng = np.random.default_rng(seed)
    z = np.exp(2j * theta.astype(np.float64))
    centers = z[rng.choice(len(z), size=k, replace=False)]
    assign = np.full(len(z), -1)
    for _ in range(iters):
        d = np.abs(z[:, None] - centers[None, :])
        new_assign = d.argmin(axis=1)
        if np.array_equal(new_assign, assign):
            break
        assign = new_assign
        for j in range(k):
            members = z[assign == j]
            if len(members):
                m = members.mean()
                if abs(m) > 1e-9:
                    centers[j] = m / abs(m)
    ang = np.angle(centers) / 2.0
    ang = np.where(ang <= -np.pi / 2, ang + np.pi, ang)
    return np.sort(ang)


def even_angle_grid(k: int) -> np.ndarray:
    """The reference's fixed replication grid: k evenly spaced angles
    covering the mod-pi circle, e.g. k=6 -> -60,-30,0,30,60,90 degrees."""
    step = 180.0 / k
    return np.radians(np.arange(k) * step - (k // 2 - (k % 2 == 0)) * step)


def mean_best_iou(wh: np.ndarray, anchors: np.ndarray) -> float:
    return float(wh_iou(wh, anchors).max(axis=1).mean())


def recall_at(wh: np.ndarray, anchors: np.ndarray, thr: float) -> float:
    return float((wh_iou(wh, anchors).max(axis=1) > thr).mean())


def format_anchor_line(anchors: np.ndarray) -> str:
    return ", ".join(f"{w:.0f},{h:.0f}" for w, h in anchors)


def format_angle_line(angles_rad: np.ndarray) -> str:
    return ",".join(f"{np.degrees(a):.0f}" for a in angles_rad)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", type=str, default="",
                   help=".data file (uses its train= list)")
    p.add_argument("--train", type=str, default="",
                   help="train.txt image list (alternative to --data)")
    p.add_argument("--img-size", type=int, default=608)
    p.add_argument("--num", type=int, default=9, help="number of wh anchors")
    p.add_argument("--num-angles", type=int, default=6)
    p.add_argument("--cluster-angles", action="store_true",
                   help="circular k-means over label theta instead of the "
                        "even grid the reference uses")
    p.add_argument("--thr", type=float, default=0.5,
                   help="IoU threshold for the recall report")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    if args.data:
        train_list = parse_data_cfg(args.data)["train"]
    elif args.train:
        train_list = args.train
    else:
        p.error("one of --data / --train is required")

    wht = collect_wh_theta(train_list, args.img_size)
    wh, theta = wht[:, :2], wht[:, 2]
    anchors = kmeans_anchors(wh, args.num, seed=args.seed)
    if args.cluster_angles:
        angles = circular_kmeans_angles(theta, args.num_angles,
                                        seed=args.seed)
    else:
        angles = even_angle_grid(args.num_angles)

    print(f"{len(wh)} boxes from {train_list} @ net {args.img_size}")
    print(f"mean best wh-IoU: {mean_best_iou(wh, anchors):.4f}   "
          f"recall@{args.thr}: {recall_at(wh, anchors, args.thr):.4f}")
    print(f"anchors = {format_anchor_line(anchors)}")
    print(f"angles = {format_angle_line(angles)}")
    return anchors, angles


if __name__ == "__main__":
    main()
