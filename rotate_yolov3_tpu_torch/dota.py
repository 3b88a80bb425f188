"""DOTA pipeline CLI of the PyTorch port: tile splitting, per-tile detection,
cross-tile merge, Task-1 evaluation.

The counterpart of the repository's ``dota.py`` with the same subcommands
and flags, plus ``--device cuda|cpu`` (default ``cuda``):

  python -m rotate_yolov3_tpu_torch.dota split  --images DIR --labels DIR --out DIR [--subsize 1024 --gap 200]
  python -m rotate_yolov3_tpu_torch.dota detect --cfg CFG [--weights W] --source DIR --out DIR [--names FILE]
  python -m rotate_yolov3_tpu_torch.dota detect --cfg CFG [--weights W] --tiles DIR --out DIR [--batch-size 8]
  python -m rotate_yolov3_tpu_torch.dota merge  --dets DIR --out DIR --names datacfg/dota.names
  python -m rotate_yolov3_tpu_torch.dota eval   --dets DIR --gt DIR --names datacfg/dota.names

``detect --source`` runs full-resolution scenes through the on-device tile
pipeline (``data.dota.device_tiles``) and writes Task-1 files directly;
``detect --tiles`` detects pre-split tiles and writes per-tile text files
for ``merge``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def cmd_split(opt):
    from .data.dota.img_split import split_dataset

    written = split_dataset(opt.images, opt.labels, opt.out,
                            subsize=opt.subsize, gap=opt.gap,
                            keep_frac=opt.keep_frac)
    print(f"wrote {len(written)} tiles under {opt.out}")


def cmd_detect(opt):
    import torch

    from .data.loaders import LoadImages, batched
    from .detector import Detector, detections_to_numpy
    from .ops.boxes import scale_coords_rotated

    if bool(opt.tiles) == bool(opt.source):
        raise SystemExit("pass exactly one of --tiles (pre-split, host "
                         "pipeline) or --source (full images, on-device "
                         "tile pipeline)")
    # exact top-k unless asked: the port's Detector would default to the
    # strided top-k on CUDA, the reference CLI's default is exact
    det = Detector(opt.cfg, weights=opt.weights or None,
                   img_size=opt.img_size, conf_thres=opt.conf_thres,
                   nms_thres=opt.nms_thres, max_det=opt.max_det,
                   devices=opt.devices,
                   compute_dtype=torch.bfloat16 if opt.bf16 else torch.float32,
                   approx_top_k=bool(opt.approx_topk), device=opt.device)
    if opt.source:
        return _detect_device_tiles(opt, det)
    os.makedirs(opt.out, exist_ok=True)
    loader = LoadImages(opt.tiles, img_size=det.img_size)
    n = 0
    for items, n_real in batched(iter(loader), opt.batch_size):
        imgs = np.stack([it[1] for it in items])
        dets, mask = det(imgs)
        per_image = detections_to_numpy(dets, mask)
        for (path, _, _, ratio, pad), d in zip(items[:n_real],
                                               per_image[:n_real]):
            if len(d):
                d = scale_coords_rotated(torch.from_numpy(d), ratio,
                                         pad).numpy()
            stem = os.path.splitext(os.path.basename(path))[0]
            np.savetxt(os.path.join(opt.out, stem + ".txt"), d, fmt="%.4f")
            n += 1
    print(f"detected over {n} tiles -> {opt.out}")


def _detect_device_tiles(opt, det):
    """``--source``: full-resolution images through the on-device tile
    pipeline (tiles, letterbox, detection and cross-tile merge on the
    detector's device), no pre-split tiles on disk. Writes devkit Task-1
    files directly."""
    import cv2

    from .config.parse import load_classes
    from .data.dota.device_tiles import DeviceTilePipeline
    from .data.dota.result_merge import write_task1_results

    pipe = DeviceTilePipeline(det, subsize=opt.subsize, gap=opt.gap,
                              merge_nms_thres=opt.merge_nms_thres,
                              max_merged=opt.max_merged)
    names = load_classes(opt.names) if opt.names else [
        str(i) for i in range(det.spec.yolo_specs[0].num_classes)]
    exts = (".png", ".jpg", ".jpeg", ".tif", ".bmp")
    merged = {}
    n_tiles = 0
    t0 = time.perf_counter()
    for fname in sorted(os.listdir(opt.source)):
        stem, ext = os.path.splitext(fname)
        if ext.lower() not in exts:
            continue
        img0 = cv2.imread(os.path.join(opt.source, fname))
        if img0 is None:
            continue
        img = img0[:, :, ::-1]          # BGR -> RGB (net-input convention)
        dets, mask = pipe(img)
        merged[stem] = dets[mask]
        n_tiles += pipe.num_tiles(*img.shape[:2])
    dt = time.perf_counter() - t0
    write_task1_results(merged, names, opt.out)
    total = sum(len(v) for v in merged.values())
    print(f"on-device tile pipeline ({det.device.type}): {len(merged)} "
          f"images / {n_tiles} tiles in {dt:.1f}s (first call included), "
          f"{total} merged detections -> {opt.out}")


def cmd_merge(opt):
    from .config.parse import load_classes
    from .data.dota.result_merge import (merge_tile_detections,
                                         write_task1_results)

    names = load_classes(opt.names)
    tile_dets = {}
    for f in sorted(os.listdir(opt.dets)):
        if not f.endswith(".txt"):
            continue
        path = os.path.join(opt.dets, f)
        if os.path.getsize(path) == 0:
            arr = np.zeros((0, 7), np.float32)
        else:
            arr = np.loadtxt(path, ndmin=2)
            if arr.size == 0:
                arr = np.zeros((0, 7), np.float32)
        tile_dets[os.path.splitext(f)[0]] = arr.astype(np.float32)
    merged = merge_tile_detections(tile_dets, nms_thres=opt.nms_thres)
    write_task1_results(merged, names, opt.out)
    total = sum(len(v) for v in merged.values())
    print(f"merged {len(tile_dets)} tiles -> {len(merged)} images, "
          f"{total} detections -> {opt.out}")


def cmd_eval(opt):
    from .config.parse import load_classes
    from .data.dota.evaluation import evaluate_task1

    names = load_classes(opt.names)
    result = evaluate_task1(opt.dets, opt.gt, names, iou_thr=opt.iou_thres,
                            method=opt.ap_method)
    for row in result["per_class"]:
        print(f"{row['name']:>20} AP={row['ap']:.4f} (n_gt={row['n_gt']})")
    print(f"{'mAP':>20} {result['map']:.4f}")
    if opt.json:
        with open(opt.json, "w") as f:
            json.dump(result, f, indent=1)


def make_parser():
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("split")
    ps.add_argument("--images", required=True)
    ps.add_argument("--labels", required=True)
    ps.add_argument("--out", required=True)
    ps.add_argument("--subsize", type=int, default=1024)
    ps.add_argument("--gap", type=int, default=200)
    ps.add_argument("--keep-frac", type=float, default=0.7)
    ps.set_defaults(fn=cmd_split)

    pd = sub.add_parser("detect")
    pd.add_argument("--cfg", required=True)
    pd.add_argument("--weights", default="")
    pd.add_argument("--tiles", default="",
                    help="pre-split tile dir (host pipeline; per-tile txt "
                         "outputs for the merge subcommand)")
    pd.add_argument("--source", default="",
                    help="FULL-resolution image dir: on-device tile "
                         "pipeline (tiles, detection and merge on the "
                         "device), writes Task-1 files directly")
    pd.add_argument("--subsize", type=int, default=1024)
    pd.add_argument("--gap", type=int, default=200)
    pd.add_argument("--merge-nms-thres", type=float, default=0.3)
    pd.add_argument("--max-merged", type=int, default=1024)
    pd.add_argument("--names", default="",
                    help="class-names file for --source Task-1 output")
    pd.add_argument("--out", required=True)
    pd.add_argument("--img-size", type=int, default=None)
    pd.add_argument("--batch-size", type=int, default=8)
    pd.add_argument("--conf-thres", type=float, default=0.1)
    pd.add_argument("--nms-thres", type=float, default=0.4)
    pd.add_argument("--max-det", type=int, default=512)
    pd.add_argument("--devices", type=int, default=0,
                    help="shard tile batches over N devices (0 = single); "
                         "with --tiles, --batch-size must divide by N")
    pd.add_argument("--approx-topk", action="store_true",
                    help="strided-bin pre-NMS top-k (ops/topk.py) for "
                         "throughput; the default is exact ranking")
    pd.add_argument("--bf16", action="store_true")
    pd.add_argument("--device", type=str, default="cuda",
                    help="torch device: cuda or cpu")
    pd.set_defaults(fn=cmd_detect)

    pm = sub.add_parser("merge")
    pm.add_argument("--dets", required=True)
    pm.add_argument("--out", required=True)
    pm.add_argument("--names", required=True)
    pm.add_argument("--nms-thres", type=float, default=0.3)
    pm.set_defaults(fn=cmd_merge)

    pe = sub.add_parser("eval")
    pe.add_argument("--dets", required=True)
    pe.add_argument("--gt", required=True)
    pe.add_argument("--names", required=True)
    pe.add_argument("--iou-thres", type=float, default=0.5)
    pe.add_argument("--ap-method", choices=["11point", "continuous"],
                    default="11point")
    pe.add_argument("--json", default="")
    pe.set_defaults(fn=cmd_eval)
    return p


def main(argv=None) -> None:
    opt = make_parser().parse_args(argv)
    opt.fn(opt)


if __name__ == "__main__":
    main()
