"""Rotated mAP evaluation CLI of the PyTorch port.

The counterpart of the repository's ``test.py`` with the same flags: run
the model over the validation set, rotated NMS, match to GT by skew-IoU >=
0.5, print the per-class P/R/AP table and mAP. ``--device`` takes ``cuda``
(default) or ``cpu``; top-k is exact unless ``--approx-topk``.

Usage:
  python -m rotate_yolov3_tpu_torch.test --cfg cfg/yolov3-rotate-hrsc.cfg \\
      --data datacfg/hrsc2016.data --weights weights/best.weights --device cuda
"""

from __future__ import annotations

import argparse


def test(opt):
    import torch

    from .config.parse import load_classes, parse_data_cfg
    from .detector import Detector
    from .eval.evaluator import evaluate_dataset, print_eval_table

    data_cfg = parse_data_cfg(opt.data)
    names = load_classes(data_cfg["names"]) if "names" in data_cfg else []
    det = Detector(
        opt.cfg, weights=opt.weights or None, img_size=opt.img_size,
        conf_thres=opt.conf_thres, nms_thres=opt.nms_thres,
        max_det=opt.max_det, devices=opt.devices,
        compute_dtype=torch.bfloat16 if opt.bf16 else torch.float32,
        approx_top_k=bool(opt.approx_topk), device=opt.device)
    result = evaluate_dataset(
        det, data_cfg["valid"], batch_size=opt.batch_size,
        iou_thr=opt.iou_thres, names=names, method=opt.ap_method,
        max_images=opt.max_images, max_gt=opt.max_gt,
        cache_images=opt.cache_images, workers=opt.workers)
    print_eval_table(result)
    return result["mp"], result["mr"], result["map"]


def make_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cfg", type=str, required=True)
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--weights", type=str, default="",
                   help=".weights or .pt checkpoint")
    p.add_argument("--img-size", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--conf-thres", type=float, default=0.1)
    p.add_argument("--nms-thres", type=float, default=0.4)
    p.add_argument("--iou-thres", type=float, default=0.5,
                   help="matching IoU for TP")
    p.add_argument("--max-det", type=int, default=512,
                   help="detection capacity; eval keeps the dense-scene 512 "
                        "so mAP is never silently capped")
    p.add_argument("--max-gt", type=int, default=512,
                   help="per-image GT capacity for matching; a warning is "
                        "printed if any image exceeds it")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--ap-method", choices=["continuous", "11point"],
                   default="continuous")
    p.add_argument("--devices", type=int, default=0,
                   help="data-parallel over N devices (0 = single); "
                        "--batch-size must divide by N")
    p.add_argument("--approx-topk", action="store_true",
                   help="strided-bin pre-NMS top-k (ops/topk.py); eval "
                        "defaults to exact top-k on every device")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--cache-images", choices=["", "ram", "disk"], default="",
                   help="cache decoded images (useful for repeated evals)")
    p.add_argument("--workers", type=int, default=1,
                   help="host prefetch worker threads")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


if __name__ == "__main__":
    test(make_parser().parse_args())
