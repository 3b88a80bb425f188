"""Rotated-object detection CLI of the PyTorch port.

The counterpart of the repository's ``detect.py`` with the same flags: load
cfg + weights, iterate images/videos, run the detector, rescale rotated
boxes to original image coordinates, draw/write results. ``--device`` takes
``cuda`` (default) or ``cpu``.

Usage:
  python -m rotate_yolov3_tpu_torch.detect --cfg cfg/yolov3-rotate-hrsc.cfg \\
      --weights weights/best.weights --source data/samples --device cuda
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def detect(opt):
    import torch

    from .config.parse import load_classes, parse_data_cfg
    from .data.loaders import VID_EXTS, LoadImages, LoadWebcam, batched
    from .detector import Detector, detections_to_numpy
    from .ops.boxes import scale_coords_rotated
    from .utils.plotting import draw_detections

    names = None
    if opt.data:
        data_cfg = parse_data_cfg(opt.data)
        if "names" in data_cfg:
            names = load_classes(data_cfg["names"])

    det = Detector(
        opt.cfg, weights=opt.weights or None, img_size=opt.img_size,
        conf_thres=opt.conf_thres, nms_thres=opt.nms_thres,
        max_det=opt.max_det, devices=opt.devices,
        compute_dtype=torch.bfloat16 if opt.bf16 else torch.float32,
        approx_top_k=False if opt.exact_topk else None, device=opt.device)
    on_cuda = det.device.type == "cuda"

    os.makedirs(opt.output, exist_ok=True)
    if opt.source.isdigit() or opt.source.startswith(("rtsp://", "http://")):
        loader = LoadWebcam(opt.source, img_size=det.img_size)
    else:
        loader = LoadImages(opt.source, img_size=det.img_size)
    t_total, n_imgs = 0.0, 0
    video_writers = {}   # source video path -> cv2.VideoWriter

    for items, n_real in batched(iter(loader), opt.batch_size):
        imgs = np.stack([it[1] for it in items])
        t0 = time.perf_counter()
        dets, mask = det(imgs)
        if on_cuda:
            torch.cuda.synchronize(det.device)
        t_total += time.perf_counter() - t0
        per_image = detections_to_numpy(dets, mask)

        for (path, _, img0, ratio, pad), d in zip(items[:n_real],
                                                  per_image[:n_real]):
            n_imgs += 1
            if len(d):
                d = scale_coords_rotated(torch.from_numpy(d), ratio,
                                         pad).numpy()
            base = os.path.splitext(os.path.basename(path.split("#")[0]))[0]
            frame = path.split("#")[1] if "#" in path else ""
            stem = base + ("_" + frame if frame else "")
            print(f"{path}: {len(d)} detections")
            if opt.save_txt or not opt.no_save:
                txt = os.path.join(opt.output, stem + ".txt")
                with open(txt, "w") as f:
                    for row in d:
                        f.write(("%g " * 7 % tuple(row)).strip() + "\n")
            if not opt.no_save:
                import cv2
                drawn = draw_detections(img0, d, names)
                src = path.split("#")[0]
                if os.path.splitext(src)[1].lower() in VID_EXTS:
                    # assemble annotated frames back into a video
                    w = video_writers.get(src)
                    if w is None:
                        fps = getattr(loader, "video_fps", {}).get(src, 30.0)
                        vpath = os.path.join(opt.output, base + "_det.mp4")
                        w = cv2.VideoWriter(
                            vpath, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                            (img0.shape[1], img0.shape[0]))
                        if not w.isOpened():
                            raise IOError(f"VideoWriter failed: {vpath}")
                        video_writers[src] = w
                        print(f"writing video {vpath}")
                    w.write(drawn)
                else:
                    cv2.imwrite(os.path.join(opt.output, stem + ".jpg"),
                                drawn)

    for w in video_writers.values():
        w.release()
    if n_imgs:
        print(f"done: {n_imgs} images, {t_total:.3f}s {det.device.type} time "
              f"({n_imgs / max(t_total, 1e-9):.1f} img/s)")


def make_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cfg", type=str, required=True, help="model .cfg path")
    p.add_argument("--data", type=str, default="", help=".data path (names)")
    p.add_argument("--weights", type=str, default="",
                   help=".weights checkpoint")
    p.add_argument("--source", type=str, required=True,
                   help="image/video file, folder, or glob")
    p.add_argument("--output", type=str, default="output",
                   help="output folder")
    p.add_argument("--img-size", type=int, default=None,
                   help="net input size (default: cfg [net] width)")
    p.add_argument("--conf-thres", type=float, default=0.3)
    p.add_argument("--nms-thres", type=float, default=0.4)
    p.add_argument("--max-det", type=int, default=128,
                   help="detection capacity; NMS cost ~O(n^2), use 512 for "
                        "dense scenes")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--save-txt", action="store_true")
    p.add_argument("--no-save", action="store_true",
                   help="skip writing annotated images")
    p.add_argument("--devices", type=int, default=0,
                   help="data-parallel over N devices (0 = single); "
                        "--batch-size must divide by N")
    p.add_argument("--exact-topk", action="store_true",
                   help="exact pre-NMS top-k (default: strided-bin top-k "
                        "on CUDA, exact on the CPU; see ops/topk.py)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 conv stack")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda or cpu")
    return p


if __name__ == "__main__":
    detect(make_parser().parse_args())
