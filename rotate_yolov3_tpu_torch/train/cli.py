"""Training CLI of the PyTorch port: ``python -m
rotate_yolov3_tpu_torch.train``.

The counterpart of the repository's ``train.py`` with the same flags: build
the model from the cfg, load ``.weights`` or ``.pt`` (full or
backbone-only), SGD with burn-in + step LR from the cfg [net] block, an
epoch loop with a per-epoch eval, a ``results.txt`` row per epoch, the
resume checkpoint (``torch.save`` of the train state) and ``last``/``best``
``.pt`` and ``.weights`` exports. ``--device`` takes ``cuda`` (default) or
``cpu``.

``--devices N`` trains data-parallel on N ranks, one process each
(``parallel.mesh``): the first N cards over NCCL (more than there are
raises ``ValueError``), or N CPU processes over gloo with ``--device cpu``.
Every rank reads the same global batches (same seed, same multi-scale
draws) and trains on its contiguous slice; rank 0 alone writes
``results.txt``, the checkpoints and the exports and runs the per-epoch
eval with a one-device ``Detector``. ``--device-aug`` augments each batch
on the device inside the train step (``data.augment_device``) and turns
the host augmentation off; the card's machine has no cv2, so it is the
augmentation a card run has.

Two choices of the reference are kept or changed on purpose:
  * the ``seen`` counter of a loaded ``.weights`` file is dropped, as the
    reference drops it (burn-in restarts from step 0);
  * each step's metrics stay on the device; they are copied to the host
    once per epoch and summed there in float64 in step order, which prints
    the reference's numbers without a device sync per metric per step.
The per-epoch eval reads images through ``--cache-images``, as training
does (the reference's eval decodes them anew).

Usage:
  python -m rotate_yolov3_tpu_torch.train --cfg cfg/yolov3-rotate-hrsc.cfg \\
      --data datacfg/hrsc2016.data --weights darknet53.conv.74.weights \\
      --epochs 100 --batch-size 8 --device cuda
"""

from __future__ import annotations

import argparse
import os
import time

# seconds a data-parallel rank waits for the others in a collective: rank 0
# alone runs the per-epoch eval and writes the checkpoints while the rest
# wait in the next step
RANK_WAIT_S = 3600.0


def train(opt):
    """Train as the flags say; returns the best mAP of the per-epoch
    evals (-1 without eval)."""
    from ..parallel.mesh import launch, make_mesh
    from ..utils.device import resolve_device

    device = resolve_device(opt.device)
    if opt.devices and opt.devices > 1:
        devices = make_mesh(opt.devices, device)
        return launch(_train_rank, opt.devices, (opt, devices))[0]
    return _train(opt, device)


def _train_rank(rank, world, store_dir, opt, devices):
    import torch.distributed as dist

    from ..parallel.mesh import init_group

    group = init_group(rank, world, store_dir, devices[rank],
                       timeout=RANK_WAIT_S)
    try:
        return _train(opt, devices[rank], group)
    finally:
        dist.destroy_process_group()


def _train(opt, device, group=None):
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..config.hyp import Hyp
    from ..config.parse import (load_classes, parse_data_cfg,
                                parse_model_cfg)
    from ..data.datasets import LoadImagesAndLabels
    from ..detector import Detector
    from ..eval.evaluator import evaluate_dataset, print_eval_table
    from ..models.darknet import build_network, init_params
    from ..models.weights_io import (load_weights_file, save_darknet_weights,
                                     save_torch_pt)
    from ..parallel.mesh import shard_batch
    from ..utils.metrics_writer import MetricsWriter
    from .schedule import cosine_schedule, darknet_schedule
    from .trainer import (init_train_state, load_checkpoint, make_train_step,
                          save_checkpoint)

    rank, world = ((0, 1) if group is None else
                   (dist.get_rank(group), dist.get_world_size(group)))
    lead = rank == 0
    log = print if lead else (lambda *a, **k: None)

    data_cfg = parse_data_cfg(opt.data)
    names = load_classes(data_cfg["names"]) if "names" in data_cfg else []
    spec = build_network(parse_model_cfg(opt.cfg), img_size=opt.img_size)
    net = dict(spec.hyp)
    hyp = Hyp(rotated_ignore=opt.rotated_ignore)

    params, state = init_params(spec, opt.seed)
    if opt.weights:
        params, state, _ = load_weights_file(spec, params, state,
                                             opt.weights)
        log(f"loaded weights from {opt.weights}")

    dataset = LoadImagesAndLabels(
        data_cfg["train"], img_size=spec.img_size,
        batch_size=opt.batch_size,
        augment=not (opt.no_augment or opt.device_aug), hyp=hyp,
        max_gt=opt.max_gt, seed=opt.seed,
        cache_images=opt.cache_images, workers=opt.workers)
    steps_per_epoch = len(dataset)
    if steps_per_epoch == 0:
        raise ValueError("dataset smaller than one batch")

    # optimizer from the cfg [net] hyperparams (two-tier config)
    base_lr = opt.lr if opt.lr else float(net.get("learning_rate", 1e-3))
    burn_in = int(net.get("burn_in", 1000)) if opt.burn_in is None \
        else opt.burn_in
    if opt.cosine:
        sched = cosine_schedule(base_lr, steps_per_epoch * opt.epochs,
                                burn_in)
    else:
        sched = darknet_schedule(base_lr, burn_in,
                                 net.get("steps", (400000, 450000)),
                                 net.get("scales", (0.1, 0.1)))
    ts = init_train_state(
        spec, params, state, sched, momentum=float(net.get("momentum", .9)),
        weight_decay=float(net.get("decay", 5e-4)),
        compute_dtype=torch.bfloat16 if opt.bf16 else torch.float32,
        device=device)
    step_fn = make_train_step(spec, hyp, process_group=group,
                              device_aug=opt.device_aug, aug_seed=opt.seed)

    start_epoch = 0
    ckpt_dir = os.path.join(opt.out_dir, "ckpt")
    if opt.resume:
        start_epoch = load_checkpoint(ckpt_dir, ts)
        log(f"resumed from epoch {start_epoch}")

    if opt.multi_scale:
        # the reference's random=1: a new size every ms_interval batches
        # from 0.67x..1.5x in 32 px steps, drawn per batch index
        base = spec.img_size
        scale_sizes = sorted({max(32, (int(base * s) // 32) * 32)
                              for s in np.linspace(0.67, 1.5, 8)})
        dataset.set_multi_scale(scale_sizes, interval=opt.ms_interval)
        log(f"multi-scale sizes: {scale_sizes} "
            f"(every {opt.ms_interval} batches)")

    best_map = -1.0
    if lead:
        os.makedirs(opt.out_dir, exist_ok=True)
        results_path = os.path.join(opt.out_dir, "results.txt")
        metrics_writer = MetricsWriter(opt.out_dir,
                                       tensorboard=not opt.no_tensorboard)

    # one Detector reused across epochs, refreshed from the trained weights
    eval_det = None
    if lead and not opt.no_eval and "valid" in data_cfg and \
            os.path.exists(data_cfg["valid"]):
        eval_det = Detector(opt.cfg, img_size=spec.img_size,
                            conf_thres=opt.conf_thres,
                            nms_thres=opt.nms_thres, device=device)

    for epoch in range(start_epoch, opt.epochs):
        dataset.set_epoch(epoch)
        t0 = time.time()
        keys, rows = [], []
        for batch in dataset:
            imgs, tgts, valid = (t.to(device) for t in shard_batch(
                rank, world, *(torch.from_numpy(a) for a in batch)))
            metrics = step_fn(ts, imgs, tgts, valid)
            keys = list(metrics)
            rows.append(torch.stack([metrics[k] for k in keys]))
        # one copy per epoch; the sums run in float64 in step order
        agg = {}
        for row in (torch.stack(rows).cpu().tolist() if rows else []):
            for k, v in zip(keys, row):
                agg[k] = agg.get(k, 0.0) + v
        agg = {k: v / max(len(rows), 1) for k, v in agg.items()}
        if not lead:
            continue
        dt = time.time() - t0
        imgs_per_s = len(rows) * opt.batch_size / max(dt, 1e-9)
        print(f"epoch {epoch}: " +
              " ".join(f"{k}={v:.4f}" for k, v in sorted(agg.items())) +
              f" ({imgs_per_s:.1f} img/s)")

        # per-epoch eval: refresh through the full fusion pipeline (BN fold,
        # input-scale fold, head permutation) from the unfused weights
        mp = mr = mAP = 0.0
        if eval_det is not None:
            eval_det.refresh_params(*ts.net.params_state())
            result = evaluate_dataset(eval_det, data_cfg["valid"],
                                      batch_size=opt.batch_size,
                                      names=names,
                                      max_images=opt.eval_max_images,
                                      cache_images=opt.cache_images,
                                      workers=opt.workers)
            mp, mr, mAP = result["mp"], result["mr"], result["map"]
            print_eval_table(result)

        with open(results_path, "a") as f:
            f.write(f"{epoch} {agg.get('xy', 0):.5f} {agg.get('obj', 0):.5f} "
                    f"{agg.get('cls', 0):.5f} {agg.get('angle', 0):.5f} "
                    f"{agg.get('total', 0):.5f} {mp:.5f} {mr:.5f} "
                    f"{mAP:.5f}\n")
        metrics_writer.write(epoch, {**agg, "P": mp, "R": mr, "mAP": mAP,
                                     "img_per_s": imgs_per_s,
                                     "lr": sched(ts.step)})

        save_checkpoint(ckpt_dir, ts, step=epoch + 1)
        # both interchange flavours, as the reference writes them
        host = [{k: {n: t.cpu() for n, t in d.items()} for k, d in x.items()}
                for x in ts.net.params_state()]
        seen = ts.step * opt.batch_size
        save_darknet_weights(spec, *host,
                             os.path.join(opt.out_dir, "last.weights"),
                             seen=seen)
        save_torch_pt(spec, *host, os.path.join(opt.out_dir, "last.pt"),
                      epoch=epoch)
        if mAP > best_map:
            best_map = mAP
            save_darknet_weights(spec, *host,
                                 os.path.join(opt.out_dir, "best.weights"),
                                 seen=seen)
            save_torch_pt(spec, *host, os.path.join(opt.out_dir, "best.pt"),
                          epoch=epoch)
    if lead:
        metrics_writer.close()
    return best_map


def make_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cfg", type=str, required=True)
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--weights", type=str, default="",
                   help="initial .weights (full or backbone-only) or .pt")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--img-size", type=int, default=None)
    p.add_argument("--max-gt", type=int, default=64)
    p.add_argument("--lr", type=float, default=None,
                   help="override cfg learning_rate")
    p.add_argument("--burn-in", type=int, default=None)
    p.add_argument("--cosine", action="store_true")
    p.add_argument("--devices", type=int, default=0,
                   help="data-parallel over N devices, one process each "
                        "(0 = single); --batch-size must divide by N")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--rotated-ignore", action="store_true",
                   help="exact rotated skew-IoU for the objectness ignore "
                        "region instead of darknet's axis-aligned box_iou")
    p.add_argument("--device-aug", action="store_true",
                   help="mosaic/rotation/scale/flip/HSV augmentation on the "
                        "device inside the train step (host augmentation "
                        "off)")
    p.add_argument("--multi-scale", action="store_true",
                   help="vary net input size every --ms-interval batches "
                        "(0.67x-1.5x, /32) — the reference's random=1 cfg "
                        "behavior")
    p.add_argument("--ms-interval", type=int, default=10,
                   help="batches between multi-scale size draws")
    p.add_argument("--cache-images", choices=["", "ram", "disk"], default="",
                   help="cache decoded images in RAM or as .npy sidecars")
    p.add_argument("--workers", type=int, default=1,
                   help="host prefetch worker threads")
    p.add_argument("--no-eval", action="store_true")
    p.add_argument("--no-tensorboard", action="store_true",
                   help="disable TensorBoard event files (metrics.csv/"
                        ".jsonl are always written)")
    p.add_argument("--eval-max-images", type=int, default=None)
    p.add_argument("--conf-thres", type=float, default=0.1)
    p.add_argument("--nms-thres", type=float, default=0.4)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--out-dir", type=str, default="weights")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p
