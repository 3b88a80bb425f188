#!/usr/bin/env python3
"""Data parallelism across the cards of one host: correctness and scaling.

    python3 tools/multicard.py          # every card of the host, at most 4
    python3 tools/multicard.py --steps  # item 2 alone, on any number of cards
    python3 tools/multicard.py --cpu 4  # rehearsal: 4 gloo ranks on the CPU,
                                        # small sizes, no timing claims

With N cards (NCCL, one process per card; N >= 2):
  1. the data-parallel train step on N ranks (HRSC cfg, 608², 2 images per
     rank, f32 with TF32 off; ``parallel.dryrun.dp_train_steps``): step 1
     on a global batch whose rank slices are equal (so each rank's loss
     normalisation is the whole batch's) against one process on that batch
     (loss terms rtol 1e-4, grad norm 3e-3), step 2 on distinct images,
     after which every rank's parameters and BN state must equal rank 0's
     bit for bit;
  2. the train step's time for 1, 2, ..., N ranks at B = 8 per rank, 608²,
     bf16 and f32 (PyTorch's defaults: cuDNN may use TF32): the median
     ms/step over 8 steps after 3 warm-ups (host clock around a
     synchronised step, on every rank; the slowest rank's median printed),
     and, in the same process as the one-rank run, the plain step (no
     process group: no sync BN, no all-reduce) on the same batch;
  3. ``Detector(devices=n)`` for n = 1, 2, ..., N on 128 images per card and
     on 128 in all, 608², bf16: detections equal to one device's on the same
     slices, kernels A and B launched once per replica, img/s (host-clock
     median of 5 calls, every card synchronised);
  4. the DOTA scene of ``chip_smoke.py`` phase 7 (DOTA cfg, 608², f32, TF32
     off) sharded over N cards against one: merged masks equal, rows within
     1e-5, scene ms (host-clock median of 3).
Every line ends with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the drawn images and the DOTA scene)

STEPS, WARMUP = 8, 3


def _time_rank(rank, world, store_dir, devices, img, per_rank, dtype):
    """Median ms of this rank's data-parallel train steps and, with one
    rank, of the plain step on the same batch (else None)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from rotate_yolov3_tpu_torch.config.hyp import Hyp
    from rotate_yolov3_tpu_torch.config.parse import parse_model_cfg
    from rotate_yolov3_tpu_torch.models.darknet import (build_network,
                                                        init_params)
    from rotate_yolov3_tpu_torch.parallel.mesh import (init_group,
                                                       shard_batch)
    from rotate_yolov3_tpu_torch.train.schedule import darknet_schedule
    from rotate_yolov3_tpu_torch.train.trainer import (init_train_state,
                                                       make_train_step)

    device = devices[rank]
    group = init_group(rank, world, store_dir, device)
    try:
        spec = build_network(parse_model_cfg(cs.CFG), img_size=img)
        params, state = init_params(spec, seed=0)
        imgs, labels = cs._draw_ships(per_rank * world, img, seed=31)
        cs.DEVICE = "cpu"
        batch = [t.to(device) for t in shard_batch(
            rank, world, *cs._train_batch(torch, imgs, labels))]

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        def median_ms(process_group):
            ts = init_train_state(spec, params, state,
                                  darknet_schedule(1e-3, burn_in=1),
                                  compute_dtype=dtype, device=device)
            step = make_train_step(spec, Hyp(), process_group=process_group)
            times = []
            for i in range(WARMUP + STEPS):
                sync()
                t0 = time.perf_counter()
                total = step(ts, *batch)["total"]
                sync()
                times.append((time.perf_counter() - t0) * 1e3)
            if not np.isfinite(float(total)):
                raise AssertionError(f"rank {rank}: loss {float(total)}")
            return statistics.median(times[WARMUP:])

        return median_ms(group), median_ms(None) if world == 1 else None
    finally:
        dist.destroy_process_group()


def _sync_all(torch, devices) -> None:
    for d in {d for d in devices if d.type == "cuda"}:
        torch.cuda.synchronize(d)


def _host_ms(torch, fn, devices, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        _sync_all(torch, devices)
        t0 = time.perf_counter()
        fn()
        _sync_all(torch, devices)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _step_times(torch, launch, mesh, counts, img, card) -> None:
    """Item 2: the train step's ms over 1..N ranks, and the plain step."""
    per_rank = 8 if mesh[0].type == "cuda" else 2
    for dtype in (torch.bfloat16, torch.float32):
        ms = {k: launch(_time_rank, k, (mesh[:k], img, per_rank, dtype),
                        timeout=900.0) for k in counts}
        print(f"train step {str(dtype)[6:]} @{img}, B={per_rank} per rank, "
              f"slowest rank's median ms/step: plain step (one process, no "
              f"group) {ms[1][0][1]:.3f} ms, " + ", ".join(
                  f"{k} rank(s) {max(r[0] for r in ms[k]):.3f} ms "
                  f"({k * per_rank / max(r[0] for r in ms[k]) * 1e3:.2f} "
                  f"img/s)" for k in counts)
              + f" [{card}]", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", type=int, default=0,
                    help="rehearse with this many gloo ranks on the CPU")
    ap.add_argument("--steps", action="store_true",
                    help="only the train step's times (item 2), on as "
                         "many cards as there are (one is enough)")
    opt = ap.parse_args()

    import numpy as np
    import torch

    from rotate_yolov3_tpu_torch.config.parse import parse_model_cfg
    from rotate_yolov3_tpu_torch.data.dota.device_tiles import \
        DeviceTilePipeline
    from rotate_yolov3_tpu_torch.detector import Detector
    from rotate_yolov3_tpu_torch.models.darknet import (build_network,
                                                        init_params)
    from rotate_yolov3_tpu_torch.ops.gather_rows import gather_rows
    from rotate_yolov3_tpu_torch.ops.skew_iou_cuda import skew_kill_matrix
    from rotate_yolov3_tpu_torch.parallel.dryrun import dp_train_steps
    from rotate_yolov3_tpu_torch.parallel.mesh import launch, make_mesh

    if opt.cpu:
        n, kind, card = opt.cpu, "cpu", "CPU rehearsal, no timing claims"
        img, b_det, scene_side = 96, 4, 1900
    else:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < (1 if opt.steps else 2):
            print(f"multicard: needs {1 if opt.steps else 2} or more CUDA "
                  f"devices, has {have}", file=sys.stderr)
            return 1
        n, kind = min(4, have), "cuda"
        card = cs.card_line()
        img, b_det, scene_side = 608, 128, cs.SCENE
        print(f"{card} x{torch.cuda.device_count()}; torch "
              f"{torch.__version__}", flush=True)
    cs.DEVICE = kind
    mesh = make_mesh(n, kind)
    first = mesh[0]
    counts = sorted({1, min(2, n), n})

    if opt.steps:
        _step_times(torch, launch, mesh, counts, img, card)
        return 0

    # 1. the DP step on N ranks against one process
    spec = build_network(parse_model_cfg(cs.CFG), img_size=img)
    params, state = init_params(spec, seed=0)
    ships, labels = cs._draw_ships(2, img, seed=32)
    equal = tuple(t.cpu() for t in cs._train_batch(
        torch, np.concatenate([ships] * n), labels * n))
    more, more_labels = cs._draw_ships(2 * n, img, seed=33)
    distinct = tuple(t.cpu() for t in cs._train_batch(torch, more,
                                                      more_labels))
    old = cs._no_tf32(torch)
    try:
        want = cs._one_process_step(torch, spec, params, state, equal, first)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
    ranks = dp_train_steps(mesh, cs.CFG, img, params, state,
                           [equal, distinct], timeout=900.0)
    for r, out in enumerate(ranks):
        cs._metrics_close(out["metrics"][0], want, f"rank {r} of {n}")
    differ = [f"rank {r} {tree}.{k}.{name}" for r, out in enumerate(ranks)
              for tree in ("params", "state") for k, d in out[tree].items()
              for name, t in d.items()
              if not torch.equal(t, ranks[0][tree][k][name])]
    if differ:
        raise AssertionError(f"ranks differ after 2 steps: {differ[:5]}")
    print(f"DP step on {n} ranks ({kind}), f32 TF32 off, B={2 * n} @{img}: "
          "vs one process " + ", ".join(
              f"{k} {ranks[0]['metrics'][0][k]:.6f}/{want[k]:.6f}"
              for k in sorted(want))
          + f"; after 2 steps all ranks bit-equal [{card}]", flush=True)

    # 2. train step time over 1..N ranks, B = 8 per rank
    _step_times(torch, launch, mesh, counts, img, card)

    # 3. Detector replicas on distinct cards
    gen = torch.Generator(device=first).manual_seed(5)
    xs = torch.randint(0, 256, (b_det * n, img, img, 3), generator=gen,
                       device=first, dtype=torch.uint8)
    kw = dict(img_size=img, conf_thres=cs.CONF, nms_thres=cs.THR,
              max_det=128, compute_dtype=torch.bfloat16, seed=0, device=kind)
    one = Detector(cs.CFG, **kw)
    line = []
    for k in counts:
        det = Detector(cs.CFG, devices=k, **kw)
        for batch in (b_det, b_det * k):
            x = xs[:batch]
            want = [torch.cat(t) for t in zip(*[one(part)
                                                for part in x.chunk(k)])]
            gather_rows.launches = skew_kill_matrix.launches = 0
            got = det(x)
            launches = (gather_rows.launches, skew_kill_matrix.launches)
            if kind == "cuda" and launches != (k, k):
                raise AssertionError(f"{k} replicas: launches {launches}")
            if not all(torch.equal(a.to(first), b)
                       for a, b in zip(got, want)):
                raise AssertionError(f"{k} replicas at B={batch}: detections "
                                     f"differ from one device's")
            ms = _host_ms(torch, lambda: det(x), det.mesh, reps=5)
            line.append(f"{k} card(s) B={batch} {batch / ms * 1e3:.2f}")
        del det
    print(f"Detector bf16 @{img}, max_det 128, img/s: " + ", ".join(line)
          + f"; detections equal to one card's on the same slices, kernels A "
          f"and B once per replica [{card}]", flush=True)
    del one, xs

    # 4. the DOTA scene sharded over N cards
    cs.SCENE = scene_side
    scene = cs._dota_scene()
    old = cs._no_tf32(torch)
    try:
        out = {}
        for k in (1, n):
            det = Detector(cs.DOTA_CFG, img_size=img, conf_thres=cs.CONF,
                           max_det=512, approx_top_k=False, seed=0,
                           devices=k, device=kind)
            pipe = DeviceTilePipeline(det, subsize=1024, gap=200,
                                      merge_nms_thres=cs.MERGE_THR,
                                      max_merged=1024)
            out[k] = pipe(scene) + (_host_ms(torch, lambda: pipe(scene),
                                             det.mesh, reps=3),)
            del det, pipe
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
    (d1, m1, ms1), (dn, mn, msn) = out[1], out[n]
    err = float(np.abs(d1 - dn).max())
    if not np.array_equal(m1, mn) or err > 1e-5:
        raise AssertionError(f"DOTA over {n} cards: masks differ at "
                             f"{int((m1 != mn).sum())}, rows {err:.3g}")
    print(f"DOTA scene f32 (TF32 off) over {n} cards: merged masks equal "
          f"({int(mn.sum())} kept), rows max |diff| {err:.3g}; "
          f"{ms1:.3f} ms on one card, {msn:.3f} ms on {n} [{card}]",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
