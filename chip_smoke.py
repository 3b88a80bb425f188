#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rotate_yolov3_tpu_torch``) on one
CUDA card. Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises, so the exit code is not 0):

  1. the card's name and power limit (``nvidia-smi``);
  2. build every kernel of ``rotate_yolov3_tpu_torch/csrc/`` with nvcc;
  3. each kernel against its plain PyTorch version on the card, at the
     serving path's shapes (B = 8): the row gather (kernel A) bit for bit,
     the skew-IoU kill mask (kernel B) on every pair more than 1e-4 from
     the threshold; each kernel's time beside the plain version's;
  4. the serving slice, ``Detector("cfg/yolov3-rotate-hrsc.cfg",
     device="cuda")`` at 608² with seeded random weights and conf 0.05, in
     bf16 and in f32 (TF32 off): both kernels' launch counters must grow,
     the keep masks and detections must equal those recomputed through the
     plain versions from the same boxes, and the f32 card result must agree
     with the plain-PyTorch path run on the CPU from the same head maps;
  5. img/s at B = 128 for max_det 128 and 512 in bf16, the stage split of
     one such batch, and the B = 1 latency;
  6. the fused greedy NMS (kernel C) against kernel B + the greedy fixpoint
     (bit for bit) and against its plain version (on every image with no
     pair within 1e-4 of the threshold), at B = 8, K = 512 without and
     with 15 classes, at K = 1024 and at K = 200 with 15 classes, with a
     worst-case suppression chain and an all-invalid image; its time
     beside both;
  7. the DOTA slice: ``DeviceTilePipeline`` over ``Detector(
     "cfg/yolov3-rotate-dota.cfg")`` at 608² (25 tiles of a seeded
     synthetic 4000² scene, a K = 1024 merge) in bf16 and in f32 (TF32
     off): kernels A, B and C must launch through ``pipe(img)`` alone;
     kernels A and B are held against their plain versions at the tile
     stage's shapes (T = 25, 7581 cells of 378 lanes, K = 512, 15
     classes) on the path's own heads and boxes, and the per-tile keep
     against the plain recompute; the merged output must equal the merge
     recomputed through the plain kernel C from the same per-tile
     detections; the f32 card letterbox must agree with the CPU one within
     ``LB_TOL``; scene ms, tiles/s, the stage split and peak memory;
  8. ``fused_greedy=True`` on the HRSC serving heads at B = 128, max_det
     512: the same detections and keep as the default two-stage path, and
     kernel C's time beside kernel B + fixpoint.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
is ``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script exits with an error and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(ROOT, "cfg", "yolov3-rotate-hrsc.cfg")
DOTA_CFG = os.path.join(ROOT, "cfg", "yolov3-rotate-dota.cfg")
DEVICE = "cuda"
B_CHECK = 8          # batch of the kernel and slice checks
B_BENCH = 128        # batch of the throughput phase
THR = 0.4            # NMS IoU threshold of the product path
CONF = 0.05          # keeps every stage live with random weights
BAND = 1e-4          # kill pairs this close to THR may round either way
SCENE = 4000         # side of the synthetic DOTA scene: 25 tiles of 1024
NET_IMG = None       # net input of phases 7-8 (None: the cfg's, 608)
MERGE_THR = 0.3      # cross-tile merge NMS threshold (dota.py default)
# f32 letterbox, card against CPU, on 0-255 values: the two antialiased
# bilinear interpolates round differently (6.36e-3 apart at 1024 -> 608 on
# an H100); a wrong tap or weight moves pixels by whole units
LB_TOL = 1e-2

KERNELS = {
    "gather_rows": ("rotate_yolov3_tpu_torch/csrc/gather_rows.cu",
                    "rotate_yolov3_tpu/ops/gather_rows.py:100"),
    "skew_kill": ("rotate_yolov3_tpu_torch/csrc/skew_kill.cu",
                  "rotate_yolov3_tpu/ops/skew_iou_pallas.py:501"),
    "nms_greedy": ("rotate_yolov3_tpu_torch/csrc/nms_greedy.cu",
                   "rotate_yolov3_tpu/ops/nms_pallas.py:189"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_build(_build) -> None:
    """One nvcc per kernel source, all started together."""
    def build(name):
        t0 = time.perf_counter()
        _build.load(name)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    names = _build.kernel_names()
    with ThreadPoolExecutor(len(names)) as pool:
        times = dict(zip(names, pool.map(build, names)))
    for name, dt in times.items():
        report = _build.BUILD_LOG.get(name, (dt, "(already built)"))[1]
        ptxas = [l.strip() for l in report.splitlines()
                 if "registers" in l or "spill" in l]
        log(f"build {name}: {dt:.2f} s; " + " | ".join(ptxas))
    log(f"build: {len(names)} kernels in {time.perf_counter() - t0:.2f} s")


def phase_gather(torch, card, results) -> None:
    from rotate_yolov3_tpu_torch.ops.gather_rows import (gather_rows,
                                                         gather_rows_ref)

    gen = torch.Generator(device="cuda").manual_seed(1)
    n, c = 7581, 126
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        cells = torch.randn((B_CHECK, n, c), generator=gen, device="cuda"
                            ).to(dtype)
        for k in (128, 512):
            idx = torch.randint(0, n, (B_CHECK, k), generator=gen,
                                device="cuda", dtype=torch.int32)
            idx[:, :6] = torch.tensor([0, 0, n - 1, n - 1, -5, n + 9],
                                      dtype=torch.int32)
            got = gather_rows(cells, idx)
            ref = gather_rows_ref(cells, idx)
            bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
            if not torch.equal(got.view(bits), ref.view(bits)):
                raise AssertionError(f"gather_rows {dtype} K={k}: kernel "
                                     f"differs from torch.gather")
            err = float((got.float() - ref.float()).abs().max())
            worst = max(worst, err)
            ms = device_ms(torch, lambda: gather_rows(cells, idx))
            plain = device_ms(torch, lambda: gather_rows_ref(cells, idx))
            call = time_ms(torch, lambda: gather_rows(cells, idx))
            call_p = time_ms(torch, lambda: gather_rows_ref(cells, idx))
            log(f"gather_rows {str(dtype)[6:]} B={B_CHECK} N={n} C={c} "
                f"K={k}: bit-equal; device kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms; per call {call:.4f} ms, plain {call_p:.4f}"
                f" ms [{card}]")
            if dtype == torch.bfloat16 and k == 512:
                results["gather_rows"] = {"ms": ms, "plain_ms": plain}
    results["gather_rows"]["max_abs_err"] = worst


def _detection_boxes(torch, gen, k: int):
    """B_CHECK images of k score-sorted boxes at detection scale within a
    608-px image, the last eighth zero-area padding as on the serving
    path."""
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(
        (B_CHECK, k), generator=gen, device="cuda")
    boxes = torch.stack([u(0, 608), u(0, 608), u(10, 160), u(10, 160),
                         u(-3.1416, 3.1416)], dim=-1).contiguous()
    boxes[:, k - k // 8:] = 0.0
    return boxes


def phase_kill(torch, card, results) -> None:
    from rotate_yolov3_tpu_torch.ops.skew_iou_cuda import (
        skew_kill_matrix, skew_kill_matrix_ref)
    from rotate_yolov3_tpu_torch.ops.skew_iou_green import skew_iou_green

    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    for k in (128, 512):
        boxes = _detection_boxes(torch, gen, k)
        cls = torch.randint(0, 15, (B_CHECK, k), generator=gen,
                            device="cuda", dtype=torch.int32)
        iou = skew_iou_green(boxes[:, :, None, :], boxes[:, None, :, :])
        far = (iou - THR).abs() > BAND
        for cls_id in (None, cls):
            got = skew_kill_matrix(boxes, cls_id, iou_thr=THR)
            ref = skew_kill_matrix_ref(boxes, cls_id, iou_thr=THR)
            diff = (got != ref)
            bad = int((diff & far).sum())
            if bad:
                raise AssertionError(f"skew_kill K={k}: {bad} pairs outside "
                                     f"±{BAND} of thr differ from the plain "
                                     f"version")
            worst = max(worst, float((got.float() - ref.float())[far]
                                     .abs().max()))
            kills = int(got.sum())
            if kills == 0:
                raise AssertionError(f"skew_kill K={k}: no pair kills")
            ms = device_ms(torch, lambda: skew_kill_matrix(boxes, cls_id,
                                                           THR))
            plain = device_ms(torch, lambda: skew_kill_matrix_ref(
                boxes, cls_id, THR), reps=3)
            tag = "cls" if cls_id is not None else "no-cls"
            log(f"skew_kill {tag} B={B_CHECK} K={k} thr={THR}: equal on "
                f"{int(far.sum())} pairs, {int((~far).sum())} excluded "
                f"within ±{BAND}, {int(diff.sum())} differ inside the band, "
                f"{kills} kills; device kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms "
                f"[{card}]")
            if k == 512 and cls_id is None:
                results["skew_kill"] = {"ms": ms, "plain_ms": plain}
    results["skew_kill"]["max_abs_err"] = worst


def _check_detections(torch, dets, mask, max_det: int) -> None:
    if tuple(dets.shape[1:]) != (max_det, 7) or \
            tuple(mask.shape[1:]) != (max_det,):
        raise AssertionError(f"bad output shapes {tuple(dets.shape)}, "
                             f"{tuple(mask.shape)}")
    if not bool(torch.isfinite(dets).all()):
        raise AssertionError("non-finite detections")
    if bool(dets[~mask].any()):
        raise AssertionError("rows outside the mask are not zero")
    kept = dets[mask]
    if kept.shape[0] == 0 or bool((kept[:, 5] < CONF).any()) or \
            bool((kept[:, 2:4] <= 0).any()):
        raise AssertionError("kept detections below conf or with empty "
                             "boxes (or none kept)")


def phase_slice(torch, card, results) -> None:
    from rotate_yolov3_tpu_torch.detector import Detector
    from rotate_yolov3_tpu_torch.ops.gather_rows import gather_rows
    from rotate_yolov3_tpu_torch.ops.nms_greedy import nms_greedy_ref
    from rotate_yolov3_tpu_torch.ops.rotated_nms import (decode_candidates,
                                                         nms_from_candidates,
                                                         select_candidates)
    from rotate_yolov3_tpu_torch.ops.skew_iou_cuda import skew_kill_matrix
    from rotate_yolov3_tpu_torch.ops.skew_iou_green import skew_iou_green

    gen = torch.Generator().manual_seed(3)
    batches = torch.randint(0, 256, (3, B_CHECK, 608, 608, 3), generator=gen,
                            dtype=torch.uint8)
    for dtype in (torch.bfloat16, torch.float32):
        tf32 = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        if dtype == torch.float32:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        try:
            det = Detector(CFG, conf_thres=CONF, nms_thres=THR, max_det=128,
                           compute_dtype=dtype, seed=0, device="cuda")
            specs, fm = det.spec.yolo_specs, det.field_major_heads
            use_cls = specs[0].num_classes > 1
            name = str(dtype)[6:]
            n_batches = len(batches) if dtype == torch.bfloat16 else 1
            # the main path: counters from 0, through the entry point only
            gather_rows.launches = 0
            skew_kill_matrix.launches = 0
            outs = [det(batches[i]) for i in range(n_batches)]
            torch.cuda.synchronize()
            launches = {"gather_rows": gather_rows.launches,
                        "skew_kill": skew_kill_matrix.launches}
            if min(launches.values()) < n_batches:
                raise AssertionError(f"slice {name}: a kernel of the path "
                                     f"did not launch: {launches}")
            if dtype == torch.bfloat16:
                for key, n in launches.items():
                    results[key]["launches"] = n
            for dets, mask in outs:
                _check_detections(torch, dets, mask, det.max_det)

            # the same stages one by one, and keep recomputed from the same
            # boxes through the plain kill mask
            heads = det.heads(batches[0])
            scores, idx, valid = select_candidates(
                heads, specs, CONF, det.max_det, det.approx_top_k, fm)
            boxes, cls = decode_candidates(heads, specs, idx, valid, fm)
            out_k, keep_k = nms_from_candidates(boxes, scores, cls, valid,
                                                THR, use_cls, det.max_det)
            out_r, keep_r = nms_from_candidates(
                boxes, scores, cls, valid, THR, use_cls, det.max_det,
                keep_fn=nms_greedy_ref)
            if not (torch.equal(keep_k, keep_r) and torch.equal(out_k, out_r)):
                raise AssertionError(f"slice {name}: kernel keep differs "
                                     f"from the plain recompute")
            dets0, mask0 = outs[0]
            if not (torch.equal(mask0, keep_k) and torch.equal(dets0, out_k)):
                raise AssertionError(f"slice {name}: Detector output differs "
                                     f"from the staged recompute")
            log(f"slice {name} B={B_CHECK} x{n_batches} @608: launches "
                f"{launches}; {int(mask0.sum())} kept of {int(valid.sum())} "
                f"valid candidates (batch 0); checksum "
                f"{float(dets0.double().sum()):.6f}; keep and detections "
                f"equal to the plain-kill recompute [{card}]")
            if dtype == torch.float32:
                _slice_vs_cpu(torch, card, heads, specs, det, fm, use_cls,
                              (scores, idx, valid, boxes, cls, keep_k,
                               out_k), skew_iou_green)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = tf32


def _slice_vs_cpu(torch, card, heads, specs, det, fm, use_cls, card_stages,
                  skew_iou_green) -> None:
    """The card's f32 stages against the plain-PyTorch path on the CPU, each
    stage fed the card's own inputs, so near-tied scores (the two devices'
    sigmoid differ in the last bit) cannot reorder a later stage."""
    from rotate_yolov3_tpu_torch.ops.rotated_nms import (decode_candidates,
                                                         nms_from_candidates,
                                                         select_candidates)
    from rotate_yolov3_tpu_torch.ops.skew_iou_cuda import (
        skew_kill_matrix, skew_kill_matrix_ref)

    scores, idx, valid, boxes, cls, keep, out = [t.cpu()
                                                 for t in card_stages]
    heads_c = [h.cpu() for h in heads]
    # top-k: sorted values are independent of the order of tied scores
    scores_c, idx_c, _ = select_candidates(heads_c, specs, CONF, det.max_det,
                                           det.approx_top_k, fm)
    score_err = float((scores_c - scores).abs().max())
    if score_err > 1e-6:
        raise AssertionError(f"slice f32: top-k scores differ from the CPU "
                             f"path by {score_err}")
    # decode from the card's indices
    boxes_c, cls_c = decode_candidates(heads_c, specs, idx, valid, fm)
    box_err = float((boxes_c - boxes).abs().max())
    if box_err > 1e-3 or not torch.equal(cls_c, cls):
        raise AssertionError(f"slice f32: decoded boxes differ from the CPU "
                             f"path by {box_err}")
    # kill + fixpoint from the card's boxes
    cls_arg = cls if use_cls else None
    kill_k = skew_kill_matrix(boxes.cuda(), None if cls_arg is None
                              else cls_arg.cuda(), THR).cpu()
    kill_c = skew_kill_matrix_ref(boxes, cls_arg, THR)
    iou = skew_iou_green(boxes[:, :, None, :], boxes[:, None, :, :])
    far = (iou - THR).abs() > BAND
    if bool(((kill_k != kill_c) & far).any()):
        raise AssertionError("slice f32: card kill mask differs from the CPU "
                             "plain version outside the band")
    out_c, keep_c = nms_from_candidates(boxes, scores, cls, valid, THR,
                                        use_cls, det.max_det)
    same_kill = torch.equal(kill_k, kill_c)
    if same_kill and not (torch.equal(keep_c, keep) and
                          torch.equal(out_c, out)):
        raise AssertionError("slice f32: card keep differs from the CPU "
                             "plain path on equal kill masks")
    log(f"slice f32 vs CPU plain path: top-k scores max diff {score_err:.3g}"
        f" ({int((idx_c != idx).sum())} index slots differ by tie order), "
        f"boxes max diff {box_err:.3g}, kill masks "
        f"{'equal' if same_kill else 'equal outside the band'}, keep "
        f"{'equal' if torch.equal(keep_c, keep) else 'differs (band)'} "
        f"[{card}]")


def _device_events(torch, fn, reps: int):
    """(kernel name, µs) of every device-side event torch.profiler records
    over ``reps`` calls of ``fn()``, after one untimed call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # the device-side events only: a CPU event's device time repeats the
    # time of the kernels it launched
    return [(e.name, e.device_time_total) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def device_ms(torch, fn, reps: int = 10) -> float:
    """Mean device time of ``fn()``: the CUDA kernel time that torch.profiler
    records over ``reps`` calls, divided by ``reps``. Where the profiler
    records no device time, the CUDA-event time of ``reps`` back-to-back
    calls divided by ``reps`` stands in (an upper bound), and a line says
    so."""
    total_us = sum(us for _, us in _device_events(torch, fn, reps))
    if total_us > 0:
        return total_us / reps / 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    log("(torch.profiler recorded no device time; CUDA events over "
        f"{reps} back-to-back calls instead)")
    return start.elapsed_time(end) / reps


def top_kernels(torch, fn, n: int = 8) -> str:
    """The ``n`` kernels with the most device time in one call of ``fn()``,
    as "share% name" items."""
    by_name: dict = {}
    for name, us in _device_events(torch, fn, 1):
        by_name[name] = by_name.get(name, 0.0) + us
    total = sum(by_name.values()) or 1.0
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return "; ".join(f"{100 * us / total:.1f}% {name[:70]}"
                     for name, us in top)


def phase_bench(torch, card) -> None:
    from rotate_yolov3_tpu_torch.detector import Detector
    from rotate_yolov3_tpu_torch.ops.rotated_nms import (
        decode_candidates, greedy_suppress_fixpoint_kill, select_candidates)
    from rotate_yolov3_tpu_torch.ops.skew_iou_cuda import skew_kill_matrix

    gen = torch.Generator().manual_seed(4)
    x = torch.randint(0, 256, (B_BENCH, 608, 608, 3), generator=gen,
                      dtype=torch.uint8).cuda()
    for max_det in (128, 512):
        det = Detector(CFG, conf_thres=CONF, nms_thres=THR, max_det=max_det,
                       compute_dtype=torch.bfloat16, seed=0, device="cuda")
        specs, fm = det.spec.yolo_specs, det.field_major_heads
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(torch, lambda: det(x), reps=5, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2**30
        busy = device_ms(torch, lambda: det(x), reps=3)
        log(f"bench bf16 B={B_BENCH} max_det={max_det} @608: "
            f"{B_BENCH / ms * 1e3:.2f} img/s ({ms:.3f} ms/batch, median of "
            f"5; device busy {busy:.3f} ms = {100 * busy / ms:.1f}% of the "
            f"call; peak {peak:.2f} GiB) [{card}]")

        heads = det.heads(x)
        scores, idx, valid = select_candidates(heads, specs, CONF, max_det,
                                               det.approx_top_k, fm)
        boxes, _ = decode_candidates(heads, specs, idx, valid, fm)
        kill = skew_kill_matrix(boxes, None, THR)
        stages = {
            "backbone": lambda: det.heads(x),
            "scores+topk": lambda: select_candidates(
                heads, specs, CONF, max_det, det.approx_top_k, fm),
            "gather+decode": lambda: decode_candidates(heads, specs, idx,
                                                       valid, fm),
            "kill": lambda: skew_kill_matrix(boxes, None, THR),
            "fixpoint": lambda: greedy_suppress_fixpoint_kill(kill, valid),
        }
        split = {k: time_ms(torch, f, reps=5, warmup=1)
                 for k, f in stages.items()}
        log(f"stages bf16 B={B_BENCH} max_det={max_det} (ms): "
            + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
            + f" [{card}]")
        if max_det == 128:
            log(f"top kernels of one B={B_BENCH} call (device time): "
                + top_kernels(torch, lambda: det(x)) + f" [{card}]")
            one = x[:1].contiguous()
            lat = time_ms(torch, lambda: det(one), reps=20, warmup=3)
            busy1 = device_ms(torch, lambda: det(one), reps=5)
            log(f"latency bf16 B=1 max_det=128 @608: {lat:.3f} ms (device "
                f"busy {busy1:.3f} ms) [{card}]")
        del det, heads, scores, idx, valid, boxes, kill


def _nms_boxes(torch, gen, b: int, k: int, n_cls: int, special: bool):
    """b images of k score-sorted detection boxes (the last eighth zero-area
    padding, one row in ten below threshold), optional class ids. With
    ``special``, image 0 is a worst-case suppression chain (every box
    overlaps its neighbour with IoU 0.5 and the next but one with 0.2, so
    the greedy result alternates and the fixpoint needs ~K passes) and the
    last image has no valid row."""
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(
        (b, k), generator=gen, device=DEVICE)
    boxes = torch.stack([u(0, 800), u(0, 800), u(10, 120), u(10, 120),
                         u(-3.1416, 3.1416)], dim=-1)
    valid = torch.rand((b, k), generator=gen, device=DEVICE) > 0.1
    valid[:, k - k // 8:] = False
    cls = (torch.randint(0, n_cls, (b, k), generator=gen, device=DEVICE,
                         dtype=torch.int32) if n_cls else None)
    if special:
        i = torch.arange(k, device=DEVICE, dtype=torch.float32)
        boxes[0] = torch.stack([10 + 4 * i, torch.full_like(i, 300.0),
                                torch.full_like(i, 12.0),
                                torch.full_like(i, 12.0),
                                torch.zeros_like(i)], dim=-1)
        valid[0] = True
        if cls is not None:
            cls[0] = 3
        valid[-1] = False
    boxes = torch.where(valid[..., None], boxes, 0.0).contiguous()
    return boxes, cls, valid


def phase_nms_greedy(torch, card, results) -> None:
    from rotate_yolov3_tpu_torch.ops.nms_greedy import (nms_greedy,
                                                        nms_greedy_ref)
    from rotate_yolov3_tpu_torch.ops.rotated_nms import keep_two_stage
    from rotate_yolov3_tpu_torch.ops.skew_iou_green import skew_iou_green

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    cases = [  # (B, K, classes, thr, chain + all-invalid images)
        (B_CHECK, 512, 0, THR, True), (B_CHECK, 512, 15, THR, True),
        (1, 1024, 15, MERGE_THR, False), (2, 1024, 15, MERGE_THR, True),
        (3, 200, 15, MERGE_THR, True)]   # K not a multiple of 32
    for b, k, n_cls, thr, special in cases:
        boxes, cls, valid = _nms_boxes(torch, gen, b, k, n_cls, special)
        keep = nms_greedy(boxes, cls, valid, thr)
        two_stage = lambda: keep_two_stage(boxes, cls, valid, thr)
        if not torch.equal(keep, two_stage()):
            raise AssertionError(f"nms_greedy B={b} K={k}: keep differs from "
                                 f"kernel B + fixpoint")
        ref = nms_greedy_ref(boxes, cls, valid, thr)
        iou = skew_iou_green(boxes[:, :, None, :], boxes[:, None, :, :])
        live = torch.ones((k, k), dtype=torch.bool, device=DEVICE).triu(1) \
            & valid[:, :, None] & valid[:, None, :]
        if cls is not None:
            live &= cls[:, :, None] == cls[:, None, :]
        band = ((iou - thr).abs() <= BAND) & live
        clean = ~band.any(dim=(1, 2))
        if not torch.equal(keep[clean], ref[clean]):
            raise AssertionError(f"nms_greedy B={b} K={k}: keep differs from "
                                 f"the plain version on an image with no "
                                 f"pair within ±{BAND} of thr")
        if special:
            alt = torch.arange(k, device=DEVICE) % 2 == 0
            if not torch.equal(keep[0], alt) or bool(keep[-1].any()):
                raise AssertionError(f"nms_greedy B={b} K={k}: wrong keep on "
                                     f"the chain or the all-invalid image")
        n_kept = int(keep.sum())
        if not 0 < n_kept < int(valid.sum()):
            raise AssertionError(f"nms_greedy B={b} K={k}: nothing kept or "
                                 f"nothing suppressed")
        # 50 calls: one launch of ~0.06 ms is too short a window to time
        ms = device_ms(torch, lambda: nms_greedy(boxes, cls, valid, thr),
                       reps=50)
        two_ms = device_ms(torch, two_stage)
        plain = device_ms(torch, lambda: nms_greedy_ref(boxes, cls, valid,
                                                         thr), reps=2)
        call = time_ms(torch, lambda: nms_greedy(boxes, cls, valid, thr))
        call_two = time_ms(torch, two_stage, reps=5, warmup=1)
        tag = f"{n_cls} classes" if n_cls else "no-cls"
        log(f"nms_greedy {tag} B={b} K={k} thr={thr}"
            f"{' (chain + all-invalid)' if special else ''}: keep equal to "
            f"kernel B + fixpoint; equal to the plain version on "
            f"{int(clean.sum())} of {b} images ({int(band.sum())} live pairs "
            f"within ±{BAND} of thr, {int((keep != ref).sum())} keep "
            f"entries differ); {n_kept} kept of {int(valid.sum())} valid; "
            f"device kernel C {ms:.4f} ms, kernel B + fixpoint {two_ms:.4f} "
            f"ms, plain {plain:.4f} ms; per call C {call:.4f} ms, B + "
            f"fixpoint {call_two:.4f} ms [{card}]")
        if (b, k, special) == (1, 1024, False):
            results["nms_greedy"] = {"ms": ms, "plain_ms": plain,
                                     "max_abs_err": float(
                                         (keep[clean].float()
                                          - ref[clean].float()).abs().max())}


def _dota_scene(seed: int = 6):
    """A seeded synthetic SCENE² RGB uint8 aerial scene: a noisy dark
    ground with 4·(SCENE/100)² bright rotated rectangles (numpy only)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    img = rng.integers(20, 70, (SCENE, SCENE, 3), dtype=np.uint8)
    r = 64
    yy, xx = np.mgrid[-r:r, -r:r].astype(np.float32)
    for _ in range(4 * (SCENE // 100) ** 2):
        cx, cy = rng.integers(r, SCENE - r, 2)
        w, h, th = rng.uniform(16, 120), rng.uniform(8, 48), \
            rng.uniform(-np.pi, np.pi)
        u = xx * np.cos(th) + yy * np.sin(th)
        v = -xx * np.sin(th) + yy * np.cos(th)
        inside = (np.abs(u) <= w / 2) & (np.abs(v) <= h / 2)
        img[cy - r:cy + r, cx - r:cx + r][inside] = rng.integers(150, 256, 3)
    return img


def _tiles_vs_plain(torch, card, name, det, lb, tile_dets, tile_mask):
    """The DOTA path's per-tile stage recomputed from the same heads:
    kernel A against ``torch.gather`` on the path's (T, cells, na·no) maps
    and rows (bit for bit), kernel B against its plain version on the path's
    boxes and classes (every pair outside the band), and the per-tile keep
    and detections through the plain versions (every tile whose kill masks
    agree). Returns the worst |kernel - plain| of A and of B."""
    from rotate_yolov3_tpu_torch.ops.gather_rows import (gather_rows,
                                                         gather_rows_ref)
    from rotate_yolov3_tpu_torch.ops.nms_greedy import nms_greedy_ref
    from rotate_yolov3_tpu_torch.ops.rotated_nms import (decode_candidates,
                                                         nms_from_candidates,
                                                         select_candidates)
    from rotate_yolov3_tpu_torch.ops.skew_iou_cuda import (
        skew_kill_matrix, skew_kill_matrix_ref)
    from rotate_yolov3_tpu_torch.ops.skew_iou_green import skew_iou_green

    specs, fm = det.spec.yolo_specs, det.field_major_heads
    use_cls, thr = specs[0].num_classes > 1, det.nms_thres
    heads = det.heads(lb)
    scores, idx, valid = select_candidates(heads, specs, det.conf_thres,
                                           det.max_det, det.approx_top_k, fm)
    # kernel A: the cell rows decode_gathered gathers
    na, no = specs[0].na, specs[0].no
    cells = torch.cat([h.reshape(h.shape[0], -1, na * no) for h in heads],
                      dim=1).contiguous()
    cell_idx = torch.div(idx, na, rounding_mode="floor").contiguous()
    got, ref = gather_rows(cells, cell_idx), gather_rows_ref(cells, cell_idx)
    bits = torch.int16 if cells.dtype == torch.bfloat16 else torch.int32
    if not torch.equal(got.view(bits), ref.view(bits)):
        raise AssertionError(f"dota {name}: gather_rows at the tile shapes "
                             f"differs from torch.gather")
    # kernel B: the class-aware kill mask of the decoded boxes
    boxes, cls = decode_candidates(heads, specs, idx, valid, fm)
    cls_arg = cls if use_cls else None
    kill_k = skew_kill_matrix(boxes, cls_arg, thr)
    kill_r = skew_kill_matrix_ref(boxes, cls_arg, thr)
    iou = skew_iou_green(boxes[:, :, None, :], boxes[:, None, :, :])
    far = (iou - thr).abs() > BAND
    if bool(((kill_k != kill_r) & far).any()):
        raise AssertionError(f"dota {name}: skew_kill at the tile shapes "
                             f"differs from the plain version outside the "
                             f"band")
    # keep and detections: the staged kernels equal det(lb), and the plain
    # versions equal them on every tile whose kill masks agree
    out_k, keep_k = nms_from_candidates(boxes, scores, cls, valid, thr,
                                        use_cls, det.max_det)
    if not (torch.equal(keep_k, tile_mask) and torch.equal(out_k,
                                                           tile_dets)):
        raise AssertionError(f"dota {name}: det(tiles) differs from its "
                             f"stages run one by one")
    out_r, keep_r = nms_from_candidates(boxes, scores, cls, valid, thr,
                                        use_cls, det.max_det,
                                        keep_fn=nms_greedy_ref)
    same = (kill_k == kill_r).flatten(1).all(dim=1)
    if not (torch.equal(keep_r[same], keep_k[same]) and
            torch.equal(out_r[same], out_k[same])):
        raise AssertionError(f"dota {name}: per-tile keep differs from the "
                             f"plain recompute")
    log(f"dota {name} tile stage, T={cells.shape[0]} cells={cells.shape[1]} "
        f"C={cells.shape[2]} K={idx.shape[1]}, "
        f"{'class-aware' if use_cls else 'no-cls'} thr={thr}: kernel A "
        f"bit-equal to torch.gather; kernel B equal to "
        f"its plain version on {int(far.sum())} pairs "
        f"({int((kill_k != kill_r).sum())} differ within ±{BAND}); keep and "
        f"detections equal to the plain recompute on {int(same.sum())} of "
        f"{same.numel()} tiles, {int(keep_k.sum())} kept [{card}]")
    return (float((got.float() - ref.float()).abs().max()),
            float((kill_k.float() - kill_r.float())[far].abs().max()))


def phase_dota(torch, card, results) -> None:
    import numpy as np

    from rotate_yolov3_tpu_torch.data.dota.device_tiles import \
        DeviceTilePipeline
    from rotate_yolov3_tpu_torch.data.letterbox import letterbox_torch
    from rotate_yolov3_tpu_torch.detector import Detector
    from rotate_yolov3_tpu_torch.ops.gather_rows import gather_rows
    from rotate_yolov3_tpu_torch.ops.nms_greedy import (nms_greedy,
                                                        nms_greedy_ref)
    from rotate_yolov3_tpu_torch.ops.rotated_nms import keep_two_stage
    from rotate_yolov3_tpu_torch.ops.skew_iou_cuda import skew_kill_matrix

    scene = _dota_scene()
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        tf32 = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        if dtype == torch.float32:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        try:
            det = Detector(DOTA_CFG, img_size=NET_IMG, conf_thres=CONF,
                           max_det=512, approx_top_k=False,
                           compute_dtype=dtype, seed=0, device=DEVICE)
            pipe = DeviceTilePipeline(det, subsize=1024, gap=200,
                                      merge_nms_thres=MERGE_THR,
                                      max_merged=1024)
            t = pipe.num_tiles(SCENE, SCENE)
            m = min(1024, t * det.max_det)
            # the path: counters from 0, through the entry point only
            gather_rows.launches = 0
            skew_kill_matrix.launches = 0
            nms_greedy.launches = 0
            dets, mask = pipe(scene)
            launches = {"gather_rows": gather_rows.launches,
                        "skew_kill": skew_kill_matrix.launches,
                        "nms_greedy": nms_greedy.launches}
            if min(launches.values()) < 1:
                raise AssertionError(f"dota {name}: a kernel of the path did "
                                     f"not launch: {launches}")
            if dtype == torch.bfloat16:
                results["nms_greedy"]["launches"] = launches["nms_greedy"]
            kept = dets[mask]
            if dets.shape != (1024, 7) or mask.shape != (1024,) or \
                    not bool(torch.isfinite(torch.from_numpy(dets)).all()) \
                    or dets[~mask].any() or len(kept) == 0 or \
                    (kept[:, 5] < CONF).any() or (kept[:, 2:4] <= 0).any() \
                    or (kept[1:, 5] > kept[:-1, 5]).any():
                raise AssertionError(f"dota {name}: bad merged output")
            if kept[:, :2].max() <= 1024:
                raise AssertionError(f"dota {name}: detections were not "
                                     f"moved to source coordinates")

            # the same stages one by one: the tile stage recomputed through
            # the plain versions of kernels A and B, the merge from the same
            # per-tile detections through the plain kernel C
            with torch.inference_mode():
                bucket = pipe.upload(scene)
                lb, ratio, pad, org = pipe.letterbox_tiles(bucket)
                tile_dets, tile_mask = det(lb)
                errs = _tiles_vs_plain(torch, card, name, det, lb, tile_dets,
                                       tile_mask)
                for key, err in zip(("gather_rows", "skew_kill"), errs):
                    results[key]["max_abs_err"] = max(
                        results[key]["max_abs_err"], err)
                rows, valid, _ = pipe.select(tile_dets, tile_mask, ratio,
                                             pad, org)
                out_k, keep_k = pipe.merge_nms(rows, valid)
                out_r, keep_r = pipe.merge_nms(rows, valid,
                                               keep_fn=nms_greedy_ref)
                out_b, keep_b = pipe.merge_nms(
                    rows, valid, keep_fn=keep_two_stage)
            if not (torch.equal(keep_k, keep_b) and torch.equal(out_k,
                                                                out_b)):
                raise AssertionError(f"dota {name}: merge through kernel C "
                                     f"differs from kernel B + fixpoint")
            if not (torch.equal(keep_k, keep_r) and torch.equal(out_k,
                                                                out_r)):
                raise AssertionError(f"dota {name}: merge through kernel C "
                                     f"differs from the plain recompute")
            if not (np.array_equal(keep_k.cpu().numpy(), mask) and
                    np.array_equal(out_k.cpu().numpy(), dets)):
                raise AssertionError(f"dota {name}: pipe(img) differs from "
                                     f"its stages run one by one")
            n_valid = int(valid.sum())
            log(f"dota {name} {SCENE}x{SCENE} -> {t} tiles @"
                f"{det.img_size}, max_det 512, merge K={m}: launches "
                f"{launches}; {len(kept)} merged detections of {n_valid} "
                f"valid candidates; checksum "
                f"{float(dets.astype(np.float64).sum()):.6f}; merge equal to the "
                f"plain kernel C and to kernel B + fixpoint [{card}]")
            if dtype == torch.float32:
                tiles = torch.stack([
                    bucket.cpu()[y:y + 1024, x:x + 1024]
                    for x, y in org.cpu().to(torch.int64).tolist()])
                lb_cpu = letterbox_torch(tiles.float(), det.img_size)[0]
                err = float((lb.cpu() - lb_cpu).abs().max())
                if err > LB_TOL:
                    raise AssertionError(f"dota f32: card letterbox differs "
                                         f"from the CPU by {err}")
                log(f"dota f32: card letterbox within {err:.3g} of the CPU "
                    f"(limit {LB_TOL}) [{card}]")

            # timing: the whole call (host clock, result on the host), its
            # stages (CUDA events), the merge through C vs B + fixpoint
            torch.cuda.reset_peak_memory_stats()
            for _ in range(2):
                pipe(scene)
            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                pipe(scene)
                walls.append((time.perf_counter() - t0) * 1e3)
            scene_ms = statistics.median(walls)
            peak = torch.cuda.max_memory_allocated() / 2**30
            busy = device_ms(torch, lambda: pipe(scene), reps=3)
            with torch.inference_mode():
                stages = {
                    "upload": lambda: pipe.upload(scene),
                    "tiles+letterbox": lambda: pipe.letterbox_tiles(bucket),
                    "detection": lambda: det(lb),
                    "re-map+top-k": lambda: pipe.select(
                        tile_dets, tile_mask, ratio, pad, org),
                    "merge NMS": lambda: pipe.merge_nms(rows, valid),
                }
                split = {key: time_ms(torch, f, reps=5, warmup=1)
                         for key, f in stages.items()}
                c_ms = device_ms(torch, lambda: pipe.merge_nms(rows, valid))
                b_ms = device_ms(torch, lambda: pipe.merge_nms(
                    rows, valid, keep_fn=keep_two_stage))
                b_call = time_ms(torch, lambda: pipe.merge_nms(
                    rows, valid, keep_fn=keep_two_stage), reps=5,
                    warmup=1)
            log(f"dota {name} scene: {scene_ms:.3f} ms (median of 5 after 2 "
                f"warm-ups, host clock, source on the host to merged numpy "
                f"rows), {t / scene_ms * 1e3:.2f} tiles/s, device busy "
                f"{busy:.3f} ms = {100 * busy / scene_ms:.1f}% of the call, "
                f"peak {peak:.2f} GiB; stages (ms): "
                + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
                + f"; merge NMS device time through C {c_ms:.4f} ms, through"
                f" B + fixpoint {b_ms:.4f} ms (per call {split['merge NMS']:.3f}"
                f" vs {b_call:.3f} ms) [{card}]")
            if dtype == torch.bfloat16:
                log(f"top kernels of one bf16 scene call (device time): "
                    + top_kernels(torch, lambda: pipe(scene), n=10)
                    + f" [{card}]")
            del det, pipe, lb, tile_dets, tile_mask, rows, valid
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = tf32


def phase_fused_serving(torch, card) -> None:
    from rotate_yolov3_tpu_torch.detector import Detector
    from rotate_yolov3_tpu_torch.ops.nms_greedy import nms_greedy
    from rotate_yolov3_tpu_torch.ops.rotated_nms import (
        decode_candidates, keep_two_stage, non_max_suppression_fused,
        select_candidates)

    max_det = 512
    det = Detector(CFG, img_size=NET_IMG, conf_thres=CONF, nms_thres=THR,
                   max_det=max_det, compute_dtype=torch.bfloat16, seed=0,
                   device=DEVICE)
    gen = torch.Generator().manual_seed(7)
    x = torch.randint(0, 256, (B_BENCH, det.img_size, det.img_size, 3),
                      generator=gen, dtype=torch.uint8).to(DEVICE)
    specs, fm = det.spec.yolo_specs, det.field_major_heads
    heads = det.heads(x)
    kw = dict(conf_thres=CONF, nms_thres=THR, max_det=max_det,
              approx_top_k=det.approx_top_k, field_major=fm)
    base = non_max_suppression_fused(heads, specs, **kw)
    nms_greedy.launches = 0
    fused = non_max_suppression_fused(heads, specs, fused_greedy=True, **kw)
    torch.cuda.synchronize()
    if nms_greedy.launches != 1:
        raise AssertionError(f"fused_greedy: kernel C launched "
                             f"{nms_greedy.launches} times, not once")
    if not (torch.equal(fused[1], base[1]) and torch.equal(fused[0],
                                                           base[0])):
        raise AssertionError("fused_greedy: detections or keep differ from "
                             "the two-stage default")
    full_f = time_ms(torch, lambda: non_max_suppression_fused(
        heads, specs, fused_greedy=True, **kw), reps=5, warmup=1)
    full_b = time_ms(torch, lambda: non_max_suppression_fused(
        heads, specs, **kw), reps=5, warmup=1)
    scores, idx, valid = select_candidates(heads, specs, CONF, max_det,
                                           det.approx_top_k, fm)
    boxes, _ = decode_candidates(heads, specs, idx, valid, fm)
    two_stage = lambda: keep_two_stage(boxes, None, valid, THR)
    c_ms = device_ms(torch, lambda: nms_greedy(boxes, None, valid, THR))
    b_ms = device_ms(torch, two_stage)
    c_call = time_ms(torch, lambda: nms_greedy(boxes, None, valid, THR))
    b_call = time_ms(torch, two_stage, reps=5, warmup=1)
    log(f"fused_greedy bf16 B={B_BENCH} max_det={max_det} @{det.img_size}: "
        f"detections "
        f"and keep equal to the default ({int(base[1].sum())} kept); NMS "
        f"tail per call {full_f:.3f} ms fused vs {full_b:.3f} ms two-stage; "
        f"device kernel C {c_ms:.4f} ms vs kernel B + fixpoint {b_ms:.4f} "
        f"ms; per call C {c_call:.4f} ms vs B + fixpoint {b_call:.4f} ms "
        f"[{card}]")
    del det, x, heads


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    from rotate_yolov3_tpu_torch import _build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    results: dict = {}
    phase_build(_build)
    phase_gather(torch, card, results)
    phase_kill(torch, card, results)
    phase_slice(torch, card, results)
    phase_bench(torch, card)
    phase_nms_greedy(torch, card, results)
    phase_dota(torch, card, results)
    phase_fused_serving(torch, card)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": r["launches"],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
