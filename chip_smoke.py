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
     one such batch, and the B = 1 latency.

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

ROOT = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(ROOT, "cfg", "yolov3-rotate-hrsc.cfg")
B_CHECK = 8          # batch of the kernel and slice checks
B_BENCH = 128        # batch of the throughput phase
THR = 0.4            # NMS IoU threshold of the product path
CONF = 0.05          # keeps every stage live with random weights
BAND = 1e-4          # kill pairs this close to THR may round either way

KERNELS = {
    "gather_rows": ("rotate_yolov3_tpu_torch/csrc/gather_rows.cu",
                    "rotate_yolov3_tpu/ops/gather_rows.py:100"),
    "skew_kill": ("rotate_yolov3_tpu_torch/csrc/skew_kill.cu",
                  "rotate_yolov3_tpu/ops/skew_iou_pallas.py:501"),
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
    for name in _build.kernel_names():
        t0 = time.perf_counter()
        _build.load(name)
        dt = time.perf_counter() - t0
        report = _build.BUILD_LOG.get(name, (dt, "(already built)"))[1]
        ptxas = [l.strip() for l in report.splitlines()
                 if "registers" in l or "spill" in l]
        log(f"build {name}: {dt:.2f} s; " + " | ".join(ptxas))


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
    from rotate_yolov3_tpu_torch.ops.rotated_nms import (decode_candidates,
                                                         nms_from_candidates,
                                                         select_candidates)
    from rotate_yolov3_tpu_torch.ops.skew_iou_cuda import (
        skew_kill_matrix, skew_kill_matrix_ref)
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
                kill_fn=skew_kill_matrix_ref)
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
