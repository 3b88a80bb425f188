#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rotate_yolov3_tpu_torch``) on one
CUDA card. Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises, so the exit code is not 0):

  1. the card's name and power limit (``nvidia-smi``);
  2. build every kernel of ``rotate_yolov3_tpu_torch/csrc/`` with nvcc;
  3. each kernel against its plain PyTorch version on the card: the row
     gather (kernel A) bit for bit on the head maps in place (a list of
     three (B, H*W, C) tables) and on one concatenated table, with indices
     at every head's first and last cell and out of range, at B = 8, at the
     main path's B = 128, K = 512, bf16, C = 126 and at the DOTA tile
     stage's T = 25, C = 378 (timed there beside torch.cat + torch.gather,
     torch.gather alone and its bound); the skew-IoU kill
     mask (kernel B) with each pair algo on every pair more than 1e-4 from
     the threshold, at B = 8 and 128 with K = 128 and 512, on uniform,
     clustered and all-overlap boxes, without and with 15 classes, and on
     the degenerate boxes; per case its time, the near pairs P_near / P_all
     (the pairs its near-pair test keeps), its bound and its share of it;
  4. the serving slice, ``Detector("cfg/yolov3-rotate-hrsc.cfg",
     device="cuda")`` at 608² with seeded random weights and conf 0.05, in
     bf16 and in f32 (TF32 off): both kernels' launch counters must grow,
     the keep masks and detections must equal those recomputed through the
     plain versions from the same boxes, and the f32 card result must agree
     with the plain-PyTorch path run on the CPU from the same head maps;
  5. the B = 1 latency in bf16 (img/s at B = 128 and the stage split of
     one such batch come from phase 16);
  6. the fused greedy NMS (kernel C) against kernel B + the greedy fixpoint
     (bit for bit) and against its plain version (on every image with no
     pair within 1e-4 of the threshold), at B = 8, K = 512 without and
     with 15 classes, at K = 1024 and at K = 200 with 15 classes, with a
     worst-case suppression chain and an all-invalid image, and at B = 1,
     K = 1024 on all-overlapping boxes (the dense worst case) and on boxes
     that kill nothing; its time beside both and its bound;
  7. the DOTA slice: ``DeviceTilePipeline`` over ``Detector(
     "cfg/yolov3-rotate-dota.cfg")`` at 608² (25 tiles of a seeded
     synthetic 4000² scene, a K = 1024 merge) in bf16 and in f32 (TF32
     off): kernels A, B and C must launch through ``pipe(img)`` alone;
     kernels A (the heads in place, as the path calls it, and one
     concatenated table) and B are held against their plain versions at
     the tile stage's shapes (T = 25, 7581 cells of 378 lanes, K = 512, 15
     classes) on the path's own heads and boxes, and the per-tile keep
     against the plain recompute; the merged output must equal the merge
     recomputed through the plain kernel C from the same per-tile
     detections; the f32 card letterbox must agree with the CPU one within
     ``LB_TOL``; scene ms, tiles/s, the stage split and peak memory;
  8. ``fused_greedy=True`` on the HRSC serving heads at B = 128, max_det
     512: the same detections and keep as the default two-stage path, and
     kernel C's time beside kernel B + fixpoint, its plain version and its
     bound;
  9. the IoU matrix (kernel E), each pair algo, triangle off and on, at
     17 x 33, 512 x 512, the degenerate boxes, B = 8 images of 512 one
     image a call, and batched at B = 128, K = 512 on the serving path's
     own boxes (phase 8's) in one launch: within ``IOU_TOL`` of its plain
     version (run ``KILL_CHUNK`` images at a time at B = 128) and
     ``ARGSORT_TOL`` of the argsort oracle, the triangle equal to the full
     matrix above the diagonal, the batch equal to one launch per image;
     its time beside the plain version's, 128 launches of one image, and
     its bound;
 10. the kill mask's other pair algos (kernel B': green2, candidates) at
     B = 8, K = 512, with and without 15 classes, equal to the plain
     version on every image without a pair within ``BAND`` of the
     threshold, and on the degenerate boxes; kernel C's green2 bit for bit
     kernel B green2 + fixpoint, and its "candidates" equal to "green";
     times;
 11. the gather + decode kernel (kernel D) on HRSC heads (B = 8, K = 512,
     bf16 and f32; B = 128, K = 512, bf16, the serving shape, with its
     bound) and DOTA heads at the tile stage's shape (25 tiles,
     7581 cells x 378 lanes, nc = 15), with head-boundary indices, tied
     class logits and planted non-finite rows (``D_PLANTS``: NaN and +-inf
     in tw, th, t_theta, NaN in class 0 or a later class, all classes -inf
     or NaN): boxes within ``DECODE_RTOL``/``DECODE_ATOL`` of the plain
     version with NaN in the same places, class ids equal, columns 6-7
     zero; times beside the plain version and kernel A + decode;
 12. the slice's options on the HRSC ``Detector`` at 608², B = 8, max_det
     512, bf16 and f32 (TF32 off): ``iou_algo`` green2 and candidates,
     ``iou_matrix_fn`` hooks through kernel E (one launch per call),
     ``non_max_suppression`` of
     ``predict_raw`` with and without a hook, and ``decode_kernel=True``
     with each ``iou_algo``, two-stage and fused. The kernels of each path
     must launch; keep and detections must equal the stages through the
     kernels, the plain versions and, in f32, the CPU path, on every image
     without a band pair. Then each option's per-call time at B = 128.

 13. the training path on the HRSC cfg (Darknet-53, na = 18, nc = 1) from
     seeded random weights, images drawn with numpy (no cv2 anywhere): one
     f32 train step (TF32 off) at B = 2, 256² on the card and on the CPU
     from the same weights and batch (loss terms within
     ``TRAIN_LOSS_RTOL``, grad norm within ``GRAD_NORM_RTOL``, the largest
     difference of the updated params and BN state printed); the step at
     B = 8, 608², f32 and bf16: ms/step, img/s, the forward / loss /
     backward / optimizer split, peak memory, device busy share, top
     kernels; a 20-step fit on one batch whose total loss must fall; the
     training CLI (``rotate_yolov3_tpu_torch.train``, in-process) for one
     epoch of 2 steps on 16 drawn 608² images read through the disk cache,
     whose per-epoch eval must launch kernels A and B and write
     results.txt, last/best .pt and .weights, with Detectors loaded from
     last.weights and last.pt equal to the in-run eval Detector; and the
     eval CLI (``rotate_yolov3_tpu_torch.test``) on those images with
     last.weights, its host IoU from the native library.
 14. data parallelism and on-device augmentation: (a) ``augment_batch``'s
     ops (``data.augment_device``) on the card against the CPU on the same
     draws, B = 8, 608², f32, images and labels within ``AUG_TOL``, and its
     ms per batch; (b) the train step with ``device_aug`` at B = 8, 608²,
     f32 and bf16, ms/step beside the plain step's, and one epoch of the
     train CLI with ``--device-aug``; (c) two gloo ranks sharing the card
     (NCCL refuses two ranks on one GPU) run the HRSC cfg at 608², B = 8
     global, f32 with TF32 off: the first step on a batch whose halves are
     equal (so each rank's loss normalisation is the whole batch's) against
     one process's B = 8 step (loss terms ``TRAIN_LOSS_RTOL``, grad norm
     ``GRAD_NORM_RTOL``), the second on 8 distinct images, after which the
     ranks' parameters and BN state must be bit-equal; (d) one NCCL rank
     against the plain step (and, with two or more cards, N = device_count
     (at most 4) NCCL ranks against one process); (e) a ``Detector`` with
     two replicas on the one card (its internal ``mesh`` set to the list
     ``make_mesh`` returns on two cards) against one replica on the same
     slices at B = 128, 608², bf16, masks and detections equal, kernels A
     and B launched once per replica, img/s of both, and the sharded DOTA
     scene of phase 7 (N = 2, f32, TF32 off) against the single pipeline,
     merged masks equal, rows within 1e-5; (f) with one card,
     ``Detector(devices=2)`` and ``train --devices 2`` must raise; (g)
     ``parallel.dryrun.dryrun_multichip(1, "cuda")``.
 15. the rest of the port: (a) ``Detector("cfg/yolov3-rotate-hrsc.cfg",
     packed_stem=True)`` at 608²: in f32 (TF32 off) at B = 8 its heads
     within ``STEM_TOL`` (relative) of the canonical Detector's, keep and
     detections equal to the plain recompute and, from the card's stages,
     the CPU path, masks equal and rows within 1e-3 of the canonical
     Detector's on every image with the same candidates and no band pair;
     in bf16 at B = 128 kernels A and B launched once each, keep and
     detections equal to the plain recompute, img/s of the packed and the
     canonical Detector in turns, and the stem alone (conv0 + conv1 against
     conv0' + conv1', and conv1' after an explicit ``F.pad``) in µs/img;
     (b) a copy of the HRSC cfg with heads of na 12, 18, 18
     (``MIXED_MASK``) at B = 8, 608², bf16 and f32 (TF32 off): kernel A
     launched once per head, B once, D never, also with
     ``decode_kernel=True``; keep and detections equal to the plain
     recompute, the decode to the CPU's plain one, and in f32 the CPU path;
     (c) ``utils``: ``select_device``, ``device_info``, ``time_fn`` of a
     bf16 B = 128 call with the achieved TFLOP/s of ``flops_per_image``,
     and a ``trace`` of one call that names kernels A and B; (d) the
     port's ``kmeans_anchors`` on phase 13's drawn labels and
     ``verify_reference --self-test``.
 16. the port's benchmark (``rotate_yolov3_tpu_torch.bench``): its cell
     function ``run_cell`` for one trial of each cell of ``BENCHMARK.json``
     (B = 128, 608², bf16, max_det 128 and 512) at the product defaults,
     kernel B's bound from phase 2's pair count: img/s, the stage ladder,
     the check against the plain reference (``bench_reference``); the
     per-cell and the headline JSON lines must hold their keys,
     ``correct`` must be true, kernels A and B launched once per
     ``Detector.__call__`` of the timed trial and every roofline share (A,
     B, mfu) at most 100%; then the check alone on each control of the
     bench (``bench.CONTROLS``: fp8 kernels, a layer without its bias, bf16
     boxes) put in the max_det 128 cell's program's place, which must give
     ``correct`` false.
 17. the conv epilogue (``ops.conv_epilogue``: bias, activation and the
     shortcut add after each convolution of the backbone, in one pass) on
     the HRSC ``Detector`` at 608²: layer by layer through the fused walk's
     hooks, the kernel against its plain version on the same convolution
     output, bit for bit (NaN in the same places), at B = ``EPI_B`` in bf16
     and f32 (TF32 off) on every conv layer's shape with and without a
     residual, finite and with NaN and +-inf planted, and at the main
     path's B = 128, bf16, on the path's own inputs; the heads bit-equal to
     the eager program (each convolution with its bias, ``F.leaky_relu``,
     the walk's adds) in f32 and with the packed stem at B = 8 and in bf16
     at B = 128; 75 launches per ``Detector.__call__``; the eager program's
     trace (which op launches which kernel, with its bytes and time) and
     none of its three passes left in the fused backbone's; the kernel's
     device time per call beside its bytes bound and the eager passes'
     time, and the backbone eager against fused in turns.
Every kernel's bound (``bound_ms``, ``bound_by``) is the larger of the fp32
operations its inputs need over ``FP32_PEAK`` and its bytes over
``MEM_PEAK``; a pair's operations are counted in the SASS of probe kernels
built from the kernels' own pair code (``count_pair_ops``), and phase 3
also states the bound at the fp32 instruction rate (``instr_ms``), which
code built without FMA contraction can reach. The line before the last is
a JSON object ``{"kernels": [...]}`` (time, plain time, bound and
library-call time of every kernel); the last is ``{"ok": true, "device":
{...}}``. Without a CUDA device, or without the
package beside it, the script exits with an error and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
# the card's peaks, and a kernel's bound_ms: the larger of the operations its
# inputs need over FP32_PEAK and the bytes it must move (each input read
# once, each output written once) over MEM_PEAK
from rotate_yolov3_tpu_torch.utils import roofline  # noqa: E402
from rotate_yolov3_tpu_torch.utils.roofline import (  # noqa: E402
    FP32_PEAK, MEM_PEAK, bound, in_chunks, live_pairs)

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

# the degenerate boxes of tests/test_pallas.py:50-58: identical, parallel-edge
# and axis-aligned overlaps, where a contracted FMA mints spurious
# parallel-edge candidates
DEGENERATE = ((50, 50, 20, 10, 0.8), (50, 50, 20, 10, 0.8),
              (50, 50, 20, 10, 0.0), (55, 50, 20, 10, 0.0),
              (50, 52, 20, 10, 0.0), (30, 30, 16, 8, 0.5),
              (34, 33, 16, 8, 0.5))
IOU_TOL = 1e-5       # kernel E against its plain version, on IoU
ARGSORT_TOL = 2e-3   # any algo against the argsort oracle (tests/test_pallas)
# kernel D against its plain version: transcendentals may round apart
DECODE_RTOL, DECODE_ATOL = 1e-5, 1e-4
# non-finite values planted into kernel D's rows (phase 11): field -> value,
# fields 0-4 tx, ty, tw, th, t_theta, 6 + c class c's logit, "cls" every
# class logit (class plants only where nc > 1)
_NAN, _INF = float("nan"), float("inf")
D_PLANTS = ({2: _NAN}, {2: _INF}, {2: -_INF}, {3: _NAN}, {3: _INF},
            {3: -_INF}, {4: _NAN}, {4: _INF}, {4: -_INF}, {0: _INF, 1: -_INF},
            {6: _NAN}, {6: _NAN, 10: 50.0}, {9: _NAN, 10: 50.0}, {15: _NAN},
            {"cls": -_INF}, {"cls": _NAN})

# kernel B's layouts and shapes (phase 3): (B, K) of the checks at B_CHECK
# and of the main path at B_BENCH, max_det 128 and 512
KILL_LAYOUTS = ("uniform", "clustered", "all-overlap")
KILL_SHAPES = ((B_CHECK, 128), (B_CHECK, 512), (B_BENCH, 128),
               (B_BENCH, 512))
KILL_CHUNK = 16      # images per call of a plain version at B = B_BENCH
# phase 13 (training): the step at full size and the CLIs' dataset, the
# card-against-CPU step's (batch, size), the fit's steps, and the tolerances
# of that step's loss terms and grad norm (f32 on both sides, TF32 off).
# The grad norm sums the gradients of 75 train-mode BN layers, random init,
# B = 2: f32 rounding moves it by ~1e-3 (each side's distance from a
# float64 step is printed), so its tolerance is 3e-3.
TRAIN_IMG, TRAIN_B, TRAIN_N_IMAGES = 608, 8, 16
TRAIN_CHECK = (2, 256)
TRAIN_FIT_STEPS = 20
TRAIN_LOSS_RTOL, GRAD_NORM_RTOL = 1e-4, 3e-3
# phase 14: images in [0, 1] and normalized labels of the card's
# augmentation against the CPU's on the same draws
AUG_TOL = 1e-5
# phase 15: packed against canonical heads, f32, TF32 off, within STEM_TOL
# times the largest |head| (absolutely, where that is above 1); the anchors
# of the mixed-na cfg's first [yolo] (na 12, the other heads 18)
STEM_TOL = 1e-4
MIXED_MASK = (6, 7)
# phase 17: batch of the conv epilogue's layer-by-layer check at every shape
EPI_B = 2

# every kernel of the port, each pair algo of B, C and E its own entry:
# name -> (source, the TPU kernel's pallas_call it replaces)
_CSRC = "rotate_yolov3_tpu_torch/csrc/"
_KILL = (_CSRC + "skew_kill.cu",
         "rotate_yolov3_tpu/ops/skew_iou_pallas.py:501")
_NMS = (_CSRC + "nms_greedy.cu", "rotate_yolov3_tpu/ops/nms_pallas.py:189")
_IOU = (_CSRC + "skew_iou_matrix.cu",
        "rotate_yolov3_tpu/ops/skew_iou_pallas.py:368")
# kernels A, C and E have an entry at each of two shapes: A at the serving
# path's B = 128 ("gather_rows") and the DOTA tile stage's ("gather_rows:
# dota"); C at the DOTA merge's B = 1, K = 1024 ("nms_greedy:green") and
# fused_greedy's B = 128, K = 512 ("nms_greedy:green:serving"); E, each
# algo, at one 512 x 512 matrix and batched over the serving path's B = 128
# images (":serving")
_GATHER = (_CSRC + "gather_rows.cu",
           "rotate_yolov3_tpu/ops/gather_rows.py:100")
KERNELS = {
    # the port's own kernel: the JAX package leaves bias, activation and the
    # shortcut add to XLA, which fuses them into the convolution
    "conv_epilogue": (_CSRC + "conv_epilogue.cu",
                      "rotate_yolov3_tpu/models/darknet.py:439"),
    "gather_rows": _GATHER, "gather_rows:dota": _GATHER,
    "skew_kill:green": _KILL, "skew_kill:green2": _KILL,
    "skew_kill:candidates": _KILL,
    "nms_greedy:green": _NMS, "nms_greedy:green:serving": _NMS,
    "nms_greedy:green2": _NMS,
    "decode_rows": (_CSRC + "decode_rows.cu",
                    "rotate_yolov3_tpu/ops/decode_pallas.py:188"),
    "skew_iou_matrix:green": _IOU, "skew_iou_matrix:green2": _IOU,
    "skew_iou_matrix:candidates": _IOU,
    "skew_iou_matrix:green:serving": _IOU,
    "skew_iou_matrix:green2:serving": _IOU,
    "skew_iou_matrix:candidates:serving": _IOU,
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


# (kind, algo) -> (fp32 operations, fp32 instructions) of one pair
PAIR_OPS: dict = {}


def count_pair_ops(_build) -> None:
    """Fill ``PAIR_OPS`` from the SASS of the pair probes
    (``roofline.count_pair_ops``)."""
    PAIR_OPS.update(roofline.count_pair_ops(_build))


def pair_ops(kind: str, algo: str) -> int:
    """fp32 operations of one pair of probe ``kind`` by ``algo``."""
    return PAIR_OPS[(kind, algo)][0]


def instr_ms(instr: float) -> float:
    """ms of ``instr`` fp32 instructions at one per lane per clock: half
    the fp32 peak, which counts an FFMA as two operations. Code built with
    -fmad=false executes its adds and multiplies one by one, so this is the
    rate it can reach."""
    return instr / (FP32_PEAK / 2) * 1e3


def phase_build(_build) -> None:
    """One nvcc per kernel source, all started together."""
    def build(name):
        t0 = time.perf_counter()
        _build.load(name)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    names = _build.kernel_names()
    with ThreadPoolExecutor(len(names) + 1) as pool:
        probes = pool.submit(count_pair_ops, _build)
        times = dict(zip(names, pool.map(build, names)))
        probes.result()
    for name, dt in times.items():
        report = _build.BUILD_LOG.get(name, (dt, "(already built)"))[1]
        ptxas = [l.strip() for l in report.splitlines()
                 if "registers" in l or "spill" in l]
        log(f"build {name}: {dt:.2f} s; " + " | ".join(ptxas))
    log(f"build: {len(names)} kernels in {time.perf_counter() - t0:.2f} s")
    log("fp32 operations (instructions) of one pair, from the SASS of the "
        "pair probes: " + ", ".join(f"{k} {a} {n} ({i})" for (k, a), (n, i)
                                    in PAIR_OPS.items()))


def _gather_case(torch, gen, b: int, c: int, dtype, k: int):
    """Head maps of a 608² input (19², 38², 76² cells: 7581) as the path
    views them, (b, H*W, c) tables, and (b, k) int32 indices whose first
    entries are every head's first and last cell and two out of range."""
    tables = [torch.randn((b, g * g, c), generator=gen, device=DEVICE
                          ).to(dtype) for g in (19, 38, 76)]
    n = sum(t.shape[1] for t in tables)
    idx = torch.randint(0, n, (b, k), generator=gen, device=DEVICE,
                        dtype=torch.int32)
    edges = [0, 360, 361, 1804, 1805, n - 1, -5, n + 9]
    idx[:, :len(edges)] = torch.tensor(edges, dtype=torch.int32)
    return tables, idx


def _gather_equal(torch, what, tables, idx) -> float:
    """Kernel A on the tables in place and on their concatenation, each bit
    for bit its plain version; the worst |kernel - plain|."""
    from rotate_yolov3_tpu_torch.ops.gather_rows import (gather_rows,
                                                         gather_rows_ref)

    ref = gather_rows_ref(tables, idx)
    bits = torch.int16 if ref.dtype == torch.bfloat16 else torch.int32
    worst = 0.0
    for form, cells in (("heads in place", tables),
                        ("one table", torch.cat(tables, dim=1))):
        got = gather_rows(cells, idx)
        if not torch.equal(got.view(bits), ref.view(bits)):
            raise AssertionError(f"gather_rows {what} ({form}): kernel "
                                 f"differs from torch.cat + torch.gather")
        worst = max(worst, _max_err(got, ref))
    return worst


def phase_gather(torch, card, results) -> None:
    from rotate_yolov3_tpu_torch.ops.gather_rows import (gather_rows,
                                                         gather_rows_ref)

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    c = 126
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for k in (128, 512):
            tables, idx = _gather_case(torch, gen, B_CHECK, c, dtype, k)
            worst = max(worst, _gather_equal(
                torch, f"{dtype} B={B_CHECK} K={k}", tables, idx))
            ms = device_ms(torch, lambda: gather_rows(tables, idx))
            plain = device_ms(torch, lambda: gather_rows_ref(tables, idx))
            call = time_ms(torch, lambda: gather_rows(tables, idx))
            call_p = time_ms(torch, lambda: gather_rows_ref(tables, idx))
            log(f"gather_rows {str(dtype)[6:]} B={B_CHECK} N=7581 C={c} "
                f"K={k}: bit-equal (heads in place and one table, head "
                f"boundaries, out of range); device kernel {ms:.4f} ms, "
                f"plain (cat + gather) {plain:.4f} ms; per call "
                f"{call:.4f} ms, plain {call_p:.4f} ms [{card}]")
    # the serving path's shape, max_det 512 (B_BENCH images, HRSC), and the
    # DOTA tile stage's (25 tiles, 15 classes: C = 378), bf16
    for key, b, ch in (("gather_rows", B_BENCH, c), ("gather_rows:dota", 25,
                                                      378)):
        k = 512
        tables, idx = _gather_case(torch, gen, b, ch, torch.bfloat16, k)
        err = _gather_equal(torch, f"bfloat16 B={b} C={ch}", tables, idx)
        ms = device_ms(torch, lambda: gather_rows(tables, idx), reps=20)
        plain = device_ms(torch, lambda: gather_rows_ref(tables, idx),
                          reps=20)
        # the library call: torch.gather on the concatenated table with an
        # index clamped beforehand
        cat = torch.cat(tables, dim=1)
        n = cat.shape[1]
        idx64 = idx.long().clamp(0, n - 1)[..., None].expand(-1, -1, ch)
        lib = device_ms(torch, lambda: torch.gather(cat, 1, idx64), reps=20)
        # K rows of C bf16 read and written, K int32 indices read
        bnd = bound(0, b * k * (2 * ch * 2 + 4))
        log(f"gather_rows bfloat16 B={b} N={n} C={ch} K={k}: bit-equal; "
            f"device kernel {ms:.4f} ms (heads in place), torch.cat + "
            f"torch.gather (plain) {plain:.4f} ms, torch.gather on the "
            f"concatenated table with a clamped int64 index {lib:.4f} ms; "
            f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), "
            f"{100 * bnd['bound_ms'] / ms:.1f}% of it [{card}]")
        results[key] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                        "max_abs_err": max(worst, err), **bnd}
        del tables, idx, cat, idx64


def _detection_boxes(torch, gen, k: int, b=None):
    """b (default B_CHECK) images of k score-sorted boxes at detection scale
    within a 608-px image, the last eighth zero-area padding as on the
    serving path."""
    b = B_CHECK if b is None else b
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(
        (b, k), generator=gen, device=DEVICE)
    boxes = torch.stack([u(0, 608), u(0, 608), u(10, 160), u(10, 160),
                         u(-3.1416, 3.1416)], dim=-1).contiguous()
    boxes[:, k - k // 8:] = 0.0
    return boxes


def kill_layout(torch, gen, layout: str, b: int, k: int):
    """b images of k boxes in one of KILL_LAYOUTS: "uniform" is
    _detection_boxes; "clustered" is k / 16 objects (32 at K = 512) of 16
    boxes jittered about each (centre ±4% of the side, sides ±10%, angle
    ±0.1), rows in random order: the shape assumed for a trained
    detector's top-K (no trained weights are in the repository);
    "all-overlap" is k boxes jittered about one centre, where every pair
    overlaps and nothing is culled."""
    if layout == "uniform":
        return _detection_boxes(torch, gen, k, b)
    rand = lambda *shape: torch.rand(shape, generator=gen, device=DEVICE)
    noise = lambda *shape: torch.randn(shape, generator=gen, device=DEVICE)
    if layout == "clustered":
        n_obj = k // 16
        obj = torch.stack([608 * rand(b, n_obj), 608 * rand(b, n_obj),
                           10 + 150 * rand(b, n_obj), 10 + 150 * rand(b, n_obj),
                           6.2832 * rand(b, n_obj) - 3.1416], dim=-1)
        obj = obj.repeat_interleave(16, dim=1)
        side = obj[..., 2:4].mean(-1)
        boxes = torch.stack([obj[..., 0] + 0.04 * side * noise(b, k),
                             obj[..., 1] + 0.04 * side * noise(b, k),
                             obj[..., 2] * (1 + 0.1 * noise(b, k)),
                             obj[..., 3] * (1 + 0.1 * noise(b, k)),
                             obj[..., 4] + 0.1 * noise(b, k)], dim=-1)
        order = rand(b, k).argsort(dim=1)
        return torch.gather(boxes, 1, order[..., None].expand(-1, -1, 5)
                            ).contiguous()
    if layout == "all-overlap":
        return torch.stack([304 + 4 * noise(b, k), 304 + 4 * noise(b, k),
                            60 + 40 * rand(b, k), 60 + 40 * rand(b, k),
                            6.2832 * rand(b, k) - 3.1416], dim=-1).contiguous()
    raise ValueError(layout)


def phase_kill(torch, card, results) -> None:
    """Kernel B, each pair algo, on each layout and shape, without and with
    15 classes: equal to its plain version on every pair outside the band;
    its time beside the bound of the work these inputs need."""
    from rotate_yolov3_tpu_torch.ops.skew_iou_cuda import (
        ALGOS, skew_kill_matrix, skew_kill_matrix_ref)
    from rotate_yolov3_tpu_torch.ops.skew_iou_green import skew_iou_green

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    ops = {algo: PAIR_OPS[("kill_rec", algo)] for algo in ALGOS}
    far_of = lambda bx: (skew_iou_green(bx[:, :, None, :], bx[:, None, :, :])
                         - THR).abs() > BAND
    worst = dict.fromkeys(ALGOS, 0.0)
    for layout in KILL_LAYOUTS:
        for b, k in KILL_SHAPES:
            boxes = kill_layout(torch, gen, layout, b, k)
            cls = torch.randint(0, 15, (b, k), generator=gen, device=DEVICE,
                                dtype=torch.int32)
            far = in_chunks(far_of, boxes, chunk=KILL_CHUNK)
            for cls_id in (None, cls):
                tag = "cls" if cls_id is not None else "no-cls"
                p_near, p_all = live_pairs(boxes, cls_id, THR)
                nbytes = b * k * (20 + (4 if cls_id is not None else 0) + k)
                for algo in ALGOS:
                    got = skew_kill_matrix(boxes, cls_id, THR, algo)
                    ref = in_chunks(lambda bx, cl: skew_kill_matrix_ref(
                        bx, cl, THR, algo), boxes, cls_id, chunk=KILL_CHUNK)
                    diff = got != ref
                    bad = int((diff & far).sum())
                    if bad:
                        raise AssertionError(
                            f"skew_kill {algo} {layout} {tag} B={b} K={k}: "
                            f"{bad} pairs outside ±{BAND} of thr differ from "
                            f"the plain version")
                    worst[algo] = max(worst[algo], _max_err(got[far],
                                                            ref[far]))
                    kills = int(got.sum())
                    if kills == 0:
                        raise AssertionError(f"skew_kill {algo} {layout} "
                                             f"{tag} B={b} K={k}: no pair "
                                             f"kills")
                    ms = device_ms(torch, lambda: skew_kill_matrix(
                        boxes, cls_id, THR, algo))
                    flops, instr = ops[algo]
                    bnd = bound(p_near * flops, nbytes)
                    at_rate = max(instr_ms(p_near * instr),
                                nbytes / MEM_PEAK * 1e3)
                    log(f"skew_kill {algo} {layout} {tag} B={b} K={k} "
                        f"thr={THR}: equal on {int(far.sum())} pairs, "
                        f"{int((~far).sum())} excluded within ±{BAND}, "
                        f"{int(diff.sum())} differ inside the band, {kills} "
                        f"kills; device kernel {ms:.4f} ms; P_near/P_all "
                        f"{p_near}/{p_all} = {p_near / p_all:.4f}; bound "
                        f"{bnd['bound_ms']:.5f} ms ({bnd['bound_by']}), "
                        f"{100 * bnd['bound_ms'] / ms:.1f}% of it; at the "
                        f"fp32 instruction rate {at_rate:.5f} ms, "
                        f"{100 * at_rate / ms:.1f}% of it [{card}]")
                    if (layout, b, k, cls_id) == ("uniform", B_BENCH, 512,
                                                  None):
                        plain = device_ms(torch, lambda: in_chunks(
                            lambda bx: skew_kill_matrix_ref(
                                bx, None, THR, algo), boxes,
                            chunk=KILL_CHUNK), reps=1)
                        log(f"skew_kill {algo} uniform no-cls B={b} K={k}: "
                            f"plain version {plain:.4f} ms ({b // KILL_CHUNK}"
                            f" calls of {KILL_CHUNK} images) [{card}]")
                        results[f"skew_kill:{algo}"] = {
                            "ms": ms, "plain_ms": plain, "library_ms": None,
                            **bnd}
            del boxes, cls, far
    # the degenerate boxes, each algo
    deg = torch.tensor(DEGENERATE, dtype=torch.float32, device=DEVICE)[None]
    for algo in ALGOS:
        got = skew_kill_matrix(deg, None, THR, algo)
        ref = skew_kill_matrix_ref(deg, None, THR, algo)
        if bool(((got != ref) & far_of(deg)).any()):
            raise AssertionError(f"skew_kill {algo}: degenerate boxes differ "
                                 f"from the plain version")
        log(f"skew_kill {algo} degenerate set: {int(got.sum())} kills, equal "
            f"to the plain version outside ±{BAND} [{card}]")
    for algo in ALGOS:
        results[f"skew_kill:{algo}"]["max_abs_err"] = worst[algo]


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
                results["gather_rows"]["launches"] = launches["gather_rows"]
                results["skew_kill:green"]["launches"] = launches["skew_kill"]
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
                  skew_iou_green, what: str = "slice f32") -> None:
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
        raise AssertionError(f"{what}: top-k scores differ from the CPU "
                             f"path by {score_err}")
    # decode from the card's indices
    boxes_c, cls_c = decode_candidates(heads_c, specs, idx, valid, fm)
    box_err = float((boxes_c - boxes).abs().max())
    if box_err > 1e-3 or not torch.equal(cls_c, cls):
        raise AssertionError(f"{what}: decoded boxes differ from the CPU "
                             f"path by {box_err}")
    # kill + fixpoint from the card's boxes
    cls_arg = cls if use_cls else None
    kill_k = skew_kill_matrix(boxes.cuda(), None if cls_arg is None
                              else cls_arg.cuda(), THR).cpu()
    kill_c = skew_kill_matrix_ref(boxes, cls_arg, THR)
    iou = skew_iou_green(boxes[:, :, None, :], boxes[:, None, :, :])
    far = (iou - THR).abs() > BAND
    if bool(((kill_k != kill_c) & far).any()):
        raise AssertionError(f"{what}: card kill mask differs from the CPU "
                             "plain version outside the band")
    out_c, keep_c = nms_from_candidates(boxes, scores, cls, valid, THR,
                                        use_cls, det.max_det)
    same_kill = torch.equal(kill_k, kill_c)
    if same_kill and not (torch.equal(keep_c, keep) and
                          torch.equal(out_c, out)):
        raise AssertionError(f"{what}: card keep differs from the CPU "
                             "plain path on equal kill masks")
    log(f"{what} vs CPU plain path: top-k scores max diff {score_err:.3g}"
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


def queue_ms(torch, fn, reps: int = 20) -> float:
    """CUDA-event time of ``reps`` back-to-back calls of ``fn()`` over
    ``reps``, after one untimed call: the device time per call where each
    call's kernels outlast its launch on the host (the queue stays full),
    an upper bound where they do not."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int = 10) -> float:
    """Mean device time of ``fn()``: the CUDA kernel time that torch.profiler
    records over ``reps`` calls, divided by ``reps``; the larger of two
    such passes, since a pass that drops kernel events (seen on the H100)
    only reads low. Where the profiler records no device time,
    ``queue_ms`` stands in (an upper bound), and a line says so."""
    total_us = max(sum(us for _, us in _device_events(torch, fn, reps))
                   for _ in range(2))
    if total_us > 0:
        return total_us / reps / 1e3
    log("(torch.profiler recorded no device time; CUDA events over "
        f"{reps} back-to-back calls instead)")
    return queue_ms(torch, fn, reps)


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
    """Phase 5: B = 1 latency of the product path (B = 128 throughput and
    its stage ladder come from the benchmark's ``run_cell``, phase 16)."""
    from rotate_yolov3_tpu_torch.detector import Detector

    gen = torch.Generator().manual_seed(4)
    one = torch.randint(0, 256, (1, 608, 608, 3), generator=gen,
                        dtype=torch.uint8).cuda()
    det = Detector(CFG, conf_thres=CONF, nms_thres=THR, max_det=128,
                   compute_dtype=torch.bfloat16, seed=0, device="cuda")
    lat = time_ms(torch, lambda: det(one), reps=20, warmup=3)
    busy1 = device_ms(torch, lambda: det(one), reps=5)
    log(f"latency bf16 B=1 max_det=128 @608: {lat:.3f} ms (device "
        f"busy {busy1:.3f} ms) [{card}]")


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


def _nms_layout(torch, gen, b: int, k: int, n_cls: int, layout: str):
    """Phase 6's boxes, classes and valid rows: ``_nms_boxes`` ("random",
    or "special" with the chain and the all-invalid image), "all-overlap"
    (``kill_layout``'s: every pair overlaps, every row valid) or "no-kill"
    (boxes of 5-10 px on a 50-px grid: no pair intersects)."""
    if layout in ("random", "special"):
        return _nms_boxes(torch, gen, b, k, n_cls, layout == "special")
    valid = torch.ones((b, k), dtype=torch.bool, device=DEVICE)
    if layout == "all-overlap":
        return kill_layout(torch, gen, layout, b, k), None, valid
    i = torch.arange(k, device=DEVICE, dtype=torch.float32).expand(b, k)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(
        (b, k), generator=gen, device=DEVICE)
    boxes = torch.stack([50 * (i % 32), 50 * torch.div(i, 32,
                                                       rounding_mode="floor"),
                         u(5, 10), u(5, 10), u(-3.1416, 3.1416)], dim=-1)
    return boxes.contiguous(), None, valid


def phase_nms_greedy(torch, card, results) -> None:
    from rotate_yolov3_tpu_torch.ops.nms_greedy import (nms_greedy,
                                                        nms_greedy_ref)
    from rotate_yolov3_tpu_torch.ops.rotated_nms import keep_two_stage
    from rotate_yolov3_tpu_torch.ops.skew_iou_green import skew_iou_green

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    cases = [  # (B, K, classes, thr, layout)
        (B_CHECK, 512, 0, THR, "special"), (B_CHECK, 512, 15, THR, "special"),
        (1, 1024, 15, MERGE_THR, "random"), (2, 1024, 15, MERGE_THR,
                                             "special"),
        (3, 200, 15, MERGE_THR, "special"),   # K not a multiple of 32
        (1, 1024, 0, MERGE_THR, "all-overlap"),
        (1, 1024, 0, MERGE_THR, "no-kill")]
    for b, k, n_cls, thr, layout in cases:
        special = layout == "special"
        boxes, cls, valid = _nms_layout(torch, gen, b, k, n_cls, layout)
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
        if layout == "no-kill" and not torch.equal(keep, valid):
            raise AssertionError(f"nms_greedy B={b} K={k} no-kill: a row "
                                 f"was suppressed")
        if layout != "no-kill" and not 0 < n_kept < int(valid.sum()):
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
        shape = {"special": " (chain + all-invalid)", "random": "",
                 "all-overlap": " all-overlap", "no-kill": " no-kill"}[layout]
        log(f"nms_greedy {tag} B={b} K={k} thr={thr}{shape}: keep equal to "
            f"kernel B + fixpoint; equal to the plain version on "
            f"{int(clean.sum())} of {b} images ({int(band.sum())} live pairs "
            f"within ±{BAND} of thr, {int((keep != ref).sum())} keep "
            f"entries differ); {n_kept} kept of {int(valid.sum())} valid; "
            f"device kernel C {ms:.4f} ms, kernel B + fixpoint {two_ms:.4f} "
            f"ms, plain {plain:.4f} ms; per call C {call:.4f} ms, B + "
            f"fixpoint {call_two:.4f} ms [{card}]")
        if b == 1:
            # the near pairs' geometry, or boxes, classes, valid in and keep
            # out; the walk's dependent steps are not counted
            p_near = live_pairs(boxes, cls, thr)[0]
            bnd = bound(p_near * pair_ops("kill_rec", "green"), b * k * 26)
            log(f"nms_greedy {tag} B={b} K={k}{shape}: {p_near} near pairs; "
                f"bound {bnd['bound_ms']:.5f} ms ({bnd['bound_by']}), "
                f"{100 * bnd['bound_ms'] / ms:.1f}% of it [{card}]")
        if layout == "random":
            results["nms_greedy:green"] = {
                "ms": ms, "plain_ms": plain, "library_ms": None,
                "max_abs_err": float((keep[clean].float()
                                      - ref[clean].float()).abs().max()),
                **bnd}


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
    kernel A on the path's head maps in place (as ``decode_gathered`` calls
    it) and on their concatenated (T, cells, na·no) table against
    ``torch.cat`` + ``torch.gather`` (bit for bit), kernel B against its
    plain version on the path's boxes and classes (every pair outside the
    band), and the per-tile keep
    and detections through the plain versions (every tile whose kill masks
    agree). Returns the worst |kernel - plain| of A and of B."""
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
    # kernel A: the cell rows decode_gathered gathers, from the heads as it
    # passes them (views of the channels-last maps: no copy)
    na, no = specs[0].na, specs[0].no
    tables = [h.reshape(h.shape[0], -1, na * no) for h in heads]
    if not all(t.is_contiguous() for t in tables):
        raise AssertionError(f"dota {name}: a head map is not a contiguous "
                             f"(T, H*W, na*no) view")
    cell_idx = torch.div(idx, na, rounding_mode="floor").contiguous()
    gather_err = _gather_equal(torch, f"dota {name} tile stage", tables,
                               cell_idx)

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
    log(f"dota {name} tile stage, T={tables[0].shape[0]} cells="
        f"{sum(t.shape[1] for t in tables)} C={tables[0].shape[2]} "
        f"K={idx.shape[1]}, "
        f"{'class-aware' if use_cls else 'no-cls'} thr={thr}: kernel A "
        f"(heads in place and one table) bit-equal to torch.cat + "
        f"torch.gather; kernel B equal to "
        f"its plain version on {int(far.sum())} pairs "
        f"({int((kill_k != kill_r).sum())} differ within ±{BAND}); keep and "
        f"detections equal to the plain recompute on {int(same.sum())} of "
        f"{same.numel()} tiles, {int(keep_k.sum())} kept [{card}]")
    return (gather_err,
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
                results["nms_greedy:green"]["launches"] = \
                    launches["nms_greedy"]
                results["gather_rows:dota"]["launches"] = \
                    launches["gather_rows"]
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
                for key, err in zip(("gather_rows:dota", "skew_kill:green"),
                                    errs):
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


def phase_fused_serving(torch, card, results):
    """Kernel C on the HRSC serving heads at B_BENCH, max_det 512; returns
    the path's (B_BENCH, 512, 5) boxes, which phase 9 reuses."""
    from rotate_yolov3_tpu_torch.detector import Detector
    from rotate_yolov3_tpu_torch.ops.nms_greedy import (nms_greedy,
                                                        nms_greedy_ref)
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
    n_fused = nms_greedy.launches
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
    # kernel C's time: CUDA events over back-to-back calls (each launch
    # takes far longer than its enqueue, so the queue stays full), beside
    # the profiler's reading
    c_fn = lambda: nms_greedy(boxes, None, valid, THR)
    c_ms = queue_ms(torch, c_fn, reps=50)
    c_prof = device_ms(torch, c_fn)
    b_ms = device_ms(torch, two_stage)
    c_call = time_ms(torch, lambda: nms_greedy(boxes, None, valid, THR))
    b_call = time_ms(torch, two_stage, reps=5, warmup=1)
    # the plain version, KILL_CHUNK images a call, against kernel C on every
    # image without a pair in the band
    keep = nms_greedy(boxes, None, valid, THR)
    plain_fn = lambda: in_chunks(lambda bx, v: nms_greedy_ref(
        bx, None, v, THR), boxes, valid, chunk=KILL_CHUNK)
    ref = plain_fn()
    clean = in_chunks(lambda bx, v: _clean_images(torch, bx, None, v),
                      boxes, valid, chunk=KILL_CHUNK)
    if not torch.equal(keep[clean], ref[clean]):
        raise AssertionError("fused_greedy: kernel C differs from its plain "
                             "version on an image without a band pair")
    plain = device_ms(torch, plain_fn, reps=1)
    # the near pairs' geometry (kernel C reads BoxRec records, as B), or
    # boxes and valid in, keep out
    p_near, p_all = live_pairs(boxes, None, THR)
    bnd = bound(p_near * pair_ops("kill_rec", "green"),
                B_BENCH * max_det * 22)
    log(f"fused_greedy bf16 B={B_BENCH} max_det={max_det} @{det.img_size}: "
        f"detections "
        f"and keep equal to the default ({int(base[1].sum())} kept); NMS "
        f"tail per call {full_f:.3f} ms fused vs {full_b:.3f} ms two-stage; "
        f"device kernel C {c_ms:.4f} ms (CUDA events over 50 back-to-back "
        f"calls; torch.profiler {c_prof:.4f} ms) vs kernel B + fixpoint "
        f"{b_ms:.4f} ms, plain {plain:.4f} ms ({B_BENCH // KILL_CHUNK} "
        f"calls of "
        f"{KILL_CHUNK} images; {int(clean.sum())} of {B_BENCH} images have "
        f"no band pair, equal there); per call C {c_call:.4f} ms vs B + "
        f"fixpoint {b_call:.4f} ms; P_near/P_all {p_near}/{p_all} = "
        f"{p_near / p_all:.4f}; bound {bnd['bound_ms']:.5f} ms "
        f"({bnd['bound_by']}), {100 * bnd['bound_ms'] / c_ms:.1f}% of it "
        f"[{card}]")
    results["nms_greedy:green:serving"] = {
        "ms": c_ms, "plain_ms": plain, "library_ms": None,
        "launches": n_fused,
        "max_abs_err": _max_err(keep[clean], ref[clean]), **bnd}
    del det, x, heads
    return boxes


def _max_err(got, want) -> float:
    """max |got - want| as floats; 0 for empty tensors."""
    if got.numel() == 0:
        return 0.0
    return float((got.float() - want.float()).abs().max())


def _clean_images(torch, boxes, cls, valid, thr: float = THR):
    """(B,) bool: images with no live pair (j > i, both valid, same class)
    whose IoU lies within ±BAND of ``thr``, where any two exact pair algos
    or predicates may decide differently."""
    from rotate_yolov3_tpu_torch.ops.skew_iou_green import skew_iou_green

    k = boxes.shape[1]
    iou = skew_iou_green(boxes[:, :, None, :], boxes[:, None, :, :])
    live = torch.ones((k, k), dtype=torch.bool, device=boxes.device).triu(1) \
        & valid[:, :, None] & valid[:, None, :]
    if cls is not None:
        live &= cls[:, :, None] == cls[:, None, :]
    return ~(((iou - thr).abs() <= BAND) & live).any(dim=(1, 2))


def _same_on_clean(torch, what, boxes, cls, valid, got, want) -> str:
    """Raise unless the (keep, detections) pairs ``got`` and ``want`` are
    equal on every image without a pair in the band; describe the match."""
    got = [g.to(w.device) for g, w in zip(got, want)]
    if all(torch.equal(g, w) for g, w in zip(got, want)):
        return f"equal on all {len(got[0])} images"
    clean = _clean_images(torch, boxes, cls, valid).to(want[0].device)
    for g, w in zip(got, want):
        if not torch.equal(g[clean], w[clean]):
            raise AssertionError(f"{what}: differs on an image with no pair "
                                 f"within ±{BAND} of thr")
    return (f"equal on the {int(clean.sum())} of {clean.numel()} images "
            f"without a pair within ±{BAND} of thr; an image with one "
            f"differs")


def iou_live_pairs(torch, boxes, triangle: bool = True) -> int:
    """Pairs of (B, K, 5) boxes with themselves that kernel E's step 1 hands
    to the geometry (``iou_may_overlap``; j > i with ``triangle``),
    counted with the plain mirror of its test."""
    from rotate_yolov3_tpu_torch.ops.skew_iou_cuda import iou_may_overlap

    k = boxes.shape[1]
    mask = torch.ones((k, k), dtype=torch.bool, device=boxes.device)
    if triangle:
        mask = mask.triu(1)
    return int(in_chunks(lambda bx: (iou_may_overlap(
        bx[:, :, None], bx[:, None, :]) & mask).flatten(1).sum(1),
        boxes, chunk=KILL_CHUNK).sum())


def _iou_err(what, got, ref) -> float:
    """max |got - ref| where ``ref`` is not NaN; raise unless NaN sits in the
    same places and the rest is within IOU_TOL."""
    nan = ref.isnan()
    if not bool((got.isnan() == nan).all()):
        raise AssertionError(f"{what}: NaN in other places than the plain "
                             f"version")
    err = _max_err(got[~nan], ref[~nan])
    if not err <= IOU_TOL:
        raise AssertionError(f"{what}: {err} from the plain version")
    return err


def _same_values(a, b) -> bool:
    """Equal, NaN where the other is NaN."""
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan()))
                                       .all())


def phase_iou_matrix(torch, card, results, serving) -> None:
    """Kernel E, each algo, against its plain version and the argsort
    oracle; batched over ``serving``, the serving path's (B_BENCH, 512, 5)
    boxes."""
    from rotate_yolov3_tpu_torch.ops.skew_iou import \
        skew_iou_matrix as argsort_iou
    from rotate_yolov3_tpu_torch.ops.skew_iou_cuda import (
        ALGOS, skew_iou_matrix, skew_iou_matrix_ref)

    gen = torch.Generator(device=DEVICE).manual_seed(9)
    u = lambda n, lo, hi: lo + (hi - lo) * torch.rand(
        n, generator=gen, device=DEVICE)
    small = [torch.stack([u(n, 0, 60), u(n, 0, 60), u(n, 5, 30),
                          u(n, 5, 30), u(n, -3.1416, 3.1416)], dim=-1)
             for n in (17, 33)]
    det = _detection_boxes(torch, gen, 512)          # (B_CHECK, 512, 5)
    deg = torch.tensor(DEGENERATE, dtype=torch.float32, device=DEVICE)
    cases = [("17x33", small[0], small[1]), ("512x512", det[0], det[0]),
             ("degenerate", deg, deg)]
    for algo in ALGOS:
        worst = worst_arg = 0.0
        for name, a, b in cases:
            oracle = argsort_iou(a, b)
            for triangle in (False, True):
                got = skew_iou_matrix(a, b, triangle, algo)
                ref = skew_iou_matrix_ref(a, b, triangle, algo)
                err = float((got - ref).abs().max())
                if not err <= IOU_TOL or not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"skew_iou_matrix {algo} {name} "
                                         f"triangle={triangle}: {err} from "
                                         f"the plain version")
                worst = max(worst, err)
                if triangle:
                    up = torch.ones_like(got, dtype=torch.bool).triu(1)
                    if bool(got[~up].any()) or not torch.equal(
                            got[up], full[up]):
                        raise AssertionError(f"skew_iou_matrix {algo} "
                                             f"{name}: triangle is not the "
                                             f"full matrix above the "
                                             f"diagonal and 0 below")
                else:
                    full = got
                    arg = float((got - oracle).abs().max())
                    if arg > ARGSORT_TOL:
                        raise AssertionError(f"skew_iou_matrix {algo} "
                                             f"{name}: {arg} from the "
                                             f"argsort oracle")
                    worst_arg = max(worst_arg, arg)
            if name == "degenerate" and float(
                    (full.diagonal() - 1).abs().max()) > ARGSORT_TOL:
                raise AssertionError(f"skew_iou_matrix {algo}: a degenerate "
                                     f"box's IoU with itself is not 1")
        # B_CHECK images one call each, and the batch in one call
        hook = torch.stack([skew_iou_matrix(x, x, True, algo) for x in det])
        hook_ref = torch.stack([skew_iou_matrix_ref(x, x, True, algo)
                                for x in det])
        err = float((hook - hook_ref).abs().max())
        if err > IOU_TOL or not torch.equal(
                skew_iou_matrix(det, det, True, algo), hook):
            raise AssertionError(f"skew_iou_matrix {algo} B={B_CHECK}: "
                                 f"{err} from the plain version, or the "
                                 f"batch differs from one image a call")
        worst = max(worst, err)
        x = det[0]
        ms = device_ms(torch, lambda: skew_iou_matrix(x, x, True, algo),
                       reps=20)
        plain = device_ms(torch, lambda: skew_iou_matrix_ref(x, x, True,
                                                             algo), reps=3)
        log(f"skew_iou_matrix {algo}: 17x33, 512x512 and the degenerate set "
            f"(triangle off and on) and B={B_CHECK} x 512x512 (one image a "
            f"call and batched, equal) within {worst:.3g} of the plain "
            f"version (limit {IOU_TOL}), within {worst_arg:.3g} of the "
            f"argsort oracle (limit {ARGSORT_TOL}); 512x512 triangle: device "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms [{card}]")
        # the pairs that take the geometry above the diagonal, or boxes in
        # and the f32 matrix out
        p_geo = iou_live_pairs(torch, x[None])
        bnd = bound(p_geo * pair_ops("iou_rec", algo),
                    2 * x.shape[0] * 20 + x.shape[0] ** 2 * 4)
        log(f"skew_iou_matrix {algo} 512x512 triangle: {p_geo} pairs take "
            f"the geometry; bound {bnd['bound_ms']:.5f} ms "
            f"({bnd['bound_by']}), {100 * bnd['bound_ms'] / ms:.1f}% of it "
            f"[{card}]")
        results[f"skew_iou_matrix:{algo}"] = {
            "ms": ms, "plain_ms": plain, "library_ms": None,
            "max_abs_err": worst, **bnd}

        # batched over the serving path's B_BENCH images, as a hooked NMS
        # call runs it: against the plain version in chunks, the triangle
        # against the full matrix, the batch against one image a call
        got = skew_iou_matrix(serving, serving, True, algo)
        ref = in_chunks(lambda bx: skew_iou_matrix_ref(
            bx, bx, True, algo), serving, chunk=KILL_CHUNK)
        err = _iou_err(f"skew_iou_matrix {algo} serving B={B_BENCH}", got,
                       ref)
        full = skew_iou_matrix(serving, serving, False, algo)
        up = torch.ones_like(got[0], dtype=torch.bool).triu(1).expand_as(got)
        one_by_one = torch.stack([skew_iou_matrix(v, v, True, algo)
                                  for v in serving])
        if bool(got[~up].any()) or not _same_values(got[up], full[up]) or \
                not _same_values(got, one_by_one):
            raise AssertionError(f"skew_iou_matrix {algo} serving: the "
                                 f"triangle differs from the full matrix, "
                                 f"or the batch from one image a call")
        differ = int(((got != ref) & ~(got.isnan() & ref.isnan())).sum())
        # CUDA events over back-to-back calls (each launch outlasts its
        # enqueue), beside the profiler's reading, which dropped events here
        ms = queue_ms(torch, lambda: skew_iou_matrix(serving, serving, True,
                                                     algo), reps=50)
        prof = device_ms(torch, lambda: skew_iou_matrix(serving, serving,
                                                        True, algo))
        loop_ms = device_ms(torch, lambda: [skew_iou_matrix(v, v, True, algo)
                                            for v in serving], reps=3)
        plain = device_ms(torch, lambda: in_chunks(
            lambda bx: skew_iou_matrix_ref(bx, bx, True, algo), serving,
            chunk=KILL_CHUNK), reps=1)
        p_geo = iou_live_pairs(torch, serving)
        b, k = serving.shape[:2]
        bnd = bound(p_geo * pair_ops("iou_rec", algo),
                    2 * b * k * 20 + b * k * k * 4)
        log(f"skew_iou_matrix {algo} serving boxes B={b} K={k} triangle, one "
            f"launch: within {err:.3g} of the plain version ({differ} of "
            f"{got.numel()} entries differ), the triangle equal to the full "
            f"matrix above the diagonal, equal to one launch per image; "
            f"device kernel {ms:.4f} ms (CUDA events over 50 back-to-back "
            f"calls; torch.profiler {prof:.4f} ms), {b} launches of one image "
            f"{loop_ms:.4f} ms, plain {plain:.4f} ms ({b // KILL_CHUNK} "
            f"calls of {KILL_CHUNK} images); {p_geo} of "
            f"{b * k * (k - 1) // 2} pairs take the geometry; bound "
            f"{bnd['bound_ms']:.5f} ms ({bnd['bound_by']}), "
            f"{100 * bnd['bound_ms'] / ms:.1f}% of it [{card}]")
        results[f"skew_iou_matrix:{algo}:serving"] = {
            "ms": ms, "plain_ms": plain, "library_ms": None,
            "max_abs_err": err, **bnd}
        del got, ref, full, one_by_one


def phase_pair_algos(torch, card, results) -> None:
    """Kernel B' (green2, candidates) and kernel C's green2."""
    from rotate_yolov3_tpu_torch.ops.nms_greedy import (nms_greedy,
                                                        nms_greedy_ref)
    from rotate_yolov3_tpu_torch.ops.rotated_nms import keep_two_stage
    from rotate_yolov3_tpu_torch.ops.skew_iou_cuda import (
        ALGOS, skew_kill_matrix, skew_kill_matrix_ref)
    from rotate_yolov3_tpu_torch.ops.skew_iou_green import skew_iou_green

    gen = torch.Generator(device=DEVICE).manual_seed(10)
    boxes = _detection_boxes(torch, gen, 512)
    cls = torch.randint(0, 15, (B_CHECK, 512), generator=gen, device=DEVICE,
                        dtype=torch.int32)
    valid = torch.ones((B_CHECK, 512), dtype=torch.bool, device=DEVICE)
    deg = torch.tensor(DEGENERATE, dtype=torch.float32, device=DEVICE)[None]
    deg_ok = torch.ones((1, len(DEGENERATE)), dtype=torch.bool,
                        device=DEVICE)
    deg_clean = bool(_clean_images(torch, deg, None, deg_ok).all())
    iou = skew_iou_green(boxes[:, :, None, :], boxes[:, None, :, :])
    far = (iou - THR).abs() > BAND
    for algo in ALGOS[1:]:
        worst = 0.0
        for cls_id in (None, cls):
            got = skew_kill_matrix(boxes, cls_id, THR, algo)
            ref = skew_kill_matrix_ref(boxes, cls_id, THR, algo)
            diff = got != ref
            if bool((diff & far).any()):
                raise AssertionError(f"skew_kill {algo}: {int((diff & far)
                                     .sum())} pairs outside ±{BAND} of thr "
                                     f"differ from the plain version")
            worst = max(worst, _max_err(got[far], ref[far]))
            kills = int(got.sum())
            if kills == 0:
                raise AssertionError(f"skew_kill {algo}: no pair kills")
            ms = device_ms(torch, lambda: skew_kill_matrix(boxes, cls_id,
                                                           THR, algo))
            plain = device_ms(torch, lambda: skew_kill_matrix_ref(
                boxes, cls_id, THR, algo), reps=2)
            tag = "cls" if cls_id is not None else "no-cls"
            log(f"skew_kill {algo} {tag} B={B_CHECK} K=512 thr={THR}: equal "
                f"to the plain version on {int(far.sum())} pairs, "
                f"{int((~far).sum())} excluded within ±{BAND}, "
                f"{int(diff.sum())} differ inside the band, {kills} kills; "
                f"device kernel {ms:.4f} ms, plain {plain:.4f} ms [{card}]")
        # the degenerate boxes through this algo, against green and plain
        d_got = skew_kill_matrix(deg, None, THR, algo)
        d_ref = skew_kill_matrix_ref(deg, None, THR, algo)
        d_green = skew_kill_matrix(deg, None, THR, "green")
        if deg_clean and not (torch.equal(d_got, d_ref)
                              and torch.equal(d_got, d_green)):
            raise AssertionError(f"skew_kill {algo}: degenerate boxes differ "
                                 f"from the plain version or from green")
        entry = results[f"skew_kill:{algo}"]
        entry["max_abs_err"] = max(entry["max_abs_err"], worst)
        log(f"skew_kill {algo} degenerate set: {int(d_got.sum())} kills, "
            f"equal to the plain version and to green [{card}]")

    # kernel C, green2: bit for bit kernel B green2 + fixpoint; "candidates"
    # computes green, as in the reference
    for n_cls in (0, 15):
        nb, ncls, nvalid = _nms_boxes(torch, gen, B_CHECK, 512, n_cls, True)
        keep = nms_greedy(nb, ncls, nvalid, THR, algo="green2")
        two = keep_two_stage(nb, ncls, nvalid, THR, algo="green2")
        if not torch.equal(keep, two):
            raise AssertionError("nms_greedy green2: keep differs from "
                                 "kernel B green2 + fixpoint")
        ref = nms_greedy_ref(nb, ncls, nvalid, THR, algo="green2")
        clean = _clean_images(torch, nb, ncls, nvalid)
        if not torch.equal(keep[clean], ref[clean]):
            raise AssertionError("nms_greedy green2: keep differs from the "
                                 "plain version on an image without a band "
                                 "pair")
        if not torch.equal(nms_greedy(nb, ncls, nvalid, THR,
                                      algo="candidates"),
                           nms_greedy(nb, ncls, nvalid, THR, algo="green")):
            raise AssertionError("nms_greedy: algo 'candidates' is not "
                                 "'green'")
        alt = torch.arange(512, device=DEVICE) % 2 == 0
        if not torch.equal(keep[0], alt) or bool(keep[-1].any()):
            raise AssertionError("nms_greedy green2: wrong keep on the chain "
                                 "or the all-invalid image")
        ms = device_ms(torch, lambda: nms_greedy(nb, ncls, nvalid, THR,
                                                 algo="green2"), reps=50)
        two_ms = device_ms(torch, lambda: keep_two_stage(
            nb, ncls, nvalid, THR, algo="green2"))
        plain = device_ms(torch, lambda: nms_greedy_ref(
            nb, ncls, nvalid, THR, algo="green2"), reps=2)
        green_ms = device_ms(torch, lambda: nms_greedy(nb, ncls, nvalid, THR),
                             reps=50)
        tag = f"{n_cls} classes" if n_cls else "no-cls"
        log(f"nms_greedy green2 {tag} B={B_CHECK} K=512 (chain + "
            f"all-invalid): keep equal to kernel B green2 + fixpoint, to "
            f"the plain version on {int(clean.sum())} of {B_CHECK} images "
            f"without a band pair; 'candidates' equal to 'green'; "
            f"{int(keep.sum())} kept; device kernel C green2 {ms:.4f} ms "
            f"(green {green_ms:.4f}), kernel B green2 + fixpoint "
            f"{two_ms:.4f} ms, plain {plain:.4f} ms [{card}]")
        if not n_cls:
            p_near = live_pairs(nb, ncls, THR)[0]
            bnd = bound(p_near * pair_ops("kill_rec", "green2"),
                        B_CHECK * 512 * 26)
            log(f"nms_greedy green2 no-cls B={B_CHECK} K=512: {p_near} near "
                f"pairs; bound {bnd['bound_ms']:.5f} ms ({bnd['bound_by']}),"
                f" {100 * bnd['bound_ms'] / ms:.1f}% of it [{card}]")
            results["nms_greedy:green2"] = {
                "ms": ms, "plain_ms": plain, "library_ms": None,
                "max_abs_err": _max_err(keep[clean], ref[clean]), **bnd}


def _random_head_maps(torch, gen, specs, img: int, b: int, dtype):
    """Seeded N(0, 2) raw head maps of an img² input with, in every other
    grid row, class 1's logits copied into class 4, so the class argmax meets
    exact ties."""
    na, no, nc = specs[0].na, specs[0].no, specs[0].num_classes
    heads = []
    for y in specs:
        g = img // y.stride
        h = 2.0 * torch.randn((b, g, g, na * no), generator=gen,
                              device=DEVICE)
        if nc > 4:   # field-major lanes: class c of anchor a at (6+c)*na+a
            h[:, ::2, :, 10 * na:11 * na] = h[:, ::2, :, 7 * na:8 * na]
        heads.append(h.to(dtype))
    return heads


def _plant_rows(torch, heads, idx, meta, na: int, nc: int):
    """Write each of D_PLANTS into the field-major lanes of one selected
    row's cell and anchor (image p % B, row 64 + p); (B, K) bool of the
    planted rows."""
    planted = torch.zeros(idx.shape, dtype=torch.bool, device=idx.device)
    plants = [p for p in D_PLANTS
              if nc > 1 or all(f != "cls" and f < 6 for f in p)]
    for p, plant in enumerate(plants):
        bi, row = p % idx.shape[0], 64 + p
        g = int(idx[bi, row])
        cell, a = divmod(g, na)
        for h, m in zip(heads, meta):
            if cell < m.n_cells:
                y, x = divmod(cell, m.width)
                break
            cell -= m.n_cells
        for f, v in plant.items():
            for ff in (range(6, 6 + nc) if f == "cls" else (f,)):
                h[bi, y, x, ff * na + a] = v
        planted[bi, row] = True
    return planted


def phase_decode(torch, card, results) -> None:
    """Kernel D against its plain version and against kernel A + the plain
    decode it replaces."""
    from rotate_yolov3_tpu_torch.config.parse import parse_model_cfg
    from rotate_yolov3_tpu_torch.models.darknet import build_network
    from rotate_yolov3_tpu_torch.ops.decode_rows import (decode_rows,
                                                         decode_rows_ref,
                                                         heads_meta)
    from rotate_yolov3_tpu_torch.ops.rotated_nms import decode_candidates

    gen = torch.Generator(device=DEVICE).manual_seed(11)
    k, img = 512, NET_IMG or 608
    worst = 0.0
    # the last case, HRSC bf16 at the serving batch, gives the JSON entry
    for cfg, b, dtypes in ((CFG, B_CHECK, (torch.bfloat16, torch.float32)),
                           (DOTA_CFG, 25, (torch.bfloat16,)),
                           (CFG, B_BENCH, (torch.bfloat16,))):
        specs = build_network(parse_model_cfg(cfg), img_size=img).yolo_specs
        na, nc = specs[0].na, specs[0].num_classes
        for dtype in dtypes:
            heads = _random_head_maps(torch, gen, specs, img, b, dtype)
            meta = heads_meta(specs, [h.shape for h in heads])
            n = sum(m.n_cells for m in meta) * na
            idx = torch.randint(0, n, (b, k), generator=gen, device=DEVICE,
                                dtype=torch.int32)
            edges, off = [], 0
            for m in meta:                  # first and last of every head
                edges += [off, off + m.n_cells * na - 1]
                off += m.n_cells * na
            idx[:, :len(edges)] = torch.tensor(edges, dtype=torch.int32)
            valid = torch.rand((b, k), generator=gen, device=DEVICE) > 0.2
            planted = _plant_rows(torch, heads, idx, meta, na, nc)
            got = decode_rows(heads, idx, valid, meta, na, nc)
            ref = decode_rows_ref(heads, idx, valid, meta, na, nc)
            nan = ref[..., :5].isnan()
            err = torch.where(nan, 0.0, (got[..., :5] - ref[..., :5]).abs())
            if not torch.equal(got[..., :5].isnan(), nan) or \
                    bool((err > DECODE_ATOL + DECODE_RTOL
                          * ref[..., :5].abs()).any()) or \
                    not torch.equal(got[..., 5], ref[..., 5]) or \
                    bool(got[..., 6:].any()) or \
                    bool(got[~valid & ~planted][:, :5].any()):
                raise AssertionError(f"decode_rows {cfg} {dtype}: kernel "
                                     f"differs from the plain version")
            worst = max(worst, float(err.max()))
            # rows whose class maximum is tied between classes
            cells = torch.cat([h.reshape(b, -1, h.shape[-1]) for h in heads],
                              dim=1)
            g = idx.long()
            lanes = (6 + torch.arange(nc, device=DEVICE)) * na \
                + (g % na)[..., None]
            rows = torch.gather(cells, 1, (g // na)[..., None].expand(
                -1, -1, cells.shape[-1]))
            logits = torch.gather(rows, 2, lanes).float()
            ties = int(((logits == logits.amax(-1, keepdim=True)).sum(-1)
                        > 1).sum()) if nc > 1 else 0
            ms = device_ms(torch, lambda: decode_rows(heads, idx, valid, meta,
                                                      na, nc), reps=20)
            plain = device_ms(torch, lambda: decode_rows_ref(
                heads, idx, valid, meta, na, nc), reps=5)
            a_plus = device_ms(torch, lambda: decode_candidates(
                heads, specs, idx, valid, True), reps=5)
            name = str(dtype)[6:]
            log(f"decode_rows {os.path.basename(cfg)} {name} B={b} "
                f"cells={n // na} C={heads[0].shape[-1]} K={k} nc={nc}: "
                f"boxes within {float(err.max()):.3g} of the plain version "
                f"(rtol {DECODE_RTOL}, atol {DECODE_ATOL}), NaN in the same "
                f"{int(nan.any(-1).sum())} rows, class ids equal "
                f"({ties} rows with a tied class maximum, "
                f"{int(planted.sum())} planted non-finite rows), columns "
                f"6-7 zero; device kernel D {ms:.4f} ms, plain {plain:.4f} "
                f"ms, kernel A + decode {a_plus:.4f} ms [{card}]")
            if cfg == CFG and dtype == torch.bfloat16:
                # per row: 6 + nc fields read, index and valid read, 8 f32
                # written; 30 + nc operations (two sigmoids, two clamped
                # exps, a tanh, the scaling and masking, nc compares)
                bnd = bound(b * k * (30 + nc),
                            b * k * ((6 + nc) * 2 + 4 + 1 + 32))
                # each field the kernel reads (5, and nc class logits where
                # nc > 1) sits in its own 32-byte sector
                fields = 5 + (nc if nc > 1 else 0)
                floor = b * k * (fields * 32 + 4 + 1 + 32) / MEM_PEAK * 1e3
                log(f"decode_rows HRSC bf16 B={b} K={k}: bound "
                    f"{bnd['bound_ms']:.5f} ms ({bnd['bound_by']}), "
                    f"{100 * bnd['bound_ms'] / ms:.1f}% of it; at one 32-byte "
                    f"sector per field read {floor:.5f} ms, "
                    f"{100 * floor / ms:.1f}% of it [{card}]")
                results["decode_rows"] = {"ms": ms, "plain_ms": plain,
                                          "library_ms": None, **bnd}
    results["decode_rows"]["max_abs_err"] = worst


def phase_options(torch, card, results) -> None:
    """The slice's paths at 608², B = B_CHECK, max_det 512: 1
    ``Detector(iou_algo=...)``, 2 ``Detector(iou_matrix_fn=...)``, 3
    ``non_max_suppression(det.predict_raw(x))`` with and without a hook, 4
    ``non_max_suppression_fused(decode_kernel=True[, fused_greedy=True])``
    for each ``iou_algo``; then their per-call time at B = B_BENCH."""
    from functools import partial

    from rotate_yolov3_tpu_torch.detector import Detector
    from rotate_yolov3_tpu_torch.ops.decode_rows import (decode_rows,
                                                         decode_rows_ref,
                                                         heads_meta)
    from rotate_yolov3_tpu_torch.ops.gather_rows import gather_rows
    from rotate_yolov3_tpu_torch.ops.nms_greedy import (kernel_algo,
                                                        nms_greedy)
    from rotate_yolov3_tpu_torch.ops.rotated_nms import (
        decode_candidates, greedy_suppress_fixpoint_kill, keep_fn_for,
        nms_candidates, nms_from_candidates, non_max_suppression,
        non_max_suppression_fused, select_candidates)
    from rotate_yolov3_tpu_torch.ops.skew_iou_cuda import (
        ALGOS, skew_iou_matrix, skew_iou_matrix_auto_nms,
        skew_iou_matrix_ref, skew_kill_matrix, skew_kill_matrix_ref)

    counted = (gather_rows, skew_kill_matrix, nms_greedy, decode_rows,
               skew_iou_matrix)

    def run(fn):
        """``fn()`` with every launch count from 0; (its result, counts)."""
        for f in counted:
            f.launches = 0
            if hasattr(f, "algo_launches"):
                f.algo_launches = dict.fromkeys(f.algo_launches, 0)
        out = fn()
        torch.cuda.synchronize()
        n = {"gather_rows": gather_rows.launches,
             "decode_rows": decode_rows.launches}
        for f, key in ((skew_kill_matrix, "skew_kill"),
                       (nms_greedy, "nms_greedy"),
                       (skew_iou_matrix, "skew_iou_matrix")):
            n.update({f"{key}:{a}": c for a, c in f.algo_launches.items()})
        return out, n

    def plain_kill(algo):
        """Kernel B's plain version with ``algo`` + the fixpoint."""
        return lambda b, c, v, iou_thr: greedy_suppress_fixpoint_kill(
            skew_kill_matrix_ref(b, c, iou_thr, algo), v)

    hooks = {  # name -> (hook, its plain version, the algo it launches)
        "skew_iou_matrix_auto_nms": (
            skew_iou_matrix_auto_nms,
            partial(skew_iou_matrix_ref, triangle=True), "green"),
        "skew_iou_matrix": (skew_iou_matrix, skew_iou_matrix_ref, "green"),
        "skew_iou_matrix(algo=green2, triangle)": (
            partial(skew_iou_matrix, algo="green2", triangle=True),
            partial(skew_iou_matrix_ref, algo="green2", triangle=True),
            "green2"),
        "skew_iou_matrix(algo=candidates)": (
            partial(skew_iou_matrix, algo="candidates"),
            partial(skew_iou_matrix_ref, algo="candidates"), "candidates"),
    }
    max_det, img = 512, NET_IMG or 608
    gen = torch.Generator().manual_seed(12)
    x = torch.randint(0, 256, (B_CHECK, img, img, 3), generator=gen,
                      dtype=torch.uint8)
    path_launches: dict = {}
    dets_bf16: dict = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        tf32 = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        if dtype == torch.float32:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        try:
            kw = dict(img_size=NET_IMG, conf_thres=CONF, nms_thres=THR,
                      max_det=max_det, compute_dtype=dtype, seed=0,
                      device=DEVICE)
            base = Detector(CFG, **kw)
            specs, fm = base.spec.yolo_specs, base.field_major_heads
            use_cls = specs[0].num_classes > 1

            def stages(det):
                heads = det.heads(x)
                scores, idx, valid = select_candidates(
                    heads, specs, CONF, max_det, det.approx_top_k, fm)
                boxes, cls = decode_candidates(heads, specs, idx, valid, fm)
                return heads, idx, (boxes, scores, cls, valid)

            def check(path, got, n, expect, staged, keep_fn, plain_fn):
                """The entry point's (detections, keep) ``got``, its launch
                counts ``n``: each kernel of ``expect`` launched; ``got``
                equals the stages through the kernels, and the plain
                versions (and in f32 the CPU path) on the same boxes."""
                missing = {key: n[key] for key in expect if n[key] < 1}
                if missing:
                    raise AssertionError(f"{path} {name}: a kernel of the "
                                         f"path did not launch: {missing}")
                if dtype == torch.bfloat16:
                    for key in expect:
                        path_launches[key] = path_launches.get(key, 0) \
                            + n[key]
                _check_detections(torch, got[0], got[1], max_det)
                boxes, scores, cls, valid = staged
                want = nms_from_candidates(boxes, scores, cls, valid, THR,
                                           use_cls, max_det, keep_fn=keep_fn)
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise AssertionError(f"{path} {name}: the entry point "
                                         f"differs from its stages")
                cls_arg = cls if use_cls else None
                plain = nms_from_candidates(boxes, scores, cls, valid, THR,
                                            use_cls, max_det,
                                            keep_fn=plain_fn)
                msg = "plain: " + _same_on_clean(
                    torch, f"{path} {name} vs plain", boxes, cls_arg, valid,
                    got[::-1], plain[::-1])
                if dtype == torch.float32:
                    cpu = [t.cpu() for t in staged]
                    out_c = nms_from_candidates(*cpu, THR, use_cls, max_det,
                                                keep_fn=keep_fn)
                    msg += "; CPU path: " + _same_on_clean(
                        torch, f"{path} f32 vs the CPU path", boxes,
                        cls_arg, valid, got[::-1], out_c[::-1])
                log(f"{path} {name} B={B_CHECK} max_det={max_det} @{img}: "
                    f"launches { {k: n[k] for k in expect} }; "
                    f"{int(got[1].sum())} kept; keep and detections equal "
                    f"to the stages through the kernels; {msg} [{card}]")

            # 1: the kill mask's pair algo
            for algo in ALGOS[1:]:
                det = Detector(CFG, iou_algo=algo, **kw)
                got, n = run(lambda: det(x))
                check(f"Detector(iou_algo={algo!r})", got, n,
                      ("gather_rows", f"skew_kill:{algo}"), stages(det)[2],
                      keep_fn_for(None, algo), plain_kill(algo))
                if dtype == torch.bfloat16:
                    dets_bf16[f"iou_algo={algo}"] = det
            # 2: the IoU-matrix hook (kernel E once per call)
            for hname, (hook, plain_hook, algo) in hooks.items():
                det = Detector(CFG, iou_matrix_fn=hook, **kw)
                got, n = run(lambda: det(x))
                if n[f"skew_iou_matrix:{algo}"] != 1 or \
                        any(n[f"skew_kill:{a}"] for a in ALGOS):
                    raise AssertionError(f"iou_matrix_fn={hname}: kernel E "
                                         f"not once per call, or the kill "
                                         f"mask ran: {n}")
                check(f"Detector(iou_matrix_fn={hname})", got, n,
                      ("gather_rows", f"skew_iou_matrix:{algo}"),
                      stages(det)[2], keep_fn_for(hook),
                      keep_fn_for(plain_hook))
                if dtype == torch.bfloat16:
                    dets_bf16[f"iou_matrix_fn={hname}"] = det
            # 3: the decoded-input entry
            pred = base.predict_raw(x)
            staged = nms_candidates(pred, CONF, max_det)
            for hname, hook, plain_hook, key in (
                    ("None", None, None, "skew_kill:green"),
                    ("skew_iou_matrix_auto_nms", skew_iou_matrix_auto_nms,
                     partial(skew_iou_matrix_ref, triangle=True),
                     "skew_iou_matrix:green")):
                got, n = run(lambda: non_max_suppression(
                    pred, CONF, THR, max_det, iou_matrix_fn=hook))
                check(f"non_max_suppression(predict_raw, iou_matrix_fn="
                      f"{hname})", got, n, (key,), staged,
                      keep_fn_for(hook),
                      plain_kill("green") if hook is None
                      else keep_fn_for(plain_hook))
                if dtype == torch.float32:
                    cpu = non_max_suppression(pred.cpu(), CONF, THR, max_det,
                                              iou_matrix_fn=hook)
                    log(f"non_max_suppression iou_matrix_fn={hname} f32, the "
                        f"whole CPU path from the card's predictions: "
                        + _same_on_clean(torch, "decoded-input f32 vs CPU",
                                         staged[0], staged[2], staged[3],
                                         got[::-1], cpu[::-1]) + f" [{card}]")
            # 4: kernel D, with each pair algo, two-stage and fused
            heads, idx, (boxes_a, scores, _, valid) = stages(base)
            meta = heads_meta(specs, [h.shape for h in heads])
            na, nc = specs[0].na, specs[0].num_classes
            aos = decode_rows(heads, idx, valid, meta, na, nc, fm)
            aos_r = decode_rows_ref(heads, idx, valid, meta, na, nc, fm)
            err = float((aos[..., :5] - aos_r[..., :5]).abs().max())
            if bool(((aos - aos_r).abs() > DECODE_ATOL
                     + DECODE_RTOL * aos_r.abs()).any()) or \
                    not torch.equal(aos[..., 5], aos_r[..., 5]):
                raise AssertionError(f"decode_kernel {name}: kernel D "
                                     f"differs from its plain version")
            boxes_d = aos[..., :5].contiguous()
            cls_d = aos[..., 5].to(torch.int32)
            a_err = float((boxes_d - boxes_a).abs().max())
            msg = (f"kernel D within {err:.3g} of its plain version and "
                   f"{a_err:.3g} of kernel A + decode")
            if dtype == torch.float32:
                cpu = decode_rows([h.cpu() for h in heads], idx.cpu(),
                                  valid.cpu(), meta, na, nc, fm)
                c_err = float((cpu[..., :5] - aos[..., :5].cpu()).abs()
                              .max())
                if c_err > 1e-3 or not torch.equal(cpu[..., 5],
                                                   aos[..., 5].cpu()):
                    raise AssertionError(f"decode_kernel f32: kernel D "
                                         f"{c_err} from the CPU path")
                msg += f", {c_err:.3g} of the CPU path"
            log(f"decode_kernel {name}: {msg} [{card}]")
            staged = (boxes_d, scores, cls_d, valid)
            for algo in ALGOS:
                for fused in (False, True):
                    got, n = run(lambda: non_max_suppression_fused(
                        heads, specs, conf_thres=CONF, nms_thres=THR,
                        max_det=max_det, approx_top_k=base.approx_top_k,
                        field_major=fm, iou_algo=algo, fused_greedy=fused,
                        decode_kernel=True))
                    if n["gather_rows"]:
                        raise AssertionError("decode_kernel: kernel A ran")
                    key = (f"nms_greedy:{kernel_algo(algo)}" if fused
                           else f"skew_kill:{algo}")
                    check(f"non_max_suppression_fused(decode_kernel=True, "
                          f"fused_greedy={fused}, iou_algo={algo!r})", got,
                          n, ("decode_rows", key), staged,
                          keep_fn_for(None, algo, fused, max_det),
                          plain_kill(kernel_algo(algo) if fused else algo))
            del base, det, heads, pred
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = tf32
    for key, n in path_launches.items():     # phases 4 and 7 set A, B, C
        results.setdefault(key, {}).setdefault("launches", n)
        if key.startswith("skew_iou_matrix:"):  # the batched hook launches
            results[key + ":serving"]["launches"] = n

    # per-call time at B = B_BENCH, bf16, beside the default path
    det = Detector(CFG, img_size=NET_IMG, conf_thres=CONF, nms_thres=THR,
                   max_det=max_det, compute_dtype=torch.bfloat16, seed=0,
                   device=DEVICE)
    specs, fm = det.spec.yolo_specs, det.field_major_heads
    xb = torch.randint(0, 256, (B_BENCH, img, img, 3), generator=gen,
                       dtype=torch.uint8).to(DEVICE)
    times = {"default": time_ms(torch, lambda: det(xb), reps=5, warmup=2)}
    for key, d in dets_bf16.items():
        times[key] = time_ms(torch, lambda: d(xb), reps=3, warmup=1)
    for hname, hook in (("None", None),
                        ("skew_iou_matrix_auto_nms",
                         skew_iou_matrix_auto_nms)):
        times[f"non_max_suppression(predict_raw, iou_matrix_fn={hname})"] = \
            time_ms(torch, lambda: non_max_suppression(
                det.predict_raw(xb), CONF, THR, max_det,
                iou_matrix_fn=hook), reps=3, warmup=1)
    log(f"options bf16 B={B_BENCH} max_det={max_det} @{img}, ms per call "
        f"(CUDA events, median): " + ", ".join(
            f"{k} {v:.3f}" for k, v in times.items()) + f" [{card}]")
    heads = det.heads(xb)
    tails = {}
    for tag, extra in (("default", {}),
                       ("decode_kernel", {"decode_kernel": True}),
                       ("decode_kernel+fused_greedy",
                        {"decode_kernel": True, "fused_greedy": True}),
                       ("fused_greedy", {"fused_greedy": True})):
        tails[tag] = time_ms(torch, lambda: non_max_suppression_fused(
            heads, specs, conf_thres=CONF, nms_thres=THR, max_det=max_det,
            approx_top_k=det.approx_top_k, field_major=fm, **extra),
            reps=5, warmup=1)
    log(f"NMS tail from the heads, bf16 B={B_BENCH} max_det={max_det}, ms "
        f"per call: " + ", ".join(f"{k} {v:.3f}" for k, v in tails.items())
        + f" [{card}]")
    del det, xb, heads, dets_bf16


def _draw_ships(n: int, size: int, seed: int):
    """``n`` seeded size² BGR uint8 images, each a noisy dark sea with 1-4
    bright rotated rectangles (elongated, ship-like; numpy only), and their
    (N, 6) label rows (cls, cx, cy, w, h normalized, θ radians)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    imgs = rng.integers(20, 60, (n, size, size, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    labels = []
    for img in imgs:
        rows = []
        for _ in range(int(rng.integers(1, 5))):
            w = rng.uniform(0.15, 0.4) * size
            h = rng.uniform(0.04, 0.12) * size
            cx, cy = rng.uniform(0.2, 0.8, 2) * size
            th = rng.uniform(-np.pi / 2, np.pi / 2)
            u = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
            v = -(xx - cx) * np.sin(th) + (yy - cy) * np.cos(th)
            img[(np.abs(u) <= w / 2) & (np.abs(v) <= h / 2)] = \
                rng.integers(150, 256, 3)
            rows.append((0, cx / size, cy / size, w / size, h / size, th))
        labels.append(np.asarray(rows, np.float32))
    return imgs, labels


def _train_batch(torch, imgs, labels, max_gt: int = 64):
    """(imgs, targets, valid) on DEVICE, padded as the loader pads."""
    import numpy as np

    tgts = np.zeros((len(imgs), max_gt, 6), np.float32)
    valid = np.zeros((len(imgs), max_gt), bool)
    for i, rows in enumerate(labels):
        tgts[i, :len(rows)] = rows
        valid[i, :len(rows)] = True
    return tuple(torch.from_numpy(a).to(DEVICE)
                 for a in (np.ascontiguousarray(imgs[..., ::-1]), tgts,
                           valid))


def _write_dataset(root: str, imgs, labels) -> str:
    """The images as the loader's disk cache finds them: an empty file at
    each listed image path (only its mtime is read) and, newer than it, its
    ``<img>.cache.npy`` sidecar, so no image is decoded; the label files,
    the list and a .data file. Returns the .data path."""
    import numpy as np

    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "labels"))
    paths = []
    for i, (img, rows) in enumerate(zip(imgs, labels)):
        path = os.path.join(root, "images", f"im{i:04d}.jpg")
        open(path, "wb").close()
        os.utime(path, (time.time() - 60,) * 2)
        np.save(path + ".cache.npy", img)
        with open(os.path.join(root, "labels", f"im{i:04d}.txt"), "w") as f:
            f.write("".join(f"{int(r[0])} {r[1]:.6f} {r[2]:.6f} {r[3]:.6f} "
                            f"{r[4]:.6f} {r[5]:.6f}\n" for r in rows))
        paths.append(path)
    list_path = os.path.join(root, "train.txt")
    with open(list_path, "w") as f:
        f.write("\n".join(paths) + "\n")
    data = os.path.join(root, "ships.data")
    with open(data, "w") as f:
        f.write(f"classes=1\ntrain={list_path}\nvalid={list_path}\n"
                f"names={os.path.join(ROOT, 'datacfg', 'hrsc.names')}\n")
    return data


def _staged_step(torch, ts, spec, hyp, imgs, tgts, valid):
    """One train step as ``make_train_step`` runs it, with CUDA events
    between its stages: ms of forward, loss (assignment included),
    backward, optimizer (grad norm, lr, SGD update)."""
    from rotate_yolov3_tpu_torch.train.loss import compute_loss

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    net, opt = ts.net, ts.optimizer
    ev[0].record()
    heads = [h.float() for h in net(imgs.to(torch.float32) / 255.0)]
    ev[1].record()
    total, _ = compute_loss(heads, tgts, valid, spec.yolo_specs,
                            int(imgs.shape[1]), hyp)
    ev[2].record()
    opt.zero_grad(set_to_none=True)
    total.backward()
    ev[3].record()
    torch.nn.utils.get_total_norm(
        [t.grad for t in net.parameters() if t.grad is not None])
    for group in opt.param_groups:
        group["lr"] = ts.lr_schedule(ts.step)
    opt.step()
    ts.step += 1
    ev[4].record()
    ev[4].synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]


def _f64_grad_norm(torch, spec, params, state, batch, hyp) -> float:
    """The grad norm of one train step's loss computed in float64 on the
    CPU (network, loss and backward): the reference the f32 grad norms of
    the card and the CPU are measured against."""
    from rotate_yolov3_tpu_torch.models.darknet import Darknet
    from rotate_yolov3_tpu_torch.train.loss import compute_loss

    f64 = torch.float64
    net = Darknet(spec, params, state, compute_dtype=f64).to(f64).train()
    imgs, tgts, valid = (t.cpu() for t in batch)
    total, _ = compute_loss(net(imgs.to(f64) / 255.0), tgts.to(f64), valid,
                            spec.yolo_specs, int(imgs.shape[1]), hyp)
    total.backward()
    return float(torch.nn.utils.get_total_norm(
        [t.grad for t in net.parameters()]))


def phase_train(torch, card) -> None:
    """Phase 13: the training path and its eval (see the module docstring)."""
    import tempfile

    import numpy as np

    from rotate_yolov3_tpu_torch import _build
    from rotate_yolov3_tpu_torch import detector as detector_mod
    from rotate_yolov3_tpu_torch import test as test_cli
    from rotate_yolov3_tpu_torch import train as train_cli
    from rotate_yolov3_tpu_torch.config.hyp import Hyp
    from rotate_yolov3_tpu_torch.config.parse import parse_model_cfg
    from rotate_yolov3_tpu_torch.eval import metrics
    from rotate_yolov3_tpu_torch.models.darknet import (build_network,
                                                        init_params)
    from rotate_yolov3_tpu_torch.native import polyiou
    from rotate_yolov3_tpu_torch.ops.gather_rows import gather_rows
    from rotate_yolov3_tpu_torch.ops.skew_iou_cuda import skew_kill_matrix
    from rotate_yolov3_tpu_torch.train.schedule import darknet_schedule
    from rotate_yolov3_tpu_torch.train.trainer import (init_train_state,
                                                       make_train_step)

    hyp = Hyp()
    fixed_lr = darknet_schedule(1e-3, burn_in=1)     # 1e-3 at every step
    t0 = time.perf_counter()

    # (a) one f32 step (TF32 off) from the same weights and batch on the
    # card and on the CPU
    b_chk, s_chk = TRAIN_CHECK
    spec = build_network(parse_model_cfg(CFG), img_size=s_chk)
    params, state = init_params(spec, seed=0)
    imgs, labels = _draw_ships(b_chk, s_chk, seed=11)
    batch = _train_batch(torch, imgs, labels)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dev in (DEVICE, "cpu"):
            ts = init_train_state(spec, params, state, fixed_lr,
                                  device=dev)
            m = make_train_step(spec, hyp)(
                ts, *(t.to(dev) for t in batch))
            out[dev] = ({k: float(v) for k, v in m.items()},
                        [{k: {n: t.cpu() for n, t in d.items()}
                          for k, d in x.items()}
                         for x in ts.net.params_state()])
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    (mc, (pc, sc)), (mh, (ph, sh)) = out[DEVICE], out["cpu"]
    for k, want in mh.items():
        tol = GRAD_NORM_RTOL if k == "grad_norm" else TRAIN_LOSS_RTOL
        if not abs(mc[k] - want) <= tol * abs(want) + 1e-7:
            raise AssertionError(f"train step: {k} on the card {mc[k]} vs "
                                 f"the CPU {want} (rtol {tol})")
    gn64 = _f64_grad_norm(torch, spec, params, state, batch, hyp)
    d_par = max(float((pc[k][n] - ph[k][n]).abs().max())
                for k in pc for n in pc[k])
    d_bn = max(float((sc[k][n] - sh[k][n]).abs().max())
               for k in sc for n in sc[k])
    log(f"train step f32 (TF32 off) B={b_chk} @{s_chk}, card vs CPU: "
        + ", ".join(f"{k} {mc[k]:.6f}/{mh[k]:.6f}" for k in sorted(mh))
        + f"; updated params max |diff| {d_par:.3g}, BN state {d_bn:.3g} "
        f"(loss terms rtol {TRAIN_LOSS_RTOL}, grad_norm {GRAD_NORM_RTOL}); "
        f"grad_norm in float64 on the CPU {gn64:.4f}: card f32 "
        f"{mc['grad_norm'] / gn64 - 1:+.3e}, CPU f32 "
        f"{mh['grad_norm'] / gn64 - 1:+.3e} from it [{card}]")

    # (b) the step at full size, f32 (PyTorch's default: cuDNN may use
    # TF32) and bf16
    spec = build_network(parse_model_cfg(CFG), img_size=TRAIN_IMG)
    params, state = init_params(spec, seed=0)
    imgs, labels = _draw_ships(TRAIN_N_IMAGES, TRAIN_IMG, seed=12)
    batch = _train_batch(torch, imgs[:TRAIN_B], labels[:TRAIN_B])
    n_gt = int(batch[2].sum())
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        ts = init_train_state(spec, params, state, fixed_lr,
                              compute_dtype=dtype, device=DEVICE)
        step = make_train_step(spec, hyp)
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(torch, lambda: step(ts, *batch), reps=10, warmup=3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        busy = device_ms(torch, lambda: step(ts, *batch), reps=3)
        stages = np.median([_staged_step(torch, ts, spec, hyp, *batch)
                            for _ in range(10)], axis=0)
        log(f"train step {name} B={TRAIN_B} @{TRAIN_IMG} ({n_gt} GT): "
            f"{ms:.3f} ms/step (CUDA-event median of 10 after 3 warm-ups), "
            f"{TRAIN_B / ms * 1e3:.2f} img/s; stages (median of 10, ms): "
            f"forward {stages[0]:.3f}, loss {stages[1]:.3f}, backward "
            f"{stages[2]:.3f}, optimizer {stages[3]:.3f}; device busy "
            f"{busy:.3f} ms = {100 * busy / ms:.1f}% of the step; peak "
            f"{peak:.2f} GiB [{card}]")
        log(f"top kernels of one {name} step (device time): "
            + top_kernels(torch, lambda: step(ts, *batch)) + f" [{card}]")
        del ts, step

    # (c) a short fit: 20 steps on one repeated batch, fixed lr 1e-3
    ts = init_train_state(spec, params, state, fixed_lr, device=DEVICE)
    step = make_train_step(spec, hyp)
    totals = torch.stack([step(ts, *batch)["total"]
                          for _ in range(TRAIN_FIT_STEPS)]).tolist()
    if not totals[-1] < totals[0]:
        raise AssertionError(f"fit: the total loss did not fall over "
                             f"{TRAIN_FIT_STEPS} steps: {totals}")
    log(f"fit f32 B={TRAIN_B} @{TRAIN_IMG}, {TRAIN_FIT_STEPS} steps on one "
        f"batch, lr 1e-3: total {totals[0]:.4f} -> {totals[-1]:.4f} (min "
        f"{min(totals):.4f}) [{card}]")
    del ts, step, batch

    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        data = _write_dataset(os.path.join(tmp, "ships"), imgs, labels)
        out_dir = os.path.join(tmp, "w")

        # (d) the training CLI in-process: 1 epoch of 2 steps with its
        # per-epoch eval, the eval Detector recorded
        made = []

        class RecordingDetector(detector_mod.Detector):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

        args = ["--cfg", CFG, "--data", data, "--epochs", "1",
                "--batch-size", str(TRAIN_B), "--img-size", str(TRAIN_IMG),
                "--no-augment", "--cache-images", "disk",
                "--no-tensorboard", "--out-dir", out_dir, "--device", DEVICE]
        gather_rows.launches = 0
        skew_kill_matrix.launches = 0
        detector_cls = detector_mod.Detector
        detector_mod.Detector = RecordingDetector
        try:
            t1 = time.perf_counter()
            best = train_cli.train(train_cli.make_parser().parse_args(args))
            torch.cuda.synchronize()
            t_cli = time.perf_counter() - t1
        finally:
            detector_mod.Detector = detector_cls
        launches = {"gather_rows": gather_rows.launches,
                    "skew_kill": skew_kill_matrix.launches}
        if min(launches.values()) < 1 or len(made) != 1:
            raise AssertionError(f"train CLI: the eval's kernels did not "
                                 f"launch ({launches}) or no eval Detector "
                                 f"({len(made)})")
        files = ("results.txt", "last.pt", "last.weights", "best.pt",
                 "best.weights", os.path.join("ckpt", "1.pt"))
        missing = [f for f in files
                   if not os.path.exists(os.path.join(out_dir, f))]
        if missing:
            raise AssertionError(f"train CLI did not write {missing}")
        with open(os.path.join(out_dir, "results.txt")) as f:
            row = f.read().split()
        x = torch.from_numpy(np.ascontiguousarray(imgs[:TRAIN_B, ..., ::-1]))
        d_run, m_run = made[0](x)
        for ckpt in ("last.weights", "last.pt"):
            fresh = detector_cls(
                CFG, weights=os.path.join(out_dir, ckpt),
                img_size=TRAIN_IMG, conf_thres=0.1, device=DEVICE)
            d, m = fresh(x)
            if not (torch.equal(m, m_run) and torch.equal(d, d_run)):
                w = max(float((a - b).abs().max()) for a, b in zip(
                    fresh.net.parameters(), made[0].net.parameters()))
                h = max(float((a - b).abs().max()) for a, b in zip(
                    fresh.heads(x), made[0].heads(x)))
                again = made[0](x)
                raise AssertionError(
                    f"train CLI: a Detector loaded from {ckpt} differs from "
                    f"the in-run eval Detector: fused weights max |diff| "
                    f"{w:.3g}, heads {h:.3g}, masks differ at "
                    f"{int((m != m_run).sum())}, dets max |diff| "
                    f"{float((d - d_run).abs().max()):.3g}; the in-run "
                    f"Detector equal to itself: "
                    f"{torch.equal(again[0], d_run)}")
        log(f"train CLI f32 B={TRAIN_B} @{TRAIN_IMG}, 1 epoch of "
            f"{TRAIN_N_IMAGES // TRAIN_B} steps + eval of {TRAIN_N_IMAGES} "
            f"images: {t_cli:.1f} s; results.txt {' '.join(row)}; best mAP "
            f"{best:.4f}; eval launches {launches}; Detectors from "
            f"last.weights and last.pt equal to the in-run eval Detector "
            f"({int(m_run.sum())} kept) [{card}]")

        # (e) the eval CLI on the same images with last.weights; the host
        # IoU must come from the native library
        polyiou.get_lib()
        calls = [0]
        host_iou = metrics._cross_iou_host

        def counting(a, b):
            calls[0] += 1
            return host_iou(a, b)

        fallbacks = host_iou.fallbacks
        metrics._cross_iou_host = counting
        try:
            mp, mr, mAP = test_cli.test(test_cli.make_parser().parse_args(
                ["--cfg", CFG, "--data", data, "--weights",
                 os.path.join(out_dir, "last.weights"), "--img-size",
                 str(TRAIN_IMG), "--conf-thres", "0.01", "--cache-images",
                 "disk", "--device", DEVICE]))
        finally:
            metrics._cross_iou_host = host_iou
        if calls[0] < 1 or host_iou.fallbacks != fallbacks:
            raise AssertionError(f"test CLI: host IoU calls {calls[0]}, "
                                 f"fallbacks {host_iou.fallbacks - fallbacks}")
        log(f"test CLI @{TRAIN_IMG} on {TRAIN_N_IMAGES} images (conf 0.01): "
            f"P {mp:.4f} R {mr:.4f} mAP {mAP:.4f}; {calls[0]} host IoU "
            f"matrices, all native [{card}]")
    log(f"phase train: {time.perf_counter() - t0:.1f} s")


def _aug_batch(torch, n: int, size: int, seed: int, dev):
    """(imgs f32 in [0, 1], targets, valid) of ``n`` drawn ship images on
    ``dev``."""
    imgs, labels = _draw_ships(n, size, seed)
    u8, tgts, valid = _train_batch(torch, imgs, labels)
    return (u8.to(dev).float() / 255.0, tgts.to(dev), valid.to(dev))


def _no_tf32(torch):
    """Turn TF32 off (cuDNN and matmul); returns the flags to restore."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return old


def _metrics_close(got: dict, want: dict, what: str) -> None:
    for k, w in want.items():
        tol = GRAD_NORM_RTOL if k == "grad_norm" else TRAIN_LOSS_RTOL
        if not abs(got[k] - w) <= tol * abs(w) + 1e-7:
            raise AssertionError(f"{what}: {k} {got[k]} vs one process {w} "
                                 f"(rtol {tol})")


def _one_process_step(torch, spec, params, state, batch, dev) -> dict:
    """Metrics of one f32 plain train step at ``DP_LR`` (as
    ``dp_train_steps`` runs it) on ``dev``."""
    from rotate_yolov3_tpu_torch.config.hyp import Hyp
    from rotate_yolov3_tpu_torch.parallel.dryrun import DP_LR
    from rotate_yolov3_tpu_torch.train.schedule import darknet_schedule
    from rotate_yolov3_tpu_torch.train.trainer import (init_train_state,
                                                       make_train_step)

    ts = init_train_state(spec, params, state,
                          darknet_schedule(DP_LR, burn_in=1), momentum=0.9,
                          weight_decay=5e-4, device=dev)
    m = make_train_step(spec, Hyp())(ts, *(t.to(dev) for t in batch))
    return {k: float(v) for k, v in m.items()}


def phase_parallel(torch, card) -> None:
    """Phase 14: data parallelism and on-device augmentation (see the module
    docstring)."""
    import tempfile

    import numpy as np

    from rotate_yolov3_tpu_torch import _build
    from rotate_yolov3_tpu_torch import train as train_cli
    from rotate_yolov3_tpu_torch.config.hyp import Hyp
    from rotate_yolov3_tpu_torch.config.parse import parse_model_cfg
    from rotate_yolov3_tpu_torch.data import augment_device as aug
    from rotate_yolov3_tpu_torch.data.dota.device_tiles import \
        DeviceTilePipeline
    from rotate_yolov3_tpu_torch.detector import Detector
    from rotate_yolov3_tpu_torch.models.darknet import (build_network,
                                                        init_params)
    from rotate_yolov3_tpu_torch.ops.gather_rows import gather_rows
    from rotate_yolov3_tpu_torch.ops.nms_greedy import nms_greedy
    from rotate_yolov3_tpu_torch.ops.skew_iou_cuda import skew_kill_matrix
    from rotate_yolov3_tpu_torch.parallel.dryrun import (dp_train_steps,
                                                         dryrun_multichip)
    from rotate_yolov3_tpu_torch.parallel.mesh import make_mesh
    from rotate_yolov3_tpu_torch.train.schedule import darknet_schedule
    from rotate_yolov3_tpu_torch.train.trainer import (init_train_state,
                                                       make_train_step)

    t0 = time.perf_counter()
    dev = torch.device(DEVICE, 0)
    hyp = Hyp()
    n_cards = torch.cuda.device_count()

    # (a) the augmentation on the card against the CPU, same draws
    x, tgts, valid = _aug_batch(torch, TRAIN_B, TRAIN_IMG, 21, dev)
    draws = aug.draw_augment(torch.Generator().manual_seed(3), TRAIN_B,
                             TRAIN_IMG, Hyp(degrees=60.0))
    card_draws = aug.AugDraws(**{k: None if v is None else v.to(dev)
                                 for k, v in vars(draws).items()})
    old = _no_tf32(torch)
    try:
        got = aug.apply_augment(card_draws, x, tgts, valid)
        want = aug.apply_augment(draws, x.cpu(), tgts.cpu(), valid.cpu())
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
    err = [float((g.cpu() - w).abs().max()) for g, w in zip(got[:2],
                                                            want[:2])]
    if max(err) > AUG_TOL or not torch.equal(got[2].cpu(), want[2]):
        raise AssertionError(f"augment_batch on the card vs the CPU: images "
                             f"{err[0]:.3g}, labels {err[1]:.3g} (tol "
                             f"{AUG_TOL}), valid equal "
                             f"{torch.equal(got[2].cpu(), want[2])}")
    gen = torch.Generator(device=dev).manual_seed(4)
    ms_apply = time_ms(torch, lambda: aug.apply_augment(card_draws, x, tgts,
                                                        valid), reps=10)
    ms_full = time_ms(torch, lambda: aug.augment_batch(gen, x, tgts, valid,
                                                       hyp), reps=10)
    log(f"augment_batch B={TRAIN_B} @{TRAIN_IMG} f32 (mosaic, rotation, "
        f"scale/translate, flip, HSV): card vs CPU on the same draws max "
        f"|diff| images {err[0]:.3g}, labels {err[1]:.3g}, valid equal; "
        f"{ms_apply:.3f} ms per batch applied, {ms_full:.3f} ms drawn and "
        f"applied (CUDA-event median of 10) [{card}]")

    # (b) the train step with on-device augmentation beside the plain one
    spec = build_network(parse_model_cfg(CFG), img_size=TRAIN_IMG)
    params, state = init_params(spec, seed=0)
    imgs, labels = _draw_ships(TRAIN_N_IMAGES, TRAIN_IMG, seed=12)
    batch = _train_batch(torch, imgs[:TRAIN_B], labels[:TRAIN_B])
    fixed_lr = darknet_schedule(1e-3, burn_in=1)
    for dtype in (torch.float32, torch.bfloat16):
        ms = {}
        for device_aug in (False, True):
            ts = init_train_state(spec, params, state, fixed_lr,
                                  compute_dtype=dtype, device=DEVICE)
            step = make_train_step(spec, hyp, device_aug=device_aug)
            total = float(step(ts, *batch)["total"])
            if not np.isfinite(total):
                raise AssertionError(f"device_aug={device_aug} step: loss "
                                     f"{total}")
            ms[device_aug] = time_ms(torch, lambda: step(ts, *batch),
                                     reps=10, warmup=2)
            del ts, step
        log(f"train step {str(dtype)[6:]} B={TRAIN_B} @{TRAIN_IMG}: "
            f"{ms[True]:.3f} ms/step with --device-aug, {ms[False]:.3f} "
            f"without (CUDA-event median of 10) [{card}]")
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        data = _write_dataset(os.path.join(tmp, "ships"), imgs, labels)
        out_dir = os.path.join(tmp, "w")
        t1 = time.perf_counter()
        train_cli.train(train_cli.make_parser().parse_args(
            ["--cfg", CFG, "--data", data, "--epochs", "1", "--batch-size",
             str(TRAIN_B), "--img-size", str(TRAIN_IMG), "--device-aug",
             "--cache-images", "disk", "--no-eval", "--no-tensorboard",
             "--out-dir", out_dir, "--device", DEVICE]))
        t_cli = time.perf_counter() - t1
        with open(os.path.join(out_dir, "results.txt")) as f:
            row = [float(v) for v in f.read().split()]
        if not (np.isfinite(row).all() and row[5] > 0 and os.path.exists(
                os.path.join(out_dir, "last.weights"))):
            raise AssertionError(f"train CLI --device-aug: {row}")
    log(f"train CLI --device-aug f32 B={TRAIN_B} @{TRAIN_IMG}, 1 epoch of "
        f"{TRAIN_N_IMAGES // TRAIN_B} steps: {t_cli:.1f} s; results.txt "
        f"{' '.join(f'{v:g}' for v in row)} [{card}]")

    # (c) two gloo ranks on the one card against one process, f32, no TF32
    dp_imgs, dp_labels = _draw_ships(TRAIN_B // 2, TRAIN_IMG, seed=13)
    equal_halves = _train_batch(torch, np.concatenate([dp_imgs, dp_imgs]),
                                dp_labels + dp_labels)
    distinct = _train_batch(torch, imgs[TRAIN_B:2 * TRAIN_B],
                            labels[TRAIN_B:2 * TRAIN_B])
    host = [tuple(t.cpu() for t in b) for b in (equal_halves, distinct)]
    old = _no_tf32(torch)
    try:
        want = _one_process_step(torch, spec, params, state, host[0], dev)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
    t1 = time.perf_counter()
    ranks = dp_train_steps([dev, dev], CFG, TRAIN_IMG, params, state, host,
                           backend="gloo", timeout=600.0)
    t_dp = time.perf_counter() - t1
    for r, out in enumerate(ranks):
        _metrics_close(out["metrics"][0], want, f"gloo rank {r} on one card")
    unequal = [f"{tree}.{k}.{n}" for tree in ("params", "state")
               for k, d in ranks[0][tree].items() for n, t in d.items()
               if not torch.equal(t, ranks[1][tree][k][n])]
    if unequal or ranks[0]["step"] != 2:
        raise AssertionError(f"gloo ranks after 2 steps: step "
                             f"{ranks[0]['step']}, differ in {unequal[:5]}")
    log(f"data parallel, 2 gloo ranks on one card (CUDA tensors through "
        f"gloo), f32 TF32 off, B={TRAIN_B} global @{TRAIN_IMG}: step 1 vs "
        f"one process " + ", ".join(
            f"{k} {ranks[0]['metrics'][0][k]:.6f}/{want[k]:.6f}"
            for k in sorted(want))
        + f"; after 2 steps the ranks' params and BN state are bit-equal; "
        f"{t_dp:.1f} s with spawning [{card}]")

    # (d) NCCL: one rank (and, with more cards, every card up to 4)
    b_chk, s_chk = TRAIN_CHECK
    small = build_network(parse_model_cfg(CFG), img_size=s_chk)
    sp, ss = init_params(small, seed=0)
    ship_imgs, ship_labels = _draw_ships(b_chk, s_chk, seed=14)
    for n in sorted({1, min(n_cards, 4)}):
        reps = max(1, n)
        batch_n = tuple(t.cpu() for t in _train_batch(
            torch, np.concatenate([ship_imgs] * reps), ship_labels * reps))
        old = _no_tf32(torch)
        try:
            want = _one_process_step(torch, small, sp, ss, batch_n, dev)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = old
        ranks = dp_train_steps(make_mesh(n, DEVICE), CFG, s_chk, sp, ss,
                               [batch_n], backend="nccl", timeout=300.0)
        for r, out in enumerate(ranks):
            _metrics_close(out["metrics"][0], want, f"NCCL rank {r} of {n}")
        log(f"data parallel, {n} NCCL rank(s) (of {n_cards} card(s)), f32 "
            f"TF32 off, B={b_chk * reps} @{s_chk}: step vs one process "
            + ", ".join(f"{k} {ranks[0]['metrics'][0][k]:.6f}/{want[k]:.6f}"
                        for k in sorted(want)) + f" [{card}]")

    # (e) Detector and DOTA replicas, two on the one card
    two = [dev, dev]     # what make_mesh(2, "cuda") returns on two cards
    gen = torch.Generator(device=dev).manual_seed(5)
    xb = torch.randint(0, 256, (B_BENCH, 608, 608, 3), generator=gen,
                       device=dev, dtype=torch.uint8)
    one = Detector(CFG, conf_thres=CONF, nms_thres=THR, max_det=128,
                   compute_dtype=torch.bfloat16, seed=0, device=DEVICE)
    rep = Detector(CFG, conf_thres=CONF, nms_thres=THR, max_det=128,
                   compute_dtype=torch.bfloat16, seed=0, device=DEVICE)
    rep.mesh, rep.device = two, dev
    rep.refresh_params()
    half = B_BENCH // 2
    d1, m1 = (torch.cat(t) for t in zip(one(xb[:half]), one(xb[half:])))
    gather_rows.launches = 0
    skew_kill_matrix.launches = 0
    d2, m2 = rep(xb)
    launches = {"gather_rows": gather_rows.launches,
                "skew_kill": skew_kill_matrix.launches}
    if launches != {"gather_rows": 2, "skew_kill": 2}:
        raise AssertionError(f"Detector replicas: launches {launches}, want "
                             f"one of kernels A and B per replica")
    if not torch.equal(m1, m2) or not torch.equal(d1, d2):
        raise AssertionError(f"Detector replicas vs one replica on the same "
                             f"slices: masks differ at "
                             f"{int((m1 != m2).sum())}, dets max |diff| "
                             f"{float((d1 - d2).abs().max()):.3g}")
    d128, m128 = one(xb)
    ms_one = time_ms(torch, lambda: one(xb), reps=5, warmup=1)
    ms_rep = time_ms(torch, lambda: rep(xb), reps=5, warmup=1)
    log(f"Detector bf16 B={B_BENCH} @608, two replicas sharing one card "
        f"(not scaling): masks and dets equal to one replica on the same "
        f"slices ({int(m2.sum())} kept), kernel launches per replica "
        f"{ {k: v // 2 for k, v in launches.items()} }; against one B="
        f"{B_BENCH} call: masks differ at {int((m128 != m2).sum())}; "
        f"{B_BENCH / ms_one * 1e3:.2f} img/s one replica, "
        f"{B_BENCH / ms_rep * 1e3:.2f} img/s two replicas [{card}]")
    del one, rep, xb

    scene = _dota_scene()
    old = _no_tf32(torch)
    try:
        pipes = []
        for mesh in ([dev], two):
            det = Detector(DOTA_CFG, img_size=NET_IMG, conf_thres=CONF,
                           max_det=512, approx_top_k=False, seed=0,
                           device=DEVICE)
            det.mesh, det.device = mesh, dev
            det.refresh_params()
            pipes.append(DeviceTilePipeline(det, subsize=1024, gap=200,
                                            merge_nms_thres=MERGE_THR,
                                            max_merged=1024))
        d1, m1 = pipes[0](scene)
        gather_rows.launches = 0
        skew_kill_matrix.launches = 0
        nms_greedy.launches = 0
        d2, m2 = pipes[1](scene)
        launches = {"gather_rows": gather_rows.launches,
                    "skew_kill": skew_kill_matrix.launches,
                    "nms_greedy": nms_greedy.launches}
        ms = [time_ms(torch, lambda p=p: p(scene), reps=3, warmup=1)
              for p in pipes]
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
    err = float(np.abs(d1 - d2).max())
    if launches != {"gather_rows": 2, "skew_kill": 2, "nms_greedy": 1} or \
            not np.array_equal(m1, m2) or err > 1e-5:
        raise AssertionError(f"sharded DOTA scene: launches {launches}, "
                             f"masks differ at {int((m1 != m2).sum())}, "
                             f"rows max |diff| {err:.3g}")
    log(f"DOTA scene f32 (TF32 off), {pipes[0].num_tiles(SCENE, SCENE)} "
        f"tiles over two replicas sharing one card (padded to "
        f"{-(-pipes[0].num_tiles(SCENE, SCENE) // 2) * 2}): merged masks "
        f"equal ({int(m2.sum())} kept), rows max |diff| {err:.3g}; launches "
        f"{launches}; {ms[0]:.3f} ms one replica, {ms[1]:.3f} ms two "
        f"[{card}]")
    del pipes, det

    # (f) refusals past the card count
    if n_cards == 1:
        for what, fn in (
                ("Detector(devices=2)", lambda: Detector(
                    CFG, devices=2, device=DEVICE)),
                ("train --devices 2", lambda: train_cli.train(
                    train_cli.make_parser().parse_args(
                        ["--cfg", CFG, "--data", "unused.data",
                         "--devices", "2", "--device", DEVICE])))):
            try:
                fn()
            except ValueError as e:
                log(f"{what} on one card raises: {e}")
            else:
                raise AssertionError(f"{what} did not raise on one card")
    else:
        log(f"{n_cards} cards: the one-card refusals do not apply")

    # (g) the dry run on one card
    loss = dryrun_multichip(1, DEVICE)
    log(f"dryrun_multichip(1, cuda): loss {loss:.4f} [{card}]")
    log(f"phase parallel: {time.perf_counter() - t0:.1f} s")


def _mixed_na_cfg(root: str) -> str:
    """A copy of the HRSC cfg in ``root`` whose first [yolo] has the two
    anchors of ``MIXED_MASK`` (its head conv 84 filters): heads of na 12,
    18 and 18, which take the per-head decode."""
    with open(CFG) as f:
        lines = f.read().split("\n")
    y = lines.index("[yolo]")
    f_line = max(i for i in range(y) if lines[i].startswith("filters="))
    m_line = next(i for i in range(y, len(lines))
                  if lines[i].startswith("mask"))
    na = len(MIXED_MASK) * 6
    lines[f_line] = f"filters={na * 7}"
    lines[m_line] = "mask = " + ",".join(map(str, MIXED_MASK))
    path = os.path.join(root, "yolov3-rotate-hrsc-mixed-na.cfg")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


def _counted(torch, fn):
    """``fn()`` with the launch counts of kernels A, B and D set to 0 just
    before it; (its result, the counts read just after)."""
    from rotate_yolov3_tpu_torch.ops.decode_rows import decode_rows
    from rotate_yolov3_tpu_torch.ops.gather_rows import gather_rows
    from rotate_yolov3_tpu_torch.ops.skew_iou_cuda import skew_kill_matrix

    wrappers = {"gather_rows": gather_rows, "skew_kill": skew_kill_matrix,
                "decode_rows": decode_rows}
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: w.launches for k, w in wrappers.items()}


def _staged_vs_plain(torch, what, det, x, out):
    """Raise unless the entry point's (detections, keep) ``out`` equal its
    stages run one by one from ``det.heads(x)`` and the keep recomputed
    from the same boxes through the plain kill mask (``KILL_CHUNK`` images
    a call). Returns the heads and the stages, as ``_slice_vs_cpu`` takes
    them."""
    from rotate_yolov3_tpu_torch.ops.nms_greedy import nms_greedy_ref
    from rotate_yolov3_tpu_torch.ops.rotated_nms import (decode_candidates,
                                                         nms_from_candidates,
                                                         select_candidates)

    specs, fm = det.spec.yolo_specs, det.field_major_heads
    use_cls = specs[0].num_classes > 1
    heads = det.heads(x)
    scores, idx, valid = select_candidates(heads, specs, CONF, det.max_det,
                                           det.approx_top_k, fm)
    boxes, cls = decode_candidates(heads, specs, idx, valid, fm)
    out_k, keep_k = nms_from_candidates(boxes, scores, cls, valid, THR,
                                        use_cls, det.max_det)

    def plain_keep(b, c, v, iou_thr):
        return in_chunks(lambda bb, cc, vv: nms_greedy_ref(
            bb, cc, vv, iou_thr), b, c, v, chunk=KILL_CHUNK)

    out_r, keep_r = nms_from_candidates(boxes, scores, cls, valid, THR,
                                        use_cls, det.max_det,
                                        keep_fn=plain_keep)
    if not (torch.equal(keep_k, keep_r) and torch.equal(out_k, out_r)):
        raise AssertionError(f"{what}: kernel keep differs from the plain "
                             f"recompute")
    dets, mask = out
    if not (torch.equal(mask, keep_k) and torch.equal(dets, out_k)):
        raise AssertionError(f"{what}: Detector output differs from the "
                             f"staged recompute")
    return heads, (scores, idx, valid, boxes, cls, keep_k, out_k)


def _stem_times(torch, card, canon, packed, x) -> None:
    """The stem alone, B = len(x), bf16, channels_last, CUDA events: conv0
    + conv1 against conv0' + conv1' as the packed Detector runs them
    (conv0' with the symmetric pad 1, conv1' with pad 1 and its last row
    and column dropped; each convolution finished by the conv epilogue)
    and with conv1' after an explicit ``F.pad``; each made dense
    (channels_last), as layer 2's convolution would."""
    import torch.nn.functional as F

    from rotate_yolov3_tpu_torch.models.darknet import (_LEAKY_SLOPE,
                                                        layer_key)
    from rotate_yolov3_tpu_torch.ops.conv_epilogue import conv_epilogue

    xin = x.to(torch.bfloat16).permute(0, 3, 1, 2)

    def dense(y):
        return y.contiguous(memory_format=torch.channels_last)

    def stem(det):
        l0, l1 = det.net.spec.layers[:2]
        return lambda: dense(det.net._conv(l1, det.net._conv(l0, xin)))

    def packed_pad():
        l0, l1 = packed.net.spec.layers[:2]
        (top, bottom), (left, right) = l1.pad
        y = F.pad(packed.net._conv(l0, xin), (left, right, top, bottom))
        key = layer_key(1)
        return dense(conv_epilogue(F.conv2d(y, packed.net.kernels[key]),
                                   packed.net.biases[key], l1.activation,
                                   slope=_LEAKY_SLOPE))

    runs = {"canonical": stem(canon), "packed": stem(packed),
            "packed, conv1' after F.pad": packed_pad}
    with torch.inference_mode():
        outs = {k: f() for k, f in runs.items()}
        same = torch.equal(outs["packed"], outs["packed, conv1' after F.pad"])
        err = _max_err(outs["packed"], outs["canonical"])
        scale = float(outs["canonical"].float().abs().max())
        del outs
        us = {}
        for name in ("canonical", "packed", "packed, conv1' after F.pad",
                     "packed, conv1' after F.pad", "packed", "canonical"):
            us.setdefault(name, []).append(
                time_ms(torch, runs[name], reps=10, warmup=2) * 1e3 / len(x))
    log(f"stem alone bf16 B={len(x)} @{x.shape[1]}, layer-1 output dense (µs/img, "
        f"in turns): " + "; ".join(f"{k} " + " / ".join(f"{v:.3f}" for v in
                                                         vs)
                                   for k, vs in us.items())
        + f"; packed vs canonical max diff {err:.3g} (|out| <= "
        f"{scale:.3g}); the two conv1' forms "
        f"{'bit-equal' if same else 'differ'} [{card}]")


def _rest_packed(torch, card):
    """Phase 15(a): ``Detector(packed_stem=True)`` at 608². Returns the
    canonical bf16 Detector and the B = B_BENCH images for (c)."""
    from rotate_yolov3_tpu_torch.detector import Detector
    from rotate_yolov3_tpu_torch.ops.rotated_nms import select_candidates
    from rotate_yolov3_tpu_torch.ops.skew_iou_green import skew_iou_green

    img = NET_IMG or 608
    gen = torch.Generator().manual_seed(15)
    x8 = torch.randint(0, 256, (B_CHECK, img, img, 3), generator=gen,
                       dtype=torch.uint8)
    kw = dict(img_size=NET_IMG, conf_thres=CONF, nms_thres=THR, max_det=128,
              seed=0, device=DEVICE)
    old = _no_tf32(torch)
    try:
        canon = Detector(CFG, compute_dtype=torch.float32, **kw)
        packed = Detector(CFG, compute_dtype=torch.float32, packed_stem=True,
                          **kw)
        specs, fm = packed.spec.yolo_specs, packed.field_major_heads
        use_cls = specs[0].num_classes > 1
        with torch.inference_mode():
            hc = canon.heads(x8)
            hp = packed.heads(x8)
        head_err = max(_max_err(p, c) for p, c in zip(hp, hc))
        scale = max(float(h.abs().max()) for h in hc)
        # relative to the heads' size where they are below 1: random
        # weights give heads of ~1e-4
        if not head_err <= STEM_TOL * min(1.0, scale):
            raise AssertionError(f"packed f32: heads {head_err} from the "
                                 f"canonical Detector's (|heads| <= "
                                 f"{scale})")
        out, n = _counted(torch, lambda: packed(x8))
        if n["gather_rows"] < 1 or n["skew_kill"] < 1:
            raise AssertionError(f"packed f32: a kernel of the path did not "
                                 f"launch: {n}")
        _check_detections(torch, *out, packed.max_det)
        heads, stages = _staged_vs_plain(torch, "packed f32", packed, x8,
                                         out)
        _slice_vs_cpu(torch, card, heads, specs, packed, fm, use_cls, stages,
                      skew_iou_green, what="packed f32")
        # against the canonical Detector, on every image whose candidates
        # are the same rows in the same order (the heads differ by float
        # reassociation, which can swap near-tied scores) and that has no
        # pair within the band
        scores, idx, valid, boxes, cls = stages[:5]
        cdets, cmask = canon(x8)
        _, cidx, _ = select_candidates(hc, specs, CONF, canon.max_det,
                                       canon.approx_top_k, fm)
        comparable = (idx == cidx).all(1) & _clean_images(
            torch, boxes, cls if use_cls else None, valid)
        dets, mask = out
        if not (torch.equal(mask[comparable], cmask[comparable]) and
                _max_err(dets[comparable], cdets[comparable]) <= 1e-3):
            raise AssertionError("packed f32: detections differ from the "
                                 "canonical Detector's on an image with the "
                                 "same candidates and no band pair")
        log(f"packed f32 B={B_CHECK} @{img}: launches {n}; heads max diff from "
            f"the canonical Detector {head_err:.3g} (|heads| <= "
            f"{scale:.3g}); {int(mask.sum())} kept; keep and detections equal "
            f"to the plain recompute; masks equal and rows within 1e-3 of the "
            f"canonical Detector's on {int(comparable.sum())} of {B_CHECK} "
            f"images (the rest: candidates reordered by near ties, or a "
            f"band pair) [{card}]")
        del canon, packed, hc, hp, heads, stages, out, cdets, cmask
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old

    gen = torch.Generator().manual_seed(16)
    x = torch.randint(0, 256, (B_BENCH, img, img, 3), generator=gen,
                      dtype=torch.uint8).to(DEVICE)
    canon = Detector(CFG, compute_dtype=torch.bfloat16, **kw)
    packed = Detector(CFG, compute_dtype=torch.bfloat16, packed_stem=True,
                      **kw)
    out, n = _counted(torch, lambda: packed(x))
    if n["gather_rows"] != 1 or n["skew_kill"] != 1:
        raise AssertionError(f"packed bf16 B={B_BENCH}: kernels A and B must "
                             f"launch once each: {n}")
    _check_detections(torch, *out, packed.max_det)
    _staged_vs_plain(torch, f"packed bf16 B={B_BENCH}", packed, x, out)
    dets = {"canonical": canon, "packed": packed}
    ms: dict = {}
    for name in ("canonical", "packed", "packed", "canonical"):
        ms.setdefault(name, []).append(
            time_ms(torch, lambda: dets[name](x), reps=5, warmup=2))
    log(f"packed bf16 B={B_BENCH} @{img}: launches {n}; keep and detections "
        f"equal to the plain recompute; img/s in turns (median of 5 each): "
        + "; ".join(f"{k} " + " / ".join(f"{B_BENCH / v * 1e3:.2f}"
                                          for v in vs)
                    for k, vs in ms.items()) + f" [{card}]")
    _stem_times(torch, card, canon, packed, x)
    del packed, out
    return canon, x


def _rest_mixed(torch, card, root) -> None:
    """Phase 15(b): a mixed-na cfg at full width through ``Detector`` and
    ``decode_kernel=True``: kernel A once per head, B once, D never."""
    from rotate_yolov3_tpu_torch.detector import Detector
    from rotate_yolov3_tpu_torch.ops.rotated_nms import (
        decode_candidates, non_max_suppression_fused)
    from rotate_yolov3_tpu_torch.ops.skew_iou_green import skew_iou_green

    cfg = _mixed_na_cfg(root)
    img = NET_IMG or 608
    gen = torch.Generator().manual_seed(17)
    x8 = torch.randint(0, 256, (B_CHECK, img, img, 3), generator=gen,
                       dtype=torch.uint8)
    for dtype in (torch.bfloat16, torch.float32):
        name = f"mixed-na {str(dtype)[6:]}"
        old = _no_tf32(torch) if dtype == torch.float32 else None
        try:
            det = Detector(cfg, img_size=NET_IMG, conf_thres=CONF,
                           nms_thres=THR, max_det=128, compute_dtype=dtype,
                           seed=0, device=DEVICE)
            specs, fm = det.spec.yolo_specs, det.field_major_heads
            use_cls = specs[0].num_classes > 1
            nas = [s.na for s in specs]
            if len(set(nas)) < 2:
                raise AssertionError(f"{name}: heads of one na {nas}")
            want = {"gather_rows": len(specs), "skew_kill": 1,
                    "decode_rows": 0}
            out, n = _counted(torch, lambda: det(x8))
            if n != want:
                raise AssertionError(f"{name}: launches {n}, expected {want}")
            _check_detections(torch, *out, det.max_det)
            heads, stages = _staged_vs_plain(torch, name, det, x8, out)
            out_dk, n_dk = _counted(torch, lambda: non_max_suppression_fused(
                heads, specs, conf_thres=CONF, nms_thres=THR,
                max_det=det.max_det, approx_top_k=det.approx_top_k,
                field_major=fm, decode_kernel=True))
            if n_dk != want:
                raise AssertionError(f"{name}: decode_kernel=True launches "
                                     f"{n_dk}, expected {want}")
            if not all(torch.equal(a, b) for a, b in zip(out_dk, out)):
                raise AssertionError(f"{name}: decode_kernel=True differs")
            scores, idx, valid, boxes, cls = stages[:5]
            if dtype == torch.float32:
                _slice_vs_cpu(torch, card, heads, specs, det, fm, use_cls,
                              stages, skew_iou_green, what=name)
            else:
                # the plain gather + decode on the CPU, from the card's
                # bf16 heads and candidates
                boxes_c, cls_c = decode_candidates(
                    [h.cpu() for h in heads], specs, idx.cpu(), valid.cpu(),
                    fm)
                err = _max_err(boxes_c, boxes.cpu())
                if err > 1e-3 or not torch.equal(cls_c, cls.cpu()):
                    raise AssertionError(f"{name}: decoded boxes {err} from "
                                         f"the CPU plain path")
                log(f"{name}: boxes from the plain gather + decode on the "
                    f"CPU within {err:.3g} [{card}]")
            log(f"{name} B={B_CHECK} @{img}, na {nas}: launches {n} "
                f"(decode_kernel=True: {n_dk}, the same detections); "
                f"{int(out[1].sum())} kept; keep and detections equal to the "
                f"plain recompute [{card}]")
            del det, heads, stages, out, out_dk
        finally:
            if old is not None:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = old


def _rest_utils(torch, card, det, x, root) -> None:
    """Phase 15(c): the device, timing, trace and FLOP utilities on the
    card, on the canonical bf16 Detector at B = B_BENCH."""
    from rotate_yolov3_tpu_torch.utils.device import (device_info,
                                                      select_device)
    from rotate_yolov3_tpu_torch.utils.profiling import (flops_per_image,
                                                         time_fn, trace)

    dev = select_device("cuda")
    info = device_info()
    if dev.type != "cuda" or torch.cuda.get_device_name(0) not in info:
        raise AssertionError(f"select_device / device_info: {dev}, {info}")
    t = time_fn(det, x, iters=5, warmup=2)
    img_s = B_BENCH / t["mean_s"]
    flops = flops_per_image(det.spec)
    with trace(os.path.join(root, "trace")) as log_dir:
        det(x)
    files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    with open(os.path.join(log_dir, files[0])) as f:
        text = f.read()
    named = {k: k in text for k in ("gather_rows_kernel",
                                    "skew_kill_kernel")}
    if len(files) != 1 or not all(named.values()):
        raise AssertionError(f"trace: {files}, kernels named: {named}")
    log(f"utils: select_device -> {dev}; {info}; time_fn of a bf16 "
        f"B={B_BENCH} Detector call: mean {t['mean_s'] * 1e3:.3f} ms, min "
        f"{t['min_s'] * 1e3:.3f} ms, std {t['std_s'] * 1e3:.3f} ms over "
        f"{t['iters']} ({img_s:.2f} img/s); flops_per_image {flops} -> "
        f"{flops * img_s / 1e12:.2f} TFLOP/s achieved; trace "
        f"{len(text) / 2**20:.1f} MiB names kernels A and B [{card}]")


def _rest_tools(root) -> None:
    """Phase 15(d): the port's anchor tool on phase 13's drawn labels, and
    the reference-check tool's self-test."""
    import contextlib
    import io

    import numpy as np

    from rotate_yolov3_tpu_torch.tools import kmeans_anchors, verify_reference

    imgs, labels = _draw_ships(TRAIN_N_IMAGES, TRAIN_IMG, seed=12)
    data = _write_dataset(os.path.join(root, "ships"), imgs, labels)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        anchors, angles = kmeans_anchors.main([
            "--data", data, "--img-size", str(TRAIN_IMG), "--num", "9",
            "--num-angles", "6"])
    lines = buf.getvalue().splitlines()
    if anchors.shape != (9, 2) or \
            not bool(np.all(np.diff(anchors.prod(1)) >= 0)) or \
            "angles = -60,-30,0,30,60,90" not in lines:
        raise AssertionError(f"kmeans_anchors: {lines}")
    for line in lines:
        log(f"kmeans_anchors: {line}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = verify_reference.main(["--self-test"])
    if rc != 0 or "self-test OK" not in buf.getvalue():
        raise AssertionError(f"verify_reference --self-test: rc {rc}\n"
                             + buf.getvalue())
    log("verify_reference --self-test: exit 0, self-test OK")


def phase_rest(torch, card) -> None:
    """Phase 15: the packed stem, mixed-na heads, the utilities and the
    tools (see the module docstring)."""
    import tempfile

    from rotate_yolov3_tpu_torch import _build

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        det, x = _rest_packed(torch, card)
        _rest_utils(torch, card, det, x, root)
        del det, x
        _rest_mixed(torch, card, root)
        _rest_tools(root)
    log(f"phase rest: {time.perf_counter() - t0:.1f} s")


def phase_bench_twin(torch, card) -> None:
    """Phase 16: one trial of each cell of the port's benchmark (see the
    module docstring): B = 128 img/s, the stage ladder and the check; then
    the check of each control, which must fail."""
    from rotate_yolov3_tpu_torch import bench

    info = bench.card_info(torch.device("cuda"))
    workloads = bench.load_workloads()
    results, prefixes = {}, {}
    for name, w in workloads.items():
        cell = bench.cell_of(w)
        r = bench.run_cell(cell, trials=1, max_trials=1,
                           pair_ops=pair_ops("kill_rec", "green"))
        bench.report(name, r, info)
        line = json.loads(json.dumps(bench.cell_line(name, cell, r, info)))
        log(f"bench {name}: {line['img_per_s']:.2f} img/s (one trial of "
            f"{cell.scan_iters}x{cell.batch_size}), stages (ms) "
            + ", ".join(f"{k} {v:.3f}" for k, v in r["stages_ms"].items())
            + f"; check: {bench.check_summary(r['check'])} [{card}]")
        shares = {"mfu": r["mfu"], **{k: v["share"]
                                      for k, v in r["kernels"].items()}}
        if not line["correct"]:
            raise AssertionError(f"bench {name}: correct is false: {line}")
        if any(n != 1 for n in r["launches_per_call"].values()):
            raise AssertionError(f"bench {name}: launches per call "
                                 f"{r['launches_per_call']}, not 1 each")
        if any(v is None or not 0 < v <= 1 for v in shares.values()):
            raise AssertionError(f"bench {name}: a share is missing or "
                                 f"above 100%: {shares}")
        if w.get("root_prefix") is not None:
            results[name], prefixes[name] = r, w["root_prefix"]
    line = json.loads(json.dumps(bench.headline_line(results, prefixes,
                                                     info)))
    missing = [k for k in ("metric", "value", "unit", "vs_baseline", "max",
                           "min", "spread_pct", "trials", "maxdet512_value",
                           "maxdet512_max", "maxdet512_spread_pct",
                           "maxdet512_trials", "correct", "mfu", "card",
                           "power_limit", "card_count") if k not in line]
    if missing or line["correct"] is not True:
        raise AssertionError(f"bench headline line: missing {missing} or not "
                             f"correct: {line}")
    log(f"bench twin headline line: {json.dumps(line)}")
    # each control, put in the program's place, must fail the same check
    name = next(n for n, p in prefixes.items() if p == "")
    for control in bench.CONTROLS:
        c = bench.run_check(bench.cell_of(workloads[name]), control)
        log(f"bench {name} control {control}: {bench.check_summary(c)} "
            f"[{card}]")
        if c["correct"] is not False:
            raise AssertionError(f"bench control {control}: the check "
                                 f"passed a wrong program")


def _same_bits(torch, got, want):
    """(NaN in the same places and every other element bit-equal, every
    element bit-equal NaN payloads included)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False, False
    ints = torch.int16 if got.element_size() == 2 else torch.int32
    exact = torch.equal(got.view(ints), want.view(ints))
    nan = want.isnan()
    same = exact or (torch.equal(got.isnan(), nan) and torch.equal(
        got.masked_fill(nan, 0).view(ints),
        want.masked_fill(nan, 0).view(ints)))
    return same, exact


def _eager_heads(torch, net, x):
    """The backbone as it ran before the conv epilogue: per conv layer
    ``F.conv2d`` with its bias (cuDNN's convolution, then
    ``output.add_(bias)``) and ``_activate``; the walk's own shortcut adds.
    ``x``: (B, H, W, C) in the net's dtype, on the card."""
    from rotate_yolov3_tpu_torch.models.darknet import (_activate, _conv2d,
                                                        _walk, layer_key)

    def conv(layer, h):
        key = layer_key(layer.index)
        return _activate(_conv2d(layer, h, net.kernels[key],
                                 net.biases[key]), layer.activation)

    return _walk(net.spec, x.permute(0, 3, 1, 2), conv)


def _plant_epilogue(torch, y, bias, res):
    """Copies of a conv output, its bias and a residual with NaN and +-inf
    planted: single elements of ``y`` and ``res`` (NaN + -inf among them),
    one bias channel each of +inf, -inf and NaN."""
    y, bias = y.clone(), bias.clone()
    b, c, h, w = y.shape
    nan, inf = float("nan"), float("inf")
    y[0, 0, 0, 0], y[0, 1 % c, 0, w - 1] = nan, inf
    y[b - 1, c - 1, h - 1, w - 1] = -inf
    y[b // 2, c // 2, h // 2, w // 2] = nan
    bias[c // 3], bias[(2 * c) // 3], bias[c - 1] = inf, -inf, nan
    if res is not None:
        res = res.clone()
        res[0, 0, 0, 0], res[0, 0, h - 1, 0] = -inf, nan
        res[b - 1, c - 1, h - 1, w - 1], res[0, 1 % c, 0, w - 1] = inf, -inf
    return y, bias, res


def _epilogue_walk(torch, det, x, extra: bool, timed: bool = False):
    """Walk ``det``'s network on ``x`` (B, H, W, C) through the fused walk's
    two hooks: each conv layer's raw convolution finished by the kernel
    and by the plain version on the same inputs (the path's own residual),
    which must agree bit for bit; with ``extra`` also the other residual
    case (a drawn residual where the path has none, none where it has
    one) and both cases with NaN and +-inf planted (``_plant_epilogue``).
    Returns the heads of the walk (the kernel's outputs); per conv layer
    (index, shape, residual on the path, activation, cases held, cases
    also equal in NaN payloads, and with ``timed`` the kernel's and the
    plain version's ms on the path's inputs, ``_spun_ms``); and the
    largest |kernel - plain| on the path's own inputs."""
    from rotate_yolov3_tpu_torch.models import darknet
    from rotate_yolov3_tpu_torch.models.darknet import (_conv2d, _walk,
                                                        layer_key)
    from rotate_yolov3_tpu_torch.ops.conv_epilogue import (conv_epilogue,
                                                           conv_epilogue_ref)

    net, slope, cl = det.net, darknet._LEAKY_SLOPE, torch.channels_last
    gen = torch.Generator(device=x.device).manual_seed(17)
    layers, errs = [], []

    def held(what, y, bias, act, res):
        got = conv_epilogue(y.clone(), bias, act, res, slope)
        want = conv_epilogue_ref(y.clone(), bias, act, res, slope)
        same, exact = _same_bits(torch, got, want)
        if not same:
            bad = ~((got == want) | (got.isnan() & want.isnan()))
            raise AssertionError(
                f"conv epilogue {what}: the kernel differs from its plain "
                f"version at {int(bad.sum())} of {got.numel()} elements, "
                f"first {bad.nonzero()[0].tolist()}")
        return got, exact, _max_err(got, want)

    def conv(layer, h, residual=None):
        key = layer_key(layer.index)
        y = _conv2d(layer, h, net.kernels[key], None).contiguous(
            memory_format=cl)
        bias, act = net.biases[key], layer.activation
        what = f"layer {layer.index} {tuple(y.shape)} {str(y.dtype)[6:]}"
        out, exact, err = held(what, y, bias, act, residual)
        errs.append(err)
        cases, n_exact = 1, int(exact)
        if extra:
            other = None if residual is not None else torch.randn(
                y.shape, generator=gen, device=y.device).to(y.dtype) \
                .contiguous(memory_format=cl)
            for res in (residual, other):
                if res is not residual:
                    n_exact += held(what + " other residual", y, bias, act,
                                    res)[1]
                    cases += 1
                py, pb, pr = _plant_epilogue(torch, y, bias, res)
                n_exact += held(what + " planted", py, pb, act, pr)[1]
                cases += 1
        ms = (None, None)
        if timed:
            buf = y.clone()
            ms = tuple(_spun_ms(torch, lambda f=f: f(buf, bias, act, residual,
                                                       slope))
                       for f in (conv_epilogue, conv_epilogue_ref))
        layers.append((layer.index, tuple(y.shape), residual is not None,
                       act, cases, n_exact) + ms)
        return out

    heads = _walk(net.spec, x.permute(0, 3, 1, 2), conv, conv_shortcut=conv)
    return heads, layers, max(errs)


def _epilogue_bytes(layers, esize: int) -> int:
    """Bytes the conv epilogue of one call must move: each output read and
    written once, the residual read once, the bias once."""
    return sum(esize * ((3 if res else 2) * math.prod(shape) + shape[1])
               for _, shape, res, *_ in layers)


# the eager passes the conv epilogue replaces: the bias add inside the
# convolution, the activation, the shortcut add
_PASSES = ("aten::add_", "aten::leaky_relu", "aten::add")


def _op_kernels(torch, fn, shapes: bool = False, esize: int = 2):
    """torch.profiler over one call of ``fn()`` (after one untimed call):
    per (CPU op, device kernel) the launches, the device µs and, with
    ``shapes``, for the ops of ``_PASSES`` the bytes its inputs' shapes
    imply (each input read once, the first written once, ``esize`` bytes
    an element; counted once per op, which may launch the kernel more
    than once) and the op that called it: launches and the first input
    shape seen under each caller; the set of CPU op names seen; and
    whether every op of ``_PASSES`` has its kernels (torch.profiler can
    drop device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=shapes) as prof:
        fn()
        torch.cuda.synchronize()
    groups: dict = {}
    ops = set()
    complete = True
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        ops.add(e.name)
        complete &= e.name not in _PASSES or bool(e.kernels)
        for j, k in enumerate(e.kernels):
            g = groups.setdefault((e.name, k.name), {
                "launches": 0, "us": 0.0, "bytes": 0, "callers": {}})
            g["launches"] += 1
            g["us"] += k.duration
            if shapes and e.name in _PASSES and j == 0:
                sizes = [math.prod(s) for s in e.input_shapes
                         if isinstance(s, list) and s]
                g["bytes"] += esize * (sum(sizes) + sizes[0])
                caller = e.cpu_parent.name if e.cpu_parent else "(top)"
                n, shape = g["callers"].get(caller, (0, e.input_shapes[0]))
                g["callers"][caller] = (n + 1, shape)
    return groups, ops, complete


def _spun_ms(torch, fn, reps: int = 3) -> float:
    """CUDA-event ms per call of ``reps`` back-to-back ``fn()`` queued
    behind a ~1 ms spin of the card (the bench's ``SPIN_CYCLES``), so the
    host's launches stay out of the window."""
    from rotate_yolov3_tpu_torch.bench import SPIN_CYCLES

    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _heads_vs_eager(torch, card, what, det, imgs) -> None:
    """``det``'s heads on ``imgs`` bit-equal to the eager program's."""
    with torch.inference_mode():
        got = det.heads(imgs)
        want = _eager_heads(torch, det.net, det._images(imgs))
    if not all(_same_bits(torch, g, w)[0] for g, w in zip(got, want)):
        raise AssertionError(f"conv epilogue: {what} heads differ from the "
                             f"eager program")
    log(f"conv epilogue: {what} Detector heads B={len(imgs)} "
        f"@{imgs.shape[1]} bit-equal to the eager program [{card}]")


def phase_epilogue(torch, card, results) -> None:
    """Phase 17: the conv epilogue kernel (see the module docstring)."""
    from rotate_yolov3_tpu_torch.detector import Detector
    from rotate_yolov3_tpu_torch.ops.conv_epilogue import conv_epilogue
    from rotate_yolov3_tpu_torch.ops.gather_rows import gather_rows
    from rotate_yolov3_tpu_torch.ops.skew_iou_cuda import skew_kill_matrix

    img = NET_IMG or 608
    gen = torch.Generator().manual_seed(21)
    imgs = torch.randint(0, 256, (B_BENCH, img, img, 3), generator=gen,
                         dtype=torch.uint8).to(DEVICE)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        # (a) every conv output shape at B = EPI_B, bf16 and f32, with and
        # without a residual, finite and planted; the f32 heads and the
        # packed stem's bf16 heads against the eager program
        for dtype in (torch.bfloat16, torch.float32, "packed"):
            det = Detector(CFG, img_size=img, conf_thres=CONF,
                           nms_thres=THR, max_det=128,
                           compute_dtype=torch.bfloat16 if dtype == "packed"
                           else dtype, seed=0, device=DEVICE,
                           packed_stem=dtype == "packed")
            name = "packed stem bf16" if dtype == "packed" else \
                str(dtype)[6:]
            if dtype != "packed":
                with torch.inference_mode():
                    _, layers, _ = _epilogue_walk(
                        torch, det, det._images(imgs[:EPI_B]), extra=True)
                kinds = {(s[1:], r, a) for _, s, r, a, *_ in layers}
                log(f"conv epilogue {name} B={EPI_B} @{img}: {len(layers)} "
                    f"conv layers, {len(kinds)} (shape, residual, "
                    f"activation) kinds, {sum(l[4] for l in layers)} cases "
                    f"bit-equal to the plain version (NaN in the same "
                    f"places), {sum(l[5] for l in layers)} of them in NaN "
                    f"payloads too [{card}]")
            if dtype != torch.bfloat16:
                _heads_vs_eager(torch, card, name, det, imgs[:B_CHECK])
            del det
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32

    det = Detector(CFG, img_size=img, conf_thres=CONF, nms_thres=THR,
                   max_det=128, compute_dtype=torch.bfloat16, seed=0,
                   device=DEVICE)
    n_conv = len(det.spec.conv_specs)
    # (b) the main path: counters from 0, through the entry point only
    conv_epilogue.launches = 0
    gather_rows.launches = 0
    skew_kill_matrix.launches = 0
    dets, mask = det(imgs)
    torch.cuda.synchronize()
    launches = {"conv_epilogue": conv_epilogue.launches,
                "gather_rows": gather_rows.launches,
                "skew_kill": skew_kill_matrix.launches}
    if launches != {"conv_epilogue": n_conv, "gather_rows": 1,
                    "skew_kill": 1}:
        raise AssertionError(f"conv epilogue: launches of one Detector call "
                             f"{launches}, not {n_conv}, 1, 1")
    _check_detections(torch, dets, mask, det.max_det)
    results["conv_epilogue"] = {"launches": launches["conv_epilogue"],
                                "library_ms": None}
    with torch.inference_mode():
        x = det._images(imgs)
        walked, layers, err = _epilogue_walk(torch, det, x, extra=False,
                                             timed=True)
        heads = det.heads(imgs)
        eager = _eager_heads(torch, det.net, x)
        for what, other in (("the eager program", eager),
                            ("the kernel-by-plain walk", walked)):
            if not all(_same_bits(torch, g, w)[0]
                       for g, w in zip(heads, other)):
                raise AssertionError(f"conv epilogue: the B={B_BENCH} bf16 "
                                     f"heads differ from {what}")
        del walked, eager
    results["conv_epilogue"]["max_abs_err"] = err
    log(f"conv epilogue bf16 B={B_BENCH} @{img}: launches of one Detector "
        f"call {launches}; every layer's kernel output bit-equal to the "
        f"plain version on the path's inputs; heads bit-equal to the eager "
        f"program [{card}]")

    # (c) the eager program's trace: which op launches which kernel
    def eager_call():
        return _eager_heads(torch, det.net, x)

    def fused_call():
        return det.net(x)

    with torch.inference_mode():
        for _ in range(4):
            groups, _, complete = _op_kernels(torch, eager_call, shapes=True)
            if complete:
                break
        else:
            log("(no profile of the eager backbone recorded every pass's "
                "kernels: torch.profiler dropped device events, so the "
                "passes' times below read low)")
        total_us = sum(g["us"] for g in groups.values()) or 1.0
        log(f"eager backbone trace, bf16 B={B_BENCH} (one call; op | "
            f"kernel | launches | device ms | GB | GB/s | share | called "
            f"from):")
        for (op, kname), g in sorted(groups.items(),
                                     key=lambda kv: -kv[1]["us"])[:12]:
            gb = (f"{g['bytes'] / 1e9:.2f} | "
                  f"{g['bytes'] / 1e3 / g['us']:.0f}") if g["bytes"] \
                else "- | -"
            callers = ", ".join(f"{c} {n} (first {shape})" for c, (n, shape)
                                in g["callers"].items())
            log(f"  {op} | {kname[:90]} | {g['launches']} | "
                f"{g['us'] / 1e3:.3f} | {gb} | "
                f"{100 * g['us'] / total_us:.1f}% | {callers}")
        plain_us = {op: sum(g["us"] for (o, _), g in groups.items()
                            if o == op) for op in _PASSES}
        plain_n = {op: sum(g["launches"] for (o, _), g in groups.items()
                           if o == op) for op in _PASSES}
        fused_groups, fused_ops, _ = _op_kernels(torch, fused_call)
        left = fused_ops & set(_PASSES)
        if left:
            raise AssertionError(f"conv epilogue: the fused backbone still "
                                 f"runs {sorted(left)}")
        # (d) times: the kernel and the plain version per call, the sums
        # of their per-layer times on the path's inputs (CUDA events: the
        # profiler drops device events late in this script); the backbone
        # in turns
        epi_ms = sum(l[6] for l in layers)
        plain_ms = sum(l[7] for l in layers)
        turns = {}
        for name, fn in (("eager", eager_call), ("fused", fused_call),
                         ("fused", fused_call), ("eager", eager_call)):
            turns.setdefault(name, []).append(time_ms(torch, fn, reps=5,
                                                      warmup=1))
    nbytes = _epilogue_bytes(layers, 2)
    b = bound(0, nbytes)
    results["conv_epilogue"].update(ms=epi_ms, plain_ms=plain_ms, **b)
    log(f"conv epilogue bf16 B={B_BENCH}: {epi_ms:.3f} ms of kernel per call "
        f"({n_conv} launches, CUDA events layer by layer), plain version "
        f"{plain_ms:.3f} ms, bound {b['bound_ms']:.3f} ms ({b['bound_by']}: "
        f"{nbytes / 1e9:.2f} GB), share {100 * b['bound_ms'] / epi_ms:.1f}%; "
        f"in the eager trace, the passes it replaces (launches, ms) "
        + ", ".join(f"{op} {plain_n[op]}, {us / 1e3:.3f}"
                    for op, us in plain_us.items())
        + "; backbone ms in turns "
        + "; ".join(f"{k} " + " / ".join(f"{v:.3f}" for v in vs)
                    for k, vs in turns.items())
        + "; fused trace ops with kernels: "
        + ", ".join(sorted({op for op, _ in fused_groups})) + f" [{card}]")


def main() -> int:
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
    seconds = []

    def run(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        seconds.append(f"{phase.__name__[6:]} {time.perf_counter() - t0:.1f}")
        return out

    run(phase_build, _build)
    run(phase_gather, torch, card, results)
    run(phase_kill, torch, card, results)
    run(phase_slice, torch, card, results)
    run(phase_bench, torch, card)
    run(phase_nms_greedy, torch, card, results)
    run(phase_dota, torch, card, results)
    serving = run(phase_fused_serving, torch, card, results)
    run(phase_iou_matrix, torch, card, results, serving)
    run(phase_pair_algos, torch, card, results)
    run(phase_decode, torch, card, results)
    run(phase_options, torch, card, results)
    run(phase_train, torch, card)
    run(phase_parallel, torch, card)
    run(phase_rest, torch, card)
    run(phase_bench_twin, torch, card)
    run(phase_epilogue, torch, card, results)
    log("seconds by phase: " + ", ".join(seconds))

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": r["launches"],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
