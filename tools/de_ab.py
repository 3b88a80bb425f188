#!/usr/bin/env python3
"""Kernels D (gather + decode) and E (the IoU matrix) of this checkout
against the same kernels built from an earlier source tree, and kernel C
against that tree's, on one CUDA card, on chip_smoke.py's inputs.

    python3 tools/de_ab.py OLD_CSRC [--variants]

OLD_CSRC holds a ``decode_rows.cu``, a ``skew_iou_matrix.cu``, a
``nms_greedy.cu`` and their headers with the C signatures of commit a2d003e
(kernel E takes one (N, 5) x (M, 5) matrix a launch; kernels C and D this
checkout's signatures), for example that commit's
``rotate_yolov3_tpu_torch/csrc`` unpacked with ``git archive``. With
``--variants`` it also builds the layouts of kernel D in ``D_VARIANTS`` and
the tile heights of kernel E in ``E_VARIANTS`` (string edits of this
checkout's sources). All are built with the flags of
``rotate_yolov3_tpu_torch/_build.py``, and each build's ptxas report
(registers, stack, spills, shared memory) is printed. Device times
(torch.profiler) are taken in turns: this checkout, the others, then back in
reverse order, each the mean of its two turns.

  * D on phase 11's heads (HRSC B = 8 bf16 and f32, DOTA T = 25 bf16, HRSC
    B = 128 bf16, finite): every tree's rows bit for bit this checkout's;
    then, on the same heads with chip_smoke.py's planted non-finite rows,
    the rows where the old kernel differs (the repaired fault);
  * E on phase 9's 512 x 512 detection boxes and on the serving path's
    B = 128 x 512 boxes (phase 8's), each algo, triangle: this checkout in
    one launch, the old kernel one launch per image; equal, or within
    chip_smoke.IOU_TOL with the count of entries that differ;
  * C on tools/ac_ab.py's cases and the serving boxes: bit for bit.

Prints one line per case and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (old, new) string edits of csrc/decode_rows.cu: threads per block
# and rows per thread
D_VARIANTS = {
    "t128": [("kThreads = 256;", "kThreads = 128;")],
    "t512": [("kThreads = 256;", "kThreads = 512;")],
    "t256r2": [("kRowsPerThread = 1;", "kRowsPerThread = 2;")],
    "t128r2": [("kThreads = 256;", "kThreads = 128;"),
               ("kRowsPerThread = 1;", "kRowsPerThread = 2;")],
}

# name -> edits of csrc/skew_iou_matrix.cu: the tile height fixed (16 rows
# added as an instance)
_E_ROWS = "  if (rows == 8) return launch<kAlgo, 8>"
_E_SET = "  if (err != cudaSuccess) return (int)err;\n  const cudaStream_t"
E_VARIANTS = {f"rows{r}": [
    (_E_ROWS, "  if (rows == 16) return launch<kAlgo, 16>(pa, pb, o, nb, n, "
              "m, triangle, s);\n" + _E_ROWS),
    (_E_SET, _E_SET.replace("const cudaStream_t",
                            f"rows = {r};\n  const cudaStream_t"))]
    for r in (8, 16, 32, 64)}


def decode_fn(torch, lib):
    """decode_rows_launch of ``lib`` as (heads, idx, valid, meta, na, nc)
    -> (B, K, 8); the signature of ops/decode_rows.py."""
    from rotate_yolov3_tpu_torch.models.yolo_head import (_WH_CLAMP,
                                                          ANGLE_RANGE)

    fn = lib.decode_rows_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float)] + [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 7 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(heads, idx, valid, meta, na, nc):
        b, k = idx.shape
        out = torch.empty((b, k, 8), dtype=torch.float32, device=idx.device)
        nh = len(meta)
        ints = ctypes.c_int * 4
        anchors = (ctypes.c_float * (nh * 3 * na))(
            *[v for m in meta for v in (*m.anchor_w, *m.anchor_h,
                                        *m.anchor_a)])
        ptrs = [h.data_ptr() for h in heads] + [None] * (4 - nh)
        err = fn(*ptrs, nh, ints(*[m.n_cells for m in meta]),
                 ints(*[m.width for m in meta]),
                 (ctypes.c_float * 4)(*[float(m.stride) for m in meta]),
                 anchors, idx.data_ptr(), valid.data_ptr(), out.data_ptr(),
                 b, k, heads[0].shape[3], na, nc, 1,
                 int(heads[0].dtype == torch.bfloat16), ANGLE_RANGE,
                 _WH_CLAMP, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"decode_rows launch failed: {err}")
        return out
    return run


def iou_new(torch, lib):
    fn = lib.skew_iou_matrix_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(boxes, algo_id):
        """(B, K, 5) -> (B, K, K) triangle, one launch."""
        b, k = boxes.shape[:2]
        out = torch.empty((b, k, k), dtype=torch.float32,
                          device=boxes.device)
        err = fn(boxes.data_ptr(), boxes.data_ptr(), out.data_ptr(), b, k, k,
                 1, algo_id, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"skew_iou_matrix launch failed: {err}")
        return out
    return run


def iou_old(torch, lib):
    fn = lib.skew_iou_matrix_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(boxes, algo_id):
        """(B, K, 5) -> (B, K, K) triangle, one launch per image."""
        b, k = boxes.shape[:2]
        out = torch.empty((b, k, k), dtype=torch.float32,
                          device=boxes.device)
        stream = torch.cuda.current_stream().cuda_stream
        for i in range(b):
            err = fn(boxes[i].data_ptr(), boxes[i].data_ptr(),
                     out[i].data_ptr(), k, k, 1, algo_id, stream)
            if err:
                raise RuntimeError(f"old skew_iou_matrix launch failed: "
                                   f"{err}")
        return out
    return run


def main() -> int:
    args = [a for a in sys.argv[1:] if a != "--variants"]
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch

    import chip_smoke as cs
    from ac_ab import _run_c, _serving_boxes, build, nms_new
    from rotate_yolov3_tpu_torch import _build
    from rotate_yolov3_tpu_torch.config.parse import parse_model_cfg
    from rotate_yolov3_tpu_torch.models.darknet import build_network
    from rotate_yolov3_tpu_torch.ops.decode_rows import heads_meta
    from rotate_yolov3_tpu_torch.ops.skew_iou_cuda import ALGOS, check_algo

    if not torch.cuda.is_available():
        print("de_ab: no CUDA device is available", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card, flush=True)
    old = os.path.abspath(args[0])
    out = str(_build.BUILD_DIR / "ab_de")
    csrc = str(_build.CSRC)
    d_fns = [("this", decode_fn(torch, _build.load("decode_rows"))),
             ("old", decode_fn(torch, build(_build, "decode_rows", old,
                                            f"{out}/old")))]
    if "--variants" in sys.argv:
        d_fns += [(n, decode_fn(torch, build(_build, "decode_rows", csrc,
                                             f"{out}/D_{n}", e)))
                  for n, e in D_VARIANTS.items()]
    e_fns = [("this", iou_new(torch, _build.load("skew_iou_matrix"))),
             ("old", iou_old(torch, build(_build, "skew_iou_matrix", old,
                                          f"{out}/old")))]
    if "--variants" in sys.argv:
        e_fns += [(n, iou_new(torch, build(_build, "skew_iou_matrix", csrc,
                                           f"{out}/E_{n}", e)))
                  for n, e in E_VARIANTS.items()]
    c_fns = [("this", nms_new(torch, _build.load("nms_greedy"))),
             ("old", nms_new(torch, build(_build, "nms_greedy", old,
                                          f"{out}/old")))]
    _build.load("skew_kill")
    for name, (_, report) in _build.BUILD_LOG.items():
        print(f"this checkout's {name}.cu: " + " | ".join(
            l.strip() for l in report.splitlines()
            if "registers" in l or "spill" in l), flush=True)
    cs.count_pair_ops(_build)

    def turns(fns, call, reps=30):
        t = [0.0] * len(fns)
        order = list(range(len(fns)))
        for i in order + order[::-1]:
            t[i] += cs.device_ms(torch, lambda: call(fns[i][1]),
                                 reps=reps) / 2
        return ", ".join(f"{n} {x:.4f} ms" for (n, _), x in zip(fns, t)), t

    # kernel D on phase 11's heads
    gen = torch.Generator(device="cuda").manual_seed(11)
    k, img = 512, 608
    for cfg, b, dtypes in ((cs.CFG, cs.B_CHECK,
                            (torch.bfloat16, torch.float32)),
                           (cs.DOTA_CFG, 25, (torch.bfloat16,)),
                           (cs.CFG, cs.B_BENCH, (torch.bfloat16,))):
        specs = build_network(parse_model_cfg(cfg), img_size=img).yolo_specs
        na, nc = specs[0].na, specs[0].num_classes
        for dtype in dtypes:
            heads = cs._random_head_maps(torch, gen, specs, img, b, dtype)
            meta = heads_meta(specs, [h.shape for h in heads])
            n = sum(m.n_cells for m in meta) * na
            idx = torch.randint(0, n, (b, k), generator=gen, device="cuda",
                                dtype=torch.int32)
            valid = torch.rand((b, k), generator=gen, device="cuda") > 0.2
            args_ = (heads, idx, valid, meta, na, nc)
            want = d_fns[0][1](*args_)
            for name, f in d_fns[1:]:
                if not torch.equal(f(*args_), want):
                    raise AssertionError(f"decode_rows {name} differs from "
                                         f"this checkout on finite heads")
            line, t = turns(d_fns, lambda f: f(*args_), reps=50)
            bnd = cs.bound(b * k * (30 + nc),
                           b * k * ((6 + nc) * 2 + 4 + 1 + 32))["bound_ms"]
            fields = 5 + (nc if nc > 1 else 0)
            floor = b * k * (fields * 32 + 37) / cs.MEM_PEAK * 1e3
            tag = f"{os.path.basename(cfg)} {str(dtype)[6:]} B={b} K={k}"
            print(f"de_ab decode_rows {tag}: equal bit for bit; {line}; "
                  f"bound {bnd:.5f} ms, this at {100 * bnd / t[0]:.1f}%; "
                  f"sector floor {floor:.5f} ms [{card}]", flush=True)
            planted = cs._plant_rows(torch, heads, idx, meta, na, nc)
            got, was = d_fns[0][1](*args_), d_fns[1][1](*args_)
            rows = ~((got == was) | (got.isnan() & was.isnan())).all(-1)
            print(f"de_ab decode_rows {tag} with {int(planted.sum())} "
                  f"planted non-finite rows: the old kernel differs on "
                  f"{int(rows.sum())} rows, {int((rows & ~planted).sum())} "
                  f"of them unplanted [{card}]", flush=True)
            del heads, idx, valid

    # kernel E on phase 9's 512 x 512 boxes and the serving boxes
    gen = torch.Generator(device="cuda").manual_seed(9)
    for n in (17, 33):          # phase 9's small cases draw first
        for _ in range(5):
            torch.rand(n, generator=gen, device="cuda")
    det = cs._detection_boxes(torch, gen, 512)[:1].contiguous()
    serving, s_valid = _serving_boxes(torch, cs)
    for name, boxes in (("512x512", det),
                        (f"serving B={cs.B_BENCH} K=512", serving)):
        for algo in ALGOS:
            aid = check_algo(algo)
            want = e_fns[0][1](boxes, aid)
            was = e_fns[1][1](boxes, aid)
            same = (want == was) | (want.isnan() & was.isnan())
            nan = was.isnan()
            if not bool((want.isnan() == nan).all()):
                raise AssertionError(f"skew_iou_matrix {algo} {name}: NaN "
                                     f"in other places than the old kernel")
            err = cs._max_err(want[~nan], was[~nan])
            if err > cs.IOU_TOL:
                raise AssertionError(f"skew_iou_matrix {algo} {name}: {err} "
                                     f"from the old kernel")
            for vname, f in e_fns[2:]:
                got = f(boxes, aid)
                if not bool(((got == want) | (got.isnan() & want.isnan()))
                            .all()):
                    raise AssertionError(f"skew_iou_matrix {algo} {name}: "
                                         f"{vname} differs from this "
                                         f"checkout")
            line, t = turns(e_fns, lambda f: f(boxes, aid), reps=5)
            p_geo = cs.iou_live_pairs(torch, boxes)
            b, k = boxes.shape[:2]
            bnd = cs.bound(p_geo * cs.pair_ops("iou_rec", algo),
                           2 * b * k * 20 + b * k * k * 4)["bound_ms"]
            print(f"de_ab skew_iou_matrix {algo} {name} triangle: within "
                  f"{err:.3g} of the old kernel, {int((~same).sum())} of "
                  f"{want.numel()} entries differ; {line} (old: one launch "
                  f"per image); {p_geo} pairs take the geometry; bound "
                  f"{bnd:.5f} ms, this at {100 * bnd / t[0]:.1f}% [{card}]",
                  flush=True)
            del want, was, same

    # kernel C against the old tree's, bit for bit
    gen = torch.Generator(device="cuda").manual_seed(5)
    for name, b, k, n_cls, thr, layout in (
            ("B=1 K=1024 15 classes", 1, 1024, 15, cs.MERGE_THR, "random"),
            ("B=1 K=1024 all-overlap", 1, 1024, 0, cs.MERGE_THR,
             "all-overlap"),
            ("B=8 K=512 chain", cs.B_CHECK, 512, 0, cs.THR, "special")):
        boxes, cls, valid = cs._nms_layout(torch, gen, b, k, n_cls, layout)
        _run_c(torch, cs, c_fns, turns, [(name, boxes, cls, valid, thr)])
    _run_c(torch, cs, c_fns, turns,
           [(f"B={cs.B_BENCH} K=512 serving boxes", serving, None, s_valid,
             cs.THR)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
