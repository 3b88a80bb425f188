#!/usr/bin/env python3
"""Kernels A (row gather) and C (fused greedy NMS) of this checkout against
the same kernels built from an earlier source tree, and against variants of
this checkout's sources, on one CUDA card.

    python3 tools/ac_ab.py OLD_CSRC [--variants]

OLD_CSRC holds a ``gather_rows.cu``, a ``nms_greedy.cu`` and their headers
with the C signatures of commit 66eac3a (kernel A reads one concatenated
(B, N, C) table; kernel C takes a (B, K, ceil(K/32)) mask scratch and B
counters it zeroes itself), for example that commit's
``rotate_yolov3_tpu_torch/csrc`` unpacked with ``git archive``. With
``--variants`` it also builds the variants in ``A_VARIANTS`` and
``C_VARIANTS`` (string edits of this checkout's sources). All are built with
the flags of ``rotate_yolov3_tpu_torch/_build.py``. Per case every output
must equal this checkout's bit for bit; device times (torch.profiler) are
taken in turns (this checkout, the others, then back in reverse order, each
the mean of its two turns) beside the bound chip_smoke.py computes. Kernel A
of the old tree reads the concatenated table, built outside its timing.
Prints one line per case and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (old, new) string edits of csrc/gather_rows.cu
A_VARIANTS = {
    "rows2w8": [("kWarps = 4;", "kWarps = 8;"), ("kRows = 8;", "kRows = 2;")],
    "rows4w8": [("kWarps = 4;", "kWarps = 8;"), ("kRows = 8;", "kRows = 4;")],
    "rows16w4": [("kRows = 8;", "kRows = 16;"), ("kUnroll = 2;",
                                                 "kUnroll = 1;")],
}
# name -> edits of csrc/nms_greedy.cu: the tile height fixed
_ROWS = "  if (err != cudaSuccess) return (int)err;\n  const cudaStream_t"
C_VARIANTS = {f"rows{r}": [(_ROWS, _ROWS.replace(
    "const cudaStream_t", f"rows = {r};\n  const cudaStream_t"))]
    for r in (16, 32, 64)}


def build(_build, name: str, src_dir: str, out_dir: str, edits=()):
    """``<src_dir>/<name>.cu``, edited, built into ``out_dir``; the CDLL."""
    os.makedirs(out_dir, exist_ok=True)
    for header in os.listdir(src_dir):
        if header.endswith(".cuh"):
            shutil.copy(os.path.join(src_dir, header), out_dir)
    with open(os.path.join(src_dir, f"{name}.cu")) as f:
        src = f.read()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{out_dir}: edit not found: {old!r}")
        src = src.replace(old, new)
    cu = os.path.join(out_dir, f"{name}.cu")
    with open(cu, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, f"lib{name}.so")
    proc = subprocess.run([_build.nvcc(), *_build.flags(name), "-I", out_dir,
                           "-o", lib, cu], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stdout}"
                           f"{proc.stderr}")
    print(f"{cu}: " + " | ".join(
        l.strip() for l in (proc.stdout + proc.stderr).splitlines()
        if "registers" in l or "spill" in l), flush=True)
    return ctypes.CDLL(lib)


def gather_new(torch, lib):
    fn = lib.gather_rows_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int)] + [ctypes.c_void_p] * 2 \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(tables, cat, idx):
        b, c, k = tables[0].shape[0], tables[0].shape[2], idx.shape[1]
        out = torch.empty((b, k, c), dtype=cat.dtype, device=cat.device)
        ptrs = [t.data_ptr() for t in tables] + [None] * (4 - len(tables))
        cells = (ctypes.c_int * 4)(*[t.shape[1] for t in tables])
        err = fn(*ptrs, len(tables), cells, idx.data_ptr(), out.data_ptr(),
                 b, k, c, cat.element_size(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"gather_rows launch failed: {err}")
        return out
    return run


def gather_old(torch, lib):
    fn = lib.gather_rows_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(tables, cat, idx):
        b, n, c = cat.shape
        k = idx.shape[1]
        out = torch.empty((b, k, c), dtype=cat.dtype, device=cat.device)
        err = fn(cat.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, k, c,
                 cat.element_size(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old gather_rows launch failed: {err}")
        return out
    return run


def nms_new(torch, lib):
    fn = lib.nms_greedy_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 \
        + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for size in (lib.nms_greedy_mask_ld, lib.nms_greedy_state_words):
        size.argtypes = [ctypes.c_int]
        size.restype = ctypes.c_int
    state = {}

    def run(boxes, cls, valid, thr):
        b, k = boxes.shape[:2]
        words = b * lib.nms_greedy_state_words(k)
        if state.get("n", 0) < words:   # zero, and left zero by the kernel
            state["buf"] = torch.zeros(words, dtype=torch.int32,
                                       device=boxes.device)
            state["n"] = words
        mask = torch.empty(b * k * lib.nms_greedy_mask_ld(k),
                           dtype=torch.int32, device=boxes.device)
        keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
        err = fn(boxes.data_ptr(), None if cls is None else cls.data_ptr(),
                 valid.data_ptr(), mask.data_ptr(), state["buf"].data_ptr(),
                 keep.data_ptr(), b, k, thr, 1.0 + thr, 0,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"nms_greedy launch failed: {err}")
        return keep
    return run


def nms_old(torch, lib):
    fn = lib.nms_greedy_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 \
        + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(boxes, cls, valid, thr):
        b, k = boxes.shape[:2]
        mask = torch.empty(b * k * -(-k // 32), dtype=torch.int32,
                           device=boxes.device)
        done = torch.empty(b, dtype=torch.int32, device=boxes.device)
        keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
        err = fn(boxes.data_ptr(), None if cls is None else cls.data_ptr(),
                 valid.data_ptr(), mask.data_ptr(), done.data_ptr(),
                 keep.data_ptr(), b, k, thr, 1.0 + thr, 0,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old nms_greedy launch failed: {err}")
        return keep
    return run


def main() -> int:
    args = [a for a in sys.argv[1:] if a != "--variants"]
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from rotate_yolov3_tpu_torch import _build

    if not torch.cuda.is_available():
        print("ac_ab: no CUDA device is available", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    old = os.path.abspath(args[0])
    out = str(_build.BUILD_DIR / "ab")
    csrc = str(_build.CSRC)
    a_fns = [("this", gather_new(torch, _build.load("gather_rows"))),
             ("old", gather_old(torch, build(_build, "gather_rows", old,
                                             f"{out}/old")))]
    c_fns = [("this", nms_new(torch, _build.load("nms_greedy"))),
             ("old", nms_old(torch, build(_build, "nms_greedy", old,
                                          f"{out}/old")))]
    if "--variants" in sys.argv:
        a_fns += [(n, gather_new(torch, build(_build, "gather_rows", csrc,
                                              f"{out}/A_{n}", e)))
                  for n, e in A_VARIANTS.items()]
        c_fns += [(n, nms_new(torch, build(_build, "nms_greedy", csrc,
                                           f"{out}/C_{n}", e)))
                  for n, e in C_VARIANTS.items()]
    cs.count_pair_ops(_build)

    def turns(fns, call):
        t = [0.0] * len(fns)
        order = list(range(len(fns)))
        for i in order + order[::-1]:
            t[i] += cs.device_ms(torch, lambda: call(fns[i][1]), reps=30) / 2
        return ", ".join(f"{n} {x:.4f} ms" for (n, _), x in zip(fns, t)), t

    gen = torch.Generator(device="cuda").manual_seed(1)
    for b, c, dtype in ((cs.B_BENCH, 126, torch.bfloat16),
                        (25, 378, torch.bfloat16),
                        (cs.B_BENCH, 126, torch.float32)):
        tables, idx = cs._gather_case(torch, gen, b, c, dtype, 512)
        cat = torch.cat(tables, dim=1)
        want = a_fns[0][1](tables, cat, idx)
        for n, f in a_fns[1:]:
            if not torch.equal(f(tables, cat, idx), want):
                raise AssertionError(f"gather_rows {n} differs B={b} C={c}")
        line, t = turns(a_fns, lambda f: f(tables, cat, idx))
        bnd = cs.bound(0, b * 512 * (2 * c * cat.element_size() + 4))
        print(f"ac_ab gather_rows {str(dtype)[6:]} B={b} C={c} K=512: equal; "
              f"{line}; bound {bnd['bound_ms']:.4f} ms, this at "
              f"{100 * bnd['bound_ms'] / t[0]:.1f}% [{cs.card_line()}]",
              flush=True)
        del tables, cat, idx

    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = [("B=1 K=1024 15 classes", 1, 1024, 15, cs.MERGE_THR, "random"),
             ("B=1 K=1024 all-overlap", 1, 1024, 0, cs.MERGE_THR,
              "all-overlap"),
             ("B=1 K=1024 no-kill", 1, 1024, 0, cs.MERGE_THR, "no-kill"),
             ("B=8 K=512 chain", cs.B_CHECK, 512, 0, cs.THR, "special")]
    for name, b, k, n_cls, thr, layout in cases:
        boxes, cls, valid = cs._nms_layout(torch, gen, b, k, n_cls, layout)
        _run_c(torch, cs, c_fns, turns, [(name, boxes, cls, valid, thr)])
    for layout in cs.KILL_LAYOUTS:
        boxes = cs.kill_layout(torch, gen, layout, cs.B_BENCH, 512)
        valid = torch.ones((cs.B_BENCH, 512), dtype=torch.bool,
                           device="cuda")
        valid[:, -64:] = False
        boxes[:, -64:] = 0.0
        _run_c(torch, cs, c_fns, turns,
               [(f"B={cs.B_BENCH} K=512 {layout}", boxes.contiguous(), None,
                 valid, cs.THR)])
    # the serving path's own boxes, as chip_smoke.py phase 8 makes them
    boxes, valid = _serving_boxes(torch, cs)
    _run_c(torch, cs, c_fns, turns,
           [(f"B={cs.B_BENCH} K=512 serving boxes (phase 8)", boxes, None,
             valid, cs.THR)])
    return 0


def _serving_boxes(torch, cs):
    """Phase 8's (B_BENCH, 512, 5) boxes and valid rows: the HRSC
    Detector's heads (seeded random weights, bf16) on seeded uint8 images,
    top-k and decode."""
    from rotate_yolov3_tpu_torch.detector import Detector
    from rotate_yolov3_tpu_torch.ops.rotated_nms import (decode_candidates,
                                                         select_candidates)

    det = Detector(cs.CFG, conf_thres=cs.CONF, nms_thres=cs.THR, max_det=512,
                   compute_dtype=torch.bfloat16, seed=0, device="cuda")
    gen = torch.Generator().manual_seed(7)
    x = torch.randint(0, 256, (cs.B_BENCH, det.img_size, det.img_size, 3),
                      generator=gen, dtype=torch.uint8).cuda()
    specs, fm = det.spec.yolo_specs, det.field_major_heads
    heads = det.heads(x)
    _, idx, valid = select_candidates(heads, specs, cs.CONF, 512,
                                      det.approx_top_k, fm)
    boxes, _ = decode_candidates(heads, specs, idx, valid, fm)
    return boxes, valid


def _run_c(torch, cs, c_fns, turns, cases):
    for name, boxes, cls, valid, thr in cases:
        want = c_fns[0][1](boxes, cls, valid, thr)
        for n, f in c_fns[1:]:
            if not torch.equal(f(boxes, cls, valid, thr), want):
                raise AssertionError(f"nms_greedy {n} differs: {name}")
        line, t = turns(c_fns, lambda f: f(boxes, cls, valid, thr))
        p_near = cs.live_pairs(torch, boxes, cls, thr)[0]
        # boxes, classes, valid in, keep out
        row_bytes = 22 + (0 if cls is None else 4)
        bnd = cs.bound(p_near * cs.pair_ops("kill_rec", "green"),
                       boxes.shape[0] * boxes.shape[1] * row_bytes)
        print(f"ac_ab nms_greedy {name}: equal, {int(want.sum())} kept; "
              f"{line}; {p_near} near pairs, bound {bnd['bound_ms']:.5f} ms "
              f"({bnd['bound_by']}) [{cs.card_line()}]", flush=True)


if __name__ == "__main__":
    sys.exit(main())
