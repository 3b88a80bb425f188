#!/usr/bin/env python3
"""Kernel B (the skew-IoU kill mask) of this checkout against kernel B built
from other source trees, on one CUDA card, on chip_smoke.py's phase-3 inputs:
the same seeded layouts (uniform, clustered, all-overlap), shapes and pair
algos, without and with 15 classes.

    python3 tools/kill_ab.py OTHER_CSRC [OTHER_CSRC ...]

Each OTHER_CSRC holds a ``skew_kill.cu`` and its headers (for example the
``rotate_yolov3_tpu_torch/csrc`` of an earlier commit, unpacked with ``git
archive``) whose ``skew_kill_launch`` has this checkout's C signature. All are
built with the flags of ``rotate_yolov3_tpu_torch/_build.py``. Per case: every
mask must equal this checkout's bit for bit; device time (torch.profiler, in
turns this checkout, the others, then back in reverse order, each the mean of
its two turns) beside the bound chip_smoke.py computes. Prints one line per
case and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_other(_build, csrc: str, n: int) -> ctypes.CDLL:
    """Kernel B of ``csrc`` as a loaded launch function."""
    out = os.path.join(str(_build.BUILD_DIR), f"libskew_kill_ab{n}.so")
    os.makedirs(str(_build.BUILD_DIR), exist_ok=True)
    proc = subprocess.run([_build.nvcc(), *_build.flags("skew_kill"), "-I",
                           csrc, "-o", out,
                           os.path.join(csrc, "skew_kill.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {csrc}/skew_kill.cu:\n"
                           f"{proc.stdout}{proc.stderr}")
    print(f"{csrc}/skew_kill.cu: " + " | ".join(
        l.strip() for l in (proc.stdout + proc.stderr).splitlines()
        if "registers" in l or "spill" in l), flush=True)
    return typed(ctypes.CDLL(out).skew_kill_launch)


def typed(fn):
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
        + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from rotate_yolov3_tpu_torch import _build
    from rotate_yolov3_tpu_torch.ops.skew_iou_cuda import ALGOS, check_algo

    if not torch.cuda.is_available():
        print("kill_ab: no CUDA device is available", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card, flush=True)
    others = [os.path.abspath(p) for p in sys.argv[1:]]
    fns = [typed(_build.load("skew_kill").skew_kill_launch)]
    fns += [build_other(_build, p, n) for n, p in enumerate(others)]
    for name, (_, report) in _build.BUILD_LOG.items():
        print(f"this checkout's {name}.cu: " + " | ".join(
            l.strip() for l in report.splitlines()
            if "registers" in l or "spill" in l), flush=True)
    cs.count_pair_ops(_build)
    names = ["this"] + [f"other{n}" for n in range(len(others))]
    for name, path in zip(names[1:], others):
        print(f"{name} = {path}", flush=True)

    def call(fn, boxes, cls, algo):
        b, k = boxes.shape[:2]
        out = torch.empty((b, k, k), dtype=torch.int8, device=boxes.device)
        err = fn(boxes.data_ptr(), None if cls is None else cls.data_ptr(),
                 out.data_ptr(), b, k, cs.THR, 1.0 + cs.THR, check_algo(algo),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"skew_kill launch failed: {err}")
        return out

    gen = torch.Generator(device="cuda").manual_seed(2)   # as phase 3
    for layout in cs.KILL_LAYOUTS:
        for b, k in cs.KILL_SHAPES:
            boxes = cs.kill_layout(torch, gen, layout, b, k)
            cls = torch.randint(0, 15, (b, k), generator=gen, device="cuda",
                                dtype=torch.int32)
            for cls_id in (None, cls):
                tag = "cls" if cls_id is not None else "no-cls"
                p_near, p_all = cs.live_pairs(torch, boxes, cls_id)
                nbytes = b * k * (20 + (4 if cls_id is not None else 0) + k)
                for algo in ALGOS:
                    runs = [lambda fn=fn: call(fn, boxes, cls_id, algo)
                            for fn in fns]
                    want = runs[0]()
                    for name, run in zip(names[1:], runs[1:]):
                        if not torch.equal(run(), want):
                            raise AssertionError(
                                f"{algo} {layout} {tag} B={b} K={k}: {name} "
                                f"differs from this checkout")
                    order = list(range(len(runs)))
                    t = [0.0] * len(runs)
                    for i in order + order[::-1]:
                        t[i] += cs.device_ms(torch, runs[i]) / 2
                    flops = cs.PAIR_OPS[("kill_rec", algo)][0]
                    bnd = cs.bound(p_near * flops, nbytes)["bound_ms"]
                    print(f"kill_ab {algo} {layout} {tag} B={b} K={k}: equal; "
                          + ", ".join(f"{n} {x:.4f} ms ({100 * bnd / x:.1f}%"
                                      f" of the bound)"
                                      for n, x in zip(names, t))
                          + f"; P_near/P_all {p_near / p_all:.4f}; bound "
                          f"{bnd:.5f} ms [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
