#!/usr/bin/env python3
"""The port's benchmark on this checkout against another source tree, in
turns, on one CUDA card.

    python3 tools/bench_ab.py OTHER_TREE [--seeds 0 1] [--cells NAME ...]
                              [--controls]

OTHER_TREE is a whole checkout of the repository (for example an earlier
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists). For each seed and each cell of ``BENCHMARK.json`` (or ``--cells``)
it runs ``python -m rotate_yolov3_tpu_torch.bench --cell NAME --seed S`` in
the other tree, in this one, in this one again and in the other again, each
in its own process, and prints each run's img/s, mfu, stage ladder,
device busy share, check readings and top kernels, then each tree's mean
img/s and the change between them. ``--controls`` then runs this
checkout's bench check on each control (``--check fp8|layer|boxes``, the
first cell), each of which must give ``correct: false`` and exit 1.
Prints the card's name and power limit. Exits 1 if a run is not
``correct`` or a control passes.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("img_per_s", "mfu", "stage_backbone_ms", "stage_scores_topk_ms",
        "stage_gather_decode_ms", "stage_kill_ms", "stage_fixpoint_ms",
        "stage_rows_ms", "busy_share", "correct", "f32_head_err",
        "layer_err", "box_err", "iou_err", "band_pairs")
CONTROLS = ("fp8", "layer", "boxes")


def bench(tree: str, *args: str):
    """(exit code, last JSON line) of the bench run in ``tree``."""
    proc = subprocess.run(
        [sys.executable, "-m", "rotate_yolov3_tpu_torch.bench", *args],
        cwd=tree, capture_output=True, text=True)
    lines = [l for l in proc.stdout.splitlines() if l.startswith("{")]
    if not lines:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise RuntimeError(f"bench {args} in {tree}: no JSON line "
                           f"(exit {proc.returncode})")
    return proc.returncode, json.loads(lines[-1])


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("other")
    p.add_argument("--seeds", type=int, nargs="+", default=[0])
    p.add_argument("--cells", nargs="+", default=None)
    p.add_argument("--controls", action="store_true")
    opt = p.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = opt.cells or [w["name"] for w in json.load(f)["workloads"]]
    trees = {"other": os.path.abspath(opt.other), "this": ROOT}
    ok = True
    for seed in opt.seeds:
        for cell in cells:
            ips = {"other": [], "this": []}
            for who in ("other", "this", "this", "other"):
                rc, line = bench(trees[who], "--cell", cell, "--seed",
                                 str(seed))
                ok &= rc == 0 and line.get("correct") is True
                ips[who].append(line["img_per_s"])
                print(f"{cell} seed {seed} {who}: exit {rc}; " + ", ".join(
                    f"{k} {line.get(k)}" for k in KEYS) + "; top kernels "
                    + "; ".join(f"{100 * t['share']:.1f}% {t['name'][:60]}"
                                for t in line.get("top_kernels", [])[:6]),
                    flush=True)
            mean = {k: statistics.mean(v) for k, v in ips.items()}
            print(f"{cell} seed {seed}: img/s other {mean['other']:.2f}, "
                  f"this {mean['this']:.2f}, change "
                  f"{100 * (mean['this'] / mean['other'] - 1):+.2f}% "
                  f"[{card}]", flush=True)
    if opt.controls:
        for control in CONTROLS:
            rc, line = bench(ROOT, "--cell", cells[0], "--seed",
                             str(opt.seeds[0]), "--check", control)
            ok &= rc == 1 and line.get("correct") is False
            print(f"control {control}: exit {rc}; " + ", ".join(
                f"{k} {line.get(k)}" for k in KEYS[9:]), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
