"""Checks of the reference's semantics against a checkout of it.

The port's counterpart of the repository's ``tools/verify_reference.py``,
on the port's own parser, weight loader and ``Darknet`` (no jax). Three
design decisions rest on the lineage rather than on checked code:

  (a) the ``angles=`` cfg field: whether the reference's cfgs encode anchor
      angles this way, or differently (3-tuple anchors, another key, or
      fixed in models.py);
  (b) the decode ``theta = anchor_angle + (pi/6)*tanh(t)``
      (models/yolo_head.py) and the ``.weights``/``.pt`` byte layout;
  (c) the objectness-ignore semantics (axis-aligned grid-wide ``box_iou``
      by darknet lineage, or exact rotated IoU: train/loss.py default).

Pointed at a checkout of github.com/ming71/rotate-yolov3, it (1) parses
every cfg with the port's parser and inspects the [yolo] blocks' angle
encoding, (2) loads every ``.weights``/``.pt`` into the port's model
(byte layout) and, where torch can import the reference's models.py,
prints the decoded outputs' difference on a shared random input, and (3)
greps the reference's decode and loss code for the theta
parameterisation and the ignore-mask IoU and prints the evidence beside
the port's assumptions.

``--self-test`` runs the same machinery on artifacts generated from this
repository (a cfg and a ``.weights`` round trip), so the script cannot
rot while no checkout is at hand. A ``--reference`` with no files in it
exits with code 2.

Usage:
  python -m rotate_yolov3_tpu_torch.tools.verify_reference \
      --reference path/to/rotate-yolov3
  python -m rotate_yolov3_tpu_torch.tools.verify_reference --self-test
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

OURS_THETA = "theta = anchor_angle + (pi/6) * tanh(t_theta)   [models/yolo_head.py]"
OURS_ANGLES = ("[yolo] blocks carry 'angles = a1,a2,...' (degrees); "
               "na = len(mask) * len(angles)   [config/parse.py]")
OURS_IGNORE = ("grid-wide objectness ignore uses AXIS-ALIGNED box_iou "
               "by default (--rotated-ignore for exact)   [train/loss.py]")


def section(title):
    print(f"\n=== {title} " + "=" * max(0, 60 - len(title)), flush=True)


def check_cfgs(ref):
    """(a) parse real cfgs; inspect the anchor-angle encoding."""
    from ..config.parse import parse_model_cfg

    section("cfg parsing / anchor-angle encoding")
    cfgs = sorted(glob.glob(os.path.join(ref, "**", "*.cfg"),
                            recursive=True))
    if not cfgs:
        print("NO .cfg files found — cannot verify assumption (a)")
        print(f"ours: {OURS_ANGLES}")
        return None
    ok = True
    for path in cfgs:
        try:
            blocks = parse_model_cfg(path)
        except Exception as e:
            print(f"FAIL parse {path}: {type(e).__name__}: {e}")
            ok = False
            continue
        yolos = [b for b in blocks if b["type"] == "yolo"]
        print(f"ok  {path}: {len(blocks)} blocks, {len(yolos)} yolo heads")
        for i, y in enumerate(yolos):
            anchors = y.get("anchors", [])
            mask = y.get("mask", [])
            n_anchor_vals = len(anchors) if hasattr(anchors, "__len__") else 1
            keys = sorted(set(y) - {"type"})
            print(f"    yolo[{i}] keys={keys}")
            if "angles" in y:
                print(f"    yolo[{i}] has 'angles={y['angles']}' — matches "
                      "our extension (assumption (a) CONFIRMED)")
            elif n_anchor_vals and n_anchor_vals % 3 == 0 and mask:
                print(f"    yolo[{i}] anchors have {n_anchor_vals} values — "
                      "POSSIBLE (w,h,theta) triplet encoding; our parser "
                      "assumed (w,h) pairs + separate 'angles'. REVIEW "
                      "config/parse.py + models/yolo_head.head_anchors")
            else:
                print(f"    yolo[{i}] NO angle encoding in cfg — angles "
                      "likely hard-coded in models.py (grep below); our "
                      "'angles' extension would need a default table")
    print(f"ours: {OURS_ANGLES}")
    return ok


def check_weights(ref):
    """(b1) byte-layout: load real checkpoints into our model."""
    from ..config.parse import parse_model_cfg
    from ..models.darknet import build_network, init_params
    from ..models.weights_io import load_weights_file

    section("checkpoint byte-layout")
    cfgs = sorted(glob.glob(os.path.join(ref, "**", "*.cfg"),
                            recursive=True))
    wts = sorted(glob.glob(os.path.join(ref, "**", "*.weights"),
                           recursive=True)
                 + glob.glob(os.path.join(ref, "**", "*.pt"),
                             recursive=True))
    if not wts:
        print("NO .weights/.pt files found — byte-layout unverifiable")
        return None
    if not cfgs:
        print("checkpoints exist but no cfg to build against")
        return None
    ok = True
    for w in wts:
        loaded = False
        for c in cfgs:
            try:
                spec = build_network(parse_model_cfg(c))
                params, state = init_params(spec, 0)
                _, _, meta = load_weights_file(spec, params, state, w)
                print(f"ok  {w} loads against {c} (seen={meta.seen}, "
                      f"epoch={meta.epoch})")
                loaded = True
                break
            except Exception:
                continue
        if not loaded:
            print(f"FAIL {w}: loads against no reference cfg — byte layout "
                  "or cfg arithmetic mismatch (see load_darknet_weights "
                  "shape checks for the offending layer)")
            ok = False
    return ok


def check_activations(ref):
    """(b2) per-layer activation diff vs the reference's own torch model."""
    section("activation parity vs reference torch model")
    models_py = sorted(glob.glob(os.path.join(ref, "**", "models.py"),
                                 recursive=True))
    if not models_py:
        print("reference models.py not found — activation diff skipped")
        return None
    print(f"found {models_py[0]} — attempting torch-side forward")
    try:
        import importlib.util

        import numpy as np
        import torch

        sys.path.insert(0, os.path.dirname(models_py[0]))
        spec_ = importlib.util.spec_from_file_location("ref_models",
                                                       models_py[0])
        ref_models = importlib.util.module_from_spec(spec_)
        spec_.loader.exec_module(ref_models)
        cfgs = sorted(glob.glob(os.path.join(ref, "**", "*.cfg"),
                                recursive=True))
        cfg = cfgs[0]
        tmodel = ref_models.Darknet(cfg).eval()

        from ..detector import Detector
        from ..models.weights_io import save_torch_pt

        det = Detector(cfg, conf_thres=0.0, device="cpu")
        # the port's params into the reference's model through the port's
        # .pt writer, then compare
        with tempfile.TemporaryDirectory() as td:
            pt = os.path.join(td, "x.pt")
            save_torch_pt(det.spec, det.params, det.state, pt)
            sd = torch.load(pt, map_location="cpu",
                            weights_only=False)["model"]
            tmodel.load_state_dict(sd, strict=False)
        rng = np.random.default_rng(0)
        x = rng.uniform(0, 1, (1, det.img_size, det.img_size, 3))
        with torch.no_grad():
            tout = tmodel(torch.from_numpy(
                x.transpose(0, 3, 1, 2)).float())
        out = det.predict_raw((x * 255).astype(np.uint8)).numpy()
        t = tout[0] if isinstance(tout, (list, tuple)) else tout
        d = np.abs(out - t.numpy()).max()
        print(f"decoded-output max abs diff: {d:.3e} "
              f"({'OK' if d < 1e-2 else 'INVESTIGATE — decode semantics '
                 'differ (assumption (b))'})")
        return d < 1e-2
    except Exception as e:
        print(f"torch-side forward failed ({type(e).__name__}: {e}) — "
              "fall back to the grep evidence below")
        return None


def grep_semantics(ref):
    """(b)/(c): locate the theta decode + ignore-mask IoU in reference code."""
    section("decode / ignore-mask semantics (code evidence)")
    pats = {
        "theta decode": re.compile(
            r"(tanh|sigmoid)\s*\(.*(theta|angle|ang)|"
            r"(theta|angle)\s*=.*anchor", re.I),
        "ignore mask": re.compile(
            r"ignore|iou\s*>\s*|wh_iou|box_iou|skewiou", re.I),
    }
    pys = sorted(glob.glob(os.path.join(ref, "**", "*.py"), recursive=True))
    if not pys:
        print("no reference .py files — semantics unverifiable")
        print(f"ours: {OURS_THETA}\nours: {OURS_IGNORE}")
        return None
    for name, pat in pats.items():
        print(f"-- {name} --")
        hits = 0
        for p in pys:
            if os.path.basename(p) not in ("models.py", "utils.py",
                                           "train.py"):
                continue
            try:
                for ln, line in enumerate(open(p, errors="replace"), 1):
                    if pat.search(line) and len(line) < 200:
                        print(f"  {p}:{ln}: {line.rstrip()}")
                        hits += 1
                        if hits > 20:
                            break
            except OSError:
                pass
        if not hits:
            print("  (no hits)")
    print(f"ours: {OURS_THETA}")
    print(f"ours: {OURS_IGNORE}")
    return True


def self_test():
    """Run the cfg/weights machinery against this repository's artifacts."""
    from ..config.parse import parse_model_cfg
    from ..models.darknet import build_network, init_params
    from ..models.weights_io import save_darknet_weights

    with tempfile.TemporaryDirectory() as td:
        # a stand-in "reference" tree from this repository's cfg + weights
        cfg = os.path.join(ROOT, "cfg", "yolov3-rotate-tiny.cfg")
        shutil.copy(cfg, os.path.join(td, "tiny.cfg"))
        spec = build_network(parse_model_cfg(cfg))
        params, state = init_params(spec, 0)
        save_darknet_weights(spec, params, state,
                             os.path.join(td, "tiny.weights"), seen=7)
        if check_cfgs(td) is not True:
            raise RuntimeError("self-test: the cfg check must pass on this "
                               "repository's own cfg")
        if check_weights(td) is not True:
            raise RuntimeError("self-test: the weights check must pass")
        grep_semantics(td)
    print("\nself-test OK")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reference", default="",
                    help="a checkout of the reference (ming71/rotate-yolov3)")
    ap.add_argument("--self-test", action="store_true")
    opt = ap.parse_args(argv)
    if opt.self_test:
        return self_test()
    ref = opt.reference
    n = sum(len(fs) for _, _, fs in os.walk(ref)) if os.path.isdir(ref) else 0
    print(f"reference tree: {ref} ({n} files)")
    if n == 0:
        print("EMPTY — nothing to verify. Re-run with a checkout of the "
              "reference; meanwhile --self-test keeps this script honest.")
        return 2
    results = [check_cfgs(ref), check_weights(ref), check_activations(ref),
               grep_semantics(ref)]
    section("summary")
    labels = ["cfg/angles", "weights layout", "activation parity",
              "semantics grep"]
    for lbl, r in zip(labels, results):
        print(f"{lbl:20s} {'PASS' if r else 'SKIP/UNVERIFIED' if r is None else 'FAIL'}")
    return 0 if all(r is not False for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
