"""Build the hand-written CUDA kernels of ``csrc/`` at first use.

Each ``csrc/<name>.cu`` exports a plain C launch function. ``nvcc`` compiles
it for Hopper (``sm_90a``) into its own shared library, which is loaded with
``ctypes``: no PyTorch headers are compiled, so a build takes seconds.
Libraries go to ``_build/`` beside this file (listed in ``.gitignore``),
named by a hash of the source, of every header in ``csrc/`` and of the
flags, so an edited source or header rebuilds and an unchanged one is
reused. Nothing here runs at import time: the
package imports, and its CPU paths run, on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# per-file flags: the skew-IoU arithmetic must not be contracted into FMAs
# (see the note at the top of csrc/skew_green.cuh), nor the conv epilogue's
# slope product into its residual add (csrc/conv_epilogue.cu)
EXTRA_FLAGS: Dict[str, Tuple[str, ...]] = {
    "skew_kill": ("-fmad=false",), "nms_greedy": ("-fmad=false",),
    "skew_iou_matrix": ("-fmad=false",), "conv_epilogue": ("-fmad=false",)}

_LIBS: Dict[str, ctypes.CDLL] = {}
# a Detector's replicas launch kernels from one thread each: the first
# build of a library and the launch counters are shared between them
_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
# name -> (build seconds, nvcc/ptxas report) for libraries built in this
# process; a library found already built is absent
BUILD_LOG: Dict[str, Tuple[float, str]] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin``, ``PATH``, then the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are compiled from "
        "rotate_yolov3_tpu_torch/csrc/ at first use on a GPU machine "
        "(set CUDA_HOME or put nvcc on PATH)")


def flags(name: str) -> Tuple[str, ...]:
    """nvcc flags of ``csrc/<name>.cu``: the common ones and its own."""
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def digest(name: str, csrc: Path = CSRC) -> str:
    """Hash naming the library of ``<csrc>/<name>.cu``: the source, every
    ``*.cuh`` header of ``csrc`` (any of them may be included) and the
    flags."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(b"\0" + header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(flags(name)).encode())
    return h.hexdigest()[:16]


def load(name: str) -> ctypes.CDLL:
    """Return the loaded library of ``csrc/<name>.cu``, building it first if
    no library for this source and these flags exists yet."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOAD_LOCK:
        lib = _LIBS.get(name)
        return lib if lib is not None else _build_and_load(name)


def _build_and_load(name: str) -> ctypes.CDLL:
    src = CSRC / f"{name}.cu"
    key = digest(name)
    path = BUILD_DIR / f"lib{name}-{key}.so"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".lib{name}-{key}.{os.getpid()}.so"
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc(), *flags(name), "-I", str(CSRC),
                               "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
        BUILD_LOG[name] = (time.perf_counter() - t0,
                           proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(path))
    _LIBS[name] = lib
    return lib


def count_launch(wrapper, algo: Optional[str] = None) -> None:
    """Add one to ``wrapper.launches`` (and to ``wrapper.algo_launches[
    algo]``), the count of launches of a kernel wrapper."""
    with _COUNT_LOCK:
        wrapper.launches += 1
        if algo is not None:
            wrapper.algo_launches[algo] += 1


def kernel_names() -> Tuple[str, ...]:
    """Names of every kernel source under ``csrc/``."""
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
