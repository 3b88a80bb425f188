"""Exact polygon IoU on the host: a ctypes binding of the C++ ``polyiou``.

The DOTA merge and Task-1 evaluation run on the host, as the DOTA devkit's
C++ polyiou does; ``iou_poly`` (two quads) and ``rotated_nms`` (greedy
host NMS) are the reference binding's other entry points, with its
argument order, dtypes and return values. The source is the port's own
``polyiou.cpp`` beside this file, a byte-for-byte copy of the JAX
package's framework-free ``rotate_yolov3_tpu/native/polyiou.cpp`` (the
port reads no file of that package). ``g++`` builds it at first use into
the port's git-ignored ``_build/``, named by a hash of the source and the
flags; a missing ``g++`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from .._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "polyiou.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> Path:
    key = hashlib.sha256(SRC.read_bytes()
                         + "\0".join(GXX_FLAGS).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"libpolyiou-{key}.so"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".libpolyiou-{key}.{os.getpid()}.so"
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SRC.name} (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)
    return path


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            lib.iou_poly.restype = ctypes.c_double
            lib.iou_poly.argtypes = [ctypes.POINTER(ctypes.c_double)] * 2
            lib.rbox_iou_matrix.restype = None
            lib.rbox_iou_matrix.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                ctypes.POINTER(ctypes.c_float)]
            lib.quad_iou_matrix.restype = None
            lib.quad_iou_matrix.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                ctypes.POINTER(ctypes.c_float)]
            lib.rotated_nms.restype = ctypes.c_int
            lib.rotated_nms.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_float,
                ctypes.POINTER(ctypes.c_int)]
            _lib = lib
        return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def iou_poly(p: np.ndarray, q: np.ndarray) -> float:
    """Exact IoU of two quads, each (4, 2) or flat (8,): the DOTA devkit's
    ``polyiou.iou_poly`` contract."""
    lib = get_lib()
    p = np.ascontiguousarray(np.asarray(p, np.float64).reshape(-1))
    q = np.ascontiguousarray(np.asarray(q, np.float64).reshape(-1))
    return float(lib.iou_poly(_dptr(p), _dptr(q)))


def rbox_iou_matrix(boxes: np.ndarray) -> np.ndarray:
    """(N, 5) rotated boxes -> (N, N) exact IoU matrix."""
    lib = get_lib()
    b = np.ascontiguousarray(np.asarray(boxes, np.float32)[:, :5])
    n = len(b)
    out = np.zeros((n, n), np.float32)
    if n:
        lib.rbox_iou_matrix(_fptr(b), n, _fptr(out))
    return out


def quad_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4, 2) x (M, 4, 2) quads -> (N, M) exact IoU matrix."""
    lib = get_lib()
    a = np.ascontiguousarray(np.asarray(a, np.float64).reshape(len(a), 8))
    b = np.ascontiguousarray(np.asarray(b, np.float64).reshape(len(b), 8))
    out = np.zeros((len(a), len(b)), np.float32)
    if len(a) and len(b):
        lib.quad_iou_matrix(_dptr(a), len(a), _dptr(b), len(b), _fptr(out))
    return out


def rotated_nms(boxes: np.ndarray, scores: np.ndarray,
                iou_thr: float) -> np.ndarray:
    """Greedy rotated NMS on the host of (N, 5) boxes by descending score
    (stable order); returns the kept indices into the original order."""
    lib = get_lib()
    order = np.argsort(-np.asarray(scores), kind="stable")
    dets = np.ascontiguousarray(np.concatenate(
        [np.asarray(boxes, np.float32)[order, :5],
         np.asarray(scores, np.float32)[order, None]], axis=1))
    keep = np.zeros(len(dets), np.int32)
    n = lib.rotated_nms(_fptr(dets), len(dets), float(iou_thr),
                        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return order[keep[:n]]
