"""Profiling, timing and model-info utilities: the counterpart of
``rotate_yolov3_tpu/utils/profiling.py``.

``time_fn`` times a call to its end on the device (a CUDA output is waited
for with ``torch.cuda.synchronize``), ``trace`` records a
``torch.profiler`` trace (Chrome / Perfetto format), and ``model_info`` /
``flops_per_image`` describe a network spec as the reference's do.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch


def _cuda_device(out) -> Optional[torch.device]:
    """The device of the first CUDA tensor in ``out`` (a tensor, or
    tuples, lists and dicts of them), or None."""
    if isinstance(out, torch.Tensor):
        return out.device if out.is_cuda else None
    items = out.values() if isinstance(out, dict) else (
        out if isinstance(out, (tuple, list)) else ())
    for item in items:
        dev = _cuda_device(item)
        if dev is not None:
            return dev
    return None


def _wait(out) -> None:
    dev = _cuda_device(out)
    if dev is not None:
        torch.cuda.synchronize(dev)


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 3
            ) -> Dict[str, float]:
    """Steady-state wall time of ``fn(*args)`` in seconds per call, each
    call waited for to its end (on the device of its first CUDA output,
    else the call itself); mean/std/min over ``iters`` after ``warmup``
    calls."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _wait(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        _wait(out)
        times.append(time.perf_counter() - t0)
    t = np.asarray(times)
    return {"mean_s": float(t.mean()), "std_s": float(t.std()),
            "min_s": float(t.min()), "iters": iters}


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Record a ``torch.profiler`` trace of the block (CPU activity, and
    CUDA where a card is present) and write it to ``log_dir`` (default:
    ``torch_trace`` under the temporary directory) as
    ``trace-<pid>-<ns>.pt.trace.json``, which Perfetto and
    ``chrome://tracing`` read. Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.pt.trace.json"))


def model_info(spec, params) -> str:
    """Layer table and parameter count of a network spec, as the
    reference's ``model_info``."""
    from ..models.darknet import ConvSpec, count_params

    lines = [f"{'idx':>4} {'type':>12} {'out_c':>6} {'size':>5} "
             f"{'stride':>6} {'params':>10}"]
    total = 0
    for layer in spec.layers:
        t = type(layer).__name__.replace("Spec", "").lower()
        if isinstance(layer, ConvSpec):
            n = layer.size * layer.size * layer.in_c * layer.out_c
            n += 2 * layer.out_c if layer.bn else layer.out_c
            total += n
            lines.append(f"{layer.index:>4} {t:>12} {layer.out_c:>6} "
                         f"{layer.size:>5} {layer.stride:>6} {n:>10}")
        else:
            lines.append(f"{layer.index:>4} {t:>12}")
    lines.append(f"total params: {total:,} "
                 f"(pytree: {count_params(params):,})")
    return "\n".join(lines)


def flops_per_image(spec) -> int:
    """Convolution FLOPs of one image (2 per multiply-add), as the
    reference counts them: each conv's output pixels at its cumulative
    stride times its kernel's multiply-adds."""
    from ..models.darknet import (ConvSpec, MaxPoolSpec, RouteSpec,
                                  UpsampleSpec)

    total = 0
    size = spec.img_size
    strides: Dict[int, int] = {}
    for layer in spec.layers:
        if isinstance(layer, ConvSpec):
            cur_stride = strides.get(layer.index - 1, 1) * layer.stride \
                if layer.index > 0 else layer.stride
            strides[layer.index] = cur_stride
            hw = (size // cur_stride) ** 2
            total += layer.size * layer.size * layer.in_c * layer.out_c * hw
        elif isinstance(layer, MaxPoolSpec):
            strides[layer.index] = strides.get(layer.index - 1, 1) \
                * layer.stride
        elif isinstance(layer, UpsampleSpec):
            strides[layer.index] = strides.get(layer.index - 1, 1) \
                // layer.stride
        elif isinstance(layer, RouteSpec):
            strides[layer.index] = strides[layer.layers[0]]
        else:
            strides[layer.index] = strides.get(layer.index - 1, 1)
    return 2 * total
