"""Bias, activation and the shortcut add of one convolution in one pass: the
epilogue of the fused backbone's convolutions.

``models.darknet.FusedDarknet`` runs each convolution without its bias and
finishes the layer with ``conv_epilogue`` on the convolution's output::

    t   = round(conv + bias)
    a   = round(t > 0 ? t : t * slope)     leaky; linear: a = t;
                                           relu: max(t, 0), NaN kept
    out = round(a + residual)              where a [shortcut] follows

``round`` is to the tensor's dtype (bf16 or f32), the arithmetic f32: the
roundings of the eager ops this pass replaces. PyTorch's cuDNN convolution
applies a bias as ``output.add_(bias)`` after the convolution, then come
``F.leaky_relu`` and the walk's ``x + cache[frm]``. The two agree bit for
bit, NaN and +-inf included.

``conv_epilogue`` launches the hand-written CUDA kernel
(``csrc/conv_epilogue.cu``) on CUDA tensors, in place on the output, and
uses the plain version, ``conv_epilogue_ref`` (those eager ops), only for
tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from .. import _build

_ACTS = {"linear": 0, "leaky": 1, "relu": 2}
_MAX_CHANNELS = 12288   # the bias in 48 KB of shared memory, as f32


def conv_epilogue_ref(y: torch.Tensor, bias: torch.Tensor, activation: str,
                      residual: Optional[torch.Tensor] = None,
                      slope: float = 0.1) -> torch.Tensor:
    """Plain PyTorch version: the eager ops, the bias added in place on
    ``y`` as the convolution adds it."""
    y = y.add_(bias.view(1, -1, 1, 1))
    if activation == "leaky":
        y = F.leaky_relu(y, slope)
    elif activation == "relu":
        y = F.relu(y)
    elif activation != "linear":
        raise ValueError(f"unknown activation {activation}")
    return y if residual is None else y + residual


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("conv_epilogue").conv_epilogue_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor, activation: str,
                  residual: Optional[torch.Tensor] = None,
                  slope: float = 0.1) -> torch.Tensor:
    """Finish a convolution's (B, C, H, W) output ``y``: + ``bias`` (C,),
    ``activation`` ("leaky" with ``slope``, "linear" or "relu"), +
    ``residual`` (``y``'s shape) if given. Returns the result: ``y`` itself
    on the card, written in place.

    Equals ``conv_epilogue_ref`` bit for bit. CPU tensors take the plain
    version; CUDA tensors launch the kernel, or raise: ``y`` and
    ``residual`` must be dense channels_last, all three of one dtype
    (bfloat16 or float32) on one device.
    """
    if activation not in _ACTS:
        raise ValueError(f"unknown activation {activation}")
    res_shape = None if residual is None else tuple(residual.shape)
    if y.ndim != 4 or bias.shape != (y.shape[1],) or (
            residual is not None and res_shape != tuple(y.shape)):
        raise ValueError(f"conv_epilogue: y {tuple(y.shape)}, bias "
                         f"{tuple(bias.shape)} and residual {res_shape} are "
                         f"not (B, C, H, W), (C,) and y's shape")
    tensors = (y, bias) if residual is None else (y, bias, residual)
    if all(t.device.type == "cpu" for t in tensors):
        return conv_epilogue_ref(y, bias, activation, residual, slope)
    dev = y.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"conv_epilogue: tensors on "
                         f"{[str(t.device) for t in tensors]}; all must be "
                         f"on one CUDA device")
    if y.dtype not in (torch.bfloat16, torch.float32) or \
            any(t.dtype != y.dtype for t in tensors):
        raise TypeError(f"conv_epilogue: dtypes {[t.dtype for t in tensors]}"
                        f"; one of bfloat16 or float32")
    if not all(t.is_contiguous(memory_format=torch.channels_last)
               for t in tensors if t is not bias) or not bias.is_contiguous():
        raise ValueError("conv_epilogue: y and residual must be dense "
                         "channels_last, bias contiguous")
    if y.shape[1] > _MAX_CHANNELS:
        raise ValueError(f"conv_epilogue: {y.shape[1]} channels, the kernel "
                         f"takes at most {_MAX_CHANNELS}")
    with torch.cuda.device(dev):
        err = _launcher()(y.data_ptr(), bias.data_ptr(),
                          None if residual is None else residual.data_ptr(),
                          y.numel(), y.shape[1], y.element_size(),
                          _ACTS[activation], slope,
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_epilogue kernel launch failed: CUDA error "
                           f"{err}")
    _build.count_launch(conv_epilogue)
    return y


conv_epilogue.launches = 0
