"""Packed stem: an exact reparameterisation of the darknet stem.

Torch counterpart of ``rotate_yolov3_tpu/models/packed_stem.py``. The
network opens with

    conv0: 3 -> 32,  3x3, stride 1   (full resolution, 3 input channels)
    conv1: 32 -> 64, 3x3, stride 2   (downsample to half resolution)

and the packed form folds a space-to-depth (2x2 pixel blocks into
channels) into the two kernels, so no transpose is ever materialised:

  * ``conv0'``: a 4x4 stride-2 conv from the raw image straight into the
    space-to-depth layout of conv0's output. For output phase (di, dj) at
    s2d cell (i, j), conv0's 3x3 window around pixel (2i+di, 2j+dj) lies
    in the 4x4 window of rows 2i-1..2i+2, so W0's taps scattered into a
    (4·C0, C, 4, 4) kernel (zero outside the 3x3 support) give
    s2d(conv0(x)) as an ordinary convolution: 4·C0 output channels at a
    quarter of the pixels, a contraction of 48 instead of 27.
  * ``conv1'``: a 2x2 stride-1 conv on that layout. conv1's 3x3 stride-2
    window centred on (2m, 2n) spans s2d cells m-1..m, so a
    (C1, 4·C0, 2, 2) kernel with W1's taps at (u, v) = (2α-2+di,
    2β-2+dj) gives conv1's output in the standard layout: every later
    layer is untouched.

Leaky ReLU is elementwise, so it commutes with the channel permutation.
Zero padding is kept: conv0' pads (1, 2) per side, conv1' (1, 0).
Kernels are OIHW, as everywhere in the port (the JAX package keeps HWIO;
the packed kernels equal its ``pack_stem``'s after the transpose). The
packed form does 1.78× the canonical stem's multiply-adds (structural
zeros) on the same activation bytes; ``Detector`` defaults to the
canonical stem, as the reference does.

The transform applies to BN-fused inference parameters (``fuse_bn``
output) and is exact up to float reassociation; training and
``.weights``/``.pt`` IO always use the canonical spec.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from .darknet import ConvSpec, NetworkSpec, layer_key


def can_pack_stem(spec: NetworkSpec) -> bool:
    """True if the network opens with the darknet conv3x3/s1 + conv3x3/s2
    stem pattern and nothing routes to the intermediate (layer 0) output."""
    if len(spec.layers) < 2:
        return False
    l0, l1 = spec.layers[0], spec.layers[1]
    return (isinstance(l0, ConvSpec) and isinstance(l1, ConvSpec)
            and l0.size == 3 and l0.stride == 1 and l0.pad is None
            and l1.size == 3 and l1.stride == 2 and l1.pad is None
            and l0.activation == l1.activation == "leaky"
            and spec.img_size % 2 == 0
            and 0 not in spec.routs)


def _pack_conv0(w0: torch.Tensor, b0: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C0, C, 3, 3) stride-1 kernel -> (4·C0, C, 4, 4) stride-2 kernel
    whose output channel (di·2 + dj)·C0 + co is the s2d layout of conv0's
    output, phase-major."""
    c0, cin, kh, kw = w0.shape
    assert kh == kw == 3
    k = w0.new_zeros((4 * c0, cin, 4, 4))
    for di in range(2):
        for dj in range(2):
            sl = slice((di * 2 + dj) * c0, (di * 2 + dj + 1) * c0)
            # tap (ai, bi) of the 4x4 window is offset (ai-1-di, bi-1-dj)
            # from the (2i+di, 2j+dj) centre: valid for 0 <= ai-di <= 2
            k[sl, :, di:di + 3, dj:dj + 3] = w0
    return k, b0.repeat(4)


def _pack_conv1(w1: torch.Tensor) -> torch.Tensor:
    """(C1, C0, 3, 3) stride-2 kernel -> (C1, 4·C0, 2, 2) stride-1 kernel
    reading the s2d layout of ``_pack_conv0`` (the bias is unchanged)."""
    c1, c0, kh, kw = w1.shape
    assert kh == kw == 3
    k = w1.new_zeros((c1, 4 * c0, 2, 2))
    for alpha in range(2):
        for beta in range(2):
            for di in range(2):
                for dj in range(2):
                    u = 2 * alpha - 2 + di   # original row offset, -1..1
                    v = 2 * beta - 2 + dj
                    if -1 <= u <= 1 and -1 <= v <= 1:
                        sl = slice((di * 2 + dj) * c0,
                                   (di * 2 + dj + 1) * c0)
                        k[:, sl, alpha, beta] = w1[:, :, u + 1, v + 1]
    return k


def pack_stem(spec: NetworkSpec, fused: Dict, input_scale: float = 1.0
              ) -> Tuple[NetworkSpec, Dict]:
    """Reparameterise the stem of a BN-fused network (module docstring).

    Args:
      spec: canonical NetworkSpec whose stem matches ``can_pack_stem``.
      fused: ``fuse_bn`` output for ``spec`` (OIHW kernels, any device).
      input_scale: folded into the first kernel by an f32 multiply before
        packing, as the reference does — 1/255 absorbs the uint8 image
        normalisation, and the caller feeds raw 0..255 values.
    Returns:
      (packed_spec, packed_fused): the same layer-1 output up to float
      reassociation, on the device of ``fused``; the entries of layers 2
      and later are shared, not copied.
    """
    if not can_pack_stem(spec):
        raise ValueError("the network's stem does not match the packed form")
    l0, l1 = spec.layers[0], spec.layers[1]
    e0, e1 = fused[layer_key(0)], fused[layer_key(1)]
    k0, b0 = _pack_conv0(e0["kernel"].float() * input_scale,
                         e0["bias"].float())
    k1 = _pack_conv1(e1["kernel"].float())

    new_l0 = ConvSpec(index=0, in_c=l0.in_c, out_c=4 * l0.out_c, size=4,
                      stride=2, bn=False, activation=l0.activation,
                      pad=((1, 2), (1, 2)))
    new_l1 = ConvSpec(index=1, in_c=4 * l0.out_c, out_c=l1.out_c, size=2,
                      stride=1, bn=False, activation=l1.activation,
                      pad=((1, 0), (1, 0)))
    packed_spec = dataclasses.replace(
        spec, layers=(new_l0, new_l1) + spec.layers[2:])
    packed = dict(fused)
    packed[layer_key(0)] = {"kernel": k0, "bias": b0}
    packed[layer_key(1)] = {"kernel": k1, "bias": e1["bias"].float()}
    return packed_spec, packed
