"""Darknet network from a parsed cfg: layer specs, params, BN folding and the
fused inference forward as an ``nn.Module``.

Torch counterpart of ``rotate_yolov3_tpu/models/darknet.py``. The specs and
``build_network`` are the same static description of the cfg. Params differ
only in layout: conv kernels are OIHW (PyTorch's and darknet's own order)
where the JAX package keeps HWIO; activations enter and heads leave as NHWC,
the JAX package's layout, while the convolutions run on NCHW views in
``channels_last`` memory, which makes both permutes free.

Params are dicts keyed like the reference (``layer_000``...): ``kernel``
(OIHW) plus ``bn_scale``/``bn_bias`` or ``bias``; ``state`` holds
``bn_mean``/``bn_var``. ``FusedDarknet`` is the BN-folded inference forward;
``Darknet`` the trainable one (``Conv2d`` + ``BatchNorm2d`` per conv layer,
train-mode batch statistics), which reads and returns the same dicts.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.conv_epilogue import conv_epilogue

_BN_EPS = 1e-5
_BN_UPDATE = 0.1        # running = (1-u)*running + u*batch
_LEAKY_SLOPE = 0.1


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    index: int
    in_c: int
    out_c: int
    size: int
    stride: int
    bn: bool
    activation: str          # 'leaky' | 'linear' | 'relu'
    # Explicit ((top, bottom), (left, right)) spatial padding. None = the
    # darknet default k//2 symmetric padding.
    pad: Optional[Tuple[Tuple[int, int], Tuple[int, int]]] = None


@dataclasses.dataclass(frozen=True)
class RouteSpec:
    index: int
    layers: Tuple[int, ...]  # absolute source layer indices


@dataclasses.dataclass(frozen=True)
class ShortcutSpec:
    index: int
    frm: int                 # absolute source layer index


@dataclasses.dataclass(frozen=True)
class UpsampleSpec:
    index: int
    stride: int


@dataclasses.dataclass(frozen=True)
class MaxPoolSpec:
    index: int
    size: int
    stride: int


@dataclasses.dataclass(frozen=True)
class YoloSpec:
    """Static metadata of one rotated YOLO head: masked (w, h) anchors in
    net-input pixels, each replicated at every ``anchor_angles`` entry
    (radians), so ``na = len(anchors_wh) * len(anchor_angles)``."""
    index: int
    anchors_wh: Tuple[Tuple[float, float], ...]
    anchor_angles: Tuple[float, ...]
    num_classes: int
    stride: int
    ignore_thresh: float

    @property
    def na(self) -> int:
        return len(self.anchors_wh) * len(self.anchor_angles)

    @property
    def no(self) -> int:
        # x, y, w, h, theta, obj + classes
        return 6 + self.num_classes


LayerSpec = Any


@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    """Static compiled form of a Darknet cfg."""
    layers: Tuple[LayerSpec, ...]
    routs: Tuple[int, ...]         # layer indices whose outputs are cached
    img_size: int
    channels: int
    hyp: Tuple[Tuple[str, Any], ...]   # [net] block key/values

    @property
    def yolo_specs(self) -> Tuple[YoloSpec, ...]:
        return tuple(l for l in self.layers if isinstance(l, YoloSpec))

    @property
    def conv_specs(self) -> Tuple[ConvSpec, ...]:
        return tuple(l for l in self.layers if isinstance(l, ConvSpec))


def build_network(module_defs: Sequence[Dict[str, Any]],
                  img_size: Optional[int] = None) -> NetworkSpec:
    """Compile parsed cfg blocks into a static NetworkSpec: per-layer output
    channels, absolute route/shortcut sources, cached layers and each
    layer's cumulative stride (so head strides are known statically)."""
    net = module_defs[0]
    assert net["type"] in ("net", "network")
    if img_size is None:
        img_size = int(net.get("width", 416))
    channels = int(net.get("channels", 3))

    layer_defs = module_defs[1:]
    specs: List[LayerSpec] = []
    out_c: List[int] = []      # output channels per layer
    strides: List[int] = []    # cumulative downsample factor per layer
    routs: set = set()

    for i, mdef in enumerate(layer_defs):
        t = mdef["type"]
        prev_c = out_c[i - 1] if i > 0 else channels
        prev_s = strides[i - 1] if i > 0 else 1
        if t == "convolutional":
            stride = int(mdef.get("stride", 1))
            specs.append(ConvSpec(
                index=i, in_c=prev_c, out_c=int(mdef["filters"]),
                size=int(mdef["size"]), stride=stride,
                bn=bool(mdef.get("batch_normalize", 0)),
                activation=str(mdef.get("activation", "linear"))))
            out_c.append(int(mdef["filters"]))
            strides.append(prev_s * stride)
        elif t == "maxpool":
            stride = int(mdef.get("stride", 1))
            specs.append(MaxPoolSpec(index=i, size=int(mdef["size"]),
                                     stride=stride))
            out_c.append(prev_c)
            strides.append(prev_s * stride)
        elif t == "upsample":
            stride = int(mdef.get("stride", 2))
            specs.append(UpsampleSpec(index=i, stride=stride))
            out_c.append(prev_c)
            assert prev_s % stride == 0, "upsample below stride 1"
            strides.append(prev_s // stride)
        elif t == "route":
            abs_layers = tuple(l if l >= 0 else i + l for l in mdef["layers"])
            for l in abs_layers:
                if not (0 <= l < i):
                    raise ValueError(f"route {i}: bad source layer {l}")
                routs.add(l)
            specs.append(RouteSpec(index=i, layers=abs_layers))
            out_c.append(sum(out_c[l] for l in abs_layers))
            strides.append(strides[abs_layers[0]])
        elif t == "shortcut":
            frm = mdef["from"]
            frm = frm[0] if isinstance(frm, list) else frm
            frm = frm if frm >= 0 else i + frm
            if not (0 <= frm < i):
                raise ValueError(f"shortcut {i}: bad source layer {frm}")
            if out_c[frm] != prev_c:
                raise ValueError(
                    f"shortcut {i}: channel mismatch {out_c[frm]} vs {prev_c}")
            routs.add(frm)
            specs.append(ShortcutSpec(index=i, frm=frm))
            out_c.append(prev_c)
            strides.append(prev_s)
        elif t == "yolo":
            anchors = mdef["anchors"]
            wh_pairs = [(anchors[2 * k], anchors[2 * k + 1])
                        for k in range(len(anchors) // 2)]
            masked = tuple(tuple(wh_pairs[m]) for m in mdef["mask"])
            angles_deg = mdef.get("angles", [0.0])
            angles = tuple(math.radians(a) for a in angles_deg)
            nc = int(mdef["classes"])
            expected = len(masked) * len(angles) * (6 + nc)
            if prev_c != expected:
                raise ValueError(
                    f"yolo {i}: preceding conv has {prev_c} filters, expected "
                    f"{expected} = n_mask*n_angles*(6+classes)")
            specs.append(YoloSpec(
                index=i, anchors_wh=masked, anchor_angles=angles,
                num_classes=nc, stride=prev_s,
                ignore_thresh=float(mdef.get("ignore_thresh", 0.5))))
            out_c.append(prev_c)
            strides.append(prev_s)
        else:
            raise ValueError(f"unsupported layer type [{t}] at {i}")

    hyp = tuple(sorted((k, v if not isinstance(v, list) else tuple(v))
                       for k, v in net.items() if k != "type"))
    return NetworkSpec(layers=tuple(specs), routs=tuple(sorted(routs)),
                       img_size=img_size, channels=channels, hyp=hyp)


def layer_key(i: int) -> str:
    return f"layer_{i:03d}"


def init_params(spec: NetworkSpec, seed: int = 0
                ) -> Tuple[Dict[str, Dict[str, torch.Tensor]],
                           Dict[str, Dict[str, torch.Tensor]]]:
    """f32 (params, state) for a NetworkSpec, on the CPU: He-uniform fan-in
    kernels drawn from a ``torch.Generator`` seeded with ``seed``, BN at
    identity, running stats at (0, 1). The draws differ from the JAX
    package's for the same seed; tests share weights through ``.weights``
    files or ``weights_io.params_from_numpy``."""
    gen = torch.Generator().manual_seed(seed)
    params: Dict[str, Dict[str, torch.Tensor]] = {}
    state: Dict[str, Dict[str, torch.Tensor]] = {}
    for layer in spec.conv_specs:
        bound = 1.0 / math.sqrt(layer.in_c * layer.size * layer.size)
        kernel = torch.empty(layer.out_c, layer.in_c, layer.size,
                             layer.size).uniform_(-bound, bound,
                                                  generator=gen)
        p = {"kernel": kernel}
        if layer.bn:
            p["bn_scale"] = torch.ones(layer.out_c)
            p["bn_bias"] = torch.zeros(layer.out_c)
            state[layer_key(layer.index)] = {
                "bn_mean": torch.zeros(layer.out_c),
                "bn_var": torch.ones(layer.out_c),
            }
        else:
            p["bias"] = torch.zeros(layer.out_c)
        params[layer_key(layer.index)] = p
    return params, state


def fuse_bn(spec: NetworkSpec, params: Dict, state: Dict) -> Dict:
    """Fold BN into conv kernel/bias for inference:
    kernel' = kernel · γ/√(var+ε) (per output channel, dim 0 of OIHW),
    bias' = β − mean · γ/√(var+ε)."""
    fused: Dict[str, Dict[str, torch.Tensor]] = {}
    for layer in spec.conv_specs:
        key = layer_key(layer.index)
        p = params[key]
        if layer.bn:
            s = state[key]
            inv = p["bn_scale"] / torch.sqrt(s["bn_var"].float() + _BN_EPS)
            fused[key] = {
                "kernel": p["kernel"] * inv[:, None, None, None],
                "bias": p["bn_bias"] - s["bn_mean"] * inv,
            }
        else:
            fused[key] = {"kernel": p["kernel"], "bias": p["bias"]}
    return fused


def _same_pads(size: int, stride: int, n: int) -> Tuple[int, int]:
    """XLA "SAME" window padding (low, high) along one axis of length n."""
    out = -(-n // stride)
    total = max((out - 1) * stride + size - n, 0)
    return total // 2, total - total // 2


def _maxpool(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    # "SAME" padding with -inf, as the reference's reduce_window; it can be
    # asymmetric (size 2 stride 1 pads (0, 1)), which MaxPool2d's padding
    # argument cannot express
    ph = _same_pads(size, stride, x.shape[2])
    pw = _same_pads(size, stride, x.shape[3])
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, size, stride)


def _activate(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "leaky":
        return F.leaky_relu(x, _LEAKY_SLOPE)
    if activation == "relu":
        return F.relu(x)
    if activation == "linear":
        return x
    raise ValueError(f"unknown activation {activation}")


def _fused_shortcuts(spec: NetworkSpec) -> Dict[int, ShortcutSpec]:
    """conv layer index -> the [shortcut] right after it, for every conv
    layer whose own output is not cached: only the sum is ever read."""
    return {conv.index: sc for conv, sc in zip(spec.layers, spec.layers[1:])
            if isinstance(conv, ConvSpec) and isinstance(sc, ShortcutSpec)
            and conv.index not in spec.routs}


def _walk(spec: NetworkSpec, x: torch.Tensor, conv, *,
          conv_shortcut=None) -> List[torch.Tensor]:
    """The network walk on an NCHW ``x``: ``conv(layer, x)`` runs one conv
    layer (conv, BN or bias, activation); shortcuts, routes, upsamples and
    max-pools are the same in every forward. Returns the head maps as
    (B, H, W, na·no) views, in YOLO-layer order.

    With ``conv_shortcut``, a conv layer of ``_fused_shortcuts`` runs as
    ``conv_shortcut(layer, x, residual)``: the conv layer, then + the
    cached ``residual`` of the [shortcut] after it, whose output it stands
    for. Cached tensors are only read."""
    cache: Dict[int, torch.Tensor] = {}
    heads: List[torch.Tensor] = []
    routs = set(spec.routs)
    fused = _fused_shortcuts(spec) if conv_shortcut is not None else {}
    added = {sc.index for sc in fused.values()}
    for layer in spec.layers:
        i = layer.index
        if isinstance(layer, ConvSpec):
            if i in fused:
                x = conv_shortcut(layer, x, cache[fused[i].frm])
            else:
                x = conv(layer, x)
        elif isinstance(layer, ShortcutSpec):
            if i not in added:
                x = x + cache[layer.frm]
        elif isinstance(layer, RouteSpec):
            if len(layer.layers) == 1:
                x = cache[layer.layers[0]]
            else:
                x = torch.cat([cache[l] for l in layer.layers], dim=1)
        elif isinstance(layer, UpsampleSpec):
            x = F.interpolate(x, scale_factor=layer.stride, mode="nearest")
        elif isinstance(layer, MaxPoolSpec):
            x = _maxpool(x, layer.size, layer.stride)
        elif isinstance(layer, YoloSpec):
            heads.append(x.permute(0, 2, 3, 1))
        if i in routs:
            cache[i] = x
    return heads


def _conv2d(layer: ConvSpec, x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor]) -> torch.Tensor:
    """One convolution with the layer's padding. An explicit pad
    ((top, bottom), (left, right)) runs as the symmetric (top, left) pad of
    the convolution itself wherever that reads the same windows: the
    windows start at the same rows, and any the symmetric pad adds at the
    end are dropped (conv1' of the packed stem: (1, 0)); a window the
    larger end pad would add (conv0': (1, 2)) ends on a row the symmetric
    pad also zeroes when the input is even, so none is lost. Otherwise
    the input is padded first (``F.pad``, one more pass over it). For
    conv1' the dropped row and column beat the ``F.pad`` on an H100
    (``chip_smoke.py`` phase 15, PERF.md)."""
    if layer.pad is None:
        return F.conv2d(x, w, b, layer.stride, layer.size // 2)
    (top, bottom), (left, right) = layer.pad
    k, s = layer.size, layer.stride
    h, wd = x.shape[2], x.shape[3]
    out_h = (h + top + bottom - k) // s + 1
    out_w = (wd + left + right - k) // s + 1
    if ((h + 2 * top - k) // s + 1 >= out_h
            and (wd + 2 * left - k) // s + 1 >= out_w):
        return F.conv2d(x, w, b, s, (top, left))[:, :, :out_h, :out_w]
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, b, s)


class FusedDarknet(nn.Module):
    """Inference-only forward with BN pre-folded (see ``fuse_bn``).

    ``forward`` takes (B, H, W, C) activations in the weights' dtype and
    returns the raw head maps as (B, H, W, na·no) in YOLO-layer order. Each
    conv layer is one convolution and one ``ops.conv_epilogue`` pass, which
    also takes the add of a [shortcut] right after the layer
    (``_fused_shortcuts``). Kernels and biases are read from
    ``self.kernels`` and ``self.biases`` at every call.
    """

    def __init__(self, spec: NetworkSpec, fused: Dict[str, Dict]):
        super().__init__()
        self.spec = spec
        self.kernels = nn.ParameterDict()
        self.biases = nn.ParameterDict()
        for layer in spec.conv_specs:
            key = layer_key(layer.index)
            # copies: the module never shares storage with the dicts given
            # (a trainer's live tensors, for one)
            self.kernels[key] = nn.Parameter(
                fused[key]["kernel"].clone(memory_format=torch.channels_last),
                requires_grad=False)
            self.biases[key] = nn.Parameter(fused[key]["bias"].clone(),
                                            requires_grad=False)

    def _conv(self, layer: ConvSpec, x: torch.Tensor) -> torch.Tensor:
        return self._conv_shortcut(layer, x, None)

    def _conv_shortcut(self, layer: ConvSpec, x: torch.Tensor,
                       residual: Optional[torch.Tensor]) -> torch.Tensor:
        """One conv layer: the convolution without its bias, then bias,
        activation and (given a ``residual``) the shortcut add in one
        ``conv_epilogue`` pass, in place on the convolution's output."""
        key = layer_key(layer.index)
        y = _conv2d(layer, x, self.kernels[key], None)
        if not y.is_contiguous(memory_format=torch.channels_last):
            # a sliced output (the packed stem's conv1')
            y = y.contiguous(memory_format=torch.channels_last)
        return conv_epilogue(y, self.biases[key], layer.activation, residual,
                             _LEAKY_SLOPE)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        # NCHW view, channels_last memory
        return _walk(self.spec, x.permute(0, 3, 1, 2), self._conv,
                     conv_shortcut=self._conv_shortcut)


class _AllReduceSum(torch.autograd.Function):
    """Sum of ``x`` over the ranks of ``group``, differentiable: the
    gradient of the sum with respect to each rank's ``x`` is the sum of
    every rank's incoming gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _sync_batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d,
                     group) -> torch.Tensor:
    """Train-mode BN over the batch of every rank of ``group``, as the
    reference's sync BN (``rotate_yolov3_tpu/models/darknet.py:302-327``):
    the f32 moments mean and E[x²] of this rank's slice are averaged across
    the ranks (the raw moments, not per-rank variances, which would miss
    the spread of the per-rank means), ``var = E[x²] - mean²`` normalises,
    and ``running_var`` takes the unbiased n/(n-1) variance over the global
    element count. The affine runs in the compute dtype with f32
    per-channel scalars, as the reference's train path."""
    world = dist.get_world_size(group)
    mean = x.mean((0, 2, 3), dtype=torch.float32)
    msq = x.square().mean((0, 2, 3), dtype=torch.float32)
    moments = _AllReduceSum.apply(torch.stack([mean, msq]), group) / world
    mean, msq = moments[0], moments[1]
    var = msq - mean.square()
    n = float(x.numel() // x.shape[1] * world)
    u = bn.momentum
    with torch.no_grad():
        bn.running_mean.copy_((1 - u) * bn.running_mean + u * mean)
        bn.running_var.copy_((1 - u) * bn.running_var
                             + u * (var * (n / max(n - 1.0, 1.0))))
    inv = torch.rsqrt(var + bn.eps) * bn.weight
    shift = bn.bias - mean * inv
    return (x * inv.to(x.dtype)[None, :, None, None]
            + shift.to(x.dtype)[None, :, None, None])


class Darknet(nn.Module):
    """The trainable network: per conv layer an ``nn.Conv2d`` (bias only
    without BN) and, with BN, an ``nn.BatchNorm2d(momentum=0.1, eps=1e-5)``
    — the reference's train-mode BN: normalisation by the biased batch
    variance, running variance updated with the unbiased one. Parameters
    are f32 masters in ``channels_last`` memory.

    ``forward`` takes (B, H, W, C) float images and returns the raw head
    maps (B, H, W, na·no), anchor-major channels (the loss's layout), in
    ``compute_dtype``. With bfloat16 each kernel (and bias) is cast to
    bfloat16 inside its conv, as the reference casts
    (``rotate_yolov3_tpu/models/darknet.py:298``)
    — explicit casts, no autocast; BN runs as ``F.batch_norm`` on the
    bfloat16 conv output with the f32 parameters and statistics: batch
    statistics and the affine in f32 inside the op, the output rounded
    once to bfloat16, where the reference applies the affine in bfloat16
    with f32-computed scalars (within one bfloat16 rounding of it).

    ``forward(x, process_group)`` with a process group of data-parallel
    ranks runs train-mode BN as sync BN over every rank's batch
    (``_sync_batch_norm``); without one, BN is ``F.batch_norm`` on this
    process's batch.

    ``params_state()`` returns the ``layer_key`` (params, state) dicts of
    the current weights (detached views), which ``fuse_bn``,
    ``Detector.refresh_params`` and the checkpoint writers take.
    """

    def __init__(self, spec: NetworkSpec, params: Dict, state: Dict,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spec = spec
        self.compute_dtype = compute_dtype
        self.convs = nn.ModuleDict()
        self.bns = nn.ModuleDict()
        for layer in spec.conv_specs:
            key = layer_key(layer.index)
            self.convs[key] = nn.Conv2d(layer.in_c, layer.out_c, layer.size,
                                        layer.stride, bias=not layer.bn)
            if layer.bn:
                self.bns[key] = nn.BatchNorm2d(layer.out_c, eps=_BN_EPS,
                                               momentum=_BN_UPDATE)
        with torch.no_grad():
            for key, conv in self.convs.items():
                conv.weight.copy_(params[key]["kernel"])
                if key in self.bns:
                    bn = self.bns[key]
                    bn.weight.copy_(params[key]["bn_scale"])
                    bn.bias.copy_(params[key]["bn_bias"])
                    bn.running_mean.copy_(state[key]["bn_mean"])
                    bn.running_var.copy_(state[key]["bn_var"])
                else:
                    conv.bias.copy_(params[key]["bias"])
        self.to(memory_format=torch.channels_last)

    def params_state(self) -> Tuple[Dict[str, Dict[str, torch.Tensor]],
                                    Dict[str, Dict[str, torch.Tensor]]]:
        """The current (params, state) as ``layer_key`` dicts of detached
        views of the module's tensors (no copies)."""
        params: Dict[str, Dict[str, torch.Tensor]] = {}
        state: Dict[str, Dict[str, torch.Tensor]] = {}
        for key, conv in self.convs.items():
            p = {"kernel": conv.weight.detach()}
            if key in self.bns:
                bn = self.bns[key]
                p["bn_scale"] = bn.weight.detach()
                p["bn_bias"] = bn.bias.detach()
                state[key] = {"bn_mean": bn.running_mean.detach(),
                              "bn_var": bn.running_var.detach()}
            else:
                p["bias"] = conv.bias.detach()
            params[key] = p
        return params, state

    def _conv(self, layer: ConvSpec, x: torch.Tensor,
              group=None) -> torch.Tensor:
        key = layer_key(layer.index)
        conv, dt = self.convs[key], self.compute_dtype
        if key in self.bns:
            bn = self.bns[key]
            x = _conv2d(layer, x, conv.weight.to(dt), None)
            if self.training and group is not None:
                x = _sync_batch_norm(x, bn, group)
            else:
                x = F.batch_norm(x, bn.running_mean, bn.running_var,
                                 bn.weight, bn.bias, self.training,
                                 bn.momentum, bn.eps)
        else:
            x = _conv2d(layer, x, conv.weight.to(dt), conv.bias.to(dt))
        return _activate(x, layer.activation)

    def forward(self, x: torch.Tensor,
                process_group=None) -> List[torch.Tensor]:
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        return _walk(self.spec, x,
                     functools.partial(self._conv, group=process_group))


def count_params(params: Dict) -> int:
    """Number of elements in a params (or state) dict of ``layer_key``
    entries."""
    return sum(int(v.numel()) for layer in params.values()
               for v in layer.values())
