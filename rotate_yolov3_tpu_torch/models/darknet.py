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
``bn_mean``/``bn_var``. Train-mode BN waits for the training port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

_BN_EPS = 1e-5
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


class FusedDarknet(nn.Module):
    """Inference-only forward with BN pre-folded (see ``fuse_bn``).

    ``forward`` takes (B, H, W, C) activations in the weights' dtype and
    returns the raw head maps as (B, H, W, na·no) in YOLO-layer order.
    """

    def __init__(self, spec: NetworkSpec, fused: Dict[str, Dict]):
        super().__init__()
        self.spec = spec
        self.kernels = nn.ParameterDict()
        self.biases = nn.ParameterDict()
        for layer in spec.conv_specs:
            key = layer_key(layer.index)
            self.kernels[key] = nn.Parameter(
                fused[key]["kernel"].contiguous(
                    memory_format=torch.channels_last), requires_grad=False)
            self.biases[key] = nn.Parameter(fused[key]["bias"].contiguous(),
                                            requires_grad=False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.permute(0, 3, 1, 2)          # NCHW view, channels_last memory
        cache: Dict[int, torch.Tensor] = {}
        heads: List[torch.Tensor] = []
        routs = set(self.spec.routs)
        for layer in self.spec.layers:
            i = layer.index
            if isinstance(layer, ConvSpec):
                key = layer_key(i)
                w, b = self.kernels[key], self.biases[key]
                if layer.pad is None:
                    x = F.conv2d(x, w, b, layer.stride, layer.size // 2)
                else:
                    (top, bottom), (left, right) = layer.pad
                    x = F.conv2d(F.pad(x, (left, right, top, bottom)), w, b,
                                 layer.stride)
                x = _activate(x, layer.activation)
            elif isinstance(layer, ShortcutSpec):
                x = x + cache[layer.frm]
            elif isinstance(layer, RouteSpec):
                if len(layer.layers) == 1:
                    x = cache[layer.layers[0]]
                else:
                    x = torch.cat([cache[l] for l in layer.layers], dim=1)
            elif isinstance(layer, UpsampleSpec):
                x = F.interpolate(x, scale_factor=layer.stride,
                                  mode="nearest")
            elif isinstance(layer, MaxPoolSpec):
                x = _maxpool(x, layer.size, layer.stride)
            elif isinstance(layer, YoloSpec):
                heads.append(x.permute(0, 2, 3, 1))
            if i in routs:
                cache[i] = x
        return heads
