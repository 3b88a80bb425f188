"""Checkpoint interchange: darknet ``.weights`` and reference-lineage
``.pt`` files, and conversion of the JAX package's params.

Torch counterpart of ``rotate_yolov3_tpu/models/weights_io.py``.

``.weights`` byte layout: a header of 5 int32 (major, minor, revision,
seen, pad), then flat float32 parameters, conv layers in cfg order — BN
conv: beta, gamma, running mean, running var, kernel; plain conv: bias,
kernel — with kernels in OIHW order, which is the port's in-memory layout,
so no transpose is needed.

``.pt``: the reference lineage's ``torch.save({'model': state_dict,
'epoch': ...})`` checkpoint. ``load_torch_pt`` maps the state_dict onto the
params by module order (conv weight, then BN gamma/beta/mean/var or conv
bias), so any key-naming vintage of the lineage loads; ``save_torch_pt``
writes the JAX package's wrapper and key names.
"""

from __future__ import annotations

import collections
import os
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from .darknet import NetworkSpec, layer_key

_HEADER_LEN = 5


class LoadMeta(NamedTuple):
    """Checkpoint counters: ``seen`` is the darknet header's images-seen
    counter (a ``.pt`` file has none: 0), ``epoch`` the torch-lineage
    checkpoint's epoch index (a ``.weights`` file has none: -1)."""

    seen: int = 0
    epoch: int = -1


def load_darknet_weights(spec: NetworkSpec, params: Dict, state: Dict,
                         path: str) -> Tuple[Dict, Dict, int]:
    """Load a .weights file into (params, state) dicts shaped like
    ``init_params``'s; returns new dicts plus the header's ``seen``.
    Loading stops cleanly at EOF on a conv-layer boundary (backbone-only
    files); a file that ends mid-layer or has floats left over raises."""
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype=np.int32, count=_HEADER_LEN)
        if len(header) != _HEADER_LEN:
            raise ValueError(f"truncated .weights header in {path}")
        seen = int(header[3])
        flat = np.fromfile(f, dtype=np.float32)

    new_params = {k: dict(v) for k, v in params.items()}
    new_state = {k: dict(v) for k, v in state.items()}
    ptr = 0

    def take(n: int) -> torch.Tensor:
        nonlocal ptr
        if ptr + n > len(flat):
            raise EOFError
        out = torch.from_numpy(flat[ptr:ptr + n].copy())
        ptr += n
        return out

    for layer in spec.conv_specs:
        key = layer_key(layer.index)
        oc = layer.out_c
        shape = (oc, layer.in_c, layer.size, layer.size)
        start_ptr = ptr
        try:
            if layer.bn:
                new_params[key]["bn_bias"] = take(oc)
                new_params[key]["bn_scale"] = take(oc)
                new_state[key]["bn_mean"] = take(oc)
                new_state[key]["bn_var"] = take(oc)
            else:
                new_params[key]["bias"] = take(oc)
            new_params[key]["kernel"] = take(int(np.prod(shape))).reshape(
                shape)
        except EOFError:
            if start_ptr == len(flat):
                break   # clean partial load (pretrained-backbone file)
            raise ValueError(
                f"{path}: weights end mid-layer at conv {layer.index} "
                f"(got {len(flat)} floats, layer starts at {start_ptr})")
    else:
        if ptr != len(flat):
            raise ValueError(
                f"{path}: {len(flat) - ptr} unconsumed floats — cfg/weights "
                f"mismatch")
    return new_params, new_state, seen


def load_weights_file(spec: NetworkSpec, params: Dict, state: Dict,
                      path: str) -> Tuple[Dict, Dict, LoadMeta]:
    """Load either checkpoint flavour by extension: ``.pt`` (torch pickle,
    the reference lineage's primary format) or darknet ``.weights``.
    Returns (params, state, LoadMeta)."""
    if path.endswith(".pt"):
        params, state, epoch = load_torch_pt(spec, params, state, path)
        return params, state, LoadMeta(seen=0, epoch=epoch)
    params, state, seen = load_darknet_weights(spec, params, state, path)
    return params, state, LoadMeta(seen=seen, epoch=-1)


def load_torch_pt(spec: NetworkSpec, params: Dict, state: Dict,
                  path: str) -> Tuple[Dict, Dict, int]:
    """Load a reference-lineage ``.pt`` checkpoint into (params, state).

    Accepts the ``{'model': state_dict, 'epoch': ...}`` wrapper or a bare
    state_dict. Per BN conv the tensors appear as (conv.weight OIHW,
    bn.weight, bn.bias, bn.running_mean, bn.running_var), per plain conv as
    (conv.weight, conv.bias); ``num_batches_tracked`` buffers are skipped.
    Shapes are checked against the cfg at every step, so a mismatch fails
    with the offending layer. Returns (params, state, epoch), epoch -1 if
    absent.
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    epoch = -1
    sd = ckpt
    if isinstance(ckpt, dict) and not _looks_like_state_dict(ckpt):
        sd = ckpt.get("model", ckpt.get("state_dict"))
        if sd is None:
            raise ValueError(
                f"{path}: no 'model'/'state_dict' entry in checkpoint "
                f"(keys: {sorted(ckpt)})")
        epoch = int(ckpt.get("epoch", -1) or -1)

    it = iter([(k, v) for k, v in sd.items() if torch.is_tensor(v)
               and not k.endswith("num_batches_tracked")])

    def take(expect_shape, what, layer_idx):
        try:
            key, t = next(it)
        except StopIteration:
            raise ValueError(
                f"{path}: checkpoint ends before {what} of conv layer "
                f"{layer_idx} — cfg/checkpoint mismatch") from None
        if tuple(t.shape) != tuple(expect_shape):
            raise ValueError(
                f"{path}: {what} of conv layer {layer_idx}: expected shape "
                f"{tuple(expect_shape)}, got {tuple(t.shape)} "
                f"(state_dict key {key!r})")
        return t.detach().to(torch.float32).contiguous()

    new_params = {k: dict(v) for k, v in params.items()}
    new_state = {k: dict(v) for k, v in state.items()}
    for layer in spec.conv_specs:
        key = layer_key(layer.index)
        oc, ic, k = layer.out_c, layer.in_c, layer.size
        new_params[key]["kernel"] = take((oc, ic, k, k), "conv weight",
                                         layer.index)
        if layer.bn:
            new_params[key]["bn_scale"] = take((oc,), "bn weight (gamma)",
                                               layer.index)
            new_params[key]["bn_bias"] = take((oc,), "bn bias (beta)",
                                              layer.index)
            new_state[key]["bn_mean"] = take((oc,), "bn running_mean",
                                             layer.index)
            new_state[key]["bn_var"] = take((oc,), "bn running_var",
                                            layer.index)
        else:
            new_params[key]["bias"] = take((oc,), "conv bias", layer.index)
    leftover = list(it)
    if leftover:
        raise ValueError(
            f"{path}: {len(leftover)} unconsumed tensors after the last cfg "
            f"conv layer (first: {leftover[0][0]!r}) — cfg/checkpoint "
            f"mismatch")
    return new_params, new_state, epoch


def _looks_like_state_dict(d: Dict) -> bool:
    """Heuristic: a bare state_dict maps str -> tensor for every entry."""
    vals = list(d.values())
    return bool(vals) and all(torch.is_tensor(v) for v in vals)


def _f32_cpu(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32).contiguous()


def save_torch_pt(spec: NetworkSpec, params: Dict, state: Dict, path: str,
                  epoch: int = -1) -> None:
    """Write (params, state) as a reference-lineage ``.pt`` checkpoint: the
    wrapper ``{'epoch', 'best_fitness', 'training_results', 'model',
    'optimizer'}`` with ``module_list.{i}.{Conv2d,BatchNorm2d}.*`` keys, as
    the JAX package writes it."""
    sd = collections.OrderedDict()
    for layer in spec.conv_specs:
        key = layer_key(layer.index)
        i = layer.index
        sd[f"module_list.{i}.Conv2d.weight"] = _f32_cpu(params[key]["kernel"])
        if layer.bn:
            s = state[key]
            sd[f"module_list.{i}.BatchNorm2d.weight"] = _f32_cpu(
                params[key]["bn_scale"])
            sd[f"module_list.{i}.BatchNorm2d.bias"] = _f32_cpu(
                params[key]["bn_bias"])
            sd[f"module_list.{i}.BatchNorm2d.running_mean"] = _f32_cpu(
                s["bn_mean"])
            sd[f"module_list.{i}.BatchNorm2d.running_var"] = _f32_cpu(
                s["bn_var"])
            sd[f"module_list.{i}.BatchNorm2d.num_batches_tracked"] = (
                torch.zeros((), dtype=torch.int64))
        else:
            sd[f"module_list.{i}.Conv2d.bias"] = _f32_cpu(params[key]["bias"])
    torch.save({"epoch": epoch, "best_fitness": None,
                "training_results": None, "model": sd, "optimizer": None},
               path)


def save_darknet_weights(spec: NetworkSpec, params: Dict, state: Dict,
                         path: str, seen: int = 0) -> None:
    """Write (params, state) as a darknet ``.weights`` file (the same bytes
    as the JAX package's writer for the same values)."""
    chunks = [np.array([0, 2, 5, seen, 0], dtype=np.int32).tobytes()]
    for layer in spec.conv_specs:
        key = layer_key(layer.index)
        p = params[key]
        if layer.bn:
            s = state[key]
            arrs = (p["bn_bias"], p["bn_scale"], s["bn_mean"], s["bn_var"])
        else:
            arrs = (p["bias"],)
        for t in arrs + (p["kernel"],):
            chunks.append(_f32_cpu(t).numpy().tobytes())
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        for c in chunks:
            f.write(c)
    os.replace(tmp, path)


def params_from_numpy(params: Dict, state: Dict
                      ) -> Tuple[Dict[str, Dict[str, torch.Tensor]],
                                 Dict[str, Dict[str, torch.Tensor]]]:
    """Convert the JAX package's (params, state) pytrees, given as numpy
    arrays, into the port's: HWIO kernels become OIHW, everything else is
    copied as float32."""
    out_p: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, p in params.items():
        out_p[key] = {}
        for name, arr in p.items():
            a = np.asarray(arr, np.float32)
            if name == "kernel":
                a = np.transpose(a, (3, 2, 0, 1))        # HWIO -> OIHW
            out_p[key][name] = torch.from_numpy(np.array(a, order="C"))
    out_s = {key: {name: torch.from_numpy(np.array(arr, np.float32))
                   for name, arr in s.items()}
             for key, s in state.items()}
    return out_p, out_s
