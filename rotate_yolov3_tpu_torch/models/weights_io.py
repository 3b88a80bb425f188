"""Darknet ``.weights`` loading, and conversion of the JAX package's params.

Torch counterpart of ``rotate_yolov3_tpu/models/weights_io.py`` (the
``.weights`` load). Byte layout: a header of 5 int32 (major, minor,
revision, seen, pad), then flat float32 parameters, conv layers in cfg
order — BN conv: beta, gamma, running mean, running var, kernel; plain conv:
bias, kernel — with kernels in OIHW order, which is the port's in-memory
layout, so no transpose is needed.

The torch ``.pt`` checkpoint load of the reference is not ported yet
(ROADMAP queue 1, item 2).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from .darknet import NetworkSpec, layer_key

_HEADER_LEN = 5


class LoadMeta(NamedTuple):
    """Checkpoint counters: ``seen`` is the darknet header's images-seen
    counter; ``epoch`` (torch-lineage ``.pt`` files) stays -1 here."""

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
    """Load a darknet ``.weights`` checkpoint; returns (params, state,
    LoadMeta)."""
    if path.endswith(".pt"):
        raise NotImplementedError(
            f"{path}: the torch .pt checkpoint load is not ported yet "
            f"(ROADMAP queue 1, item 2); convert it to .weights with the "
            f"JAX package's save_darknet_weights")
    params, state, seen = load_darknet_weights(spec, params, state, path)
    return params, state, LoadMeta(seen=seen, epoch=-1)


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
