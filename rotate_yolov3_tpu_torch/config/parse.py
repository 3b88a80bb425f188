"""Darknet ``.cfg`` / ``.data`` config parsing.

API-parity component: the reference drives model construction from Darknet
INI-ish ``.cfg`` files and dataset wiring from ``.data`` key=value files
(SURVEY.md §2 "cfg parser", `utils/parse_config.py` in the reference lineage).
This module keeps those exact file formats so original configs keep working,
and adds one rotation extension: a ``[yolo]`` block may carry an ``angles``
field (degrees) listing the anchor angle offsets; each (w, h) anchor selected
by ``mask`` is replicated at every angle, so the effective anchor count per
head is ``len(mask) * len(angles)``.

Pure Python, no JAX — everything downstream hangs off these dicts. The
port keeps its own copy of ``rotate_yolov3_tpu/config/parse.py`` because it
imports nothing of the JAX package.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

# Fields that are lists of ints / floats in darknet cfg files.
_INT_LIST_FIELDS = {"layers", "mask", "from"}
_FLOAT_LIST_FIELDS = {"anchors", "angles", "scales", "steps"}


def _convert_value(key: str, value: str) -> Any:
    """Convert a raw cfg string value to int/float/list where appropriate."""
    value = value.strip()
    if key in _INT_LIST_FIELDS:
        return [int(v) for v in value.split(",") if v.strip() != ""]
    if key in _FLOAT_LIST_FIELDS:
        return [float(v) for v in value.split(",") if v.strip() != ""]
    # scalars: try int, then float, else raw string
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    return value


def parse_model_cfg(path: str) -> List[Dict[str, Any]]:
    """Parse a Darknet model ``.cfg`` into a list of block dicts.

    The first block is ``[net]`` (training hyperparameters); subsequent blocks
    are layers (``[convolutional]``, ``[shortcut]``, ``[route]``,
    ``[upsample]``, ``[maxpool]``, ``[yolo]``). Each dict carries a ``type``
    key plus the block's key=value fields with numeric conversion.

    Mirrors the reference's ``parse_model_cfg`` contract (SURVEY.md §2).
    """
    if not path.endswith(".cfg"):
        raise ValueError(f"not a .cfg file: {path}")
    if not os.path.exists(path):
        raise FileNotFoundError(path)

    with open(path, "r") as f:
        lines = f.read().split("\n")

    module_defs: List[Dict[str, Any]] = []
    for raw in lines:
        line = raw.strip()
        if not line or line.startswith("#") or line.startswith(";"):
            continue
        if line.startswith("["):
            block_type = line[1:line.index("]")].strip()
            module_defs.append({"type": block_type})
            if block_type == "convolutional":
                # darknet default: absent batch_normalize means 0
                module_defs[-1]["batch_normalize"] = 0
        else:
            if "=" not in line:
                raise ValueError(f"malformed cfg line (no '='): {raw!r}")
            key, value = line.split("=", 1)
            key = key.strip()
            # strip trailing comments
            value = value.split("#")[0]
            module_defs[-1][key] = _convert_value(key, value)

    if not module_defs or module_defs[0]["type"] not in ("net", "network"):
        raise ValueError(f"cfg must start with a [net] block: {path}")

    _validate_blocks(module_defs)
    return module_defs


_SUPPORTED_BLOCKS = {
    "net", "network", "convolutional", "shortcut", "route", "upsample",
    "maxpool", "yolo",
}


def _validate_blocks(module_defs: List[Dict[str, Any]]) -> None:
    for i, mdef in enumerate(module_defs):
        t = mdef["type"]
        if t not in _SUPPORTED_BLOCKS:
            raise ValueError(f"unsupported block [{t}] at index {i}")
        if t == "yolo":
            if "anchors" not in mdef or "mask" not in mdef:
                raise ValueError(f"[yolo] block {i} missing anchors/mask")
            anchors = mdef["anchors"]
            if len(anchors) % 2 != 0:
                raise ValueError(f"[yolo] block {i}: odd anchor value count")
            n_wh = len(anchors) // 2
            if max(mdef["mask"]) >= n_wh:
                raise ValueError(
                    f"[yolo] block {i}: mask index {max(mdef['mask'])} out of "
                    f"range for {n_wh} anchors")


def parse_data_cfg(path: str) -> Dict[str, str]:
    """Parse a Darknet ``.data`` file (key = value per line) into a dict.

    Typical keys: ``classes``, ``train``, ``valid``, ``names``, ``backup``.
    Values stay strings except ``classes`` which is converted to int, matching
    the reference's loose contract (SURVEY.md §2 "cfg parser").
    """
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    options: Dict[str, Any] = {}
    with open(path, "r") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if "=" not in line:
                continue
            key, value = line.split("=", 1)
            options[key.strip()] = value.strip()
    if "classes" in options:
        options["classes"] = int(options["classes"])
    return options


def load_classes(names_path: str) -> List[str]:
    """Load class names from a ``.names`` file (one per line)."""
    with open(names_path, "r") as f:
        return [ln.strip() for ln in f if ln.strip()]
