"""Device selection: the counterpart of ``rotate_yolov3_tpu/utils/device.py``
(the reference lineage's ``torch_utils.select_device`` role).

The port's entry points run on the card unless the caller asks for the
CPU; there is no silent fallback to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``: "cuda" raises without a card (no
    fallback to the CPU), and only "cuda" and "cpu" are accepted."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r}: no CUDA device is available "
            f"(use device='cpu' for the plain-PyTorch path)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def select_device(name: str = "") -> torch.device:
    """The device the port will use: '' means "cuda" (the card); any other
    name goes through ``resolve_device``, which raises for "cuda" without
    a card."""
    return resolve_device(name or "cuda")


def device_info() -> str:
    """One line naming the backend and its devices, as the reference's:
    ``backend=cuda n=<count> [<names of up to 4 cards>]``, or
    ``backend=cpu n=1 [cpu]`` without a card."""
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        names = [torch.cuda.get_device_name(i) for i in range(min(n, 4))]
        return f"backend=cuda n={n} [{', '.join(names)}]"
    return "backend=cpu n=1 [cpu]"
