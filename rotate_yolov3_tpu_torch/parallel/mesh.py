"""Data parallelism over several devices: the device list, the process
group, the rank launcher and the batch split.

Counterpart of ``rotate_yolov3_tpu/parallel/mesh.py``. The JAX package runs
one program over a 1-D mesh (``shard_map``): the batch is split on the
``data`` axis, parameters are replicated, gradients and sync-BN moments are
averaged with ``pmean``. Here each rank is a process of its own with its
replica of the parameters on its device, joined by a
``torch.distributed`` process group: NCCL between cards, gloo on the CPU
(the counterpart of the tests' virtual CPU mesh). The collectives are the
trainer's (``train/trainer.py``) and the network's sync BN
(``models/darknet.py``); this module sets up the processes and splits the
batch.
"""

from __future__ import annotations

import datetime
import math
import os
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

#: seconds a rank waits for the others at the group's rendezvous and in a
#: collective before it fails the run (a rank that never arrives must not
#: hang it)
GROUP_TIMEOUT_S = 60.0


def make_mesh(n: int, device="cuda") -> List[torch.device]:
    """The N devices of a data-parallel run: on ``cuda`` the first N cards
    (``ValueError`` past ``torch.cuda.device_count()``, as the reference's
    ``make_mesh`` raises past ``jax.devices()``); on ``cpu`` N replicas on
    the CPU."""
    kind = torch.device(device).type
    if n < 1:
        raise ValueError(f"requested {n} devices")
    if kind == "cpu":
        return [torch.device("cpu")] * n
    if kind != "cuda":
        raise ValueError(f"unsupported device {device!r}")
    have = torch.cuda.device_count()
    if n > have:
        raise ValueError(f"requested {n} devices, have {have} CUDA "
                         f"device(s)")
    return [torch.device("cuda", i) for i in range(n)]


def init_group(rank: int, world: int, store_dir: str,
               device: torch.device, backend: Optional[str] = None,
               timeout: float = GROUP_TIMEOUT_S) -> dist.ProcessGroup:
    """Make ``device`` this process's device (on the CPU: one thread, so
    ranks sharing a host do not oversubscribe it) and join the default
    process group of ``world`` ranks through a ``FileStore`` in
    ``store_dir`` (no TCP port to pick or clash over). ``backend`` defaults
    to "nccl" between cards and "gloo" on the CPU; gloo also takes CUDA
    tensors, staged through the host (several ranks on one card need it:
    NCCL refuses two ranks on one GPU). A collective that waits more than
    ``timeout`` seconds fails."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    return dist.group.WORLD


def shard_batch(rank: int, n: int, *tensors: torch.Tensor):
    """Rank ``rank``'s contiguous slice of each tensor's leading axis, the
    slice ``P("data")`` gives device ``rank`` of N; B must divide by N."""
    out = []
    for t in tensors:
        b = t.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by {n} devices")
        per = b // n
        out.append(t[rank * per:(rank + 1) * per])
    return tuple(out)


def _rank_main(rank: int, fn: Callable, world: int, store_dir: str,
               args: Sequence[Any]) -> None:
    out = fn(rank, world, store_dir, *args)
    path = os.path.join(store_dir, f"result{rank}.pt")
    torch.save(out, path + ".tmp")
    os.replace(path + ".tmp", path)


def launch(fn: Callable, world: int, args: Sequence[Any] = (),
           timeout: Optional[float] = None) -> List[Any]:
    """Run ``fn(rank, world, store_dir, *args)`` in ``world`` spawned
    processes and return their results in rank order (each saved with
    ``torch.save``; ``fn`` must be a module-level function of this package,
    so a child imports only what it needs). ``store_dir`` is a fresh
    temporary directory for ``init_group``. Raises if any rank fails, or
    ``TimeoutError`` (after terminating the ranks) if they are not done in
    ``timeout`` seconds (None: no limit)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="dp-") as store_dir:
        ctx = mp.start_processes(_rank_main,
                                 args=(fn, world, store_dir, tuple(args)),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = math.inf if timeout is None \
            else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, min(
                    5.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks of {fn.__name__} "
                                       f"not done in {timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
        return [torch.load(os.path.join(store_dir, f"result{r}.pt"),
                           weights_only=False) for r in range(world)]
