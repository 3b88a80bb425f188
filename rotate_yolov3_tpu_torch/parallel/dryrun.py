"""Data-parallel train steps in spawned ranks: the multi-device dry run and
the harness that holds a data-parallel step against a one-process step.

``dryrun_multichip(n, device)`` is the port's twin of the repository's
``__graft_entry__.dryrun_multichip``: the tiny cfg at 64², one image per
rank, on-device augmentation on, one step; the loss must be finite and the
step count 1.

``dp_train_steps`` runs given batches through the data-parallel step on N
ranks from given weights and returns what each rank saw: the heads of one
train-mode forward (sync BN) with the BN statistics it left, and then the
metrics of every step with the final parameters and BN state. The tests
(CPU, gloo) and ``chip_smoke.py`` (the card) compare them with a
one-process run.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config.hyp import Hyp
from ..config.parse import parse_model_cfg
from ..models.darknet import Darknet, build_network, init_params
from ..train.schedule import darknet_schedule
from ..train.trainer import init_train_state, make_train_step
from .mesh import init_group, launch, make_mesh, shard_batch

#: learning rate of ``dp_train_steps`` (constant: no burn-in)
DP_LR = 1e-2
TINY_CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "cfg", "yolov3-rotate-tiny.cfg")


def _to_cpu(tree: Dict) -> Dict:
    return {k: {n: t.detach().cpu().clone() for n, t in d.items()}
            for k, d in tree.items()}


def _dp_rank(rank: int, world: int, store_dir: str, job: Dict) -> Dict:
    device = job["devices"][rank]
    group = init_group(rank, world, store_dir, device, job["backend"])
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        spec = build_network(parse_model_cfg(job["cfg"]),
                             img_size=job["img_size"])
        hyp = Hyp()
        batches = [tuple(torch.as_tensor(np.asarray(a)).to(device)
                         for a in shard_batch(rank, world, *b))
                   for b in job["batches"]]
        out: Dict = {}
        params, state = ({k: {n: torch.from_numpy(a) for n, a in d.items()}
                          for k, d in tree.items()}
                         for tree in (job["params"], job["state"]))
        if job["forward"]:
            net = Darknet(spec, params, state).to(device)
            net.train()
            with torch.no_grad():
                heads = net(batches[0][0].to(torch.float32) / 255.0, group)
            out["heads"] = [h.cpu() for h in heads]
            out["bn_state"] = _to_cpu(net.params_state()[1])
        ts = init_train_state(spec, params, state,
                              darknet_schedule(DP_LR, burn_in=1),
                              momentum=0.9, weight_decay=5e-4, device=device)
        step = make_train_step(spec, hyp, process_group=group)
        out["metrics"] = [{k: float(v) for k, v in step(ts, *b).items()}
                          for b in batches]
        out["step"] = ts.step
        out["params"], out["state"] = (_to_cpu(t)
                                       for t in ts.net.params_state())
        return out
    finally:
        dist.destroy_process_group()


def dp_train_steps(devices: Sequence[torch.device], cfg: str,
                   img_size: int, params: Dict, state: Dict,
                   batches: Sequence, backend: Optional[str] = None,
                   forward: bool = False, timeout: float = 600.0
                   ) -> List[Dict]:
    """Run each global batch ``(imgs, targets, valid)`` (numpy arrays or CPU
    tensors) of ``batches`` through one f32 data-parallel train step (TF32
    off) on ``len(devices)`` ranks, rank r on ``devices[r]`` with its
    contiguous slice, from (``params``, ``state``), SGD at the constant
    ``DP_LR`` (momentum 0.9, weight decay 5e-4). ``backend``: see
    ``mesh.init_group``. With ``forward``, each rank first runs one
    train-mode forward of the first batch from the same weights. Returns
    per rank a dict: "metrics" (one dict of floats per step), "step",
    "params" and "state" (CPU tensors) and, with ``forward``, "heads" and
    "bn_state"."""
    # numpy, not tensors: tensors would reach the ranks through shared
    # memory, which a container may hold too little of for Darknet-53
    params, state = ({k: {n: t.cpu().numpy() for n, t in d.items()}
                      for k, d in tree.items()} for tree in (params, state))
    job = dict(devices=list(devices), backend=backend, cfg=cfg,
               img_size=img_size, params=params, state=state,
               batches=[tuple(np.asarray(a) for a in b) for b in batches],
               forward=forward)
    return launch(_dp_rank, len(devices), (job,), timeout=timeout)


def _dryrun_rank(rank: int, world: int, store_dir: str,
                 devices: Sequence[torch.device]) -> Dict:
    device = devices[rank]
    group = init_group(rank, world, store_dir, device)
    try:
        img = 64
        spec = build_network(parse_model_cfg(TINY_CFG), img_size=img)
        params, state = init_params(spec, seed=0)
        ts = init_train_state(spec, params, state,
                              darknet_schedule(1e-3, burn_in=10),
                              device=device)
        step = make_train_step(spec, Hyp(), process_group=group,
                               device_aug=True)
        rng = np.random.default_rng(0)
        b = world                       # one image per rank
        imgs = rng.integers(0, 255, (b, img, img, 3)).astype(np.uint8)
        tgts = np.zeros((b, 8, 6), np.float32)
        tgts[:, 0] = [0, 0.5, 0.5, 0.3, 0.15, 0.3]
        valid = np.zeros((b, 8), bool)
        valid[:, 0] = True
        batch = shard_batch(rank, world, *(torch.from_numpy(a)
                                           for a in (imgs, tgts, valid)))
        metrics = step(ts, *(t.to(device) for t in batch))
        return {"total": float(metrics["total"]), "step": ts.step}
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int, device="cuda", timeout: float = 300.0
                     ) -> float:
    """One data-parallel train step with on-device augmentation on ``n``
    ranks (``make_mesh(n, device)``: NCCL on cards, gloo on the CPU);
    raises unless every rank's loss is finite and its step count 1.
    Returns the loss."""
    out = launch(_dryrun_rank, n, (make_mesh(n, device),), timeout=timeout)
    total = out[0]["total"]
    if not all(math.isfinite(o["total"]) and o["total"] == total
               and o["step"] == 1 for o in out):
        raise AssertionError(f"dryrun_multichip({n}, {device!r}): {out}")
    print(f"dryrun_multichip({n}, {device!r}): OK, loss={total:.4f}")
    return total
