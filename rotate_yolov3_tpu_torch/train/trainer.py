"""Train step, train state and checkpoints.

Counterpart of ``rotate_yolov3_tpu/train/trainer.py``: forward (train-mode
BN), target assignment, the multi-part loss, backward, SGD update. The
reference's optimizer is ``optax.chain(add_decayed_weights(wd, mask=
kernels), sgd(lr_schedule, momentum))``:

    trace = g + wd·p + m·trace;   p -= lr(step)·trace

with ``lr`` read at the update count before the increment (0 for the first
update). ``torch.optim.SGD(momentum=m, dampening=0, nesterov=False)``
computes the same with two parameter groups — weight decay on the conv
kernels only — and each group's ``lr`` set from the schedule before every
step. ``grad_norm`` is the global norm of the raw gradients, before decay.

Data parallelism (the reference's ``make_train_step(axis_name=...)``):
every rank runs the step on its slice of the global batch with its replica
of the train state. BN is sync BN across the ranks (``models/darknet.py``),
and after the backward one all-reduce averages the gradients and the loss
terms (the reference's ``pmean`` of both), so every rank applies the same
update and ``grad_norm`` is the norm of the averaged gradients.

On-device augmentation (``device_aug``) runs ``data.augment_device`` on the
batch between the 1/255 scale and the network, as the reference does. Its
draws come from a ``torch.Generator`` on the batch's device, seeded from
(``aug_seed``, step, rank), so every step and rank augments differently and
a run is reproducible. The reference's threefry stream (``fold_in`` of the
step, then of the mesh axis index) has no PyTorch counterpart; the two
packages agree given the same draws (``tests/test_torch_port_augment_device
.py``).

A checkpoint is ``torch.save`` of the train state: the network's
parameters and BN statistics, the optimizer's momentum buffers and the
step count.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config.hyp import Hyp
from ..data.augment_device import augment_batch
from ..models.darknet import Darknet, NetworkSpec
from .loss import compute_loss


@dataclasses.dataclass
class TrainState:
    net: Darknet
    optimizer: torch.optim.SGD
    lr_schedule: Callable[[int], float]
    step: int = 0       # updates done


def make_optimizer(net: Darknet, momentum: float = 0.9,
                   weight_decay: float = 5e-4) -> torch.optim.SGD:
    """SGD + momentum, weight decay on conv kernels only (biases and BN
    exempt, the darknet convention). The ``lr`` is set per step."""
    kernels = [c.weight for c in net.convs.values()]
    kernel_ids = {id(t) for t in kernels}
    others = [t for t in net.parameters() if id(t) not in kernel_ids]
    return torch.optim.SGD(
        [{"params": kernels, "weight_decay": weight_decay},
         {"params": others, "weight_decay": 0.0}],
        lr=0.0, momentum=momentum, dampening=0.0, nesterov=False)


def init_train_state(spec: NetworkSpec, params: Dict, state: Dict,
                     lr_schedule: Callable[[int], float],
                     momentum: float = 0.9, weight_decay: float = 5e-4,
                     compute_dtype: torch.dtype = torch.float32,
                     device="cuda") -> TrainState:
    """A train state on ``device`` from ``layer_key`` (params, state)."""
    net = Darknet(spec, params, state, compute_dtype).to(device)
    net.train()
    return TrainState(net=net, optimizer=make_optimizer(
        net, momentum, weight_decay), lr_schedule=lr_schedule)


def aug_generator(device, aug_seed: int, step: int,
                  rank: int = 0) -> torch.Generator:
    """The generator of one step's on-device augmentation: on ``device``,
    seeded from (``aug_seed``, ``step``, ``rank``)."""
    seed = int(np.random.SeedSequence([aug_seed, step, rank])
               .generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def _average_across_ranks(grads, comp: Dict[str, torch.Tensor], group
                          ) -> Dict[str, torch.Tensor]:
    """Average the gradients (in place) and the loss terms over the ranks of
    ``group`` in one all-reduce of their concatenation."""
    keys = list(comp)
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [torch.stack([comp[k].detach() for k in keys])])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view(g.shape))
        off += g.numel()
    return dict(zip(keys, flat[off:]))


def make_train_step(spec: NetworkSpec, hyp: Optional[Hyp] = None,
                    process_group=None, device_aug: bool = False,
                    aug_seed: int = 0) -> Callable:
    """The train step ``step(ts, imgs, targets, valid) -> metrics``.

    ``imgs`` (B, S, S, 3) uint8, ``targets`` (B, G, 6) f32, ``valid``
    (B, G) bool, on the net's device; the assignment and the loss use the
    batch's size S, so one step serves every multi-scale size. ``metrics``
    holds 0-dim f32 tensors on the device (the loss terms, ``total`` and
    ``grad_norm``): reading them is left to the caller, so a step does not
    wait for the device.

    With ``process_group`` the step is one rank's part of a data-parallel
    step: the batch is this rank's slice, BN is synced and the gradients
    and metrics are averaged over the group. With ``device_aug`` the batch
    is augmented on the device first (``aug_generator``).
    """
    hyp = hyp or Hyp()
    yolo_specs = spec.yolo_specs
    rank = 0 if process_group is None else dist.get_rank(process_group)

    def train_step(ts: TrainState, imgs, targets, valid
                   ) -> Dict[str, torch.Tensor]:
        net, opt = ts.net, ts.optimizer
        x = imgs.to(torch.float32) / 255.0
        if device_aug:
            gen = aug_generator(x.device, aug_seed, ts.step, rank)
            x, targets, valid = augment_batch(gen, x, targets, valid, hyp)
        heads = [h.float() for h in net(x, process_group)]
        total, comp = compute_loss(heads, targets, valid, yolo_specs,
                                   int(imgs.shape[1]), hyp)
        opt.zero_grad(set_to_none=True)
        total.backward()
        grads = [t.grad for t in net.parameters() if t.grad is not None]
        if process_group is not None:
            comp = _average_across_ranks(grads, comp, process_group)
        comp["grad_norm"] = torch.nn.utils.get_total_norm(grads)
        lr = ts.lr_schedule(ts.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        ts.step += 1
        return {k: v.detach() for k, v in comp.items()}

    return train_step


# ----------------------------- checkpoints ---------------------------------

def save_checkpoint(ckpt_dir: str, ts: TrainState, step: int,
                    keep: int = 3) -> None:
    """Write the train state as ``<ckpt_dir>/<step>.pt`` (the reference's
    resume checkpoint) and keep the ``keep`` newest."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{step}.pt")
    tmp = path + ".tmp"
    torch.save({"net": ts.net.state_dict(),
                "optimizer": ts.optimizer.state_dict(),
                "step": ts.step}, tmp)
    os.replace(tmp, path)
    for old in _checkpoint_steps(ckpt_dir)[:-keep]:
        os.remove(os.path.join(ckpt_dir, f"{old}.pt"))


def _checkpoint_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in
                  (re.fullmatch(r"(\d+)\.pt", f) for f in os.listdir(ckpt_dir))
                  if m)


def load_checkpoint(ckpt_dir: str, ts: TrainState) -> int:
    """Restore the newest checkpoint under ``ckpt_dir`` into ``ts`` (its
    network, momentum buffers and step count); returns the checkpoint's
    step label."""
    steps = _checkpoint_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    device = next(ts.net.parameters()).device
    ckpt = torch.load(os.path.join(ckpt_dir, f"{steps[-1]}.pt"),
                      map_location=device, weights_only=True)
    ts.net.load_state_dict(ckpt["net"])
    ts.optimizer.load_state_dict(ckpt["optimizer"])
    ts.step = int(ckpt["step"])
    return steps[-1]
