"""The reference's optimizer policy (torch port of
`lseg_tpu/train/optim.py` · `make_optimizer`).

- the learning rate is pre-scaled `base_lr / 16 * batch_size`;
- two parameter groups: the backbone (`vit.*`, `resnet.*`) at 1x and
  everything else (reassemble, scratch, refinenet, head1) at
  `head_lr_mult` (10x);
- SGD with momentum 0.9, no nesterov, no dampening (`optax.trace`), or
  Adam (`midas_proto`, `optax.scale_by_adam` defaults);
- weight decay added to the gradient of EVERY parameter, biases and
  BatchNorm included (`optax.add_decayed_weights`);
- the poly schedule `lr * (1 - step / max_steps) ** power`, evaluated in
  fp32 at the step count before it is incremented (`scale_by_schedule`);
- `freeze_backbone`: no decay and no update for the backbone, whose
  parameters then stop requiring grad (the backward skips it).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

BACKBONE_KEYS = ("vit", "resnet")


def poly_schedule(base_lr: float, max_steps: int,
                  power: float = 0.9) -> Callable[[int], float]:
    """step -> base_lr * (1 - min(step / max_steps, 1)) ** power, in fp32
    as the reference computes it."""
    f32 = np.float32

    def sched(step: int) -> float:
        frac = min(f32(step) / f32(max_steps), f32(1.0))
        return float(f32(base_lr) * (f32(1.0) - frac) ** f32(power))

    return sched


class Optimizer:
    """A torch optimizer over the two groups plus the poly schedule;
    `step(count)` sets each group's rate for the step count `count` and
    applies the update."""

    def __init__(self, opt: torch.optim.Optimizer,
                 schedule: Callable[[int], float]):
        self.opt = opt
        self.schedule = schedule

    def step(self, count: int) -> None:
        lr = self.schedule(count)
        for group in self.opt.param_groups:
            group["lr"] = lr * group["mult"]
        self.opt.step()

    def state_dict(self):
        return self.opt.state_dict()

    def load_state_dict(self, state) -> None:
        self.opt.load_state_dict(state)


def make_optimizer(model: nn.Module, base_lr: float, max_steps: int, *,
                   batch_size: int = 16, momentum: float = 0.9,
                   weight_decay: float = 1e-4, head_lr_mult: float = 10.0,
                   power: float = 0.9, midas_proto: bool = False,
                   freeze_backbone: bool = False) -> Optimizer:
    """The reference's optimizer over the parameters of `model` that
    require grad (`train.step.enable_grads` sets which)."""
    lr = base_lr / 16.0 * batch_size
    backbone, decoder = [], []
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        if name.split(".", 1)[0] in BACKBONE_KEYS:
            if freeze_backbone:
                p.requires_grad_(False)
            else:
                backbone.append(p)
        else:
            decoder.append(p)
    groups = [{"params": ps, "mult": mult}
              for ps, mult in ((backbone, 1.0), (decoder, head_lr_mult))
              if ps]
    if midas_proto:
        opt = torch.optim.Adam(groups, lr=lr, weight_decay=weight_decay)
    else:
        opt = torch.optim.SGD(groups, lr=lr, momentum=momentum,
                              weight_decay=weight_decay)
    return Optimizer(opt, poly_schedule(lr, max_steps, power))
