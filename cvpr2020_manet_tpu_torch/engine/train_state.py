"""Optimizer and train state, PyTorch port of `engine/train_state.py`.

Reference recipe: SGD with momentum, poly LR decay (1 - step/total)^0.9,
weight decay, and a reduced LR on the pretrained backbone relative to the
heads. The JAX package builds it from optax as, per parameter group,

    add_decayed_weights(wd) -> sgd(poly_schedule(lr), momentum)

which is `torch.optim.SGD(weight_decay=wd, momentum=m, dampening=0)`:
the decay is added to the gradient before the momentum trace, on every
parameter (GroupNorm scales and biases included); the trace has no
dampening and starts from the first gradient; the update is -lr * trace.
The schedule's count is 0 for the first update, as `LambdaLR`'s is.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from cvpr2020_manet_tpu_torch.config import TrainConfig
from cvpr2020_manet_tpu_torch.parallel.distributed import (
    all_reduce_mean_, process_group)

BACKBONE_PREFIX = "encoder.backbone."   # the Flax path key `backbone`


def poly_schedule(total_steps: int, power: float):
    """step -> (1 - clip(step / total, 0, 1))^power, the LR factor."""
    def factor(step: int) -> float:
        frac = min(max(step / total_steps, 0.0), 1.0)
        return (1.0 - frac) ** power
    return factor


def param_labels(model: nn.Module) -> dict[str, str]:
    """'backbone' for the encoder's ResNet trunk (its convs and norms, the
    pretrained `FrozenAffine` pairs of `utils/pretrained.py` among them),
    'heads' for the rest."""
    return {name: "backbone" if name.startswith(BACKBONE_PREFIX) else "heads"
            for name, _ in model.named_parameters()}


def make_optimizer(model: nn.Module, cfg: TrainConfig):
    """-> (SGD with a 'backbone' and a 'heads' parameter group, poly LR
    scheduler)."""
    labels = param_labels(model)
    groups = []
    for label, scale in (("backbone", cfg.backbone_lr_scale), ("heads", 1.0)):
        groups.append({
            "name": label, "lr": cfg.base_lr * scale,
            "params": [p for n, p in model.named_parameters()
                       if labels[n] == label]})
    opt = torch.optim.SGD(groups, lr=cfg.base_lr, momentum=cfg.momentum,
                          dampening=0.0, weight_decay=cfg.weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, poly_schedule(cfg.total_steps, cfg.poly_power))
    return opt, sched


@dataclasses.dataclass
class TrainState:
    """Step count, model, optimizer and LR schedule of one training run;
    `group`: the `torch.distributed` process group of a data-parallel run
    (the world once `parallel/distributed.initialize` has joined one, None
    in one process)."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0
    group: Any = None

    def _fill_gradients(self) -> None:
        for p in self.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)

    def allreduce_gradients(self) -> None:
        """In a data-parallel run, replace every gradient by its mean over
        the ranks (one flat all-reduce): the global batch's gradient, as
        JAX's `pmean` over the data axis gives. A no-op in one process."""
        if self.group is None:
            return
        self._fill_gradients()
        all_reduce_mean_([p.grad for p in self.model.parameters()],
                         self.group)

    def apply_gradients(self) -> None:
        """One update from the gradients in the parameters' `.grad`. A
        parameter the loss did not reach gets a zero gradient, so that it
        still decays and its momentum still runs, as under optax (torch's
        SGD would skip it)."""
        self._fill_gradients()
        self.optimizer.step()
        self.scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1

    @classmethod
    def create(cls, model: nn.Module, cfg: TrainConfig) -> "TrainState":
        opt, sched = make_optimizer(model, cfg)
        return cls(model=model, optimizer=opt, scheduler=sched,
                   group=process_group())
