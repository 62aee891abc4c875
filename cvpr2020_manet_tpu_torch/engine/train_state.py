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

import torch
from torch import nn

from cvpr2020_manet_tpu_torch.config import TrainConfig

BACKBONE_PREFIX = "encoder.backbone."   # the Flax path key `backbone`


def poly_schedule(total_steps: int, power: float):
    """step -> (1 - clip(step / total, 0, 1))^power, the LR factor."""
    def factor(step: int) -> float:
        frac = min(max(step / total_steps, 0.0), 1.0)
        return (1.0 - frac) ** power
    return factor


def param_labels(model: nn.Module) -> dict[str, str]:
    """'backbone' for the encoder's ResNet trunk, 'heads' for the rest."""
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
    """Step count, model, optimizer and LR schedule of one training run."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0

    def apply_gradients(self) -> None:
        """One update from the gradients in the parameters' `.grad`. A
        parameter the loss did not reach gets a zero gradient, so that it
        still decays and its momentum still runs, as under optax (torch's
        SGD would skip it)."""
        for p in self.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1

    @classmethod
    def create(cls, model: nn.Module, cfg: TrainConfig) -> "TrainState":
        opt, sched = make_optimizer(model, cfg)
        return cls(model=model, optimizer=opt, scheduler=sched)
