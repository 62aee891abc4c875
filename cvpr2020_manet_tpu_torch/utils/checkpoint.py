"""Checkpoint save / restore / resume, PyTorch port of `utils/checkpoint.py`.

Step checkpoints with retention, as the JAX package keeps them with orbax:
`<dir>/<step>/state.pt` holds the model's, the optimizer's and the LR
schedule's state dicts and the step count (`torch.save`), and only the
newest `max_to_keep` steps stay; `restore_params` takes the model's part
alone (stage 2's `--init_from`). Plus an immutable params-only "release"
export (`<dir>/params.pt`).

A checkpoint is written to a temporary file and renamed into place, so a
run cut off while saving leaves no partial step behind. Loading uses
`torch.load(weights_only=True)`: only tensors and plain containers.
"""

from __future__ import annotations

import os
import shutil
from typing import Mapping

import torch

from cvpr2020_manet_tpu_torch.engine.train_state import TrainState

_STATE = "state.pt"
_PARAMS = "params.pt"


def _save_atomic(obj, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def all_steps(self) -> list[int]:
        return sorted(int(d) for d in os.listdir(self._dir)
                      if d.isdigit() and os.path.isfile(
                          os.path.join(self._dir, d, _STATE)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState) -> None:
        step_dir = os.path.join(self._dir, str(state.step))
        os.makedirs(step_dir, exist_ok=True)
        _save_atomic({"model": state.model.state_dict(),
                      "optimizer": state.optimizer.state_dict(),
                      "scheduler": state.scheduler.state_dict(),
                      "step": state.step}, os.path.join(step_dir, _STATE))
        for old in self.all_steps()[:-self._max_to_keep]:
            shutil.rmtree(os.path.join(self._dir, str(old)))

    def _load(self, model: torch.nn.Module, step: int | None) -> dict:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self._dir}")
        device = next(model.parameters()).device
        return torch.load(os.path.join(self._dir, str(step), _STATE),
                          map_location=device, weights_only=True)

    def restore(self, state: TrainState, step: int | None = None
                ) -> TrainState:
        """Load a step (the latest unless given) into `state` in place;
        returns it."""
        payload = self._load(state.model, step)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.scheduler.load_state_dict(payload["scheduler"])
        state.step = int(payload["step"])
        return state

    def restore_params(self, model: torch.nn.Module,
                       step: int | None = None) -> int:
        """Load only the model's part of a step (the latest unless given)
        into `model` in place; an optimizer over its parameters keeps its
        own state. Returns the step it was saved at."""
        payload = self._load(model, step)
        model.load_state_dict(payload["model"])
        return int(payload["step"])


def export_release(params: Mapping[str, torch.Tensor], directory: str) -> None:
    """Immutable params-only export (the 'released checkpoint'): refuses a
    directory that already holds one."""
    path = os.path.join(os.path.abspath(directory), _PARAMS)
    if os.path.exists(path):
        raise FileExistsError(f"{path} exists; a release is not overwritten")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _save_atomic({k: v.detach().cpu() for k, v in params.items()}, path)


def load_release(template_params: Mapping[str, torch.Tensor],
                 directory: str) -> dict[str, torch.Tensor]:
    """The released params, checked against the template's names and
    shapes and placed on its devices and dtypes."""
    loaded = torch.load(os.path.join(os.path.abspath(directory), _PARAMS),
                        map_location="cpu", weights_only=True)
    if set(loaded) != set(template_params):
        raise KeyError(f"release and template differ in "
                       f"{sorted(set(loaded) ^ set(template_params))}")
    out = {}
    for k, t in template_params.items():
        if loaded[k].shape != t.shape:
            raise ValueError(f"{k}: release shape {tuple(loaded[k].shape)} "
                             f"!= template {tuple(t.shape)}")
        out[k] = loaded[k].to(device=t.device, dtype=t.dtype)
    return out
