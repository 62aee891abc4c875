"""Flax -> PyTorch weight bridge.

Takes the JAX package's Flax `params` tree as nested dicts of numpy arrays
(no JAX needed) and returns the port's `state_dict`:

- conv kernels HWIO -> OIHW;
- GroupNorm `scale` -> `weight`;
- Flax's auto-named submodules map by creation order: in the ASPP
  `Conv_<i>` -> `conv.<i>` and `GroupNorm_<i>` -> `norm.<i>`; in the
  encoder `GroupNorm_0/1/2` -> `low_level_norm` / `decoder_norm0` /
  `decoder_norm1`; in a head's conv stack `GroupNorm_<i>` -> `norm<i>`.

Every Flax leaf is consumed exactly once and every model tensor is filled
exactly once, with matching shapes, or the bridge raises.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

_ENCODER_NORMS = {"GroupNorm_0": "low_level_norm",
                  "GroupNorm_1": "decoder_norm0",
                  "GroupNorm_2": "decoder_norm1"}


def _torch_key(path: tuple[str, ...]) -> tuple[str, bool]:
    """Flax param path -> (state_dict key, leaf is a conv kernel)."""
    parts = []
    for i, seg in enumerate(path[:-1]):
        parent = path[i - 1] if i else ""
        m = re.fullmatch(r"(Conv|GroupNorm)_(\d+)", seg)
        if parent == "aspp" and m:
            parts += ["conv" if m.group(1) == "Conv" else "norm", m.group(2)]
        elif parent == "encoder" and seg in _ENCODER_NORMS:
            parts.append(_ENCODER_NORMS[seg])
        elif parent == "stack" and m and m.group(1) == "GroupNorm":
            parts.append(f"norm{m.group(2)}")
        else:
            parts.append(seg)
    leaf = path[-1]
    if leaf not in ("kernel", "scale", "bias"):
        raise KeyError(f"unknown Flax leaf {'/'.join(path)}")
    parts.append("bias" if leaf == "bias" else "weight")
    return ".".join(parts), leaf == "kernel"


def _leaves(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    if not prefix and set(tree) == {"params"}:      # a whole `variables` dict
        tree = tree["params"]
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def bridge_plan(params: Mapping[str, Any], model: nn.Module):
    """Map every Flax leaf to a model tensor; raise unless the mapping is
    one-to-one and every shape agrees. Leaves need only a `.shape`, so a
    shape tree (`jax.eval_shape`) can be checked without data.
    Returns [(state_dict key, flax path, is_conv_kernel)]."""
    expected = model.state_dict()
    plan, seen = [], {}
    for path, leaf in _leaves(params):
        key, is_kernel = _torch_key(path)
        if key in seen:
            raise KeyError(f"{'/'.join(path)} and {'/'.join(seen[key])} "
                           f"both map to {key}")
        if key not in expected:
            raise KeyError(f"{'/'.join(path)} -> {key}: not a model tensor")
        shape = tuple(leaf.shape)
        if is_kernel:
            shape = (shape[3], shape[2], shape[0], shape[1])
        if shape != tuple(expected[key].shape):
            raise ValueError(f"{'/'.join(path)} -> {key}: shape {shape} != "
                             f"{tuple(expected[key].shape)}")
        seen[key] = path
        plan.append((key, path, is_kernel))
    missing = sorted(set(expected) - set(seen))
    if missing:
        raise KeyError(f"model tensors without a Flax leaf: {missing}")
    return plan


def flax_to_state_dict(params: Mapping[str, Any],
                       model: nn.Module) -> dict[str, torch.Tensor]:
    """Flax `params` (numpy leaves) -> the model's state_dict (f32, CPU)."""
    out = {}
    leaves = dict(_leaves(params))
    for key, path, is_kernel in bridge_plan(params, model):
        arr = np.asarray(leaves[path], dtype=np.float32)
        if is_kernel:
            arr = arr.transpose(3, 2, 0, 1)                # HWIO -> OIHW
        out[key] = torch.tensor(arr)                       # a contiguous copy
    return out


def load_flax_params(model: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Load Flax `params` into the model in place; returns the model."""
    model.load_state_dict(flax_to_state_dict(params, model), strict=True)
    return model
