"""Flax -> PyTorch weight bridge.

Takes the JAX package's Flax `params` tree, or its whole `variables`
({"params", "batch_stats"}), as nested dicts of numpy arrays (no JAX
needed) and returns the port's `state_dict`:

- conv kernels HWIO -> OIHW;
- norm `scale` -> `weight`; BatchNorm's `batch_stats` `mean` / `var` ->
  its buffers of the same names;
- Flax's auto-named submodules map by creation order, Flax counting each
  class apart (`GroupNorm_<i>`, `BatchNorm_<i>`, `LayerNorm_<i>`,
  `FrozenAffine_<i>`): in the ASPP `Conv_<i>` -> `conv.<i>` and each norm
  -> `norm.<j>`, j its place among the ASPP's norms (with `norm="bn"`:
  BatchNorm_0..3 -> norm.0..3, GroupNorm_0 -> norm.4, BatchNorm_4 ->
  norm.5); in the encoder the three norms -> `low_level_norm` /
  `decoder_norm0` / `decoder_norm1`; in a head's conv stack the i-th norm
  -> `norm<i>`.

Every Flax leaf is consumed exactly once and every model tensor is filled
exactly once, with matching shapes, or the bridge raises.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from cvpr2020_manet_tpu_torch.models.layers import NORM_MODULES

_COLLECTIONS = ({"params"}, {"params", "batch_stats"})
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
           "mean": "mean", "var": "var"}


def _flax_names(modules) -> dict[str, int]:
    """Flax's auto-names of `modules` in creation order (each class counted
    apart) -> their index in the list."""
    counts: dict[str, int] = {}
    names = {}
    for i, m in enumerate(modules):
        n = counts.get(m.FLAX_NAME, 0)
        counts[m.FLAX_NAME] = n + 1
        names[f"{m.FLAX_NAME}_{n}"] = i
    return names


def _auto_names(model: nn.Module) -> dict[str, dict[str, str]]:
    """parent module name -> {Flax auto-name: port submodule name}, for the
    encoder's, the ASPP's and the head stacks' unnamed norms."""
    enc = model.encoder
    aspp = _flax_names(enc.aspp.norm)
    out = {"aspp": {k: f"norm.{i}" for k, i in aspp.items()}}
    out["aspp"].update({f"Conv_{i}": f"conv.{i}"
                        for i in range(len(enc.aspp.conv))})
    names = ("low_level_norm", "decoder_norm0", "decoder_norm1")
    out["encoder"] = {k: names[i] for k, i in _flax_names(
        [getattr(enc, n) for n in names]).items()}
    # both heads' stacks hold one norm class; the deeper one names them all
    out["stack"] = {k: f"norm{i}" for k, i in _flax_names(
        [m for m in model.propagation_head.stack.children()
         if isinstance(m, NORM_MODULES)]).items()}
    return out


def _torch_key(path: tuple[str, ...], auto: Mapping[str, Mapping[str, str]]
               ) -> tuple[str, bool]:
    """Flax param path -> (state_dict key, leaf is a conv kernel)."""
    parts = []
    for i, seg in enumerate(path[:-1]):
        parent = path[i - 1] if i else ""
        parts.append(auto.get(parent, {}).get(seg, seg))
    leaf = path[-1]
    if leaf not in _LEAVES:
        raise KeyError(f"unknown Flax leaf {'/'.join(path)}")
    parts.append(_LEAVES[leaf])
    return ".".join(parts), leaf == "kernel"


def _walk(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _leaves(tree: Mapping[str, Any]):
    """(path, leaf) of a `params` tree, or of each collection of a whole
    `variables` dict, the collection name dropped (the collections' leaf
    names differ)."""
    if set(tree) in _COLLECTIONS:
        for collection in sorted(tree):
            yield from _walk(tree[collection])
    else:
        yield from _walk(tree)


def bridge_plan(params: Mapping[str, Any], model: nn.Module):
    """Map every Flax leaf to a model tensor; raise unless the mapping is
    one-to-one and every shape agrees. Leaves need only a `.shape`, so a
    shape tree (`jax.eval_shape`) can be checked without data.
    Returns [(state_dict key, flax path, is_conv_kernel)]."""
    expected = model.state_dict()
    auto = _auto_names(model)
    plan, seen = [], {}
    for path, leaf in _leaves(params):
        key, is_kernel = _torch_key(path, auto)
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
    """Flax `params`, or `variables` with `batch_stats` (numpy leaves) ->
    the model's state_dict (f32, CPU)."""
    out = {}
    leaves = dict(_leaves(params))
    for key, path, is_kernel in bridge_plan(params, model):
        arr = np.asarray(leaves[path], dtype=np.float32)
        if is_kernel:
            arr = arr.transpose(3, 2, 0, 1)                # HWIO -> OIHW
        out[key] = torch.tensor(arr)                       # a contiguous copy
    return out


def load_flax_params(model: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Load Flax `params` (or `variables`) into the model in place;
    returns the model."""
    model.load_state_dict(flax_to_state_dict(params, model), strict=True)
    return model
