"""Pretrained-backbone import, PyTorch port of `utils/pretrained.py`.

The reference initializes its DeepLab ResNet-101 trunk from an ImageNet
checkpoint. The converter takes a torchvision-layout `resnet101`
state_dict (obtained out of band as .pth or .npz; nothing is downloaded
and torchvision is not needed) and returns the port's backbone
state_dict, with each BatchNorm's running statistics folded into a
`FrozenAffine` (scale, bias) pair (`models/layers.FrozenAffine`; build
the model with `ModelConfig(norm="frozen")`):

    y = gamma (x - mu) / sqrt(sigma^2 + eps) + beta  ==  x * s + b,
    s = gamma / sqrt(sigma^2 + eps),  b = beta - mu s

The conv weights stay OIHW: the port is NCHW, as torchvision is.

    sd = load_torch_file("resnet101.pth")
    load_backbone_into(model, convert_torch_resnet(sd))
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch
from torch import nn

BN_EPS = 1e-5
BACKBONE = "encoder.backbone."


def _fold_bn(prefix: str, sd: Mapping[str, np.ndarray], out: dict,
             name: str) -> None:
    gamma, beta, mean, var = (
        np.asarray(sd[f"{prefix}.{k}"], np.float32)
        for k in ("weight", "bias", "running_mean", "running_var"))
    scale = gamma / np.sqrt(var + BN_EPS)
    out[f"{name}.weight"] = scale
    out[f"{name}.bias"] = beta - mean * scale


def convert_torch_resnet(state_dict: Mapping[str, np.ndarray],
                         depths: Sequence[int] = (3, 4, 23, 3)
                         ) -> Dict[str, torch.Tensor]:
    """torchvision resnet state_dict (numpy or tensor leaves) -> the
    backbone's state_dict (keys relative to `models/resnet.ResNetBackbone`
    with norm='frozen': stem_conv, stem_norm, stage<s>_block<b>.{conv1..3,
    norm1..3, shortcut, shortcut_norm}), f32 CPU tensors."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    out: dict = {"stem_conv.weight": np.asarray(sd["conv1.weight"],
                                                np.float32)}
    _fold_bn("bn1", sd, out, "stem_norm")
    for s, n_blocks in enumerate(depths):
        for b in range(n_blocks):
            t, block = f"layer{s + 1}.{b}", f"stage{s + 1}_block{b}"
            for i in (1, 2, 3):
                out[f"{block}.conv{i}.weight"] = np.asarray(
                    sd[f"{t}.conv{i}.weight"], np.float32)
                _fold_bn(f"{t}.bn{i}", sd, out, f"{block}.norm{i}")
            if f"{t}.downsample.0.weight" in sd:
                out[f"{block}.shortcut.weight"] = np.asarray(
                    sd[f"{t}.downsample.0.weight"], np.float32)
                _fold_bn(f"{t}.downsample.1", sd, out,
                         f"{block}.shortcut_norm")
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out.items()}


def load_backbone_into(model: nn.Module,
                       backbone_sd: Mapping[str, torch.Tensor]) -> nn.Module:
    """Copy a converted backbone into `model` (a MANet) in place, checked
    tensor by tensor: a key the model lacks or a shape that differs (wrong
    depths or widths) raises with the key. A model whose norm is not
    'frozen' raises too: a GroupNorm has the same tensor names and shapes,
    but folded BN statistics are not its scale and bias. Returns the
    model."""
    if model.cfg.norm != "frozen":
        raise ValueError(f"the converted backbone holds folded BatchNorm "
                         f"(FrozenAffine) pairs; the model has "
                         f"norm={model.cfg.norm!r}, build it with "
                         f"norm='frozen'")
    target = model.state_dict()
    for k, v in backbone_sd.items():
        key = BACKBONE + k
        if key not in target:
            raise KeyError(f"missing key in the model: {key}")
        if tuple(target[key].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {key}: model "
                             f"{tuple(target[key].shape)} vs checkpoint "
                             f"{tuple(v.shape)}")
    with torch.no_grad():
        for k, v in backbone_sd.items():
            target[BACKBONE + k].copy_(v)
    return model


def load_torch_file(path: str) -> Dict[str, np.ndarray]:
    """A .pth / .pt (`torch.load(weights_only=True)`, on the CPU) or .npz
    state dict -> numpy arrays."""
    if path.endswith(".npz"):
        return dict(np.load(path))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in sd.items()}
