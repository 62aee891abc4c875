"""Dilated ResNet backbone (NCHW) — DeepLabV3+ encoder trunk.

Port of the JAX package's `models/resnet.py`: ResNet bottleneck stages,
output stride 16 through a dilated last stage with multi-grid (1, 2, 4),
the stride-4 stage-1 output exposed as the decoder's low-level feature.
Submodule names follow the Flax ones so weights bridge by name
(`weights.py`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cvpr2020_manet_tpu_torch.models.layers import Conv, make_norm


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with projection shortcut."""

    def __init__(self, in_ch: int, channels: int, *, stride: int = 1,
                 dilation: int = 1, norm: str = "gn", gn_groups: int = 32,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        out_ch = channels * 4
        norm_ctor = make_norm(norm, dtype, gn_groups)
        self.conv1 = Conv(in_ch, channels, 1, dtype=dtype)
        self.norm1 = norm_ctor(channels)
        self.conv2 = Conv(channels, channels, 3, stride=stride,
                          padding=dilation, dilation=dilation, dtype=dtype)
        self.norm2 = norm_ctor(channels)
        self.conv3 = Conv(channels, out_ch, 1, dtype=dtype)
        self.norm3 = norm_ctor(out_ch)
        if in_ch != out_ch or stride != 1:
            # Flax 'SAME' on a 1x1 stride-2 conv pads nothing
            self.shortcut = Conv(in_ch, out_ch, 1, stride=stride, padding=0,
                                 dtype=dtype)
            self.shortcut_norm = norm_ctor(out_ch)
        else:
            self.shortcut = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm1(self.conv1(x), relu=True)
        y = self.norm2(self.conv2(y), relu=True)
        residual = x if self.shortcut is None \
            else self.shortcut_norm(self.shortcut(x))
        return self.norm3(self.conv3(y), residual=residual, relu=True)


class ResNetBackbone(nn.Module):
    """x (B, 3, H, W) -> (low_level @ stride 4, trunk @ output_stride)."""

    def __init__(self, depths: Sequence[int] = (3, 4, 23, 3), width: int = 64,
                 output_stride: int = 16, norm: str = "gn",
                 gn_groups: int = 32, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if output_stride not in (8, 16):
            raise ValueError(f"output_stride {output_stride}: 8 or 16")
        self.dtype = dtype
        # stem: 7x7/2 conv (pad 3) + 3x3/2 max-pool (pad 1) -> stride 4
        self.stem_conv = Conv(3, width, 7, stride=2, padding=3, dtype=dtype)
        self.stem_norm = make_norm(norm, dtype, gn_groups)(width)
        # (stride, dilation) per stage for the requested output stride
        stage_cfg = ([(1, 1), (2, 1), (2, 1), (1, 2)] if output_stride == 16
                     else [(1, 1), (2, 1), (1, 2), (1, 4)])
        self.block_names: list[list[str]] = []
        in_ch = width
        for stage, (n_blocks, (stride, dilation)) in enumerate(
                zip(depths, stage_cfg)):
            ch = width * (2 ** stage)
            names = []
            for b in range(n_blocks):
                # multi-grid (1, 2, 4) in the dilated final stage
                mg = (1, 2, 4)[min(b, 2)] if dilation > 1 else 1
                name = f"stage{stage + 1}_block{b}"
                self.add_module(name, Bottleneck(
                    in_ch, ch, stride=stride if b == 0 else 1,
                    dilation=dilation * mg, norm=norm, gn_groups=gn_groups,
                    dtype=dtype))
                in_ch = ch * 4
                names.append(name)
            self.block_names.append(names)
        self.out_channels = in_ch

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> (B, width, H/4, W/4): 7x7/2 conv, norm, relu,
        3x3/2 max-pool."""
        x = self.stem_norm(self.stem_conv(x.to(self.dtype)), relu=True)
        return F.max_pool2d(x, 3, stride=2, padding=1)

    def stage(self, index: int, x: torch.Tensor) -> torch.Tensor:
        """The bottleneck blocks of stage `index` (0-3)."""
        for name in self.block_names[index]:
            x = getattr(self, name)(x)
        return x

    def forward(self, x: torch.Tensor):
        x = self.stem(x)
        low_level = None
        for stage in range(len(self.block_names)):
            x = self.stage(stage, x)
            if stage == 0:
                low_level = x
        return low_level, x
