"""Xception-65, DeepLab's backbone (Chen et al., DeepLabv3+,
arXiv:1802.02611, §3.3; DeepLab's `xception_65`), NCHW.

The root is a 3x3/2 conv to 32 and a 3x3 conv to 64, each with its norm
and ReLU. Then residual units of three separable layers
(`layers.SeparableConv`), the third carrying the unit's stride, each
with a shortcut: `conv` (a 1x1 at that stride and a norm), `sum` (the
identity) or `none`:

| block | depths | shortcut | stride |
| --- | --- | --- | --- |
| entry 1 | 128, 128, 128 | conv | 2 |
| entry 2 | 256, 256, 256 | conv | 2 |
| entry 3 | 728, 728, 728 | conv | 2 |
| middle, 16 units | 728, 728, 728 | sum | 1 |
| exit 1 | 728, 1024, 1024 | conv | 2 |
| exit 2 | 1536, 1536, 2048 | none | 1, ReLU inside |

Strides stop at the output stride as in DeepLab's `stack_blocks_dense`:
the unit that would pass it runs at stride 1 and at the rate reached so
far, and the units after it run at that rate times its stride. At output
stride 16 the exit flow's first unit is at stride 1, rate 1, and its
second at rate 2.

`forward` -> (the low-level feature: entry block 2's second pointwise
output after its norm, 256 channels at stride 4; the exit flow's output,
2048 channels at the output stride).
"""

from __future__ import annotations

import torch
from torch import nn

from cvpr2020_manet_tpu_torch.models.layers import (
    Conv, SeparableConv, make_norm)

# (name, depths, shortcut, stride, inner_relu); the middle flow repeats
ENTRY = [("entry1", (128, 128, 128), "conv", 2, False),
         ("entry2", (256, 256, 256), "conv", 2, False),
         ("entry3", (728, 728, 728), "conv", 2, False)]
MIDDLE = ((728, 728, 728), "sum", 1, False)
MIDDLE_UNITS = 16
EXIT = [("exit1", (728, 1024, 1024), "conv", 2, False),
        ("exit2", (1536, 1536, 2048), "none", 1, True)]
LOW_LEVEL_UNIT, LOW_LEVEL_LAYER = "entry2", 1


def xception65_units(middle_units: int = MIDDLE_UNITS):
    """(name, depths, shortcut, stride, inner_relu) of every unit."""
    return [*ENTRY, *((f"middle{i}", *MIDDLE) for i in range(middle_units)),
            *EXIT]


def unit_plan(units, output_stride: int):
    """(stride, rate) of each unit under DeepLab's `stack_blocks_dense`,
    after the root's stride 2."""
    target = output_stride // 2
    current, rate, out = 1, 1, []
    for _, _, _, stride, _ in units:
        if current == target:
            out.append((1, rate))
            rate *= stride
        else:
            out.append((stride, 1))
            current *= stride
    if current != target:
        raise ValueError(f"output stride {output_stride} is not reached")
    return out


class XceptionUnit(nn.Module):
    """Three separable layers and the shortcut."""

    def __init__(self, in_ch: int, depths, shortcut: str, stride: int,
                 rate: int, inner_relu: bool, norm: str, dtype):
        super().__init__()
        chans = (in_ch, *depths)
        self.sep = nn.ModuleList(
            SeparableConv(chans[i], chans[i + 1], 3, rate=rate,
                          stride=stride if i == 2 else 1,
                          inner_relu=inner_relu, norm=norm, dtype=dtype)
            for i in range(3))
        self.kind = shortcut
        if shortcut == "conv":
            self.shortcut = Conv(in_ch, depths[-1], 1, stride=stride,
                                 dtype=dtype)
            self.shortcut_norm = make_norm(norm, dtype)(depths[-1])

    def forward(self, x: torch.Tensor, tap: int | None = None):
        """-> the unit's output, and with `tap` the output of that
        separable layer too."""
        y, tapped = x, None
        for i, layer in enumerate(self.sep):
            y = layer(y)
            if i == tap:
                tapped = y
        if self.kind == "conv":
            y = y + self.shortcut_norm(self.shortcut(x))
        elif self.kind == "sum":
            y = y + x
        return y, tapped


class Xception65(nn.Module):
    """image (B, 3, H, W) -> (low-level (B, 256, H/4, W/4), trunk (B,
    2048, H/os, W/os))."""

    out_channels = 2048
    low_level_channels = 256

    def __init__(self, middle_units: int = MIDDLE_UNITS,
                 output_stride: int = 16,
                 norm: str = "frozen", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.root_conv1 = Conv(3, 32, 3, stride=2, dtype=dtype)
        self.root_norm1 = make_norm(norm, dtype)(32)
        self.root_conv2 = Conv(32, 64, 3, dtype=dtype)
        self.root_norm2 = make_norm(norm, dtype)(64)
        units = xception65_units(middle_units)
        cin = 64
        self.units = nn.ModuleDict()
        for (name, depths, shortcut, _, inner), (stride, rate) in zip(
                units, unit_plan(units, output_stride)):
            self.units[name] = XceptionUnit(cin, depths, shortcut, stride,
                                            rate, inner, norm, dtype)
            cin = depths[-1]

    def forward(self, x: torch.Tensor):
        x = self.root_norm1(self.root_conv1(x), relu=True)
        x = self.root_norm2(self.root_conv2(x), relu=True)
        low = None
        for name, unit in self.units.items():
            x, tapped = unit(x, LOW_LEVEL_LAYER if name == LOW_LEVEL_UNIT
                             else None)
            if tapped is not None:
                low = tapped
        return low, x


__all__ = ["Xception65", "XceptionUnit", "unit_plan", "xception65_units"]
