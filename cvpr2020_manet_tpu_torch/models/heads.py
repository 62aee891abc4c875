"""Decoder heads and the memory aggregator (SURVEY.md C5-C7), NCHW.

Port of the JAX package's `models/heads.py`. The object axis is folded
into the batch axis, so one set of weights serves any object count. The
`logit` convs run in float32 even when the model runs in bf16, and the MA
memory blend promotes to float32 (the memory itself is kept in f32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cvpr2020_manet_tpu_torch.models.layers import Conv, make_norm


class ConvStack(nn.Module):
    """Dense 3x3 conv -> norm -> ReLU stack (Flax names conv<i>, and
    <norm class>_<i> -> norm<i>)."""

    def __init__(self, in_ch: int, channels: int, depth: int, norm: str,
                 gn_groups: int, dtype: torch.dtype):
        super().__init__()
        self.depth, self.dtype = depth, dtype
        norm_ctor = make_norm(norm, dtype, gn_groups)
        for i in range(depth):
            self.add_module(f"conv{i}", Conv(in_ch if i == 0 else channels,
                                             channels, 3, dtype=dtype))
            self.add_module(f"norm{i}", norm_ctor(channels))

    def forward(self, x: torch.Tensor | None,
                pre0: torch.Tensor | None = None) -> torch.Tensor:
        """pre0: a precomputed conv0 pre-activation (before the norm); conv0
        is linear, so callers may sum its per-input-block contributions
        (MANet.propagate's decomposed head)."""
        for i in range(self.depth):
            if i == 0 and pre0 is not None:
                x = pre0.to(self.dtype)
            else:
                x = getattr(self, f"conv{i}")(x)
            x = F.relu(getattr(self, f"norm{i}")(x))
        return x


class InteractionHead(nn.Module):
    """(O, Cf + 3, h, w) -> (interaction feature (O, Cma, h, w), logit
    (O, 1, h, w) f32)."""

    def __init__(self, in_ch: int, head_channels: int, ma_channels: int,
                 norm: str, gn_groups: int, dtype: torch.dtype):
        super().__init__()
        self.stack = ConvStack(in_ch, head_channels, 2, norm, gn_groups,
                               dtype)
        self.int_feature = Conv(head_channels, ma_channels, 3, bias=True,
                                dtype=dtype)
        self.logit = Conv(ma_channels, 1, 1, bias=True, dtype=torch.float32)

    def forward(self, x: torch.Tensor):
        feat = self.int_feature(self.stack(x))
        return feat, self.logit(F.relu(feat))


class DynamicSegHead(nn.Module):
    """(O, Cf + 3 + Cma, h, w) -> logit (O, 1, h, w) f32."""

    def __init__(self, in_ch: int, head_channels: int, norm: str,
                 gn_groups: int, dtype: torch.dtype):
        super().__init__()
        self.stack = ConvStack(in_ch, head_channels, 3, norm, gn_groups,
                               dtype)
        self.logit = Conv(head_channels, 1, 1, bias=True, dtype=torch.float32)

    def forward(self, x: torch.Tensor | None,
                pre0: torch.Tensor | None = None) -> torch.Tensor:
        return self.logit(self.stack(x, pre0=pre0))


class MemoryAggregator(nn.Module):
    """Gated fusion m_r = w * f_r + (1 - w) * m_{r-1},
    w = sigmoid(conv([f_r, m_{r-1}]))."""

    def __init__(self, ma_channels: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.gate = Conv(2 * ma_channels, ma_channels, 3, bias=True,
                         dtype=dtype)

    def forward(self, f_r: torch.Tensor, m_prev: torch.Tensor) -> torch.Tensor:
        gate_in = torch.cat([f_r.to(self.dtype), m_prev.to(self.dtype)], dim=1)
        w = torch.sigmoid(self.gate(gate_in))
        return w * f_r + (1.0 - w) * m_prev
