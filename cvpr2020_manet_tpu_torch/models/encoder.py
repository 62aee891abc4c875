"""DeepLabV3+ encoder with pixel-embedding head (NCHW).

Port of the JAX package's `models/encoder.py`: ResNet trunk -> ASPP
(rates 6/12/18 + image pooling, whose norm is a 1-group GroupNorm under
every `norm`) -> decoder fusing the stride-4 low-level feature (GroupNorm
groups gcd(gn_groups, 48)) ->
stride-4 `feature` (decoder_channels) and `embedding` (embedding_dim with
bias, zero-padded to embedding_dim_padded; zeros add 0 to every matching
distance).

Flax auto-named the ASPP's and the encoder's unnamed submodules
(`Conv_0`, `GroupNorm_0`, ...) in creation order; here they are
`aspp.conv.<i>` / `aspp.norm.<i>` in that order (Flax counts each class
apart: with `norm="bn"` the ASPP's norms are BatchNorm_0..3, GroupNorm_0
for the pooling branch, BatchNorm_4), and the encoder's three norms are
`low_level_norm`, `decoder_norm0`, `decoder_norm1`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from cvpr2020_manet_tpu_torch.config import ModelConfig
from cvpr2020_manet_tpu_torch.models.layers import (
    Conv, GroupNorm, make_norm, resize_bilinear_axes)
from cvpr2020_manet_tpu_torch.models.resnet import ResNetBackbone


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling @ output stride 16."""

    def __init__(self, in_ch: int, channels: int = 256,
                 rates: tuple[int, ...] = (6, 12, 18), norm: str = "gn",
                 gn_groups: int = 32, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        convs = [Conv(in_ch, channels, 1, dtype=dtype)]
        convs += [Conv(in_ch, channels, 3, padding=r, dilation=r, dtype=dtype)
                  for r in rates]
        convs.append(Conv(in_ch, channels, 1, dtype=dtype))       # pooling
        convs.append(Conv(channels * (len(rates) + 2), channels, 1,
                          dtype=dtype))                           # project
        norm_ctor = make_norm(norm, dtype, gn_groups)
        norms = [norm_ctor(channels) for _ in range(len(rates) + 1)]
        norms.append(GroupNorm(1, channels))                      # pooling
        norms.append(norm_ctor(channels))                         # project
        self.conv = nn.ModuleList(convs)
        self.norm = nn.ModuleList(norms)
        self.n_rates = len(rates)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [F.relu(self.norm[i](self.conv[i](x)))
                    for i in range(self.n_rates + 1)]
        pooled = x.mean(dim=(2, 3), keepdim=True)
        p = self.n_rates + 1
        pooled = F.relu(self.norm[p](self.conv[p](pooled)))
        branches.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
        y = self.conv[p + 1](torch.cat(branches, dim=1))
        return F.relu(self.norm[p + 1](y))


class Encoder(nn.Module):
    """image (B, 3, H, W) -> (feature (B, Cd, H/4, W/4),
    embedding (B, Ce_pad, H/4, W/4))."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dtype = getattr(torch, cfg.dtype)
        self.backbone = ResNetBackbone(
            depths=cfg.backbone_depths, width=cfg.backbone_width,
            output_stride=cfg.output_stride, norm=cfg.norm,
            gn_groups=cfg.gn_groups, dtype=dtype)
        self.aspp = ASPP(self.backbone.out_channels, cfg.aspp_channels,
                         norm=cfg.norm, gn_groups=cfg.gn_groups, dtype=dtype)
        low_ch = cfg.backbone_width * 4
        self.low_level_proj = Conv(low_ch, cfg.low_level_channels, 1,
                                   dtype=dtype)
        self.low_level_norm = make_norm(
            cfg.norm, dtype, math.gcd(cfg.gn_groups, cfg.low_level_channels))(
            cfg.low_level_channels)
        norm_ctor = make_norm(cfg.norm, dtype, cfg.gn_groups)
        self.decoder_conv0 = Conv(cfg.aspp_channels + cfg.low_level_channels,
                                  cfg.decoder_channels, 3, dtype=dtype)
        self.decoder_norm0 = norm_ctor(cfg.decoder_channels)
        self.decoder_conv1 = Conv(cfg.decoder_channels, cfg.decoder_channels,
                                  3, dtype=dtype)
        self.decoder_norm1 = norm_ctor(cfg.decoder_channels)
        self.embedding_head = Conv(cfg.decoder_channels, cfg.embedding_dim, 1,
                                   bias=True, dtype=dtype)

    def forward(self, x: torch.Tensor):
        cfg = self.cfg
        low, trunk = self.backbone(x)
        y = self.aspp(trunk)
        y = resize_bilinear_axes(y, tuple(low.shape[2:]), 2, 3)
        ll = F.relu(self.low_level_norm(self.low_level_proj(low)))
        y = torch.cat([y, ll], dim=1)
        y = F.relu(self.decoder_norm0(self.decoder_conv0(y)))
        feature = F.relu(self.decoder_norm1(self.decoder_conv1(y)))
        emb = self.embedding_head(feature)
        pad = cfg.embedding_dim_padded - cfg.embedding_dim
        if pad > 0:
            emb = F.pad(emb, (0, 0, 0, 0, 0, pad))
        return feature, emb
