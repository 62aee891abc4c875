"""Shared layers: Flax-semantics conv and GroupNorm, resize.

Port of the JAX package's `models/layers.py`. Two Flax behaviours are kept
on purpose:

- `Conv`: parameters stay float32 and are cast, with the input, to the
  module's compute dtype at call time (Flax `nn.Conv(dtype=...)`).
- `GroupNorm`: epsilon 1e-6 (Flax's default; PyTorch's is 1e-5), with
  statistics and affine in float32 and the result cast back to the input
  dtype (Flax `nn.GroupNorm(dtype=...)`).

Modules work in NCHW. `resize_bilinear` / `resize_nearest` take the JAX
package's layout (spatial axes third- and second-to-last) and implement
its fast paths exactly: integer up-factors (half-pixel centres, edge
clamp) and the antialiased /2 downsample of `jax.image.resize`
(1/8, 3/8, 3/8, 1/8 taps, edge taps dropped and renormalized). The
general `jax.image.resize` fallback is not ported; other factors raise.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Conv(nn.Module):
    """2-D convolution with f32 parameters computed in `dtype` (NCHW)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, *,
                 stride: int = 1, padding: int | None = None,
                 dilation: int = 1, bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.dilation, self.dtype = stride, dilation, dtype
        # Flax 'SAME' at stride 1 is symmetric; 1x1 convs pad nothing
        self.padding = dilation * (kernel - 1) // 2 if padding is None \
            else padding
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), b, self.stride,
                        self.padding, self.dilation)


class GroupNorm(nn.Module):
    """Flax `nn.GroupNorm` semantics on NCHW input (eps 1e-6, f32 math)."""

    def __init__(self, groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.groups, self.weight, self.bias,
                            self.eps).to(x.dtype)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init at the scale of Flax's defaults: conv kernels
    normal with variance 1/fan_in (cut at 2 sigma, as lecun_normal),
    biases 0, norm scales 1. Runs on the CPU so the weights do not depend
    on the device."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Conv):
                fan_in = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
                w = torch.randn(m.weight.shape, generator=generator)
                m.weight.copy_(w.clamp_(-2.0, 2.0) / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


# ------------------------------------------------------------------ resize


def _upsample_axis_int(x: torch.Tensor, axis: int, s: int) -> torch.Tensor:
    """Bilinear upsample by integer factor s along `axis`, half-pixel
    centres with edge clamping (== jax.image.resize for integer factors)."""
    x = x.movedim(axis, 0)
    prev = torch.cat([x[:1], x[:-1]], dim=0)    # x[i-1], edge-clamped
    nxt = torch.cat([x[1:], x[-1:]], dim=0)     # x[i+1], edge-clamped
    phases = []
    for r in range(s):
        t = (r + 0.5) / s - 0.5
        if t < 0:
            phases.append((-t) * prev + (1.0 + t) * x)
        else:
            phases.append((1.0 - t) * x + t * nxt)
    y = torch.stack(phases, dim=1)              # (n, s, ...)
    y = y.reshape((x.shape[0] * s,) + tuple(x.shape[1:]))
    return y.movedim(0, axis)


def _downsample_axis_2x(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Bilinear /2 with jax.image.resize's antialiasing: a 4-tap triangle
    (1/8, 3/8, 3/8, 1/8); out-of-range edge taps are dropped and the
    kernel renormalized."""
    x = x.movedim(axis, 0)
    prev = torch.cat([x[:1], x[:-1]], dim=0)    # x[i-1]
    nxt = torch.cat([x[1:], x[-1:]], dim=0)     # x[i+1]
    y = (0.125 * prev[0::2] + 0.375 * x[0::2]
         + 0.375 * x[1::2] + 0.125 * nxt[1::2])
    y[0] = (0.375 * x[0] + 0.375 * x[1] + 0.125 * x[2]) / 0.875
    y[-1] = (0.125 * x[-3] + 0.375 * x[-2] + 0.375 * x[-1]) / 0.875
    return y.movedim(0, axis)


def resize_bilinear_axes(x: torch.Tensor, shape: tuple[int, int],
                         h_ax: int, w_ax: int) -> torch.Tensor:
    """Bilinear resize of spatial axes (h_ax, w_ax) to `shape`, computed in
    f32 and returned in x's dtype. Integer up-factors and /2 only."""
    orig_dtype = x.dtype
    y = x.float()
    for axis, dst in ((h_ax, shape[0]), (w_ax, shape[1])):
        src = y.shape[axis]
        if dst == src:
            continue
        if dst > src and dst % src == 0:
            y = _upsample_axis_int(y, axis, dst // src)
        elif src == 2 * dst and src >= 4:
            y = _downsample_axis_2x(y, axis)
        else:
            raise NotImplementedError(
                f"bilinear resize {src} -> {dst}: only integer up-factors "
                "and /2 are ported (the jax.image.resize fallback is not)")
    return y.to(orig_dtype)


def resize_bilinear(x: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NHWC (or HWC) to spatial `shape` (half-pixel
    centres, == torch align_corners=False for up-factors)."""
    return resize_bilinear_axes(x, shape, x.ndim - 3, x.ndim - 2)


def resize_nearest(x: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Nearest resize of NHWC (or HWC) label/mask maps, integer factors."""
    y = x
    for axis, dst in ((x.ndim - 3, shape[0]), (x.ndim - 2, shape[1])):
        src = y.shape[axis]
        if dst == src:
            continue
        if dst > src and dst % src == 0:
            y = torch.repeat_interleave(y, dst // src, dim=axis)
        elif src % dst == 0:
            f = src // dst
            idx = [slice(None)] * y.ndim
            idx[axis] = slice(f // 2, None, f)
            y = y[tuple(idx)]
        else:
            raise NotImplementedError(
                f"nearest resize {src} -> {dst}: only integer factors are "
                "ported")
    return y
