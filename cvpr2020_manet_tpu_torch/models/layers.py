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
(1/8, 3/8, 3/8, 1/8 taps, edge taps dropped and renormalized). Any other
factor takes the JAX package's fallback, `jax.image.resize` itself,
written here from its algorithm (`_resize_general_bilinear`,
`_resize_general_nearest`) under the same dispatch rule.
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


def _fast_axis_bilinear(y: torch.Tensor, axis: int, dst: int):
    """The fast path along one axis (f32 in, f32 out), or None where the
    factor is neither an integer up-factor nor /2."""
    src = y.shape[axis]
    if dst == src:
        return y
    if dst > src and dst % src == 0:
        return _upsample_axis_int(y, axis, dst // src)
    if src == 2 * dst and src >= 4:
        return _downsample_axis_2x(y, axis)
    return None


def _triangle_weights(src: int, dst: int) -> torch.Tensor:
    """jax.image.resize's (src, dst) bilinear weight matrix (its
    `compute_weight_mat` with the triangle kernel, antialias on, no
    translation), in f32: a triangle widened by the down-factor, each
    output's column normalized to sum 1, and zero where the sample lies
    outside the input."""
    inv_scale = 1.0 / (dst / src)
    kernel_scale = max(inv_scale, 1.0)
    f32 = torch.float32
    sample_f = (torch.arange(dst, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(src, dtype=f32)[:, None]).abs() \
        / kernel_scale
    weights = torch.clamp(1.0 - x, min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    eps = float(torch.finfo(f32).eps)
    weights = torch.where(total.abs() > 1000.0 * eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= src - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def _resize_general_bilinear(x: torch.Tensor, shape: tuple[int, int],
                             h_ax: int, w_ax: int) -> torch.Tensor:
    """`jax.image.resize(x, ..., "bilinear")`: each resized axis contracted
    with its weight matrix, cast to x's dtype, in x's dtype (JAX contracts
    at HIGHEST precision; it does not work in f32 as the fast paths do).
    The axes are contracted in the order of JAX's einsum path, the one of
    fewer multiply-adds (H first on a tie): in bf16 the rounding of the
    intermediate depends on it."""
    (sh, sw), (dh, dw) = (x.shape[h_ax], x.shape[w_ax]), shape
    axes = [(h_ax, dh), (w_ax, dw)]
    if sh * dw * (sw + dh) < sw * dh * (sh + dw):
        axes.reverse()
    y = x
    for axis, dst in axes:
        src = x.shape[axis]
        if dst == src:
            continue
        wm = _triangle_weights(src, dst).to(device=x.device, dtype=x.dtype)
        y = torch.tensordot(y.movedim(axis, -1), wm, dims=1).movedim(-1, axis)
    return y


def resize_bilinear_axes(x: torch.Tensor, shape: tuple[int, int],
                         h_ax: int, w_ax: int) -> torch.Tensor:
    """Bilinear resize of spatial axes (h_ax, w_ax) to `shape`, returned in
    x's dtype. As in the JAX package, the fast path is tried on H, then on
    W, in f32; if either axis misses it, the general resize runs on the
    original x over both axes, in x's own dtype."""
    yh = _fast_axis_bilinear(x.float(), h_ax, shape[0])
    y = None if yh is None else _fast_axis_bilinear(yh, w_ax, shape[1])
    if y is not None:
        return y.to(x.dtype)
    return _resize_general_bilinear(x, shape, h_ax, w_ax)


def resize_bilinear(x: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NHWC (or HWC) to spatial `shape` (half-pixel
    centres, == torch align_corners=False for up-factors)."""
    return resize_bilinear_axes(x, shape, x.ndim - 3, x.ndim - 2)


def _fast_axis_nearest(y: torch.Tensor, axis: int, dst: int):
    """Integer factors along one axis (repeat / strided slice), else None."""
    src = y.shape[axis]
    if dst == src:
        return y
    if dst > src and dst % src == 0:
        return torch.repeat_interleave(y, dst // src, dim=axis)
    if src % dst == 0:
        f = src // dst
        idx = [slice(None)] * y.ndim
        idx[axis] = slice(f // 2, None, f)
        return y[tuple(idx)]
    return None


def _resize_general_nearest(x: torch.Tensor,
                            shape: tuple[int, int]) -> torch.Tensor:
    """`jax.image.resize(x, ..., "nearest")`: along each resized axis,
    source index floor(f32((i + 0.5) * src / dst))."""
    y = x
    for axis, dst in ((x.ndim - 3, shape[0]), (x.ndim - 2, shape[1])):
        src = x.shape[axis]
        if dst == src:
            continue
        idx = torch.floor((torch.arange(dst, dtype=torch.float32) + 0.5)
                          * src / dst).long()
        y = y.index_select(axis, idx.to(x.device))
    return y


def resize_nearest(x: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Nearest resize of NHWC (or HWC) label/mask maps: integer factors on
    the fast path (tried on H, then W), else the general resize of the
    original x over both axes, as in the JAX package."""
    yh = _fast_axis_nearest(x, x.ndim - 3, shape[0])
    y = None if yh is None else _fast_axis_nearest(yh, x.ndim - 2, shape[1])
    return _resize_general_nearest(x, shape) if y is None else y
