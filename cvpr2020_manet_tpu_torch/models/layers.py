"""Shared layers: Flax-semantics conv and norms, resize.

Port of the JAX package's `models/layers.py`. Flax behaviours kept on
purpose:

- `Conv`: parameters stay float32 and are cast, with the input, to the
  module's compute dtype at call time (Flax `nn.Conv(dtype=...)`).
- The norms of `make_norm` ('gn', 'bn', 'syncbn', 'ln', 'frozen'):
  `GroupNorm` (epsilon 1e-6, Flax's default; PyTorch's is 1e-5),
  `BatchNorm` (batch statistics always, epsilon 1e-5, running averages at
  momentum 0.99 that never feed the output), `LayerNorm` over the channels
  of each pixel (epsilon 1e-6) take their statistics and affine in float32
  and cast the result back to the input dtype; the statistics use Flax's
  fast variance E[x^2] - E[x]^2 clipped at 0. `FrozenAffine` (folded
  pretrained BN) multiplies and adds in the compute dtype, as JAX's does.

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

    FLAX_NAME = "GroupNorm"

    def __init__(self, groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.groups, self.weight, self.bias,
                            self.eps).to(x.dtype)


def _chw(t: torch.Tensor) -> torch.Tensor:
    """A per-channel vector (C,) as (C, 1, 1), against NCHW."""
    return t[:, None, None]


def _normalize(x32, mean, var, scale, bias, eps: float) -> torch.Tensor:
    """Flax's `_normalize` in f32: (x - mean) * (rsqrt(var + eps) * scale)
    + bias, every argument broadcast against x."""
    return (x32 - mean) * (torch.rsqrt(var + eps) * scale) + bias


class BatchNorm(nn.Module):
    """Flax `nn.BatchNorm(use_running_average=False, momentum=0.99)` on
    NCHW input: the moments of the batch over N, H and W, in training and
    in eval alike (the JAX model's `make_norm('bn')`). Every call updates
    the running `mean` / `var` buffers as Flax's `apply(...,
    mutable=['batch_stats'])` does; they never feed the output.

    `group`: with it, the per-channel sum, sum of squares and count are
    summed over the ranks of that `torch.distributed` process group before
    the moments are formed ('syncbn', Flax's `axis_name`), through the
    autograd-aware all-reduce, so the backward is the full batch's too."""

    FLAX_NAME = "BatchNorm"

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.99, sync: bool = False, group=None):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.sync, self.group = sync, group
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def _moments(self, x32: torch.Tensor):
        dims = (0, 2, 3)
        if not self.sync:
            return x32.mean(dims), x32.square().mean(dims)
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError(
                "norm='syncbn' needs a torch.distributed process group "
                "(parallel/distributed.initialize); use 'bn' in one process")
        from torch.distributed.nn.functional import all_reduce
        n = torch.full_like(x32[0, :, 0, 0], x32.numel() / x32.shape[1])
        group = dist.group.WORLD if self.group is None else self.group
        sums = all_reduce(torch.stack([x32.sum(dims), x32.square().sum(dims),
                                       n]), group=group)
        return sums[0] / sums[2], sums[1] / sums[2]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean, mean2 = self._moments(x32)
        var = torch.clamp(mean2 - mean.square(), min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        return _normalize(x32, _chw(mean), _chw(var), _chw(self.weight),
                          _chw(self.bias), self.eps).to(x.dtype)


class LayerNorm(nn.Module):
    """Flax `nn.LayerNorm` over the channel axis at each pixel (NCHW dim 1):
    eps 1e-6, f32 statistics and affine, the result in the input dtype."""

    FLAX_NAME = "LayerNorm"

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(1, keepdim=True)
        var = torch.clamp(x32.square().mean(1, keepdim=True) - mean.square(),
                          min=0.0)
        return _normalize(x32, mean, var, _chw(self.weight), _chw(self.bias),
                          self.eps).to(x.dtype)


class FrozenAffine(nn.Module):
    """Frozen BatchNorm as a per-channel affine, y = x * scale + bias, the
    JAX package's `FrozenAffine`: pretrained BN statistics folded into
    (scale, bias) (`utils/pretrained.py`). Scale and bias are cast to the
    compute dtype before the product (bf16 at the flagship), not computed
    in f32 as the other norms are."""

    FLAX_NAME = "FrozenAffine"

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return (x * _chw(self.weight.to(dt))
                + _chw(self.bias.to(dt))).to(x.dtype)


NORMS = ("gn", "bn", "syncbn", "ln", "frozen")
NORM_MODULES = (GroupNorm, BatchNorm, LayerNorm, FrozenAffine)


def make_norm(norm: str, dtype: torch.dtype, gn_groups: int = 32,
              group=None):
    """-> a constructor `ctor(channels)` of the norm module `norm` names
    (JAX `make_norm`): 'gn' GroupNorm with `gn_groups` groups, 'bn'
    BatchNorm, 'syncbn' BatchNorm with its moments summed over the process
    group `group` (default: the world), 'ln' LayerNorm, 'frozen'
    FrozenAffine computed in `dtype`."""
    if norm == "gn":
        return lambda c: GroupNorm(gn_groups, c)
    if norm in ("bn", "syncbn"):
        return lambda c: BatchNorm(c, sync=norm == "syncbn", group=group)
    if norm == "ln":
        return LayerNorm
    if norm == "frozen":
        return lambda c: FrozenAffine(c, dtype)
    raise ValueError(f"unknown norm {norm!r}: one of {NORMS}")


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init at the scale of Flax's defaults: conv kernels
    normal with variance 1/fan_in (cut at 2 sigma, as lecun_normal),
    biases 0, every norm's scale 1 and bias 0, BatchNorm's running mean 0
    and variance 1. Runs on the CPU so the weights do not depend on the
    device."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Conv):
                fan_in = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
                w = torch.randn(m.weight.shape, generator=generator)
                m.weight.copy_(w.clamp_(-2.0, 2.0) / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, NORM_MODULES):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, BatchNorm):
                    m.mean.zero_()
                    m.var.fill_(1.0)


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
