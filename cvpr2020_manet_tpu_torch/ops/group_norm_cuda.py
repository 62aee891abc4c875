"""GroupNorm with the call sites' residual add and ReLU: the CUDA kernel
pair and its plain version.

The model's norm sites (`models/layers.GroupNorm`) compute, on NCHW input
of `groups` groups with f32 scale and bias,

    y = relu(bf16(GroupNorm_f32(x)) + residual)      (each part optional,
                                                      a residual with ReLU)

with the statistics and the affine in f32 (eps 1e-6, Flax's), the result
rounded to the input dtype, the residual added in that dtype and ReLU
last. The kernel's epilogues are the three the model's sites use: ReLU
(the stem, norm1/norm2, the ASPP, the decoder, the heads), the residual
then ReLU (norm3) and none (the shortcut's norm); it refuses a residual
without ReLU. `group_norm` goes through the custom op `torch.ops.manet.group_norm`:
its CUDA registration launches kernel 7 (`csrc/group_norm.cu`: split
statistics, then an apply with the epilogue, two launches of one C
entry), its CPU registration runs the plain version (`group_norm_plain`:
`F.group_norm` on `x.float()`, then the residual and ReLU as separate
ops), and its fake implementation gives the output's shape for
`torch.export`. The kernel takes bf16 activations only.

Kernel 7 replaces no TPU kernel (Flax's `nn.GroupNorm` is left to XLA);
it replaces aten's f32 chain on the card, which moved about 28 bytes an
element against the kernel pair's 6 (8 with a residual).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from cvpr2020_manet_tpu_torch.device import sm_count
from cvpr2020_manet_tpu_torch.kernels import build

VEC = 8                # bf16 elements in a 16-byte vector (the chunks' unit)
THREADS = 256          # a block of either launch (csrc/group_norm.cu)
# Blocks the statistics and the apply each aim for: about one full wave of
# 256-thread blocks on every SM.
BLOCKS_PER_SM = 8
# A block's least chunk: eight vectors a thread (two groups of four loads
# in flight), so that a block's merge is a small part of its time. Over
# 4-8 blocks an SM and 2-8 vectors a thread this rule was the fastest or
# within 2% of it at every site of the served paths on an H100.
MIN_CHUNK = 8 * THREADS * VEC
MAX_SPLITS = 64        # partials a row (the apply's warp merges them)


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, residual: Optional[torch.Tensor],
                     groups: int, eps: float, relu: bool) -> torch.Tensor:
    """The plain version: F.group_norm in f32, cast back to x's dtype, the
    residual added in that dtype, then ReLU."""
    y = F.group_norm(x.float(), groups, weight, bias, eps).to(x.dtype)
    if residual is not None:
        y = y + residual
    return F.relu(y) if relu else y


# Below this magnitude a bf16 ulp is taken at this one's: there the f32
# rounding of the affine's shift, about |shift| * 2^-24, which the order of
# the statistics' sums moves, is no longer small against an ulp.
ULP_FLOOR = 2.0 ** -10


def bf16_ulps(got: torch.Tensor, want: torch.Tensor,
              normalized: Optional[torch.Tensor] = None) -> torch.Tensor:
    """|got - want| in bf16 ulps of the larger magnitude of the two and of
    `normalized` (the value before a residual add, whose ulp a sum that
    cancels it keeps), at least ULP_FLOOR's: the measure kernel 7 is held
    to against `group_norm_plain`."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs())
    if normalized is not None:
        mag = torch.maximum(mag, normalized.float().abs())
    mag = mag.clamp(min=ULP_FLOOR)
    return (g - w).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)


class Plan(NamedTuple):
    """Kernel 7's grid: each (n, g) row of `row_len` elements in `splits`
    statistics chunks of `chunk`, each (n, c) plane of H * W in
    `plane_splits` apply chunks of `plane_chunk` (chunks multiples of 8
    elements, the last of a row or plane shorter)."""
    splits: int
    chunk: int
    plane_splits: int
    plane_chunk: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _chunks(length: int, units: int, target: int, most: int) -> tuple[int, int]:
    """Cut each of `units` rows or planes of `length` elements into (count,
    size) chunks: enough that units x count reaches `target` blocks, at
    most `most`, none under MIN_CHUNK unless the whole is."""
    want = max(1, min(most, _cdiv(target, units), _cdiv(length, MIN_CHUNK)))
    size = _cdiv(_cdiv(length, want), VEC) * VEC
    return _cdiv(length, size), size


@functools.lru_cache(maxsize=1024)
def plan(n: int, channels: int, hw: int, groups: int, sms: int) -> Plan:
    """The grid of one call, from its shape and the card's SM count."""
    target = BLOCKS_PER_SM * sms
    splits, chunk = _chunks(channels // groups * hw, n * groups, target,
                            MAX_SPLITS)
    plane_splits, plane_chunk = _chunks(hw, n * channels, target, 1 << 30)
    return Plan(splits, chunk, plane_splits, plane_chunk)


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           residual: Optional[torch.Tensor], groups: int, relu: bool) -> None:
    """What the kernel takes: bf16 NCHW activations (and residual of the
    same shape, with ReLU) on one CUDA device, f32 (C,) scale and bias, C
    divisible by `groups`."""
    if residual is not None and not relu:
        raise ValueError("the kernel adds a residual only before ReLU")
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 4 or x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bf16 NCHW, got {x.dtype} "
                        f"{tuple(x.shape)}")
    c = x.shape[1]
    if c % groups:
        raise ValueError(f"{c} channels do not divide into {groups} groups")
    for name, t in (("weight", weight), ("bias", bias)):
        if (t.dtype != torch.float32 or t.shape != (c,)
                or t.device != x.device):
            raise ValueError(f"{name} must be f32 ({c},) on {x.device}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype
                                 or residual.device != x.device):
        raise ValueError(f"residual {residual.dtype} {tuple(residual.shape)}"
                         f" on {residual.device} does not match x")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, contiguous from a 16-byte aligned address (a copy otherwise)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


# x, residual, y, weight, bias, partial; n; channels; hw; groups, splits;
# chunk; plane_splits; plane_chunk; eps; relu; stream
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            residual: Optional[torch.Tensor], groups: int, eps: float,
            relu: bool):
    """Check CUDA inputs and launch the kernel pair on `plan`'s grid. ->
    (y, bf16 like x; the statistics' partials, (N * G * splits, 2) f32:
    each chunk's mean and sum of squared deviations, row by row, in split
    order)."""
    _check(x, weight, bias, residual, groups, relu)
    x = _aligned(x)
    residual = None if residual is None else _aligned(residual)
    weight, bias = weight.contiguous(), bias.contiguous()
    n, c, h, w = x.shape
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y, None
    grid = plan(n, c, h * w, groups, sm_count(x.device))
    partial = torch.empty((n * groups * grid.splits, 2), dtype=torch.float32,
                          device=x.device)
    fn = build.kernel_function("group_norm", "manet_group_norm", _ARGTYPES)
    # a norm is a few microseconds of device work at the heads' sizes, so
    # the host's part counts: the raw stream handle, and a device switch
    # only where x is not on the current device
    index = x.device.index
    args = (x.data_ptr(), None if residual is None else residual.data_ptr(),
            y.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            partial.data_ptr(), n, c, h * w, groups, grid.splits, grid.chunk,
            grid.plane_splits, grid.plane_chunk, eps, int(relu),
            torch._C._cuda_getCurrentRawStream(index))
    if index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    build.check_launch("group_norm", err)
    return y, partial


# Kernel 7 as a custom op of the `manet` namespace, registered as kernels
# 1-3 are: CUDA the kernel pair, CPU the plain version, a fake
# implementation for torch.export.
_LIB = torch.library.Library("manet", "FRAGMENT")
_LIB.define("group_norm(Tensor x, Tensor weight, Tensor bias, "
            "Tensor? residual, int groups, float eps, bool relu) -> Tensor")


@torch.library.register_fake("manet::group_norm", lib=_LIB)
def _group_norm_fake(x, weight, bias, residual, groups, eps, relu):
    return x.new_empty(x.shape)


def _group_norm_cuda(x, weight, bias, residual, groups, eps, relu):
    return _launch(x, weight, bias, residual, groups, eps, relu)[0]


_LIB.impl("group_norm", group_norm_plain, "CPU")
_LIB.impl("group_norm", _group_norm_cuda, "CUDA")


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               residual: Optional[torch.Tensor] = None, *, groups: int,
               eps: float, relu: bool = False) -> torch.Tensor:
    """relu(bf16(GroupNorm(x)) + residual), each part optional, through
    `torch.ops.manet.group_norm`: kernel 7 for CUDA tensors, the plain
    version for CPU ones. No autograd."""
    return torch.ops.manet.group_norm(x, weight, bias, residual, groups,
                                      eps, relu)
