"""One step of ring global matching: the CUDA kernel (kernel 6) and its
plain version.

Port of the per-step work of the JAX package's
`ops/ring_matching_pallas.py` (`_ring_kernel`, called by
`ring_matching_shard`): a member folds the bucketed shard it holds at this
step of the ring (`prepare_ref`'s layout, in f32) into an un-normalized
running min per (query, object),

    acc[q, o] = min(acc[q, o], min_{k in o} (|k|^2 - 2 q.k)),

starting from 1e8 at the first step; at the last step it adds |q|^2,
clamps to [0, 1e8] and normalizes into `out`. The rotation of the shards
between steps is `parallel/ring.py`'s; `parallel/cp_matching.py`'s
`ring_kernel` schedule drives both.

`ring_matching_step` launches the hand-written kernel
(`csrc/ring_matching.cu`) for CUDA tensors and runs the plain version
below for CPU tensors. There is no fallback between them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from cvpr2020_manet_tpu_torch.kernels import build
from cvpr2020_manet_tpu_torch.ops.matching import (
    WRONG_LABEL_PADDING_DISTANCE, normalize_distance)


class RingShard(NamedTuple):
    """The rotating arrays of one shard (a `BucketedRef` without its
    source index), f32 keys."""
    neg2pixels: torch.Tensor  # (NKB * TK, C_pad) f32 = -2 k
    sqnorm: torch.Tensor      # (NKB, TK) f32 = |k|^2 (1e8 on padding rows)
    block_obj: torch.Tensor   # (NKB,) int32, >= O on slack blocks


def ring_matching_step_plain(query: torch.Tensor, shard: RingShard,
                             acc: torch.Tensor, out: torch.Tensor, *,
                             first: bool, last: bool) -> None:
    """Plain PyTorch version of the kernel, in place on acc / out: one
    matmul per reference block, a running min per object, and at the last
    step |q|^2, clamp and normalize."""
    o = acc.shape[1]
    block_k = shard.sqnorm.shape[1]
    if first:
        acc.fill_(WRONG_LABEL_PADDING_DISTANCE)
    for j, obj in enumerate(shard.block_obj.tolist()):
        if obj >= o:
            continue                                     # slack block
        k = shard.neg2pixels[j * block_k:(j + 1) * block_k]
        e = query @ k.T + shard.sqnorm[j][None, :]
        acc[:, obj] = torch.minimum(acc[:, obj], e.amin(dim=1))
    if last:
        qn = query.square().sum(-1, keepdim=True)
        out.copy_(normalize_distance(torch.clamp(
            torch.clamp(acc + qn, min=0.0), max=WRONG_LABEL_PADDING_DISTANCE)))


def _check(query: torch.Tensor, shard: RingShard, acc: torch.Tensor,
           out: torch.Tensor) -> None:
    """What the kernel takes: f32 query and keys of the same width (a
    multiple of 32, at most 128), 16-byte aligned, blocks of a multiple of
    128 rows, f32 norms and accumulators, int32 block objects, all
    contiguous on one CUDA device."""
    if query.device.type != "cuda":
        raise ValueError(f"unsupported device {query.device}")
    neg2, sqnorm, block_obj = shard
    nq, c = query.shape
    nkb, block_k = sqnorm.shape
    f32 = (query, neg2, sqnorm, acc, out)
    if any(t.dtype != torch.float32 for t in f32) \
            or block_obj.dtype != torch.int32:
        raise TypeError("query, keys, norms, acc and out must be f32, "
                        "block_obj int32")
    if (neg2.shape != (nkb * block_k, c) or block_obj.shape != (nkb,)
            or acc.shape != out.shape or acc.shape[0] != nq):
        raise ValueError("query / shard / accumulator shapes disagree")
    if c > 128 or c % 32:
        raise ValueError(f"the kernel takes up to 128 channels in steps of "
                         f"32, got {c}")
    if block_k % 128:
        raise ValueError(f"the kernel takes blocks of a multiple of 128 "
                         f"rows, got {block_k}")
    for t in (*f32, block_obj):
        if t.device != query.device or not t.is_contiguous():
            raise ValueError("query, shard, acc and out must be contiguous "
                             "on one device")
    for name, t in (("query", query), ("neg2pixels", neg2)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


# query, neg2, sqnorm, block_obj, acc, out; nq; c, nkb, block_k, o, first,
# last; stream
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 6
             + [ctypes.c_void_p])


def ring_matching_step(query: torch.Tensor, shard: RingShard,
                       acc: torch.Tensor, out: torch.Tensor, *, first: bool,
                       last: bool) -> None:
    """One member's ring step on its current shard: query (Nq, C) f32
    padded to the keys' width, acc (Nq, O) f32 carried between steps, out
    (Nq, O) f32 written at the last step. Launches kernel 6 for CUDA
    tensors; runs the plain version for CPU tensors."""
    if query.device.type == "cpu":
        ring_matching_step_plain(query, shard, acc, out, first=first,
                                 last=last)
        return
    _check(query, shard, acc, out)
    nq, c = query.shape
    if nq == 0:
        return
    nkb, block_k = shard.sqnorm.shape
    name = "ring_matching"
    fn = build.kernel_function(name, "manet_ring_matching_step", _ARGTYPES)
    with torch.cuda.device(query.device):
        err = fn(query.data_ptr(), shard.neg2pixels.data_ptr(),
                 shard.sqnorm.data_ptr(), shard.block_obj.data_ptr(),
                 acc.data_ptr(), out.data_ptr(), nq, c, nkb, block_k,
                 acc.shape[1], int(first), int(last),
                 torch.cuda.current_stream(query.device).cuda_stream)
    build.check_launch(name, err)
