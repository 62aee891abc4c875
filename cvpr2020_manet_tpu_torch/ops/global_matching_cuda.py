"""Global matching against a bucketed reference: the CUDA kernel and its
plain version.

Port of the JAX package's `ops/matching_pallas.py` (`BucketedRef`,
`_bucket_layout`, `prepare_ref`, `global_matching_prepared`). The
reference pixels are sorted by object ONCE per round into block_k-row
blocks, one object per block, with -2k in the model dtype and the f32 |k|^2
(1e8 on padding rows) precomputed; the matching then needs one product and
one add per (query, key) pair and one min per tile:

    min_k |q - k|^2 = |q|^2 + min_k (|k|^2 - 2 q.k)

`global_matching_prepared` launches the hand-written kernel
(`csrc/global_matching.cu`, which replaces the TPU kernel
`matching_pallas.py::_matching_kernel`) for a CUDA query, and runs the
plain version below for a CPU query. There is no fallback between them.

`global_matching_prepared_argmin` does the same with the kernel's argmin
variant (which replaces `matching_pallas.py::_matching_kernel_argmin`):
it also returns each minimum's row in the bucketed layout, for the
training path's argmin-routed backward (`ops/trainable.py`).

`global_matching_prepared_int8` is the opt-in int8 serving mode (it
replaces `matching_pallas.py::_matching_kernel_int8`): the reference is
quantized once per round with one symmetric scale (`prepare_ref_int8`),
each query row with its own (`quantize_rows_int8`), and the cross term
runs on the int8 tensor cores with int32 accumulation. The result is the
exact f32 distance between the dequantized vectors:

    d = s_q^2 |q^|^2 + s_k^2 |k^|^2 - 2 s_q s_k (q^ . k^)
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from cvpr2020_manet_tpu_torch.kernels import build
from cvpr2020_manet_tpu_torch.ops.matching import (
    WRONG_LABEL_PADDING_DISTANCE, acc_dtype, normalize_distance)

DEFAULT_TK = 512


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class BucketedRef(NamedTuple):
    """Reference memory sorted into per-object blocks (device tensors)."""
    neg2pixels: torch.Tensor  # (NKB * TK, C_pad) = -2 * embeddings, model dtype
    sqnorm: torch.Tensor      # (NKB, TK) f32 = |k|^2 (1e8 on padding rows)
    block_obj: torch.Tensor   # (NKB,) int32: object of each block (o_pad = slack)
    src_idx: torch.Tensor     # (NKB * TK,) int32: source ref row (-1 = padding)
    num_objects: int          # unpadded object count


class BucketedRefInt8(NamedTuple):
    """The int8 reference: `BucketedRef`'s layout with k = scale * pixels."""
    pixels: torch.Tensor      # (NKB * TK, C_pad) int8, object-contiguous
    sqnorm: torch.Tensor      # (NKB, TK) f32 = scale^2 |k^|^2 (1e8 on padding)
    block_obj: torch.Tensor   # (NKB,) int32
    src_idx: torch.Tensor     # (NKB * TK,) int32 (-1 = padding)
    scale: torch.Tensor       # () f32 symmetric quantization scale
    num_objects: int


def _bucket_layout(ref_onehot: torch.Tensor, ref_valid: torch.Tensor | None,
                   block_k: int):
    """Per-object bucketing of reference pixels. Returns (src_idx, block_obj,
    nkb, o, o_pad): src_idx (NKB*TK,) int32 with -1 on padding rows,
    block_obj (NKB,) int32 with the o_pad sentinel on slack blocks."""
    nk, o = ref_onehot.shape
    dev = ref_onehot.device
    o_pad = _round_up(o, 8)
    nkb = _round_up(nk, block_k) // block_k + o_pad     # static upper bound

    gate = ref_onehot.float()
    if ref_valid is not None:
        gate = gate * ref_valid.float()[:, None]
    has_obj = gate.amax(dim=1) > 0
    labels = torch.where(has_obj, gate.argmax(dim=1),
                         torch.full_like(has_obj, o_pad, dtype=torch.long))

    counts = torch.bincount(labels, minlength=o_pad + 1)[:o_pad]
    blk_per_obj = (counts + block_k - 1) // block_k
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    start_blk = torch.cat([zero, torch.cumsum(blk_per_obj, 0)[:-1]])
    seg_start = torch.cat([zero, torch.cumsum(counts, 0)[:-1]])

    order = torch.argsort(labels, stable=True)
    lab_sorted = labels[order]
    rank = torch.arange(nk, device=dev)
    lab_c = torch.clamp(lab_sorted, 0, o_pad - 1)
    dest = start_blk[lab_c] * block_k + (rank - seg_start[lab_c])
    # unlabelled pixels land on one spare row past the end, sliced off below
    dest = torch.where(lab_sorted >= o_pad,
                       torch.full_like(dest, nkb * block_k), dest)
    src_idx = torch.full((nkb * block_k + 1,), -1, dtype=torch.int32,
                         device=dev)
    src_idx[dest] = order.to(torch.int32)
    src_idx = src_idx[:-1]

    blk = torch.arange(nkb, device=dev)
    total_blocks = blk_per_obj.sum()
    block_obj = torch.searchsorted(start_blk, blk, right=True) - 1
    block_obj = torch.where(blk < total_blocks, block_obj,
                            torch.full_like(block_obj, o_pad))
    return src_idx, block_obj.to(torch.int32), nkb, o, o_pad


def prepare_ref(ref: torch.Tensor, ref_onehot: torch.Tensor,
                ref_valid: torch.Tensor | None = None, *,
                block_k: int = DEFAULT_TK) -> BucketedRef:
    """Sort reference pixels (Nk, C) by object into block_k-aligned
    buckets. Run once per interaction round; the sweep reuses it."""
    nk, c = ref.shape
    c_pad = _round_up(c, 128)
    src_idx, block_obj, nkb, o, _ = _bucket_layout(ref_onehot, ref_valid,
                                                   block_k)
    ref_pad = F.pad(ref, (0, c_pad - c))
    filled = src_idx >= 0
    gather = torch.clamp(src_idx, 0, nk - 1).long()
    neg2 = torch.where(filled[:, None], -2.0 * ref_pad[gather],
                       torch.zeros((), dtype=ref.dtype, device=ref.device))
    kn_rows = ref_pad.to(acc_dtype(ref)).square().sum(-1)
    sqnorm = torch.where(filled, kn_rows[gather],
                         torch.full_like(kn_rows[gather],
                                         WRONG_LABEL_PADDING_DISTANCE))
    return BucketedRef(neg2pixels=neg2.contiguous(),
                       sqnorm=sqnorm.reshape(nkb, block_k).contiguous(),
                       block_obj=block_obj, src_idx=src_idx, num_objects=o)


def quantize_symmetric_int8(x: torch.Tensor,
                            row_mask: torch.Tensor | None = None):
    """Symmetric per-tensor int8: x ~= scale * x^, scale = max(max|x|,
    1e-6) / 127 in f32 and x^ = round(x / scale) (half to even), clipped
    to +-127. `row_mask` (rows,) limits the statistic to the marked rows;
    the others are still quantized with it. -> (x^ int8, scale () f32)."""
    x32 = x.float()
    stat = x32 if row_mask is None else torch.where(
        row_mask.bool()[:, None], x32, 0.0)
    scale = torch.clamp(stat.abs().amax(), min=1e-6) / 127.0
    x_hat = torch.clamp(torch.round(x32 / scale), -127.0, 127.0)
    return x_hat.to(torch.int8), scale


def quantize_rows_int8(x: torch.Tensor):
    """Symmetric per-row int8 (the query side: a row's values depend on
    that row alone, so they do not depend on how rows are batched into
    launches). -> (x^ (N, C) int8, scales (N,) f32)."""
    x32 = x.float()
    scales = torch.clamp(x32.abs().amax(dim=-1), min=1e-6) / 127.0
    x_hat = torch.clamp(torch.round(x32 / scales[:, None]), -127.0, 127.0)
    return x_hat.to(torch.int8), scales


def prepare_ref_int8(ref: torch.Tensor, ref_onehot: torch.Tensor,
                     ref_valid: torch.Tensor | None = None, *,
                     block_k: int = DEFAULT_TK) -> BucketedRefInt8:
    """Int8 `prepare_ref`. The scale is taken over the rows that enter a
    bucket (labelled and, with `ref_valid`, valid), so that a gated-out
    outlier cannot coarsen every key; `sqnorm` carries scale^2, so the
    kernel's distances come out in the embedding space."""
    nk, c = ref.shape
    c_pad = _round_up(c, 128)
    src_idx, block_obj, nkb, o, _ = _bucket_layout(ref_onehot, ref_valid,
                                                   block_k)
    used = (ref_onehot != 0).any(dim=-1)
    if ref_valid is not None:
        used = used & (ref_valid != 0)
    k_hat, scale = quantize_symmetric_int8(ref, row_mask=used)
    k_pad = F.pad(k_hat, (0, c_pad - c))
    filled = src_idx >= 0
    gather = torch.clamp(src_idx, 0, nk - 1).long()
    pixels = torch.where(filled[:, None], k_pad[gather],
                         torch.zeros((), dtype=torch.int8, device=ref.device))
    kn_rows = k_pad.float().square().sum(-1) * (scale * scale)
    sqnorm = torch.where(filled, kn_rows[gather], WRONG_LABEL_PADDING_DISTANCE)
    return BucketedRefInt8(pixels=pixels.contiguous(),
                           sqnorm=sqnorm.reshape(nkb, block_k).contiguous(),
                           block_obj=block_obj, src_idx=src_idx, scale=scale,
                           num_objects=o)


def _plain(query: torch.Tensor, bucketed: BucketedRef, argmin: bool):
    """Both plain versions: one matmul per reference block (f32
    accumulation, f64 for f64 inputs; bf16 products are exact in f32), a running min (and its
    bucketed row) per object, then |q|^2, clamp and normalize. Blocks are
    visited in order and a block replaces the running minimum only when it
    is smaller, and `argmin` keeps the first of equal values in a block, so
    the lowest bucketed row wins ties, as in the kernels."""
    nq, c = query.shape
    c_pad = bucketed.neg2pixels.shape[1]
    o = bucketed.num_objects
    block_k = bucketed.sqnorm.shape[1]
    q = F.pad(query, (0, c_pad - c)).to(acc_dtype(query))
    acc = torch.full((nq, o), WRONG_LABEL_PADDING_DISTANCE, dtype=q.dtype,
                     device=query.device)
    idx = torch.full((nq, o), -1, dtype=torch.int32, device=query.device)
    for j, obj in enumerate(bucketed.block_obj.tolist()):
        if obj >= o:
            continue                                     # slack block
        k = bucketed.neg2pixels[j * block_k:(j + 1) * block_k].to(q.dtype)
        e = q @ k.T + bucketed.sqnorm[j][None, :]
        if argmin:
            bmin, barg = e.min(dim=1)
            better = bmin < acc[:, obj]
            acc[:, obj] = torch.where(better, bmin, acc[:, obj])
            idx[:, obj] = torch.where(better, (barg + j * block_k).int(),
                                      idx[:, obj])
        else:
            acc[:, obj] = torch.minimum(acc[:, obj], e.amin(dim=1))
    qn = q.square().sum(-1, keepdim=True)
    d = torch.clamp(torch.clamp(acc + qn, min=0.0),
                    max=WRONG_LABEL_PADDING_DISTANCE)
    return normalize_distance(d), idx


def global_matching_prepared_plain(query: torch.Tensor,
                                   bucketed: BucketedRef) -> torch.Tensor:
    """Plain PyTorch version of the kernel. -> (Nq, O) f32."""
    return _plain(query, bucketed, argmin=False)[0]


def global_matching_prepared_argmin_plain(query: torch.Tensor,
                                          bucketed: BucketedRef):
    """Plain PyTorch version of the argmin kernel. -> (distances (Nq, O)
    f32, bucketed rows (Nq, O) int32, -1 for an object without rows)."""
    return _plain(query, bucketed, argmin=True)


def _checked_query(query: torch.Tensor, bucketed: BucketedRef) -> torch.Tensor:
    """Check a CUDA query against the prepared reference and what the
    kernels take; returns the query zero-padded to the reference's width."""
    if query.device.type != "cuda":
        raise ValueError(f"unsupported device {query.device}")
    neg2, sqnorm, block_obj = (bucketed.neg2pixels, bucketed.sqnorm,
                               bucketed.block_obj)
    c = query.shape[1]
    c_pad = neg2.shape[1]
    nkb, block_k = sqnorm.shape
    if query.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"query dtype {query.dtype}: f32 or bf16 only")
    if neg2.dtype != query.dtype:
        raise TypeError(f"reference dtype {neg2.dtype} != query {query.dtype}")
    if sqnorm.dtype != torch.float32 or block_obj.dtype != torch.int32:
        raise TypeError("sqnorm must be f32 and block_obj int32")
    if c > c_pad or neg2.shape[0] != nkb * block_k or block_obj.shape != (nkb,):
        raise ValueError("query / bucketed reference shapes disagree")
    if c_pad != 128:
        raise ValueError(f"the kernel takes 128 channels, got {c_pad}")
    for t in (neg2, sqnorm, block_obj):
        if t.device != query.device or not t.is_contiguous():
            raise ValueError("bucketed reference must be contiguous on the "
                             "query's device")
    q = F.pad(query, (0, c_pad - c)).contiguous()
    for name, t in (("query", q), ("neg2pixels", neg2)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return q


# query, neg2, sqnorm, block_obj, out[, idx]; nq; c, nkb, block_k, o,
# is_bf16; stream
_ARGTYPES = {argmin: [ctypes.c_void_p] * (6 if argmin else 5)
             + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
             for argmin in (False, True)}


def _launch(query: torch.Tensor, bucketed: BucketedRef, argmin: bool):
    """Check a CUDA query and launch the kernel (or its argmin variant).
    -> (out, idx), idx None without `argmin`."""
    q = _checked_query(query, bucketed)
    nq = q.shape[0]
    nkb, block_k = bucketed.sqnorm.shape
    o = bucketed.num_objects
    out = torch.empty((nq, o), dtype=torch.float32, device=q.device)
    idx = (torch.empty((nq, o), dtype=torch.int32, device=q.device)
           if argmin else None)
    if nq == 0:
        return out, idx
    name = "global_matching_argmin" if argmin else "global_matching"
    fn = build.kernel_function(name, f"manet_{name}", _ARGTYPES[argmin])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), bucketed.neg2pixels.data_ptr(),
                 bucketed.sqnorm.data_ptr(), bucketed.block_obj.data_ptr(),
                 out.data_ptr(), *([idx.data_ptr()] if argmin else []),
                 nq, q.shape[1], nkb, block_k, o,
                 int(q.dtype == torch.bfloat16),
                 torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(name, err)
    return out, idx


def global_matching_prepared(query: torch.Tensor,
                             bucketed: BucketedRef) -> torch.Tensor:
    """Matching of query rows (Nq, C) against a prepared reference ->
    (Nq, O) f32. Launches the CUDA kernel for a CUDA query; runs the plain
    version for a CPU query."""
    if query.device.type == "cpu":
        return global_matching_prepared_plain(query, bucketed)
    return _launch(query, bucketed, argmin=False)[0]


def global_matching_prepared_argmin(query: torch.Tensor,
                                    bucketed: BucketedRef):
    """Matching plus winners: -> (distances (Nq, O) f32, bucketed rows
    (Nq, O) int32, -1 for an object without rows). Launches the argmin
    kernel for a CUDA query; runs the plain version for a CPU query."""
    if query.device.type == "cpu":
        return global_matching_prepared_argmin_plain(query, bucketed)
    return _launch(query, bucketed, argmin=True)


def global_matching_cuda(query: torch.Tensor, ref: torch.Tensor,
                         ref_onehot: torch.Tensor,
                         ref_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Drop-in for ops.matching.global_matching: prepare + match. Query and
    reference meet in their promoted type, as in JAX: a bf16 query against
    the f32 memory of the streaming engine matches in f32."""
    dt = torch.promote_types(query.dtype, ref.dtype)
    return global_matching_prepared(
        query.to(dt), prepare_ref(ref.to(dt), ref_onehot, ref_valid))


# ------------------------------------------------------------------ int8


def _int8_query(query: torch.Tensor, bucketed: BucketedRefInt8):
    """Quantize the query per row and pad it to the reference's width.
    -> (q^ (Nq, C_pad) int8, per-row scales (Nq, 2) f32 holding
    [-2 s_q s_k, s_q^2], multiplied in that order as on the TPU)."""
    c, c_pad = query.shape[1], bucketed.pixels.shape[1]
    if c > c_pad:
        raise ValueError(f"query has {c} channels, the reference {c_pad}")
    q_hat, s_q = quantize_rows_int8(query)
    q_hat = F.pad(q_hat, (0, c_pad - c))
    scales = torch.stack([-2.0 * s_q * bucketed.scale, s_q * s_q], dim=-1)
    return q_hat.contiguous(), scales.contiguous()


def global_matching_prepared_int8_plain(query: torch.Tensor,
                                        bucketed: BucketedRefInt8
                                        ) -> torch.Tensor:
    """Plain PyTorch version of the int8 kernel: one matmul per block over
    the int8 values widened to f32 (exact: every product and partial sum
    is an integer below 2^24), e = cross * (-2 s_q s_k) + s_k^2 |k^|^2, a
    running min per object, then + s_q^2 |q^|^2, clamp and normalize.
    -> (Nq, O) f32."""
    q_hat, scales = _int8_query(query, bucketed)
    q = q_hat.float()
    o = bucketed.num_objects
    block_k = bucketed.sqnorm.shape[1]
    acc = torch.full((q.shape[0], o), WRONG_LABEL_PADDING_DISTANCE,
                     dtype=torch.float32, device=q.device)
    for j, obj in enumerate(bucketed.block_obj.tolist()):
        if obj >= o:
            continue                                     # slack block
        k = bucketed.pixels[j * block_k:(j + 1) * block_k].float()
        e = (q @ k.T) * scales[:, :1] + bucketed.sqnorm[j][None, :]
        acc[:, obj] = torch.minimum(acc[:, obj], e.amin(dim=1))
    qn = q.square().sum(-1) * scales[:, 1]
    d = torch.clamp(torch.clamp(acc + qn[:, None], min=0.0),
                    max=WRONG_LABEL_PADDING_DISTANCE)
    return normalize_distance(d)


def _check_int8(q_hat: torch.Tensor, scales: torch.Tensor,
                bucketed: BucketedRefInt8) -> None:
    """What the int8 kernel takes: int8 query and keys of 128 channels,
    16-byte aligned, f32 norms and scales, all contiguous on one CUDA
    device."""
    if q_hat.device.type != "cuda":
        raise ValueError(f"unsupported device {q_hat.device}")
    pixels, sqnorm, block_obj = (bucketed.pixels, bucketed.sqnorm,
                                 bucketed.block_obj)
    nkb, block_k = sqnorm.shape
    if q_hat.dtype != torch.int8 or pixels.dtype != torch.int8:
        raise TypeError(f"query {q_hat.dtype} and reference {pixels.dtype}: "
                        "int8 only")
    if (sqnorm.dtype != torch.float32 or scales.dtype != torch.float32
            or block_obj.dtype != torch.int32):
        raise TypeError("sqnorm and scales must be f32, block_obj int32")
    if (q_hat.shape[1] != pixels.shape[1] or pixels.shape[0] != nkb * block_k
            or block_obj.shape != (nkb,)
            or scales.shape != (q_hat.shape[0], 2)):
        raise ValueError("query / bucketed reference shapes disagree")
    if pixels.shape[1] != 128:
        raise ValueError(f"the kernel takes 128 channels, got "
                         f"{pixels.shape[1]}")
    for t in (q_hat, scales, pixels, sqnorm, block_obj):
        if t.device != q_hat.device or not t.is_contiguous():
            raise ValueError("query, scales and bucketed reference must be "
                             "contiguous on one device")
    for name, t in (("query", q_hat), ("pixels", pixels)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


# q^, pixels, sqnorm, block_obj, scales, out; nq; c, nkb, block_k, o; stream
_ARGTYPES_INT8 = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                  + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def global_matching_int8_quantized(q_hat: torch.Tensor, scales: torch.Tensor,
                                   bucketed: BucketedRefInt8) -> torch.Tensor:
    """The int8 kernel on an already quantized CUDA query (`_int8_query`'s
    output) -> (Nq, O) f32."""
    _check_int8(q_hat, scales, bucketed)
    nq = q_hat.shape[0]
    nkb, block_k = bucketed.sqnorm.shape
    o = bucketed.num_objects
    out = torch.empty((nq, o), dtype=torch.float32, device=q_hat.device)
    if nq == 0:
        return out
    name = "global_matching_int8"
    fn = build.kernel_function(name, f"manet_{name}", _ARGTYPES_INT8)
    with torch.cuda.device(q_hat.device):
        err = fn(q_hat.data_ptr(), bucketed.pixels.data_ptr(),
                 bucketed.sqnorm.data_ptr(), bucketed.block_obj.data_ptr(),
                 scales.data_ptr(), out.data_ptr(), nq, q_hat.shape[1], nkb,
                 block_k, o, torch.cuda.current_stream(q_hat.device).cuda_stream)
    build.check_launch(name, err)
    return out


def global_matching_prepared_int8(query: torch.Tensor,
                                  bucketed: BucketedRefInt8) -> torch.Tensor:
    """Matching of float query rows (Nq, C) against an int8 reference ->
    (Nq, O) f32. Quantizes the query per row, then launches the int8
    tensor-core kernel for a CUDA query; runs the plain version for a CPU
    query."""
    if query.device.type == "cpu":
        return global_matching_prepared_int8_plain(query, bucketed)
    if not query.dtype.is_floating_point:
        raise TypeError(f"query dtype {query.dtype}: a float type only")
    return global_matching_int8_quantized(*_int8_query(query, bucketed),
                                          bucketed)


def global_matching_int8_cuda(query: torch.Tensor, ref: torch.Tensor,
                              ref_onehot: torch.Tensor,
                              ref_valid: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Int8 drop-in for ops.matching.global_matching: prepare + match."""
    return global_matching_prepared_int8(
        query, prepare_ref_int8(ref, ref_onehot, ref_valid))
