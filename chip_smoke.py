#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and nvcc. It
imports nothing of JAX. Phases (any failure exits non-zero):

1. device  — the card's name, and its name and power limit from nvidia-smi;
2. build   — nvcc builds every kernel from `cvpr2020_manet_tpu_torch/csrc`;
3. kernels — each kernel against its plain PyTorch version at the shapes
             and dtypes of the path that runs it (max abs error vs a stated
             tolerance, median ms over CUDA events, the plain version's ms,
             the bound, and a library call's ms where one exists): the
             serving kernels at 480p, the int8 kernel at the 480p round
             and at one 1080p memory page, kernel 1's f32 variant at that
             page (the f32 stream's shape), the argmin kernels at the
             training shapes, with their winners and the gradients of the
             trainable Functions; then one tiny round on the card against
             the same round on the CPU;
4. main    — the flagship ModelConfig() (ResNet-101, bf16, random weights
             from a seed) through `Evaluator.run_session` on a synthetic
             480p sequence of 16 frames, 2 objects, 3 rounds; the launch
             counters, reset just before, must show 1 global- and 15
             local-matching launches per round;
   serve_int8 — the same session with `matching_backend="int8"`, fed
             uint8 frames: 1 int8 global-matching launch and 15 local ones
             per round, none of the other global kernels;
   stream  — `StreamingIVOS` at 1080p, 2 objects, int8: 3 corrections (4
             live pages), then 8 `observe` and 8 `observe_async` of uint8
             frames and 2 of YUV 4:2:0 frames; 1 int8 global- and 1 local
             launch per observe, none per correction; then the f32 memory
             path (kernel 1's f32 variant) for 2 observes with 1 live page;
   batch   — `BatchPropagator`, 4 clips x 16 frames at 480p, int8 and f32,
             rgb and yuv420 ingest, through the batch CLI's timing loops
             (`timed_batches`): B (T - 1) = 60 launches of the global
             kernel and of the local one per batch;
5. train   — the flagship model through `Trainer.train_step` (stage 1,
             TrainConfig() defaults: crop 416, batch 8) for 4 steps and
             `Stage2Trainer.train_step` (crop 416, batch 2, 3 simulated
             rounds over 3-frame clips) for 3 steps: finite losses, step
             times, samples/s, peak memory, and the launch counters, reset
             just before each, must show the argmin kernels at B and 2B
             launches per stage-1 step and 2 B R F each per stage-2 step
             (the backward recomputes the checkpointed tails and rounds),
             and the serving kernels at none;
6. result  — one JSON line of the kernels (launches: kernels 1-2 over the
             main path's 3 rounds, kernel 3 over serve_int8's 3 rounds,
             kernels 4-5 per stage-1 step; the stream and batch phases log
             their own), the nvidia-smi line, and the final
             `{"ok": true, "device": ...}` line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12      # dense tensor-core bf16 peak (data sheet)
H100_INT8_OPS = 1979e12       # dense tensor-core int8 peak (data sheet)
H100_F32_FLOPS = 67e12        # f32 outside the tensor cores (data sheet)
H100_BYTES_PER_S = 3.35e12    # HBM3 (data sheet)

# Both sides form the same products exactly and accumulate them in f32 in
# another order (kernel 1 inside the tensor cores, whose f32 accumulation
# is not rounded step by step as on the CUDA cores). The squared distance
# is |q|^2 + |k|^2 - 2 q.k with terms up to ~1e2 at the model's embedding
# norms, so an accumulation error of ~1e-6 relative is ~2e-4 in the
# distance, and the normalization's slope is at most 1/2.
TOL_GLOBAL = 5e-4
TOL_LOCAL = 1e-4
# Kernel 1's f32 FMA variant (the stream's f32 memory) and its plain
# version (TF32 off) both form f32 products and sum them in f32 in
# another order: ~1e-6 relative of distances of ~1e1 at this embedding
# scale, halved by the normalization's slope.
TOL_GLOBAL_F32 = 1e-4
# The int8 kernel and its plain version form the same integer cross terms
# exactly and round the same f32 epilogue in the same order; only the exp
# of the normalization differs.
TOL_INT8 = 1e-5
# The global kernels' library yardstick writes the whole (Nq, Nk) cross
# term; where that exceeds this many bytes it runs over query chunks.
LIBRARY_CHUNK_BYTES = 24 * 2**30
# The kernel checks' queries are convex mixes of reference rows of every
# live object (`mixed_queries`), at an embedding scale where each live
# object's nearest distance stays off the normalization's saturation; at
# least this share of the live-object outputs must lie below 0.99, so that
# a wrong minimum for any object shows in the error.
EMBED_SCALE = 0.2
MIN_UNSATURATED = 0.9
TOL_ROUND_PROBS = 1e-3        # tiny f32 round, card vs CPU (cuDNN, kernels)
# The argmin kernels' winners must equal the plain versions' wherever an
# object's best candidate beats its second best by more than the distance
# tolerance (closer pairs may swap under another summation order); at
# least this share of the live-object positions must be that clear.
MIN_CLEAR = 0.9
# Gradients of the trainable Functions with the kernel forward against the
# same Functions on the plain forward, relative to the largest gradient,
# where both forwards chose the same winners: bf16 gradients (global
# matching) are rounded to 8 bits of mantissa, f32 ones (local matching)
# differ only in the order index_add_ sums.
TOL_GRAD_BF16 = 1e-2
TOL_GRAD_F32 = 1e-4


def log(*args):
    print(*args, flush=True)


def require(ok: bool, what: str) -> None:
    """A failed check ends the run with a non-zero exit."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of `reps` single-call CUDA-event times, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(ops: float, peak: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def mixed_queries(keys: torch.Tensor, choice: torch.Tensor,
                  g: torch.Generator, c_real: int) -> torch.Tensor:
    """Queries that lie near reference rows of several objects at once.
    keys (N, C); choice (M, L) holds, per query, one key row of each of the
    L live objects (-1: none). Each query is a random convex mix of its
    chosen rows plus noise on the first c_real channels -> (M, C)."""
    e = -torch.log(torch.rand(choice.shape, generator=g)) * (choice >= 0)
    w = e / e.sum(-1, keepdim=True)
    q = (w[..., None] * keys[choice.clamp(min=0)]).sum(1)
    q[:, :c_real] += 0.05 * EMBED_SCALE * torch.randn(
        q.shape[0], c_real, generator=g)
    return q


def global_inputs(g: torch.Generator, nq: int, nk: int, c_real: int, c: int,
                  live: int):
    """Reference rows k (Nk, C) at EMBED_SCALE on the first c_real channels,
    random labels over `live` objects, and queries (Nq, C) that each mix
    one row of every live object. -> (q, k, labels), on the CPU."""
    k = torch.zeros(nk, c)
    k[:, :c_real] = EMBED_SCALE * torch.randn(nk, c_real, generator=g)
    labels = torch.randint(0, live, (nk,), generator=g)
    choice = torch.stack([
        rows[torch.randint(len(rows), (nq,), generator=g)]
        for rows in ((labels == obj).nonzero()[:, 0] for obj in range(live))],
        dim=1)
    return mixed_queries(k, choice, g, c_real), k, labels


def local_inputs(g: torch.Generator, h: int, w: int, c_real: int, c: int,
                 live: int, window: int):
    """A previous frame k (H, W, C) as in `global_inputs`, random labels,
    and queries (H, W, C) that each mix the first pixel of each live object
    among 8 random ones in the query's window. -> (q, k, labels), CPU."""
    k = torch.zeros(h, w, c)
    k[..., :c_real] = EMBED_SCALE * torch.randn(h, w, c_real, generator=g)
    labels = torch.randint(0, live, (h, w), generator=g)
    n_draw = 8
    yy = (torch.arange(h)[:, None, None] + torch.randint(
        -window, window + 1, (h, w, n_draw), generator=g)).clamp(0, h - 1)
    xx = (torch.arange(w)[None, :, None] + torch.randint(
        -window, window + 1, (h, w, n_draw), generator=g)).clamp(0, w - 1)
    flat = yy * w + xx
    lab_at = labels.reshape(-1)[flat]
    choice = []
    for obj in range(live):
        hit = lab_at == obj
        first = flat.gather(-1, hit.int().argmax(-1, keepdim=True))[..., 0]
        choice.append(torch.where(hit.any(-1), first, -1))
    choice = torch.stack(choice, -1).reshape(h * w, live)
    q = mixed_queries(k.reshape(h * w, c), choice, g, c_real)
    return q.reshape(h, w, c), k, labels


def check_outputs(name: str, got: torch.Tensor, want: torch.Tensor,
                  live: int, tol: float) -> tuple[float, float]:
    """Hold a kernel's (..., O) output against its plain version: max abs
    error within tol, enough live-object outputs off saturation, and the
    objects past `live` (no pixels) exactly 1.0. -> (error, share)."""
    err = (got - want).abs().max().item()
    share = float((want[..., :live] < 0.99).float().mean())
    require(err <= tol, f"{name} disagrees: {err}")
    require(share >= MIN_UNSATURATED,
            f"{name}: only {share:.3f} of live-object outputs below 0.99")
    require(bool((got[..., live:] == 1.0).all()),
            f"{name}: an object with no pixels is not 1.0")
    return err, share


def cross_term_ms(mm, q: torch.Tensor, kt: torch.Tensor, out_bytes: int,
                  reps: int) -> tuple[float, int]:
    """Median ms of the library's cross term mm(q, kt) over all queries,
    in query chunks of at most LIBRARY_CHUNK_BYTES of output (out_bytes
    per element). -> (ms, number of chunks)."""
    nq = q.shape[0]
    chunk = max(32, LIBRARY_CHUNK_BYTES // (out_bytes * kt.shape[1]))

    def run():
        for i in range(0, nq, chunk):
            mm(q[i:i + chunk], kt)
    return time_ms(run, reps=reps, warmup=1), -(-nq // chunk)


def kernel_global(dev, nq: int, nk: int, c_real: int, c: int, o: int,
                  dtype: torch.dtype, what: str):
    """Kernel 1 at one of its paths' shapes: Nq queries against Nk
    reference rows of `dtype` (bf16: the round, on the tensor cores; f32:
    the stream's f32 memory, on the FMA variant), 2 live objects +
    background in an O=4 bucket (the last object has no pixels)."""
    from cvpr2020_manet_tpu_torch.ops.global_matching_cuda import (
        global_matching_prepared, global_matching_prepared_plain, prepare_ref)
    bf16 = dtype == torch.bfloat16
    tol = TOL_GLOBAL if bf16 else TOL_GLOBAL_F32
    reps = 10 if bf16 else 3
    g = torch.Generator().manual_seed(1)
    live = o - 1
    q, k, labels = global_inputs(g, nq, nk, c_real, c, live)
    q, k = q.to(dev, dtype), k.to(dev, dtype)
    onehot = torch.nn.functional.one_hot(labels, o).float().to(dev)
    b = prepare_ref(k, onehot)
    got = global_matching_prepared(q, b)
    want = global_matching_prepared_plain(q, b)
    torch.cuda.synchronize()
    err, share = check_outputs(f"global matching ({what})", got, want, live,
                               tol)
    ms = time_ms(lambda: global_matching_prepared(q, b), reps=reps)
    plain_ms = time_ms(lambda: global_matching_prepared_plain(q, b),
                       reps=reps)
    library_ms, chunks = cross_term_ms(torch.matmul, q, k.T.contiguous(),
                                       q.element_size(), reps)
    n_rows = int((b.src_idx >= 0).sum())       # labelled reference pixels
    b_ms, b_by = bound(2.0 * nq * n_rows * c,
                       H100_BF16_FLOPS if bf16 else H100_F32_FLOPS,
                       nbytes(q, b.neg2pixels, b.sqnorm, b.block_obj, got))
    log(f"[kernels] global_matching ({what}) Nq={nq} Nk={nk} (labelled "
        f"{n_rows}) C={c} O={o} {str(dtype)[6:]}: {share:.3f} of "
        f"live-object outputs below 0.99 (min {MIN_UNSATURATED}), "
        f"max|err|={err:.3g} (tol {tol}: f32 accumulation in another order"
        f"{', in the tensor cores' if bf16 else ''}); kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, cross-term GEMM only (torch.matmul over "
        f"{chunks} query chunks) {library_ms:.3f} ms, bound {b_ms:.3f} ms by "
        f"{b_by}")
    return dict(name="global_matching", route="cuda",
                source="cvpr2020_manet_tpu_torch/csrc/global_matching.cu",
                replaces="cvpr2020_manet_tpu/ops/matching_pallas.py:274",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


def kernel_global_int8(dev, nq: int, nk: int, c_real: int, c: int, o: int,
                       what: str):
    """Kernel 3 at one of its paths' shapes: bf16 queries (the model's
    embeddings) against an int8 reference of Nk rows, 2 live objects +
    background in an O=4 bucket (the last object has no pixels). Times the
    wrapper (per-row query quantization + kernel), the kernel alone, the
    plain version and torch._int_mm over the cross term."""
    from cvpr2020_manet_tpu_torch.ops.global_matching_cuda import (
        _int8_query, global_matching_int8_quantized,
        global_matching_prepared_int8, global_matching_prepared_int8_plain,
        prepare_ref_int8)
    g = torch.Generator().manual_seed(3)
    live = o - 1
    q, k, labels = global_inputs(g, nq, nk, c_real, c, live)
    q, k = q.to(dev, torch.bfloat16), k.to(dev, torch.bfloat16)
    onehot = torch.nn.functional.one_hot(labels, o).float().to(dev)
    b = prepare_ref_int8(k, onehot)
    got = global_matching_prepared_int8(q, b)
    want = global_matching_prepared_int8_plain(q, b)
    torch.cuda.synchronize()
    err, share = check_outputs(f"int8 global matching ({what})", got, want,
                               live, TOL_INT8)
    ms = time_ms(lambda: global_matching_prepared_int8(q, b))
    q_hat, scales = _int8_query(q, b)
    kernel_ms = time_ms(lambda: global_matching_int8_quantized(q_hat, scales,
                                                               b))
    plain_ms = time_ms(lambda: global_matching_prepared_int8_plain(q, b),
                       reps=3, warmup=1)
    # the library's cross term on the same int8 rows (the reference rows
    # in their source order, the same products as the kernel's)
    n_rows = int((b.src_idx >= 0).sum())       # labelled reference pixels
    k_hat = b.pixels[(b.src_idx >= 0).nonzero()[:, 0]][:n_rows // 8 * 8]
    require(torch.equal(torch._int_mm(q_hat[:64], k_hat.t()).float(),
                        q_hat[:64].float() @ k_hat.float().t()),
            "torch._int_mm disagrees with the plain cross term")
    library_ms, chunks = cross_term_ms(torch._int_mm, q_hat, k_hat.t(), 4,
                                       reps=3)
    b_ms, b_by = bound(2.0 * nq * n_rows * c, H100_INT8_OPS,
                       nbytes(q, b.pixels, b.sqnorm, b.block_obj, got))
    log(f"[kernels] global_matching_int8 ({what}) Nq={nq} Nk={nk} (labelled "
        f"{n_rows}) C={c} O={o}, bf16 queries: {share:.3f} of live-object "
        f"outputs below 0.99 (min {MIN_UNSATURATED}), max|err|={err:.3g} "
        f"(tol {TOL_INT8}: exact integer cross terms, the same f32 "
        f"epilogue); wrapper (query quantization + kernel) {ms:.3f} ms, "
        f"kernel alone {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, cross "
        f"term only (torch._int_mm over {chunks} query chunks) "
        f"{library_ms:.3f} ms, bound {b_ms:.3f} ms by {b_by}")
    return dict(name="global_matching_int8", route="cuda",
                source="cvpr2020_manet_tpu_torch/csrc/global_matching.cu",
                replaces="cvpr2020_manet_tpu/ops/matching_pallas.py:372",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms, kernel_only_ms=kernel_ms)


def kernel_local(dev, hw: tuple[int, int], c_real: int, c: int, o: int,
                 window: int):
    """Kernel 2 at the main path's shape: one half-resolution frame, f32."""
    from cvpr2020_manet_tpu_torch.ops.local_matching_cuda import (
        local_matching_prepared, local_matching_prepared_plain, prepare_local)
    g = torch.Generator().manual_seed(2)
    h, w = hw
    live = o - 1
    q, k, labels = local_inputs(g, h, w, c_real, c, live, window)
    q, k = q.to(dev), k.to(dev)
    onehot = torch.nn.functional.one_hot(labels, o).float().to(dev)
    inputs = prepare_local(q, k, onehot)
    got = local_matching_prepared(*inputs, window)
    want = local_matching_prepared_plain(*inputs, window)
    torch.cuda.synchronize()
    err, share = check_outputs("local matching", got, want, live, TOL_LOCAL)
    ms = time_ms(lambda: local_matching_prepared(*inputs, window))
    plain_ms = time_ms(lambda: local_matching_prepared_plain(*inputs, window))
    b_ms, b_by = bound(2.0 * window_pairs(h, w, window) * c, H100_F32_FLOPS,
                       nbytes(*inputs, got))
    log(f"[kernels] local_matching   {h}x{w} C={c} O={o} window={window} "
        f"f32: {share:.3f} of live-object outputs below 0.99 (min "
        f"{MIN_UNSATURATED}), max|err|={err:.3g} (tol {TOL_LOCAL}: f32 "
        f"accumulation in another order); kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, no single library call, bound {b_ms:.4f} ms by "
        f"{b_by}")
    return dict(name="local_matching", route="cuda",
                source="cvpr2020_manet_tpu_torch/csrc/local_matching.cu",
                replaces="cvpr2020_manet_tpu/ops/local_matching_pallas.py:42",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def window_pairs(h: int, w: int, window: int) -> int:
    """In-image (query, key) pairs of the (2 window + 1)^2 windows."""
    span = lambda n: sum(min(n - 1, i + window) - max(0, i - window) + 1
                         for i in range(n))
    return span(h) * span(w)


def routed_grad_error(fn, match_kernel, match_plain, inputs, g, same,
                      tol: float) -> float:
    """A trainable Function's gradients with the kernel forward against the
    same Function on the plain forward; the upstream gradient `g` is zero
    where the two forwards chose different winners (`same` false). Returns
    the max abs difference relative to the largest gradient."""
    grads = []
    for match in (match_kernel, match_plain):
        leaves = [x.clone().requires_grad_() for x in inputs]
        (fn(*leaves, match) * g * same).sum().backward()
        grads.append([x.grad.float() for x in leaves])
    torch.cuda.synchronize()
    err = max(((a - b).abs().max() / b.abs().max()).item()
              for a, b in zip(*grads))
    require(all(b.abs().max() > 0 for b in grads[1]),
            "a routed gradient is all zero")
    require(err <= tol, f"routed gradients disagree: {err}")
    return err


def global_gaps(q: torch.Tensor, b) -> torch.Tensor:
    """(Nq, O): each object's second-best minus best bucketed-row distance
    (|k|^2 - 2 q.k, f32), inf where the object has fewer than 2 rows."""
    qp = torch.nn.functional.pad(q.float(),
                                 (0, b.neg2pixels.shape[1] - q.shape[1]))
    row_obj = b.block_obj.long().repeat_interleave(b.sqnorm.shape[1])
    row_obj = torch.where(b.src_idx >= 0, row_obj, -1)
    gaps = torch.full((q.shape[0], b.num_objects), float("inf"),
                      device=q.device)
    for o in range(b.num_objects):
        rows = (row_obj == o).nonzero()[:, 0]
        if len(rows) >= 2:
            e = qp @ b.neg2pixels[rows].float().T + b.sqnorm.reshape(-1)[rows]
            two = e.topk(2, dim=1, largest=False).values
            gaps[:, o] = two[:, 1] - two[:, 0]
    return gaps


def local_gaps(q, k, kno, window: int) -> torch.Tensor:
    """(H, W, O): second-best minus best in-image key of the window."""
    h, w, _ = q.shape
    pad = (0, 0, window, window, window, window)
    k_pad = torch.nn.functional.pad(k, pad)
    kno_pad = torch.nn.functional.pad(kno, pad, value=float("inf"))
    best = torch.full(kno.shape, float("inf"), device=q.device)
    second = best.clone()
    for dy in range(2 * window + 1):
        for dx in range(2 * window + 1):
            e = (-2.0 * (q * k_pad[dy:dy + h, dx:dx + w]).sum(-1))[..., None] \
                + kno_pad[dy:dy + h, dx:dx + w]
            second = torch.minimum(second, torch.maximum(best, e))
            best = torch.minimum(best, e)
    return second - best


def kernel_global_argmin(dev, hw: tuple[int, int], c_real: int, c: int,
                         o: int):
    """Kernel 4 at the training shape: one crop's features (Nq = Nk = h w)
    against its reference frame, bf16, O = 9 with the last object
    pixel-less; winners, and the routed gradients."""
    from cvpr2020_manet_tpu_torch.ops.global_matching_cuda import (
        global_matching_prepared_argmin,
        global_matching_prepared_argmin_plain, prepare_ref)
    from cvpr2020_manet_tpu_torch.ops.trainable import GlobalMatchingTrainable
    g = torch.Generator().manual_seed(4)
    nk = nq = hw[0] * hw[1]
    live = o - 1
    q, k, labels = global_inputs(g, nq, nk, c_real, c, live)
    upstream = torch.randn(nq, o, generator=g).to(dev)
    q, k = q.to(dev, torch.bfloat16), k.to(dev, torch.bfloat16)
    onehot = torch.nn.functional.one_hot(labels, o).float().to(dev)
    b = prepare_ref(k, onehot)
    got, got_idx = global_matching_prepared_argmin(q, b)
    want, want_idx = global_matching_prepared_argmin_plain(q, b)
    torch.cuda.synchronize()
    err, share = check_outputs("global matching argmin", got, want, live,
                               TOL_GLOBAL)
    clear = global_gaps(q, b) > TOL_GLOBAL
    clear_share = float(clear[:, :live].float().mean())
    require(clear_share >= MIN_CLEAR,
            f"global argmin: only {clear_share:.3f} of positions are clear")
    require(torch.equal(got_idx[clear], want_idx[clear]),
            "global argmin: winners differ at clear positions")
    require(bool((got_idx[:, live:] == -1).all()),
            "global argmin: a pixel-less object has a winner")
    grad_err = routed_grad_error(
        lambda q, k, m: GlobalMatchingTrainable.apply(q, k, onehot, m),
        global_matching_prepared_argmin,
        global_matching_prepared_argmin_plain, (q, k), upstream,
        got_idx == want_idx, TOL_GRAD_BF16)
    ms = time_ms(lambda: global_matching_prepared_argmin(q, b))
    plain_ms = time_ms(lambda: global_matching_prepared_argmin_plain(q, b))
    kt = k.T.contiguous()
    library_ms = time_ms(lambda: torch.matmul(q, kt))
    n_rows = int((b.src_idx >= 0).sum())
    b_ms, b_by = bound(2.0 * nq * n_rows * c, H100_BF16_FLOPS,
                       nbytes(q, b.neg2pixels, b.sqnorm, b.block_obj, got,
                              got_idx))
    log(f"[kernels] global_matching_argmin  Nq={nq} Nk={nk} (labelled "
        f"{n_rows}) C={c} O={o} bf16: {share:.3f} of live-object outputs "
        f"below 0.99, max|err|={err:.3g} (tol {TOL_GLOBAL}); winners equal "
        f"at all {clear_share:.4f} of live positions whose best beats the "
        f"second best by > {TOL_GLOBAL}; pixel-less object -1; routed "
        f"gradients kernel vs plain forward {grad_err:.3g} of the largest "
        f"(tol {TOL_GRAD_BF16}: bf16 gradients); kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, cross-term GEMM only (torch.matmul bf16) "
        f"{library_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}")
    return dict(name="global_matching_argmin", route="cuda",
                source="cvpr2020_manet_tpu_torch/csrc/global_matching.cu",
                replaces="cvpr2020_manet_tpu/ops/matching_pallas.py:507",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


def kernel_local_argmin(dev, hw: tuple[int, int], c_real: int, c: int,
                        o: int, window: int):
    """Kernel 5 at the training shape: the half-resolution 416 crop, f32,
    O = 9 with the last object pixel-less; winners, and the routed
    gradients."""
    from cvpr2020_manet_tpu_torch.ops.local_matching_cuda import (
        local_matching_prepared_argmin, local_matching_prepared_argmin_plain,
        prepare_local)
    from cvpr2020_manet_tpu_torch.ops.trainable import LocalMatchingTrainable
    g = torch.Generator().manual_seed(5)
    h, w = hw
    live = o - 1
    q, k, labels = local_inputs(g, h, w, c_real, c, live, window)
    upstream = torch.randn(h, w, o, generator=g).to(dev)
    q, k = q.to(dev), k.to(dev)
    onehot = torch.nn.functional.one_hot(labels, o).float().to(dev)
    inputs = prepare_local(q, k, onehot)
    got, got_idx = local_matching_prepared_argmin(*inputs, window)
    want, want_idx = local_matching_prepared_argmin_plain(*inputs, window)
    torch.cuda.synchronize()
    err, share = check_outputs("local matching argmin", got, want, live,
                               TOL_LOCAL)
    # the pixel-less object's winner is any saturated key: not compared
    clear = (local_gaps(*inputs, window) > TOL_LOCAL)[..., :live]
    clear_share = float(clear.float().mean())
    require(clear_share >= MIN_CLEAR,
            f"local argmin: only {clear_share:.3f} of positions are clear")
    require(torch.equal(got_idx[..., :live][clear],
                        want_idx[..., :live][clear]),
            "local argmin: winners differ at clear positions")
    grad_err = routed_grad_error(
        lambda q, k, m: LocalMatchingTrainable.apply(q, k, onehot, window, m),
        local_matching_prepared_argmin, local_matching_prepared_argmin_plain,
        (q, k), upstream, got_idx == want_idx, TOL_GRAD_F32)
    ms = time_ms(lambda: local_matching_prepared_argmin(*inputs, window))
    plain_ms = time_ms(
        lambda: local_matching_prepared_argmin_plain(*inputs, window))
    b_ms, b_by = bound(2.0 * window_pairs(h, w, window) * c, H100_F32_FLOPS,
                       nbytes(*inputs, got, got_idx))
    log(f"[kernels] local_matching_argmin   {h}x{w} C={c} O={o} "
        f"window={window} f32: {share:.3f} of live-object outputs below "
        f"0.99, max|err|={err:.3g} (tol {TOL_LOCAL}); winners equal at all "
        f"{clear_share:.4f} of live positions whose best beats the second "
        f"best by > {TOL_LOCAL}; routed gradients kernel vs plain forward "
        f"{grad_err:.3g} of the largest (tol {TOL_GRAD_F32}: index_add_ "
        f"order); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, no single "
        f"library call, bound {b_ms:.4f} ms by {b_by}")
    return dict(name="local_matching_argmin", route="cuda",
                source="cvpr2020_manet_tpu_torch/csrc/local_matching.cu",
                replaces="cvpr2020_manet_tpu/ops/local_matching_pallas.py:78",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def tiny_round_reference():
    """One tiny f32 round on the card against the same round on the CPU
    (the plain versions), same seeded weights and scribbles."""
    from cvpr2020_manet_tpu_torch.config import tiny_test_config
    from cvpr2020_manet_tpu_torch.data import SyntheticDataset
    from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
    from cvpr2020_manet_tpu_torch.models import MANet
    cfg = tiny_test_config()
    ds = SyntheticDataset(image_size=cfg.eval.image_size,
                          num_frames=cfg.eval.max_frames, num_sequences=1,
                          num_objects=2, scribble_sets=1)
    seq = ds.sequences()[0]
    scr = ds.initial_scribbles(seq, 0).to_json()
    out = {}
    for device in ("cpu", "cuda"):
        ev = Evaluator(cfg, MANet(cfg.model, device=device, seed=3),
                       device=device)
        st = ev.start_sequence(ds.images(seq), 2)
        masks = ev.run_round(st, scr, ds.gt_masks(seq).shape[1:], 2)
        out[device] = (masks, st.prev_masks.cpu())
    diff = (out["cuda"][1] - out["cpu"][1]).abs().max().item()
    log(f"[kernels] tiny round, card vs CPU: max|dprob|={diff:.3g} "
        f"(tol {TOL_ROUND_PROBS}: f32, other conv algorithms and sum "
        f"orders); labels equal on "
        f"{float((out['cuda'][0] == out['cpu'][0]).mean()):.6f} of pixels")
    require(diff <= TOL_ROUND_PROBS, f"tiny round disagrees: {diff}")


def synthetic_u8(**kw):
    """A synthetic dataset that also offers raw uint8 frames, which the
    Evaluator's session loop prefers (normalized on the device)."""
    from cvpr2020_manet_tpu_torch.data import SyntheticDataset

    class Uint8Frames(SyntheticDataset):
        def images_uint8(self, seq):
            return (np.clip(self.images(seq), 0, 1) * 255).astype(np.uint8)
    return Uint8Frames(**kw)


def main_path(dev, model, phase: str, global_kernel: str, uint8: bool,
              image_size=(480, 854), n_frames=16, rounds=3):
    """A model through the Evaluator's session loop; the launch counters,
    reset just before, must show 1 `global_kernel` and n_frames - 1 local
    launches per round and no other kernel. -> the launches."""
    from cvpr2020_manet_tpu_torch.config import Config, EvalConfig
    from cvpr2020_manet_tpu_torch.data import SyntheticDataset
    from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
    from cvpr2020_manet_tpu_torch.interactive.session import InteractiveSession
    from cvpr2020_manet_tpu_torch.kernels import build

    cfg = Config(model=model.cfg, eval=EvalConfig(
        image_size=image_size, max_interactions=rounds))
    ev = Evaluator(cfg, model, device=dev)
    kw = dict(image_size=cfg.eval.image_size, num_frames=n_frames,
              num_objects=2, num_sequences=1, scribble_sets=1)
    ds = synthetic_u8(**kw) if uint8 else SyntheticDataset(**kw)
    encode_s = []
    start_sequence = ev.start_sequence

    def timed_start(*args):
        t = time.perf_counter()
        st = start_sequence(*args)
        torch.cuda.synchronize()
        encode_s.append(time.perf_counter() - t)
        return st

    ev.start_sequence = timed_start
    masks_seen = []
    session = InteractiveSession(ds, max_interactions=rounds)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    summary = ev.run_session(session,
                             on_masks=lambda *a: masks_seen.append(a[-1]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)

    n_rounds = len(ev.round_latencies)
    gt = ds.gt_masks(ds.sequences()[0])
    for r, dt in enumerate(ev.round_latencies):
        log(f"[{phase}] round {r}: {dt * 1e3:.1f} ms wall, "
            f"{n_frames / dt:.1f} frames/s")
    log(f"[{phase}] matching backend {model.matching_backend!r}, "
        f"{'uint8' if uint8 else 'float'} frames; encoder (start_sequence, "
        f"{n_frames} frames): {encode_s[0] * 1e3:.1f} ms; session "
        f"{wall:.2f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"AUC {summary['auc']:.6f}, J&F@60s "
        f"{summary['metric_at_threshold']:.6f}")
    log(f"[{phase}] launches: {launches} over {n_rounds} rounds "
        f"(per round: {global_kernel} {launches[global_kernel] / n_rounds:g}, "
        f"local {launches['local_matching'] / n_rounds:g})")
    require(n_rounds == rounds, f"{n_rounds} rounds ran, {rounds} expected")
    want = {global_kernel: n_rounds, "local_matching": (n_frames - 1) * n_rounds}
    require(launches == {k: want.get(k, 0) for k in launches},
            f"{phase} launches {launches}, expected {want}")
    n_obj = ds.num_objects(ds.sequences()[0])
    require(len(masks_seen) == rounds, "one mask submission per round")
    for m in masks_seen:
        require(m.shape == gt.shape and m.dtype == np.int32,
                f"mask shape {m.shape} {m.dtype}")
        require(0 <= m.min() and m.max() <= n_obj, "mask labels in range")
    require(bool(np.isfinite(summary["auc"])) and 0.0 <= summary["auc"] <= 1.0,
            f"AUC {summary['auc']}")
    rows = session.get_report()
    require(len(rows) == rounds * n_obj * n_frames, f"{len(rows)} report rows")
    require(all(0.0 <= r["jaccard"] <= 1.0 and 0.0 <= r["contour"] <= 1.0
                for r in rows), "J and F in [0, 1]")
    return launches


def launches_delta(fn):
    """Run fn(); -> (its result, the kernel launches it made)."""
    from cvpr2020_manet_tpu_torch.kernels import build
    before = dict(build.LAUNCHES)
    out = fn()
    return out, {k: v - before[k] for k, v in build.LAUNCHES.items()
                 if v != before[k]}


def stream_phase(dev, model_i8, model_f32, image_size=(1080, 1920),
                 corrections=3, timed=8) -> None:
    """StreamingIVOS at 1080p with 2 objects: the int8 stream through
    `corrections` corrections and `timed` sync and `timed` pipelined
    observes of uint8 frames plus 2 YUV 4:2:0 frames, then the f32 memory
    path with 1 live page."""
    from cvpr2020_manet_tpu_torch.config import Config, EvalConfig
    from cvpr2020_manet_tpu_torch.data import SyntheticDataset
    from cvpr2020_manet_tpu_torch.engine.streaming import StreamingIVOS
    from cvpr2020_manet_tpu_torch.interactive.robot import (
        InteractiveScribblesRobot)
    from cvpr2020_manet_tpu_torch.kernels import build
    from cvpr2020_manet_tpu_torch.utils.ingest import rgb_to_yuv420_host

    cfg = Config(model=model_i8.cfg, eval=EvalConfig(image_size=image_size))
    n_frames = corrections + 2 * timed + 2
    ds = SyntheticDataset(image_size=image_size, num_frames=n_frames,
                          num_objects=2, num_sequences=1, scribble_sets=1)
    seq = ds.sequences()[0]
    gt = ds.gt_masks(seq)
    u8 = (np.clip(ds.images(seq), 0, 1) * 255).astype(np.uint8)
    yuv = [rgb_to_yuv420_host(f) for f in u8[-2:]]
    robot = InteractiveScribblesRobot()
    s = StreamingIVOS(cfg, model_i8, device=dev)
    s.reset(2)
    per_observe = {"global_matching_int8": 1, "local_matching": 1}

    def observe(frame, pipelined=False):
        out, n = launches_delta(lambda: s.observe_async(frame) if pipelined
                                else s.observe(frame))
        require(n == per_observe, f"stream observe launched {n}")
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    pages = []
    for f in range(corrections):
        pred = observe(u8[f])
        scr = robot.scribble_frame(pred, gt[f], 2, f, n_frames, seq)
        mask, n = launches_delta(lambda: s.correct(scr.to_json()))
        require(n == {}, f"stream correct launched {n}")
        require(mask.shape == gt.shape[1:] and mask.max() <= 2,
                "correction mask")
        pages.append(s.live_pages())
    require(pages == [1, 2, 4], f"live pages {pages}")
    frames = u8[corrections:corrections + 2 * timed]
    sync_ms, masks = [], []
    for f in frames[:timed]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        masks.append(observe(f))
        sync_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futures = [observe(f, pipelined=True) for f in frames[timed:]]
    masks += [fut.result() for fut in futures]
    pipe_ms = (time.perf_counter() - t0) * 1e3 / timed
    yuv_ms = []
    for y in yuv:
        t0 = time.perf_counter()
        masks.append(observe(y))
        yuv_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for m in masks:
        require(m.shape == gt.shape[1:] and m.dtype == np.int32
                and 0 <= m.min() and m.max() <= 2, "stream mask")
    labelled = float(np.mean([(m > 0).mean() for m in masks]))
    n_obs = corrections + 2 * timed + len(yuv)
    require(launches == {k: per_observe.get(k, 0) * n_obs for k in launches},
            f"stream launches {launches}")
    log(f"[stream] {image_size[0]}x{image_size[1]} (padded {s.hp}x{s.wp}), "
        f"2 objects, int8, {s.live_pages()} live pages of {s.hh * s.ww} rows: "
        f"observe p50 {statistics.median(sync_ms):.1f} ms per frame "
        f"(all {', '.join(f'{t:.1f}' for t in sync_ms)}), pipelined "
        f"observe_async {pipe_ms:.1f} ms per frame, YUV 4:2:0 frames "
        f"{', '.join(f'{t:.1f}' for t in yuv_ms)} ms; non-background share "
        f"{labelled:.3f}; peak device memory {peak:.2f} GiB; launches "
        f"{launches} over {n_obs} observes and {corrections} corrections")

    s32 = StreamingIVOS(cfg, model_f32, device=dev)
    s32.reset(2)
    pred = s32.observe(u8[0])
    s32.correct(robot.scribble_frame(pred, gt[0], 2, 0, n_frames,
                                     seq).to_json())
    f32_ms = []
    for f in u8[1:3]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m, n = launches_delta(lambda: s32.observe(f))
        f32_ms.append((time.perf_counter() - t0) * 1e3)
        require(n == {"global_matching": 1, "local_matching": 1},
                f"f32 stream observe launched {n}")
        require(m.shape == gt.shape[1:], "f32 stream mask")
    log(f"[stream] f32 memory (bf16 queries matched in f32: kernel 1's f32 "
        f"variant), 1 live page: observe {', '.join(f'{t:.1f}' for t in f32_ms)}"
        f" ms per frame")


def batch_phase(dev, model, ingest: str, batch=4, n_frames=16,
                image_size=(480, 864), batches=3) -> None:
    """BatchPropagator on `batches` synthetic batches of `batch` clips: one
    warm-up batch, then the CLI's timing loops (`timed_batches`: serial
    and pipelined frames/s, planar YUV made before the clock) over the
    others; the launch counters must show B (T - 1) launches of the global
    and of the local kernel per batch."""
    from cvpr2020_manet_tpu_torch.data import SyntheticDataset
    from cvpr2020_manet_tpu_torch.engine.propagate_batch import (
        BatchPropagator, timed_batches)
    from cvpr2020_manet_tpu_torch.config import Config, EvalConfig

    cfg = Config(model=model.cfg, eval=EvalConfig(image_size=image_size))
    prop = BatchPropagator(cfg, model, ingest=ingest, device=dev)
    ds = SyntheticDataset(image_size=image_size, num_frames=n_frames,
                          num_objects=2, num_sequences=batch * batches,
                          scribble_sets=1)
    names = ds.sequences()
    data = []
    for i in range(0, len(names), batch):
        seqs = names[i:i + batch]
        frames = np.stack([(np.clip(ds.images(q), 0, 1) * 255).astype(np.uint8)
                           for q in seqs])
        first = np.stack([ds.gt_masks(q)[0, ::4, ::4] for q in seqs])
        data.append((frames, first.astype(np.int32), np.full(batch, 2)))
    gkernel = ("global_matching_int8" if model.matching_backend == "int8"
               else "global_matching")
    per_batch = {gkernel: batch * (n_frames - 1),
                 "local_matching": batch * (n_frames - 1)}
    prop.propagate(*data[0])                       # warm-up
    timed = data[1:]
    (serial_s, pipe_s, labels), n = launches_delta(
        lambda: timed_batches(prop, timed))
    runs = 2 * len(timed)                          # serial and pipelined
    require(n == {k: v * runs for k, v in per_batch.items()},
            f"{runs} batches launched {n}, expected {per_batch} each")
    for (frames, first, _), lab in zip(timed, labels):
        require(lab.shape == frames.shape[:4] and lab.max() <= 2,
                "batch labels")
        seed_up = np.repeat(np.repeat(first, 4, axis=1), 4, axis=2)
        require(float((lab[:, 0] == seed_up).mean()) > 0.95,
                "frame 0 reproduces the first mask")
    fps = batch * n_frames / statistics.median(serial_s)
    log(f"[batch] {model.matching_backend!r} matching, {ingest} ingest, "
        f"{batch} x {n_frames} frames at {image_size[0]}x{image_size[1]}: "
        f"serial {fps:.1f} frames/s (batches "
        f"{', '.join(f'{t * 1e3:.0f}' for t in serial_s)} ms), pipelined "
        f"{batch * n_frames / pipe_s:.1f} frames/s; launches {n} over "
        f"{len(timed)} serial and {len(timed)} pipelined batches")


def run_trainer(name: str, trainer, cfg, steps: int,
                per_step: dict[str, int]) -> dict[str, int]:
    """`steps` optimizer steps on synthetic batches (made beforehand); the
    launch counters, reset just before, must show `per_step` launches of
    each argmin kernel per step and none of the serving kernels. Returns
    the launches per step."""
    from cvpr2020_manet_tpu_torch.engine.train_stage1 import synthetic_batch
    from cvpr2020_manet_tpu_torch.kernels import build
    b = cfg.train.batch_size
    rng = np.random.default_rng(cfg.train.seed)
    batches = [synthetic_batch(cfg, rng) for _ in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    times, losses = [], []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch)    # returns host floats: synced
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(metrics["loss"])
        log(f"[train] {name} step {i}: "
            + " ".join(f"{k}={v:.6f}" for k, v in metrics.items())
            + f", {times[-1] * 1e3:.1f} ms")
    launches = dict(build.LAUNCHES)
    step_s = statistics.median(times[1:])
    log(f"[train] {name}: batch {b}, crop {cfg.train.crop_size}; median "
        f"step after the first {step_s * 1e3:.1f} ms, {b / step_s:.2f} "
        f"samples/s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{launches} over {steps} steps")
    require(all(np.isfinite(losses)), f"{name}: a loss is not finite")
    for kernel, n in launches.items():
        want = per_step.get(kernel, 0) * steps
        require(n == want, f"{name}: {kernel} launched {n} times, "
                f"{want} expected")
    return {k: launches[k] // steps for k in per_step}


def train_phase(dev) -> dict[str, int]:
    """The flagship model through both trainers. -> stage-1 launches per
    step of the argmin kernels."""
    import dataclasses
    from cvpr2020_manet_tpu_torch.config import Config
    from cvpr2020_manet_tpu_torch.engine.train_stage1 import Trainer
    from cvpr2020_manet_tpu_torch.engine.train_stage2 import Stage2Trainer
    cfg = Config()                       # TrainConfig(): crop 416, batch 8
    b = cfg.train.batch_size
    trainer = Trainer(cfg, device=dev)
    per_step = run_trainer(
        "stage 1", trainer, cfg, steps=4,
        per_step={"global_matching_argmin": b, "local_matching_argmin": 2 * b})
    del trainer
    torch.cuda.empty_cache()

    cfg2 = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=2))
    b2, rounds, frames = 2, cfg2.train.stage2_rounds, 3
    n = 2 * b2 * rounds * frames         # forward + recompute of each round
    run_trainer(f"stage 2 ({rounds} rounds, {frames}-frame clips)",
                Stage2Trainer(cfg2, device=dev), cfg2, steps=3,
                per_step={"global_matching_argmin": n,
                          "local_matching_argmin": n})
    return per_step


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from cvpr2020_manet_tpu_torch.kernels import build

    # [1] device
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {kind}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] TF32 off for matmuls and cuDNN: f32 comparisons run in f32")

    # [2] build
    secs = build.build_all()
    log(f"[build] {len(build.KERNELS)} kernels ready in {secs:.1f} s "
        f"({len(build.BUILD_LOGS)} compiled now by nvcc, the others found "
        f"built from the same sources)")
    for name, text in build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # [3] kernels at their paths' shapes, and a tiny round vs the CPU
    round_480p = "480p round: 15 frames against one"
    page_1080p = "one 1080p frame against one memory page"
    kernels = [kernel_global(dev, 15 * 120 * 216, 120 * 216, 100, 128, 4,
                             torch.bfloat16, round_480p),
               kernel_local(dev, (60, 108), 100, 128, 4, 15),
               kernel_global_int8(dev, 15 * 120 * 216, 120 * 216, 100, 128, 4,
                                  round_480p),
               kernel_global_argmin(dev, (104, 104), 100, 128, 9),
               kernel_local_argmin(dev, (52, 52), 100, 128, 9, 15)]
    # the stream's two global-matching shapes: int8 memory, and f32 memory
    # on kernel 1's f32 FMA variant
    pages = {"global_matching_int8": kernel_global_int8(
                 dev, 272 * 480, 272 * 480, 100, 128, 4, page_1080p),
             "global_matching (f32)": kernel_global(
                 dev, 272 * 480, 272 * 480, 100, 128, 4, torch.float32,
                 page_1080p)}
    for name, page in pages.items():
        log(f"[kernels] {name} at one 1080p page: " + json.dumps(
            {k: page[k] for k in ("max_abs_err", "ms", "kernel_only_ms",
                                  "plain_ms", "bound_ms", "bound_by",
                                  "library_ms") if k in page}))
    tiny_round_reference()
    torch.cuda.empty_cache()

    # [4] the serving paths, each with the counters reset just before it:
    # the flagship model at 480p (3 rounds), the same in the int8 mode on
    # uint8 frames, the 1080p stream, and the batch propagator
    from cvpr2020_manet_tpu_torch.config import ModelConfig
    from cvpr2020_manet_tpu_torch.models import MANet
    t0 = time.perf_counter()
    model = MANet(ModelConfig(), device=dev, seed=0)
    model_i8 = MANet(ModelConfig(), device=dev, seed=0,
                     matching_backend="int8")
    log(f"[main] two flagship models (default and int8 matching, the same "
        f"seeded weights) on {dev} in {time.perf_counter() - t0:.2f} s "
        f"({sum(p.numel() for p in model.parameters())} params each)")
    launches = main_path(dev, model, "main", "global_matching", uint8=False)
    # kernel 3's launches in the kernels line: serve_int8's 3 rounds, as
    # kernels 1-2 count the main path's; the stream and the batches log
    # their own
    launches["global_matching_int8"] = main_path(
        dev, model_i8, "serve_int8", "global_matching_int8",
        uint8=True)["global_matching_int8"]
    stream_phase(dev, model_i8, model)
    torch.cuda.empty_cache()
    for m in (model_i8, model):
        for ingest in ("rgb", "yuv420"):
            batch_phase(dev, m, ingest)
    del model, model_i8
    torch.cuda.empty_cache()

    # [5] training: the flagship model; launches per stage-1 step
    launches.update(train_phase(dev))
    for k in kernels:
        k["launches"] = launches[k["name"]]

    # [6] result
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys}
                                  for k in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
