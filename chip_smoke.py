#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and nvcc. It
imports nothing of JAX. Phases (any failure exits non-zero):

1. device  — the card's name, and its name and power limit from nvidia-smi;
2. build   — nvcc builds every kernel from `cvpr2020_manet_tpu_torch/csrc`;
             each kernel's registers, shared memory and spills (ptxas),
             and the tensor-core route of each tensor-core kernel, read
             from the built libraries' SASS: wgmma (HGMMA) in the f32
             template, in kernel 1 bf16 and in kernel 4, int8 wgmma
             (IGMMA) in kernel 3, mma.sync (HMMA) in kernels 2 and 5;
3. kernels — each kernel against its plain PyTorch version at the shapes
             and dtypes of the path that runs it (max abs error vs a stated
             tolerance, median ms over CUDA events, the plain version's ms,
             the bound, and a library call's ms where one exists): the
             serving kernels at 480p, the int8 kernel (which quantizes the
             query in its prologue) at the 480p round, at one 1080p
             memory page and at the batch engine's launch (with its key
             splits), kernel 1's f32 variant (3xTF32)
             at that page (the f32 stream's shape), kernel 2 at the 1080p
             stream's 136 x 240 beside its 480p row, kernels 1 (bf16) and
             2 at FEELVOS's batch step (a 480p frame's 120 x 216 grid
             against another, in the 9-object bucket, window 15), the
             argmin kernels at the training shapes, with their winners and
             the gradients of the trainable Functions, kernel 4 with its
             key splits and with exact ties across them (kernels 2, 4 and 5, kernel 4's
             library call and kernel 3 at the batch's shape, a fraction of
             a millisecond each, timed over runs of back-to-back calls);
             kernel 7 (GroupNorm with ReLU, and the residual at layer
             3's norm3) at the 1080p stem and layer 3 and the 720p head
             of 4 clips, against aten's f32 chain in bf16 ulps, its device
             time over CUDA-graph replays against the bytes bound; then
             one tiny round on the card
             against the same round on the CPU;
4. main    — the flagship ModelConfig() (ResNet-101, bf16, random weights
             from a seed) through `Evaluator.run_session` on a synthetic
             480p sequence of 16 frames, 2 objects, 3 rounds; the launch
             counters, reset just before, must show 1 global- and 15
             local-matching launches per round and one kernel-7 launch
             per GroupNorm call; the sweep's steps replay a CUDA graph
             (`engine/round_graph.py`), and each captured step, replayed
             under torch.profiler, must run on the card the kernel-2 and
             kernel-7 launches its capture counted;
   serve_int8 — the same session with `matching_backend="int8"`, fed
             uint8 frames: 1 int8 global-matching launch and 15 local ones
             per round, none of the other global kernels;
   davis   — the DAVIS evaluation CLI (`engine/eval_davis.py`) at the
             flagship config on a 480p DAVIS tree the script writes
             (tests/_torch_davis_tree.py: a numpy JPEG encoder, the
             port's PNG writer): sequences of
             16 frames / 2 objects and 25 / 3 (frame buckets 16 and 32),
             2 scribble sets, 8 rounds; the host JPEG and PNG decode ms,
             then four runs, the counters reset before each: default (1
             kernel-1 launch a round, bucket - 1 kernel-2 ones), int8
             (kernel 3 in place of kernel 1), stopped after the first
             item's checkpoint and run again with --resume, and --host
             against the port's evaluation server in a thread; the saved
             PNGs equal the last round's masks, the report has rounds x
             objects x frames rows an item, and the resumed and remote
             reports' metric columns equal the default run's; each run's
             wall time split into the model, the session's J and F
             scoring with the robot, and the rest;
   reference — the port's reference-style script
             (`reference_style_eval.py`: the upstream davisinteractive
             loop through `cvpr2020_manet_tpu_torch.davisinteractive`) on
             the davis tree at Config() with the CLI's seeded weights,
             held against the default CLI run: once as written (float
             frames), once fed the CLI's uint8 frames, where round 1's J
             and F must equal the CLI's to 1e-3; both with the same row
             keys, the AUC within 0.02, 1 kernel-1 and bucket - 1 kernel-2
             launches a round, the wall split as the davis runs';
   stream  — `StreamingIVOS` at 1080p, 2 objects, int8: 3 corrections (4
             live pages), then 8 `observe` and 8 `observe_async` of uint8
             frames and 2 of YUV 4:2:0 frames; 1 int8 global- and 1 local
             launch per observe, none per correction; then the f32 memory
             path (kernel 1's f32 variant) for 2 observes with 1 live page;
   cp      — context-parallel serving on a ring of 4 members on the card:
             kernel 6 at the cp stream's shape (a 1080p frame's 130,560
             f32 queries against 4 pages, 522,240 rows) against the plain
             ring and bit-identical to kernel 1's f32 variant over all
             rows, rings of 1-3 members and 3 repeated 4-rings
             bit-identical (and over distinct cards when there are two);
             the 1080p f32 stream with `cp_mesh` (4 kernel-1 launches per
             observe, masks equal to the single-device stream's); the
             flagship at 480p with stacked memory, single-device and
             with `cp_mesh`: equal masks every round, 1 / 4 kernel-1
             launches a round (one matching call); the
             cp matching artifact (`utils/export.export_cp_matching`) at
             the cp stream observe's matching over 4 members: exported,
             saved with its mesh, loaded in a fresh process, bit-equal to
             the live `cp_match_flat` and within 1e-5 of single-device
             kernel 1, 4 kernel-1 launches a call, another mesh size
             refused;
   batch   — `BatchPropagator`, 4 clips x 16 frames at 480p, int8 and f32,
             rgb and yuv420 ingest, through the batch CLI's timing loops
             (`timed_batches`): B (T - 1) = 60 launches of the global
             kernel and of the local one per batch; then FEELVOS at its
             published widths (random weights) on 4 clips x 16 frames of
             5 objects from YUV: 60 kernel-1 and 60 kernel-2 launches a
             batch and no GroupNorm call;
   export  — the host time each `manet::*` custom op adds to a call of
             its launcher; serving artifacts on torch.export
             (`utils/export.py`): the export CLI on the card at its
             defaults (480x854, uint8 frames, an 8-object bucket, the
             main path's seeded weights) writes the default and the int8
             bundle and the fused round, each with --check (export and
             save seconds, MB); each bundle
             is served from a fresh process that imports only
             `utils.export` of the port: 16 frames (extract x16, interact
             and aggregate_first on frame 0, propagate on frames 1-15,
             aggregate_update once), the counters reset before it must
             show 15 launches of kernel 1 (int8: kernel 3, no kernel 1)
             and 15 of kernel 2, no `models` module loaded; its outputs
             equal the same loop on the live module (per-entry p50 ms of
             both); the fused round launches 1 + 1 and equals the live
             round; a tiny bundle exported on the CPU, moved to the card
             (`move_to_device_pass`), launches kernels 1 and 2;
   tools   — the port's measuring entry points through their main(argv)
             at the JAX scripts' defaults, flagship Config():
             bench_matching_kernel (kernel 1
             bf16, --int8 kernel 3, --local kernel 2), bench_streaming,
             bench_train (stage 1 and stage 2, each also --pipelined),
             profile_stages (and --int8), profile_encode, run_artifact;
             each JSON line's figure finite and positive on the card, the
             kernels of its path launched, each matching-kernel run's
             kernel at least iters x reps times, the artifact's masks
             bitwise equal to the live chain's;
5. train   — the flagship model through `Trainer.train_step` (stage 1,
             TrainConfig() defaults: crop 416, batch 8) for 4 steps and
             `Stage2Trainer.train_step` (crop 416, batch 2, 3 simulated
             rounds over 3-frame clips) for 3 steps on synthetic clips;
             then the trainers' CLIs on trees the script writes
             (tests/_torch_davis_tree.py): stage 1 on a 480p DAVIS tree
             with `--uint8 --grain --grain_workers 4 --snapshot_dir` for 4
             steps, the loader alone at 0 and 4 workers (samples/s), and
             the same trainer fed synchronously and through
             `prefetch_to_device`; stage 2 at batch 2 on a 1280x720
             YouTube-VOS tree with `--ytvos_root --clip_len 3 --init_from`
             the stage-1 snapshot for 3 steps (its parameters at its first
             step equal stage 1's). Every run: finite losses, step times,
             samples/s, peak memory, and the launch counters, reset just
             before each, must show the argmin kernels at B and 2B
             launches per stage-1 step and 2 B R F each per stage-2 step
             (the backward recomputes the checkpointed tails and rounds),
             and the serving kernels at none;
   dist    — the flagship Config() at batch 8: 2 ranks on the one card,
             two processes (tests/_torch_dist_worker.py) over Gloo on CUDA
             tensors, 3 stage-1 and 2 stage-2 steps at 4 samples a rank:
             equal losses and parameter hashes across the ranks after
             every step, per rank and stage-1 step 4 kernel-4 and 8
             kernel-5 launches, the step wall, the all-reduce's share of
             it and the peak memory; the stage-1 CLI with --distributed
             --num_processes 1 on NCCL with --snapshot_dir, then resumed
             (the 2-rank NCCL CLI only where there are two cards); the cp
             train step on 4 members of the card against the one-device
             step for 3 steps (every map to TOL_GLOBAL, losses to 1e-4
             relative, 32 kernel-4 and 16 kernel-5 launches a step);
             norm='frozen' from a synthetic torchvision resnet101 .pth
             (load_torch_file, convert_torch_resnet, load_backbone_into; 2
             steps and a 480p round), 'ln' (a step and a round), 'bn'
             (extract_features at 480p; the Evaluator refuses it);
   quality — the train -> release -> eval entry point
             (`train_eval_flagship.py`) at the flagship Config(): first
             kernels 4 and 5 against their plain versions at its crops
             (256 and 192: 64 x 64 and 48 x 48 global, 32 x 32 and 24 x
             24 local); then `--steps1 8 --steps2 4 --sequences 1 --sets 1
             --rounds 3 --ablate --release DIR` (batch 2, stage 2 at 2
             rounds over 3-frame clips, 16 480p frames with 3 objects
             entering mid-sequence): finite losses, the launches of every
             step (B kernel-4 and 2B kernel-5 a stage-1 step, 2 B R F of
             each a stage-2 step) and of every round (1 kernel-1 and 15
             kernel-2 launches), none outside them; each stage's wall,
             median step and peak memory; then `--eval_release DIR` in a
             fresh call (its per-round J&F must equal the trained run's)
             and `--eval_release DIR --matching_int8` (1 kernel-3 launch
             a round);
6. result  — one JSON line of the kernels (launches: kernels 1-2 over the
             main path's 3 rounds, kernel 3 over serve_int8's 3 rounds,
             kernels 4-5 per stage-1 step, kernel 6 over the cp phase's
             4-member ring; the stream, cp, batch and export phases log
             their own), the nvidia-smi line, and the final
             `{"ok": true, "device": ...}` line.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12      # dense tensor-core bf16 peak (data sheet)
H100_INT8_OPS = 1979e12       # dense tensor-core int8 peak (data sheet)
H100_TF32_FLOPS = 495e12      # dense tensor-core TF32 peak (data sheet)
H100_F32_FLOPS = 67e12        # f32 outside the tensor cores (data sheet)
H100_LANES_PER_SM = 128       # f32 lanes of an SM's CUDA cores
H100_BYTES_PER_S = 3.35e12    # HBM3 (data sheet)

# Both sides form the same products exactly and accumulate them in f32 in
# another order (kernel 1 inside the tensor cores, whose f32 accumulation
# is not rounded step by step as on the CUDA cores). The squared distance
# is |q|^2 + |k|^2 - 2 q.k with terms up to ~1e2 at the model's embedding
# norms, so an accumulation error of ~1e-6 relative is ~2e-4 in the
# distance, and the normalization's slope is at most 1/2.
TOL_GLOBAL = 5e-4
TOL_LOCAL = 1e-4
# Kernel 1's f32 variant (the stream's f32 memory; kernel 6 is the same
# kernel) runs 3xTF32 on the tensor cores: each operand is split into two
# TF32 halves, the three products that matter are exact, the dropped
# lo x lo product is below 2^-22 of a product, and the tensor cores' sums
# (not rounded to nearest) run over 32 channels before an f32 add. Against
# the plain version (TF32 off, f32 products summed in another order) that
# is a few ulps of cross terms of ~1e1 at this embedding scale, ~1e-5 in
# the distance, halved by the normalization's slope.
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


def stream_ms(fn, reps: int = 50, rounds: int = 5) -> float:
    """A kernel's device time: CUDA events around `reps` back-to-back calls
    (the host queues them ahead of the card), over the count; median of
    `rounds`. Unlike `time_ms` it leaves out the host's work per call
    where the card is the slower side."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def graph_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """A call's device time with no host in the way: `reps` calls captured
    in one CUDA graph, CUDA events around its replays, over the count;
    median of `rounds`. For a kernel whose host work a call outlasts its
    device time (kernel 7 at layer 3's sizes)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
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
    reference rows of `dtype` (bf16: the round and the batch, on the bf16
    tensor cores; f32: the stream's f32 memory, 3xTF32 on the tensor
    cores), O - 1 live objects + background in an O bucket. The f32 bound is 3 TF32 products per pair; the f32 FMA bound
    (the CUDA cores) is logged beside it."""
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
    pairs = 2.0 * nq * n_rows * c
    in_out = nbytes(q, b.neg2pixels, b.sqnorm, b.block_obj, got)
    if bf16:
        b_ms, b_by = bound(pairs, H100_BF16_FLOPS, in_out)
        how = "f32 accumulation in another order, in the tensor cores"
    else:
        b_ms, b_by = bound(3 * pairs, H100_TF32_FLOPS, in_out)
        fma_ms = bound(pairs, H100_F32_FLOPS, in_out)[0]
        how = (f"3xTF32 on the tensor cores; 3 TF32 products per pair, the "
               f"f32 FMA bound would be {fma_ms:.3f} ms")
    log(f"[kernels] global_matching ({what}) Nq={nq} Nk={nk} (labelled "
        f"{n_rows}) C={c} O={o} {str(dtype)[6:]}: {share:.3f} of "
        f"live-object outputs below 0.99 (min {MIN_UNSATURATED}), "
        f"max|err|={err:.3g} (tol {tol}: {how}); kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, cross-term GEMM only (torch.matmul over "
        f"{chunks} query chunks) {library_ms:.3f} ms, bound {b_ms:.3f} ms by "
        f"{b_by}")
    return dict(name="global_matching", route="cuda",
                source="cvpr2020_manet_tpu_torch/csrc/global_matching.cu",
                replaces="cvpr2020_manet_tpu/ops/matching_pallas.py:274",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


def kernel_global_int8(dev, nq: int, nk: int, c_real: int, c: int, o: int,
                       what: str, back_to_back: bool = False):
    """Kernel 3 at one of its paths' shapes: bf16 queries (the model's
    embeddings, quantized per row in the kernel's prologue) against an
    int8 reference of Nk rows, 2 live objects + background in an O=4
    bucket (the last object has no pixels), with the key splits S the
    wrapper plans. Times the wrapper (single calls; with `back_to_back`,
    a launch of a fraction of a millisecond, over runs of back-to-back
    calls, the single call logged beside), the plain version and
    torch._int_mm over the cross term. The bound is the larger of the int8
    products and the epilogue's floor on the CUDA cores."""
    from cvpr2020_manet_tpu_torch.ops.global_matching_cuda import (
        QUERY_TILE, _int8_query, _launch_int8, global_matching_prepared_int8,
        global_matching_prepared_int8_plain, key_splits, prepare_ref_int8)
    g = torch.Generator().manual_seed(3)
    live = o - 1
    q, k, labels = global_inputs(g, nq, nk, c_real, c, live)
    q, k = q.to(dev, torch.bfloat16), k.to(dev, torch.bfloat16)
    onehot = torch.nn.functional.one_hot(labels, o).float().to(dev)
    b = prepare_ref_int8(k, onehot)
    splits = key_splits(nq, b, dev)
    got = global_matching_prepared_int8(q, b)
    want = global_matching_prepared_int8_plain(q, b)
    torch.cuda.synchronize()
    err, share = check_outputs(f"int8 global matching ({what})", got, want,
                               live, TOL_INT8)
    kernel_fn = lambda: global_matching_prepared_int8(q, b)
    call_ms = time_ms(kernel_fn)
    ms = stream_ms(kernel_fn) if back_to_back else call_ms
    # where the planner splits the key range, one walk gives the same bits
    if splits > 1:
        require(torch.equal(_launch_int8(q, b, 1), got),
                f"int8 S = {splits} differs from S = 1")
    plain_ms = time_ms(lambda: global_matching_prepared_int8_plain(q, b),
                       reps=3, warmup=1)
    # the library's cross term on the same int8 rows (the reference rows
    # in their source order, the same products as the kernel's)
    q_hat = _int8_query(q, b)[0]
    n_rows = int((b.src_idx >= 0).sum())       # labelled reference pixels
    k_hat = b.pixels[(b.src_idx >= 0).nonzero()[:, 0]][:n_rows // 8 * 8]
    require(torch.equal(torch._int_mm(q_hat[:64], k_hat.t()).float(),
                        q_hat[:64].float() @ k_hat.float().t()),
            "torch._int_mm disagrees with the plain cross term")
    library_ms, chunks = cross_term_ms(torch._int_mm, q_hat, k_hat.t(), 4,
                                       reps=3)
    tc_ms, b_by = bound(2.0 * nq * n_rows * c, H100_INT8_OPS,
                        nbytes(q, b.pixels, b.sqnorm, b.block_obj, got))
    epi_ms = epilogue_ms(nq, b, INT8_LANE_OPS)
    b_ms = max(tc_ms, epi_ms)
    b_what = ("the int8 products" if tc_ms >= epi_ms
              else "the epilogue on the CUDA cores")
    timing = (f"{ms:.4f} ms over back-to-back calls ({call_ms:.4f} ms a "
              f"single call)" if back_to_back else f"{ms:.3f} ms")
    log(f"[kernels] global_matching_int8 ({what}) Nq={nq} Nk={nk} (labelled "
        f"{n_rows}) C={c} O={o}, bf16 queries: {share:.3f} of live-object "
        f"outputs below 0.99 (min {MIN_UNSATURATED}), max|err|={err:.3g} "
        f"(tol {TOL_INT8}: the same quantized values, exact integer cross "
        f"terms, the same f32 epilogue); S = {splits} key splits "
        f"({-(-nq // QUERY_TILE)} query tiles"
        f"{'; the same bits as S = 1' if splits > 1 else ''}); wrapper (the "
        f"query quantized in the kernel) {timing}, plain {plain_ms:.3f} ms, cross "
        f"term only (torch._int_mm over {chunks} query chunks) "
        f"{library_ms:.3f} ms, bound {b_ms:.3f} ms by {b_by} ({b_what}; "
        f"int8 tensor cores {tc_ms:.3f} ms, epilogue floor {epi_ms:.3f} ms "
        f"at {INT8_LANE_OPS} lane operations per candidate)")
    return dict(name="global_matching_int8", route="cuda",
                source="cvpr2020_manet_tpu_torch/csrc/global_matching.cu",
                replaces="cvpr2020_manet_tpu/ops/matching_pallas.py:372",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms, splits=splits,
                epilogue_floor_ms=epi_ms, call_ms=call_ms)


def kernel_local(dev, hw: tuple[int, int], c_real: int, c: int, o: int,
                 window: int, what: str):
    """Kernel 2 at one of its paths' shapes: one frame's grid (MANet's
    half resolution, FEELVOS's full stride-4 grid), f32. The bound is 3 TF32 products per in-window pair on the tensor
    cores; the bound of the pairs the kernel computes (each query row's
    16-query tiles against its n8 key tiles) and the f32 FMA bound are
    logged beside it."""
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
    err, share = check_outputs(f"local matching ({what})", got, want, live,
                               TOL_LOCAL)
    # a launch is a fraction of a millisecond: timed over back-to-back
    # calls (the device's time), a single call logged beside
    kernel_fn = lambda: local_matching_prepared(*inputs, window)
    ms, call_ms = stream_ms(kernel_fn), time_ms(kernel_fn)
    plain_ms = time_ms(lambda: local_matching_prepared_plain(*inputs, window),
                       reps=3, warmup=1)
    io = nbytes(*inputs, got)
    pairs = 2.0 * window_pairs(h, w, window) * c
    b_ms, b_by = bound(3 * pairs, H100_TF32_FLOPS, io)
    computed = 2.0 * computed_local_pairs(h, w, window) * c
    computed_ms = bound(3 * computed, H100_TF32_FLOPS, io)[0]
    fma_ms = bound(pairs, H100_F32_FLOPS, io)[0]
    log(f"[kernels] local_matching ({what}) {h}x{w} C={c} O={o} "
        f"window={window} f32: {share:.3f} of live-object outputs below 0.99 "
        f"(min {MIN_UNSATURATED}), max|err|={err:.3g} (tol {TOL_LOCAL}: "
        f"3xTF32, f32 accumulation in another order); kernel {ms:.4f} ms "
        f"over back-to-back calls ({call_ms:.4f} ms a single call), plain "
        f"{plain_ms:.3f} ms, no single library call, bound "
        f"{b_ms:.4f} ms by {b_by} (3 TF32 products per in-window pair; "
        f"the {computed / pairs:.2f}x pairs the kernel computes "
        f"{computed_ms:.4f} ms; f32 FMA {fma_ms:.4f} ms)")
    return dict(name="local_matching", route="cuda",
                source="cvpr2020_manet_tpu_torch/csrc/local_matching.cu",
                replaces="cvpr2020_manet_tpu/ops/local_matching_pallas.py:42",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def computed_local_pairs(h: int, w: int, window: int) -> int:
    """(query, key) pairs kernel 2 multiplies: each query row's 16-query
    tiles against the n8 key tiles (3 a warp) of each key row within the
    window."""
    tiles = -(-(16 + 2 * window) // 8)
    keys = -(-tiles // 3) * 24
    rows = sum(min(h - 1, y + window) - max(0, y - window) + 1
               for y in range(h))
    return rows * -(-w // 16) * 16 * keys


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


def sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi), for CUDA-core bounds."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]
    return float(mhz) * 1e6


# Lane operations per candidate of kernel 4's argmin epilogue: the add of
# |k|^2, the compare, and the two selects of (min, row).
ARGMIN_LANE_OPS = 4.5
# ... and of kernel 3's epilogue: the integer add and the subtraction that
# turn the int32 cross term into a float, the multiply, the add of |k|^2
# and the min.
INT8_LANE_OPS = 5


def epilogue_ms(nq: int, b, lane_ops: float) -> float:
    """The CUDA-core floor of a global kernel's epilogue: `lane_ops` per
    candidate over Nq x the live k-blocks' rows (padding rows included),
    on every f32 lane of the card at its maximum clock."""
    live = int((b.block_obj < b.num_objects).sum())
    lanes = torch.cuda.get_device_properties(0).multi_processor_count \
        * H100_LANES_PER_SM
    cands = nq * live * b.sqnorm.shape[1]
    return lane_ops * cands / (lanes * sm_clock_hz()) * 1e3


def kernel_global_argmin(dev, hw: tuple[int, int], c_real: int, c: int,
                         o: int, tie_objects: int | None = None):
    """Kernel 4 at the training shape: one crop's features (Nq = Nk = h w)
    against its reference frame, bf16, O = 9 with the last object
    pixel-less; its key splits, winners, and the routed gradients. The
    bound is the larger of the tensor cores' products and the argmin
    epilogue's floor on the CUDA cores. The ties across its key splits
    are checked with `tie_objects` objects (default O): at a small crop
    each of 8 live objects fills one k-block, and no object straddles a
    split."""
    from cvpr2020_manet_tpu_torch.ops.global_matching_cuda import (
        BLOCKS_PER_SM, QUERY_TILE, key_splits,
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
    splits = key_splits(nq, b, dev)
    tiles = -(-nq // QUERY_TILE)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"[kernels] global_matching_argmin at the training shape: S = "
        f"{splits} key splits, grid {tiles} x {splits} = {tiles * splits} "
        f"blocks ({BLOCKS_PER_SM} resident per SM on {sms} SMs), "
        f"{int((b.block_obj < o).sum())} live of {b.block_obj.numel()} "
        f"k-blocks of {b.sqnorm.shape[1]} rows")
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
    # a launch is a fraction of a millisecond: kernel and library call are
    # both timed over runs of back-to-back calls (the device's time), and
    # single calls (the host's work per call included) are logged beside
    kt = k.T.contiguous()
    kernel_fn = lambda: global_matching_prepared_argmin(q, b)
    library_fn = lambda: torch.matmul(q, kt)
    ms, library_ms = stream_ms(kernel_fn), stream_ms(library_fn)
    call_ms, library_call_ms = time_ms(kernel_fn), time_ms(library_fn)
    plain_ms = time_ms(lambda: global_matching_prepared_argmin_plain(q, b))
    n_rows = int((b.src_idx >= 0).sum())
    tc_ms, b_by = bound(2.0 * nq * n_rows * c, H100_BF16_FLOPS,
                        nbytes(q, b.neg2pixels, b.sqnorm, b.block_obj, got,
                               got_idx))
    epi_ms = epilogue_ms(nq, b, ARGMIN_LANE_OPS)
    b_ms = max(tc_ms, epi_ms)
    b_what = ("the tensor cores' products" if tc_ms >= epi_ms
              else "the argmin epilogue on the CUDA cores")
    log(f"[kernels] global_matching_argmin  Nq={nq} Nk={nk} (labelled "
        f"{n_rows}) C={c} O={o} bf16: {share:.3f} of live-object outputs "
        f"below 0.99, max|err|={err:.3g} (tol {TOL_GLOBAL}); winners equal "
        f"at all {clear_share:.4f} of live positions whose best beats the "
        f"second best by > {TOL_GLOBAL}; pixel-less object -1; routed "
        f"gradients kernel vs plain forward {grad_err:.3g} of the largest "
        f"(tol {TOL_GRAD_BF16}: bf16 gradients); kernel {ms:.4f} ms over "
        f"back-to-back calls ({call_ms:.4f} ms a single call with the "
        f"wrapper's host work), plain {plain_ms:.3f} ms, cross-term GEMM only "
        f"(torch.matmul bf16) {library_ms:.4f} ms ({library_call_ms:.4f} ms "
        f"a single call), bound {b_ms:.4f} ms by {b_by} ({b_what}; "
        f"tensor cores {tc_ms:.4f} ms, epilogue floor {epi_ms:.4f} ms at "
        f"{ARGMIN_LANE_OPS} lane operations per candidate)")
    argmin_split_ties(dev, hw, c, tie_objects or o)
    return dict(name="global_matching_argmin", route="cuda",
                source="cvpr2020_manet_tpu_torch/csrc/global_matching.cu",
                replaces="cvpr2020_manet_tpu/ops/matching_pallas.py:507",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


def argmin_split_ties(dev, hw: tuple[int, int], c: int, o: int) -> None:
    """Kernel 4 at the training shape on reference rows duplicated across
    its key splits: keys in small multiples of 1/4 (every product and sum
    exact), objects of unequal sizes so that some straddle a split
    boundary, and at each boundary inside an object the rows of the
    k-block before it copied over the k-block after it (both copies in one
    object, in different splits). Queries sit next to the copied rows, so
    each copy pair ties exactly; the winners must equal the plain
    version's everywhere, and at every tie be the lower bucketed row."""
    from cvpr2020_manet_tpu_torch.ops.global_matching_cuda import (
        global_matching_prepared_argmin,
        global_matching_prepared_argmin_plain, key_splits, prepare_ref,
        split_ranges)
    g = torch.Generator().manual_seed(8)
    nk = nq = hw[0] * hw[1]
    live = o - 1
    # object j holds j + 1 shares of the rows, in a random order
    shares = torch.arange(1, live + 1)
    sizes = torch.diff(torch.cat([torch.zeros(1, dtype=torch.long),
                                  shares.cumsum(0) * nk // shares.sum()]))
    labels = torch.repeat_interleave(torch.arange(live), sizes)[
        torch.randperm(nk, generator=g)]
    onehot = torch.nn.functional.one_hot(labels, o).float().to(dev)
    k = torch.randint(-2, 3, (nk, c), generator=g) * 0.25
    b = prepare_ref(k.to(dev, torch.bfloat16), onehot)
    splits = key_splits(nq, b, dev)
    block_k = b.sqnorm.shape[1]
    obj = b.block_obj.tolist()
    live_kb = [j for j, x in enumerate(obj) if x < o]
    src = b.src_idx.view(-1, block_k).cpu().long()
    copied, straddle = [], 0
    for lo, _ in split_ranges(len(live_kb), splits)[1:]:
        before, after = live_kb[lo - 1], live_kb[lo]
        if obj[before] != obj[after]:
            continue
        straddle += 1
        keep = (src[before] >= 0) & (src[after] >= 0)
        k[src[after][keep]] = k[src[before][keep]]
        copied.append(src[before][keep])
    require(straddle > 0, "argmin ties: no object straddles a split")
    copied = torch.cat(copied)
    q = k[copied[torch.randint(len(copied), (nq,), generator=g)]].clone()
    q[:, :2] += 0.25
    q, k = q.to(dev, torch.bfloat16), k.to(dev, torch.bfloat16)
    b = prepare_ref(k, onehot)
    got, got_idx = global_matching_prepared_argmin(q, b)
    want, want_idx = global_matching_prepared_argmin_plain(q, b)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    require(err <= TOL_GLOBAL, f"argmin ties: distances differ by {err}")
    require(torch.equal(got_idx, want_idx),
            "argmin ties: winners differ from the plain version's")
    require(bool((got_idx[:, live:] == -1).all()),
            "argmin ties: a pixel-less object has a winner")
    e = q.float() @ b.neg2pixels.float().T + b.sqnorm.reshape(-1)
    row_obj = b.block_obj.long().repeat_interleave(block_k)
    ties = 0
    for ob in range(live):
        eo = torch.where((row_obj == ob) & (b.src_idx >= 0), e, float("inf"))
        at_min = eo == eo.min(dim=1, keepdim=True).values
        tie = at_min.sum(dim=1) > 1
        ties += int(tie.sum())
        require(torch.equal(got_idx[tie, ob].long(),
                            at_min.int().argmax(dim=1)[tie]),
                "argmin ties: a tie went to a higher bucketed row")
    require(ties >= nq, f"argmin ties: only {ties} ties")
    log(f"[kernels] global_matching_argmin ties at the training shape: S = "
        f"{splits}, {straddle} split boundaries inside an object, "
        f"{len(copied)} rows copied across them; winners equal to the "
        f"plain version's at all {nq * o} positions, {ties} exact ties all "
        f"won by the lower bucketed row; max|err|={err:.3g}")


def kernel_local_argmin(dev, hw: tuple[int, int], c_real: int, c: int,
                        o: int, window: int):
    """Kernel 5 at the training shape: the half-resolution 416 crop, f32,
    O = 9 with the last object pixel-less; winners, and the routed
    gradients. As kernel 2's, its bound is 3 TF32 products per in-window
    pair, with the computed pairs' and the f32 FMA bounds beside it."""
    from cvpr2020_manet_tpu_torch.device import sm_count
    from cvpr2020_manet_tpu_torch.ops.local_matching_cuda import (
        ARGMIN_PATCH_ROWS, _launch, argmin_patch_rows,
        local_matching_prepared_argmin,
        local_matching_prepared_argmin_plain, prepare_local)
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
    # a launch is a fraction of a millisecond: timed over back-to-back
    # calls (the device's time), a single call logged beside
    kernel_fn = lambda: local_matching_prepared_argmin(*inputs, window)
    ms, call_ms = stream_ms(kernel_fn), time_ms(kernel_fn)
    # every patch height gives the planner's bits
    for r in ARGMIN_PATCH_ROWS:
        d, i = _launch(*inputs, window, argmin=True, rows=r)
        require(torch.equal(d, got) and torch.equal(i, got_idx),
                f"local argmin on {r}-row patches differs")
    plain_ms = time_ms(
        lambda: local_matching_prepared_argmin_plain(*inputs, window))
    io = nbytes(*inputs, got, got_idx)
    pairs = 2.0 * window_pairs(h, w, window) * c
    b_ms, b_by = bound(3 * pairs, H100_TF32_FLOPS, io)
    computed = 2.0 * computed_local_pairs(h, w, window) * c
    computed_ms = bound(3 * computed, H100_TF32_FLOPS, io)[0]
    fma_ms = bound(pairs, H100_F32_FLOPS, io)[0]
    rows = argmin_patch_rows(h, w, sm_count(dev))
    log(f"[kernels] local_matching_argmin   {h}x{w} C={c} O={o} "
        f"window={window} f32, patches of {rows} query rows (those of "
        f"{ARGMIN_PATCH_ROWS} give the same bits): {share:.3f} of "
        f"live-object outputs below 0.99, max|err|={err:.3g} (tol "
        f"{TOL_LOCAL}: 3xTF32); winners equal at all {clear_share:.4f} of "
        f"live positions whose best beats the second best by > "
        f"{TOL_LOCAL}; routed gradients kernel vs plain forward "
        f"{grad_err:.3g} of the largest (tol {TOL_GRAD_F32}: index_add_ "
        f"order); kernel {ms:.4f} ms over back-to-back calls ({call_ms:.4f} "
        f"ms a single call), plain {plain_ms:.3f} ms, no single library "
        f"call, bound {b_ms:.4f} ms by {b_by} (3 TF32 products per "
        f"in-window pair; the {computed / pairs:.2f}x pairs the kernel "
        f"computes {computed_ms:.4f} ms; f32 FMA {fma_ms:.4f} ms)")
    return dict(name="local_matching_argmin", route="cuda",
                source="cvpr2020_manet_tpu_torch/csrc/local_matching.cu",
                replaces="cvpr2020_manet_tpu/ops/local_matching_pallas.py:78",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def kernel_group_norm(dev, shape: tuple[int, int, int, int], groups: int,
                      residual: bool, what: str):
    """Kernel 7 at one of its sites: bf16 NCHW activations (mean 3, std
    2), f32 scale and bias, ReLU and, where the site has one, the bf16
    residual, against its plain version (aten's f32 chain: upcast,
    F.group_norm, cast, add, ReLU): within one bf16 ulp on 99.9% of the
    outputs, two at most. The bound is bytes: x and the residual read
    once, y written once. The library call is aten's bf16 GroupNorm
    alone (no upcast, no epilogue)."""
    from cvpr2020_manet_tpu_torch.ops.group_norm_cuda import (
        bf16_ulps, group_norm, group_norm_plain)
    n, c, h, w = shape
    g = torch.Generator(device=dev).manual_seed(7)
    x = (3.0 + 2.0 * torch.randn(shape, device=dev, generator=g)).bfloat16()
    weight = 1.0 + 0.5 * torch.randn(c, device=dev, generator=g)
    bias = 0.5 * torch.randn(c, device=dev, generator=g)
    r = torch.randn(shape, device=dev, generator=g).bfloat16() \
        if residual else None
    kernel_fn = lambda: group_norm(x, weight, bias, r, groups=groups,
                                   eps=1e-6, relu=True)
    got = kernel_fn()
    want = group_norm_plain(x, weight, bias, r, groups, 1e-6, True)
    normalized = group_norm_plain(x, weight, bias, None, groups, 1e-6,
                                  False) if residual else None
    ulps = bf16_ulps(got, want, normalized)
    within1, worst = float((ulps <= 1).float().mean()), float(ulps.max())
    err = float((got.float() - want.float()).abs().max())
    require(within1 >= 0.999 and worst <= 2,
            f"group_norm ({what}): {within1:.5f} within one bf16 ulp, "
            f"{worst:g} at most")
    ms, b2b_ms, call_ms = (graph_ms(kernel_fn), stream_ms(kernel_fn),
                           time_ms(kernel_fn))
    plain_ms = time_ms(lambda: group_norm_plain(x, weight, bias, r, groups,
                                                1e-6, True), reps=5)
    w16, b16 = weight.bfloat16(), bias.bfloat16()
    library_ms = stream_ms(lambda: torch.nn.functional.group_norm(
        x, groups, w16, b16, 1e-6), reps=20)
    b_ms, b_by = bound(0.0, H100_BF16_FLOPS,
                       nbytes(x, got, *([r] if residual else [])))
    log(f"[kernels] group_norm ({what}) {n}x{c}x{h}x{w} G={groups} bf16"
        f"{' + residual' if residual else ''} + ReLU: {within1:.6f} of "
        f"outputs within one bf16 ulp of the plain version, {worst:g} at "
        f"most (max|err| {err:.3g}); kernel pair {ms:.4f} ms of device "
        f"time (CUDA-graph replays; {b2b_ms:.4f} ms over back-to-back "
        f"calls, {call_ms:.4f} ms a single call), {100 * b_ms / ms:.1f}% of "
        f"the bound {b_ms:.4f} ms by {b_by}; plain {plain_ms:.3f} ms; "
        f"aten's bf16 GroupNorm alone {library_ms:.4f} ms")
    return dict(name="group_norm", route="cuda",
                source="cvpr2020_manet_tpu_torch/csrc/group_norm.cu",
                replaces="none (Flax nn.GroupNorm, left to XLA)",
                max_abs_err=err, ms=ms, b2b_ms=b2b_ms, call_ms=call_ms,
                plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                within_one_ulp=within1, max_ulps=worst)


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
    launches per round, one kernel-7 launch per GroupNorm call of the
    model (counted by forward hooks) and no other kernel. -> the
    launches."""
    from cvpr2020_manet_tpu_torch.config import Config, EvalConfig
    from cvpr2020_manet_tpu_torch.data import SyntheticDataset
    from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
    from cvpr2020_manet_tpu_torch.interactive.session import InteractiveSession
    from cvpr2020_manet_tpu_torch.kernels import build
    from cvpr2020_manet_tpu_torch.models.layers import GroupNorm

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
    norm_calls = [0]

    def count_norm(*_):
        norm_calls[0] += 1
    hooks = [m.register_forward_hook(count_norm) for m in model.modules()
             if isinstance(m, GroupNorm)]
    session = InteractiveSession(ds, max_interactions=rounds)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    OPEN_NORM_COUNTS.append(norm_calls)
    try:
        summary = ev.run_session(
            session, on_masks=lambda *a: masks_seen.append(a[-1]))
    finally:
        OPEN_NORM_COUNTS.remove(norm_calls)
        for h in hooks:
            h.remove()
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
        f"local {launches['local_matching'] / n_rounds:g}); GroupNorm calls "
        f"{norm_calls[0]} (the sequence start's encoder and the rounds' "
        f"heads)")
    require(n_rounds == rounds, f"{n_rounds} rounds ran, {rounds} expected")
    require(norm_calls[0] > 0, f"{phase}: no GroupNorm call")
    want = {global_kernel: n_rounds, "local_matching": (n_frames - 1) * n_rounds,
            NORM_KERNEL: norm_calls[0]}
    require(launches == {k: want.get(k, 0) for k in launches},
            f"{phase} launches {launches}, expected {want}")
    check_replays(ev, phase)
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


# Kernel 7 (GroupNorm) launches once a bf16 norm with no backward to
# record: every norm of the serving paths, none of the trainers'. The
# launch checks hold its count to the GroupNorm calls that `norm_calls`
# counts while the path runs, or, for an exported graph, to the
# `manet::group_norm` nodes it ran; the trainers' to 0.
NORM_KERNEL = "group_norm"
# The GroupNorm counts open now (`norm_calls`, `main_path`'s hooks). A
# replayed CUDA graph (the round's sweep steps) runs no Python and calls no
# hook: `count_graph_norms` has each replay add its step's calls to them.
OPEN_NORM_COUNTS: list[list[int]] = []


@contextlib.contextmanager
def norm_hook(count: list[int]):
    """Add to count[0], while open, the GroupNorm calls on bf16 input with
    grad mode off (a global forward pre-hook on every module)."""
    from torch.nn.modules.module import register_module_forward_pre_hook
    from cvpr2020_manet_tpu_torch.models.layers import GroupNorm

    def hook(module, args):
        if (isinstance(module, GroupNorm) and not torch.is_grad_enabled()
                and args[0].dtype == torch.bfloat16):
            count[0] += 1
    handle = register_module_forward_pre_hook(hook)
    try:
        yield count
    finally:
        handle.remove()


@contextlib.contextmanager
def norm_calls():
    """Count, while open, the GroupNorm calls on bf16 input with grad mode
    off (`norm_hook`, and the replays of the round's step graphs). -> a
    one-item list, the count."""
    count = [0]
    OPEN_NORM_COUNTS.append(count)
    try:
        with norm_hook(count):
            yield count
    finally:
        OPEN_NORM_COUNTS.remove(count)


def count_graph_norms() -> None:
    """Have the round's step graphs (`engine/round_graph.py`) count their
    GroupNorm calls into the open counts: the hooks see a graph's warm-up
    step and its capture, neither of them a sweep step, so what the open
    counts counted then is taken back out; the two run the same step, and
    each replay adds half their calls."""
    from cvpr2020_manet_tpu_torch.engine import round_graph

    class NormCountedStep(round_graph.StepGraph):
        def __init__(self, *args, **kw):
            opened = [(c, c[0]) for c in OPEN_NORM_COUNTS]
            made = [0]
            with norm_hook(made):
                super().__init__(*args, **kw)
            for c, before in opened:
                c[0] = before
            require(made[0] % 2 == 0, f"a step graph's warm-up and capture "
                    f"made {made[0]} GroupNorm calls, not twice a step's")
            self.norms = made[0] // 2

        def replay(self):
            super().replay()
            for c in OPEN_NORM_COUNTS:
                c[0] += self.norms
    round_graph.StepGraph = NormCountedStep


def check_replays(ev, phase: str, reps: int = 3) -> None:
    """Replay each of the Evaluator's captured sweep steps `reps` times
    under torch.profiler: the card must run, a replay, kernel 2 and the two
    kernels of kernel 7 as often as the capture counted their launches
    (`StepGraph.counted`, which a replay adds to `build.LAUNCHES` with no
    wrapper's call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from cvpr2020_manet_tpu_torch.kernels import build
    # device kernel -> the launch counters whose launches run it
    runs = {"local_matching_tf32": ("local_matching",),
            "group_norm_stats": (NORM_KERNEL,),
            "group_norm_apply": (NORM_KERNEL,)}
    graphs = ev._steps.graphs
    require(len(graphs) > 0, f"{phase}: no sweep step was captured")
    for key, graph in graphs.items():
        require("local_matching" in graph.counted
                and set(graph.counted) <= {"local_matching", NORM_KERNEL},
                f"{phase}: step graph {key} counted {graph.counted}")
        want = {k: reps * sum(graph.counted.get(c, 0) for c in cs)
                for k, cs in runs.items()}
        before = dict(build.LAUNCHES)
        with torch.cuda.device(key[-1]):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    graph.replay()
                torch.cuda.synchronize()
        build.LAUNCHES.update(before)
        kernels = [e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        seen = {k: sum(k in name for name in kernels) for k in runs}
        log(f"[{phase}] step graph {key[:3]}: {reps} replays ran "
            f"{len(kernels)} device kernels, {seen}; its capture counted "
            f"{graph.counted} a step")
        require(seen == want, f"{phase}: step graph {key} replays ran "
                f"{seen}, its capture counted {want}")


def with_norms(want: dict[str, int], norms: int) -> dict[str, int]:
    """`want` (kernel -> launches) with `norms` kernel-7 launches."""
    return {**want, NORM_KERNEL: norms} if norms else dict(want)


def norm_nodes(exported) -> int:
    """The `manet::group_norm` nodes of an exported program's graph."""
    return sum(str(n.target) == "manet.group_norm.default"
               for n in exported.graph.nodes if n.op == "call_function")


def launches_delta(fn):
    """Run fn(); -> (its result, the kernel launches it made, its GroupNorm
    calls that take kernel 7 as `norm_calls` counts them)."""
    from cvpr2020_manet_tpu_torch.kernels import build
    before = dict(build.LAUNCHES)
    with norm_calls() as norms:
        out = fn()
    return out, {k: v - before[k] for k, v in build.LAUNCHES.items()
                 if v != before[k]}, norms[0]


# --------------------------------------------------------------------- #
# The davis phase: the DAVIS evaluation CLI on a DAVIS tree this script
# writes with tests/_torch_davis_tree.py (480p JPEGs from a numpy baseline
# encoder, indexed-PNG annotations through the port's writer, scribble
# JSON, the val split).
# --------------------------------------------------------------------- #

# (name, frames, objects, seed): frame buckets 16 and 32 of the flagship
DAVIS_SEQUENCES = (("seq16_2obj", 16, 2, 0), ("seq25_3obj", 25, 3, 1))
DAVIS_SIZE = (480, 854)
DAVIS_ROUNDS = 8
DAVIS_SETS = 2


class _StopAfterFirstItem(Exception):
    """Raised from the progress hook once the second item's first round
    is handed back: the first item's report checkpoint is on disk."""


def davis_cli(argv, stop_after_first_item=False):
    """`eval_davis.main(argv)` as a user runs it, the launch counters reset
    just before. -> dict: the JSON line, every round's (sequence, set,
    round, frame bucket) as the CLI's progress hook sees it, and its
    seconds on the evaluator's clock, each item's last-round masks,
    start_sequence times, each submission's scoring and robot time,
    launches, stderr, wall time and peak memory."""
    import contextlib
    import io

    from cvpr2020_manet_tpu_torch.engine import eval_davis
    from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
    from cvpr2020_manet_tpu_torch.kernels import build

    from cvpr2020_manet_tpu_torch.interactive.session import (
        InteractiveSession)

    run = {"rounds": [], "round_s": [], "last": {}, "start_s": [],
           "score_s": [], "stopped": False}
    real = Evaluator.run_session
    real_submit = InteractiveSession.submit_masks

    def timed_submit(session, masks):
        # J and F scoring of the round and the robot's next scribbles, in
        # the CLI's process or, under --host, in the server's thread
        t = time.perf_counter()
        real_submit(session, masks)
        run["score_s"].append(time.perf_counter() - t)

    def run_session(ev, session, on_masks=None):
        start_sequence = ev.start_sequence

        def timed_start(*args):
            t = time.perf_counter()
            st = start_sequence(*args)
            torch.cuda.synchronize()
            run["start_s"].append(time.perf_counter() - t)
            return st
        ev.start_sequence = timed_start

        def hook(seq, set_idx, round_idx, masks):
            if (stop_after_first_item and run["rounds"]
                    and run["rounds"][0][:2] != (seq, set_idx)):
                raise _StopAfterFirstItem
            run["rounds"].append((seq, set_idx, round_idx,
                                  ev.round_records[-1][0]))
            run["round_s"].append(ev.round_records[-1][2])
            run["last"][(seq, set_idx)] = masks
            on_masks(seq, set_idx, round_idx, masks)
        try:
            return real(ev, session, on_masks=hook)
        finally:
            # ev -> timed_start -> ev is a cycle: break it, so that the
            # run's model and states go when the CLI returns, not at the
            # next garbage collection (the next run's peak memory)
            del ev.start_sequence

    out, err = io.StringIO(), io.StringIO()
    Evaluator.run_session = run_session
    InteractiveSession.submit_masks = timed_submit
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    try:
        with norm_calls() as norms, contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            eval_davis.main(argv)
    except _StopAfterFirstItem:
        run["stopped"] = True
    finally:
        Evaluator.run_session = real
        InteractiveSession.submit_masks = real_submit
    torch.cuda.synchronize()
    run["wall_s"] = time.perf_counter() - t0
    run["launches"] = dict(build.LAUNCHES)
    run["norms"] = norms[0]
    run["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    run["stderr"] = err.getvalue()
    lines = out.getvalue().strip().splitlines()
    run["line"] = None if run["stopped"] else json.loads(lines[-1])
    return run


def check_davis_launches(name, run, global_kernel, buckets):
    """Each sequence's rounds in its frame bucket; 1 `global_kernel` launch
    per round and bucket - 1 local ones (the sweep over the padded
    bucket), one of kernel 7 per GroupNorm call, no other kernel."""
    for seq, _, _, tb in run["rounds"]:
        require(tb == buckets[seq], f"davis {name}: {seq} ran in frame "
                f"bucket {tb}, expected {buckets[seq]}")
    require(run["norms"] > 0, f"davis {name}: no GroupNorm call")
    want = with_norms({global_kernel: len(run["rounds"]),
                       "local_matching": sum(tb - 1
                                             for *_, tb in run["rounds"])},
                      run["norms"])
    got = run["launches"]
    log(f"[davis] {name}: launches {got} over {len(run['rounds'])} rounds")
    require(got == {k: want.get(k, 0) for k in got},
            f"davis {name} launches {got}, expected {want}")


def davis_metric_rows(report):
    from cvpr2020_manet_tpu_torch.interactive.session import (
        REPORT_COLUMNS, read_report_csv)
    return [[r[c] for c in REPORT_COLUMNS[:-1]]
            for r in read_report_csv(report)]


def davis_phase(tmp: str) -> dict:
    """The DAVIS evaluation CLI at the flagship config on a 480p tree of
    DAVIS_SEQUENCES, DAVIS_ROUNDS rounds x DAVIS_SETS scribble sets, which
    it writes under `tmp`: default (kernels 1 and 2), --matching_int8
    (kernels 3 and 2), a run stopped after its first item and resumed, and
    a run against the port's evaluation server (--host); the resumed and
    remote reports' metric columns must equal the default run's. -> what
    the reference phase reads: the tree, the frame buckets, and the
    default run with its report."""
    from cvpr2020_manet_tpu_torch.config import EvalConfig
    from cvpr2020_manet_tpu_torch.data.davis import DavisEvalDataset
    from cvpr2020_manet_tpu_torch.interactive.service import serve
    from cvpr2020_manet_tpu_torch.interactive.session import read_report_csv
    from cvpr2020_manet_tpu_torch.native.image import read_jpeg
    from cvpr2020_manet_tpu_torch.utils.colormap import load_indexed_png
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from _torch_davis_tree import write_davis_tree

    t_phase = time.perf_counter()
    size = f"{DAVIS_SIZE[1]}x{DAVIS_SIZE[0]}"
    root = os.path.join(tmp, "DAVIS")
    t0 = time.perf_counter()
    written = write_davis_tree(root, DAVIS_SIZE, DAVIS_SEQUENCES,
                               DAVIS_SETS)
    n_frames = {seq: v[0].shape[0] for seq, v in written.items()}
    n_obj = {seq: int(v[1].max()) for seq, v in written.items()}
    # the smallest of the flagship's frame buckets that holds each
    buckets = {seq: min(b for b in EvalConfig().frame_buckets if b >= n)
               for seq, n in n_frames.items()}
    log(f"[davis] wrote a {size} DAVIS tree ({n_frames} frames, "
        f"{n_obj} objects, {DAVIS_SETS} scribble sets) in "
        f"{time.perf_counter() - t0:.2f} s")

    # the host decoders at 480p, and what they decode
    seq0 = next(iter(written))
    jpg = os.path.join(root, "JPEGImages", "480p", seq0, "00000.jpg")
    png = os.path.join(root, "Annotations", "480p", seq0, "00000.png")
    dec = read_jpeg(jpg)                    # builds the decoder
    src = written[seq0][0][0]
    psnr = 10 * np.log10(255.0 ** 2 / np.mean(
        (dec.astype(np.float64) - src) ** 2))
    require(dec.shape == src.shape and psnr > 20,
            f"JPEG decode: shape {dec.shape}, PSNR {psnr:.1f} dB")
    require(np.array_equal(load_indexed_png(png), written[seq0][1][0]),
            "PNG read-back differs from the written label map")
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        read_jpeg(jpg)
    jpeg_ms = (time.perf_counter() - t0) / reps * 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        load_indexed_png(png)
    png_ms = (time.perf_counter() - t0) / reps * 1e3
    log(f"[davis] host decode per {size} frame: JPEG {jpeg_ms:.2f} ms "
        f"(the port's baseline decoder; PSNR {psnr:.1f} dB against "
        f"the encoded frame), PNG {png_ms:.2f} ms (zlib + numpy)")

    base = ["--davis_root", root, "--rounds", str(DAVIS_ROUNDS),
            "--scribble_sets", str(DAVIS_SETS)]
    report1 = os.path.join(tmp, "r1.csv")
    masks1 = os.path.join(tmp, "masks1")
    runs = {}
    runs["default"] = davis_cli(base + ["--report", report1,
                                        "--save_masks", masks1])
    runs["int8"] = davis_cli(base + ["--matching_int8", "--report",
                                     os.path.join(tmp, "r8.csv")])
    report3 = os.path.join(tmp, "r3.csv")
    stopped = davis_cli(base + ["--resume", "--report", report3],
                        stop_after_first_item=True)
    require(stopped["stopped"], "the resume run was not stopped")
    require(len({(r["sequence"], r["scribble_idx"])
                 for r in read_report_csv(report3)}) == 1,
            "the stopped run's checkpoint does not hold one item")
    runs["resumed"] = davis_cli(base + ["--resume", "--report", report3])
    require("resume: 1 completed items found" in runs["resumed"]["stderr"],
            "the resumed run did not report 1 completed item")
    srv, thread = serve(DavisEvalDataset(root, scribble_sets=DAVIS_SETS),
                        host="127.0.0.1", port=0)
    try:
        report4 = os.path.join(tmp, "r4.csv")
        runs["remote"] = davis_cli(base + [
            "--host", f"http://127.0.0.1:{srv.server_address[1]}",
            "--report", report4])
    finally:
        srv.shutdown()
        thread.join(timeout=30)
    require(not thread.is_alive(), "the evaluation server did not stop")

    for name, run in runs.items():
        line = run["line"]
        score = sum(run["score_s"])
        model = sum(run["round_s"]) + sum(run["start_s"])
        log(f"[davis] {name}: wall {run['wall_s']:.2f} s, of it "
            f"{model:.2f} s the model's rounds and start_sequence, "
            f"{score:.2f} s scoring and robot over "
            f"{len(run['score_s'])} submissions (p50 "
            f"{statistics.median(run['score_s']) * 1e3:.1f} ms), "
            f"{run['wall_s'] - model - score:.2f} s the rest (model "
            f"build, frame decode, PNG and CSV writes, HTTP); peak "
            f"device memory {run['peak_gib']:.2f} GiB, start_sequence "
            + ", ".join(f"{s * 1e3:.1f}" for s in run["start_s"])
            + f" ms; {line['rounds_run']} rounds, p50 round latency "
            f"{line['p50_round_latency_s']} s, by frame bucket "
            f"{line['p50_by_frame_bucket']}; AUC {line['auc']}, "
            f"J&F@60s {line['jf_at_60s']} (random weights: parity only)")
        require(line["rounds_run"] == len(run["rounds"]),
                f"{name}: rounds_run {line['rounds_run']}")
        require(set(line["p50_by_frame_bucket"]) == {"16", "32"},
                f"{name}: frame buckets {line['p50_by_frame_bucket']}")
        require(0.0 <= line["auc"] <= 1.0 and np.isfinite(line["auc"]),
                f"{name}: AUC {line['auc']}")
    log(f"[davis] resumed: the stopped run took {stopped['wall_s']:.2f} s "
        f"over {len(stopped['rounds'])} rounds")
    check_davis_launches("default", runs["default"], "global_matching",
                         buckets)
    check_davis_launches("int8", runs["int8"], "global_matching_int8",
                         buckets)
    check_davis_launches("resumed", runs["resumed"], "global_matching",
                         buckets)
    check_davis_launches("remote", runs["remote"], "global_matching",
                         buckets)

    # the default run: final-round PNGs, report rows per item
    run1 = runs["default"]
    per_item = _items(run1["rounds"])
    require(len(run1["last"]) == len(written) * DAVIS_SETS,
            f"{len(run1['last'])} items ran")
    for (seq, k), m in run1["last"].items():
        require(m.shape == written[seq][1].shape and m.dtype == np.int32
                and m.min() >= 0 and m.max() <= n_obj[seq],
                f"{seq} set {k}: masks {m.shape} {m.dtype}")
        saved = np.stack([load_indexed_png(os.path.join(
            masks1, f"scribble{k + 1}", seq, f"{t:05d}.png"))
            for t in range(n_frames[seq])])
        require(np.array_equal(saved, m),
                f"{seq} set {k}: saved PNGs differ from the last round")
    rows = read_report_csv(report1)
    for (seq, k), n in per_item.items():
        got = sum(r["sequence"] == seq and r["scribble_idx"] == k
                  for r in rows)
        require(got == n * n_obj[seq] * n_frames[seq],
                f"{seq} set {k}: {got} report rows for {n} rounds")
    require(all(0.0 <= r["jaccard"] <= 1.0 and 0.0 <= r["contour"] <= 1.0
                for r in rows), "J and F in [0, 1]")
    want = davis_metric_rows(report1)
    for name, report in (("resumed", report3), ("remote", report4)):
        got = davis_metric_rows(report)
        same = sum(a == b for a, b in zip(got, want))
        log(f"[davis] {name} report: {same} of {len(want)} metric rows "
            f"equal the default run's ({len(got)} rows)")
        require(got == want,
                f"{name} report's metric columns differ from run 1's")
    require(len(davis_metric_rows(os.path.join(tmp, "r8.csv")))
            == sum(n * n_obj[s] * n_frames[s] for (s, _), n in
                   _items(runs["int8"]["rounds"]).items()),
            "int8 report rows")
    log(f"[davis] phase took {time.perf_counter() - t_phase:.1f} s")
    return {"root": root, "buckets": buckets, "report": report1,
            "run": runs["default"]}


def _items(rounds):
    count = {}
    for seq, k, *_ in rounds:
        count[(seq, k)] = count.get((seq, k), 0) + 1
    return count


# --------------------------------------------------------------------- #
# The reference phase: the port's reference-style script (the upstream
# davisinteractive loop through the port's shim) on the davis phase's tree,
# held against that phase's default CLI run.
# --------------------------------------------------------------------- #

# Round 1 takes the tree's own scribbles in both loops. The script asks its
# dataset for float frames (`images`, normalized on the host) where the
# CLI's session loop takes uint8 ones (`images_uint8`, normalized on the
# card): they differ at the padding and, the card dividing by a multiply
# with the reciprocal, in the last bit, which moves argmax near-ties of
# the random bf16 model. The uint8 leg hands the script the CLI's frames:
# with identical inputs its round-1 rows must agree to this.
TOL_REFERENCE_ROUND1 = 1e-3
# Later rounds take the robot's scribbles on each loop's own masks, so
# differences may compound: the AUCs must agree to this, in both legs.
TOL_REFERENCE_AUC = 0.02


def reference_leg(davis: dict, frames: str) -> float:
    """`reference_style_eval.main` as a user runs it on the davis phase's
    tree (DAVIS_ROUNDS rounds; the DAVIS_SETS scribble sets the CLI read
    with --scribble_sets), its dataset's `images` giving `frames` ("float":
    as written; "uint8": the CLI's frames), the launch counters reset just
    before: 1 kernel-1 and bucket - 1 kernel-2 launches a round, the same
    row keys as the CLI's default run, the AUC within TOL_REFERENCE_AUC of
    its. Logs the wall split into the model (start_sequence per item, then
    rounds), scoring with the robot and the rest, p50 rounds by frame
    bucket, round 1's largest J / F difference and every round's mean J&F
    gap. -> round 1's largest difference."""
    import contextlib
    import io

    from cvpr2020_manet_tpu_torch import reference_style_eval
    from cvpr2020_manet_tpu_torch.data.davis import DavisEvalDataset
    from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
    from cvpr2020_manet_tpu_torch.interactive.session import (
        REPORT_COLUMNS, InteractiveSession, read_report_csv)
    from cvpr2020_manet_tpu_torch.kernels import build

    name = f"reference ({frames} frames)"
    report = os.path.join(os.path.dirname(davis["report"]),
                          f"reference_{frames}.csv")
    run = {"rounds": [], "round_s": [], "start_s": [], "score_s": []}
    real = (Evaluator.start_sequence, Evaluator.run_round,
            InteractiveSession.submit_masks,
            DavisEvalDataset.num_scribble_sets, DavisEvalDataset.images)

    def start_sequence(ev, *args):
        t = time.perf_counter()
        st = real[0](ev, *args)
        torch.cuda.synchronize()
        run["start_s"].append(time.perf_counter() - t)
        return st

    def run_round(ev, state, scribbles, *args):
        masks = real[1](ev, state, scribbles, *args)
        t_bucket, _, dt = ev.round_records[-1]
        run["rounds"].append((scribbles["sequence"], None,
                              state.round_idx - 1, t_bucket))
        run["round_s"].append(dt)
        return masks

    def submit_masks(session, masks):
        t = time.perf_counter()
        real[2](session, masks)
        run["score_s"].append(time.perf_counter() - t)

    out = io.StringIO()
    Evaluator.start_sequence = start_sequence
    Evaluator.run_round = run_round
    InteractiveSession.submit_masks = submit_masks
    # the script's session reads DAVIS's 3 scribble sets a sequence (it has
    # no --scribble_sets, nor has JAX's); the tree holds DAVIS_SETS
    DavisEvalDataset.num_scribble_sets = lambda self, seq: DAVIS_SETS
    if frames == "uint8":
        DavisEvalDataset.images = DavisEvalDataset.images_uint8
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    try:
        with norm_calls() as norms, contextlib.redirect_stdout(out):
            reference_style_eval.main([
                "--davis_root", davis["root"], "--rounds", str(DAVIS_ROUNDS),
                "--report", report])
    finally:
        (Evaluator.start_sequence, Evaluator.run_round,
         InteractiveSession.submit_masks,
         DavisEvalDataset.num_scribble_sets,
         DavisEvalDataset.images) = real
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run["launches"] = dict(build.LAUNCHES)
    run["norms"] = norms[0]
    peak = torch.cuda.max_memory_allocated() / 2**30
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    cli = davis["run"]

    require(set(line) == {"auc", "jf_at_60s", "rows"},
            f"{name}: JSON keys {sorted(line)}")
    check_davis_launches(name, run, "global_matching", davis["buckets"])
    rows, want = read_report_csv(report), read_report_csv(davis["report"])
    require(line["rows"] == len(rows), f"{name}: {line['rows']} rows in "
            f"the JSON line, {len(rows)} in the report")
    key_cols = REPORT_COLUMNS[:5]
    require([[r[c] for c in key_cols] for r in rows]
            == [[r[c] for c in key_cols] for r in want],
            f"{name}: the report's row keys differ from the CLI's")
    require(all(0.0 <= r["jaccard"] <= 1.0 and 0.0 <= r["contour"] <= 1.0
                for r in rows), f"{name}: J and F in [0, 1]")
    first = [(a, b) for a, b in zip(rows, want) if a["interaction"] == 0]
    err1 = max(max(abs(a["jaccard"] - b["jaccard"]),
                   abs(a["contour"] - b["contour"])) for a, b in first)
    gaps = []
    for i in range(DAVIS_ROUNDS):
        jf = [np.mean([0.5 * (r["jaccard"] + r["contour"]) for r in rs
                       if r["interaction"] == i]) for rs in (rows, want)]
        gaps.append(jf[0] - jf[1])
    auc_gap = line["auc"] - cli["line"]["auc"]
    by_bucket = {}
    for (*_, tb), dt in zip(run["rounds"], run["round_s"]):
        by_bucket.setdefault(str(tb), []).append(dt)
    p50 = {b: round(statistics.median(v), 4) for b, v in by_bucket.items()}
    model = sum(run["start_s"]) + sum(run["round_s"])
    score = sum(run["score_s"])
    log(f"[reference] {name}: wall {wall:.2f} s, of it {model:.2f} s the "
        f"model (start_sequence {sum(run['start_s']):.2f} s over "
        f"{len(run['start_s'])} items: "
        + ", ".join(f"{s * 1e3:.1f}" for s in run["start_s"])
        + f" ms; rounds {sum(run['round_s']):.2f} s), {score:.2f} s scoring "
        f"and robot over {len(run['score_s'])} submissions (p50 "
        f"{statistics.median(run['score_s']) * 1e3:.1f} ms), "
        f"{wall - model - score:.2f} s the rest; peak device memory "
        f"{peak:.2f} GiB; p50 round s by frame bucket {p50} (the CLI's "
        f"{cli['line']['p50_by_frame_bucket']}, start_sequence "
        f"{sum(cli['start_s']):.2f} s over {len(cli['start_s'])} "
        f"sequences)")
    log(f"[reference] {name}: JSON line {json.dumps(line)}; against the "
        f"CLI's default run: round 1 max |dJ|, |dF| over {len(first)} rows "
        f"{err1:.3g}; per-round mean J&F gap "
        + ", ".join(f"{g:+.5f}" for g in gaps)
        + f"; AUC {line['auc']} against {cli['line']['auc']} ({auc_gap:+.4f},"
        f" tol {TOL_REFERENCE_AUC}); {len(rows)} rows, keys equal")
    require(abs(auc_gap) <= TOL_REFERENCE_AUC,
            f"{name}: AUC {line['auc']} against the CLI's "
            f"{cli['line']['auc']}")
    return err1


def reference_phase(davis: dict) -> None:
    """The reference-style script on the davis phase's tree at Config()
    with the CLI's seeded weights, held against the phase's default CLI
    run: as written (float frames), then on the CLI's uint8 frames, where
    round 1's J and F must agree to TOL_REFERENCE_ROUND1 on every row."""
    t_phase = time.perf_counter()
    reference_leg(davis, "float")
    torch.cuda.empty_cache()
    err1 = reference_leg(davis, "uint8")
    require(err1 <= TOL_REFERENCE_ROUND1,
            f"reference on the CLI's frames: round 1 J/F differ from the "
            f"CLI's by {err1} (tol {TOL_REFERENCE_ROUND1})")
    log(f"[reference] on the CLI's frames round 1 agrees to {err1:.3g} "
        f"(tol {TOL_REFERENCE_ROUND1}); phase took "
        f"{time.perf_counter() - t_phase:.1f} s")


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
    norms_in_all = [0]

    def observe(frame, pipelined=False):
        out, n, norms = launches_delta(
            lambda: s.observe_async(frame) if pipelined else s.observe(frame))
        # observe_async enqueues the whole frame before it returns
        require(norms > 0 and n == with_norms(per_observe, norms),
                f"stream observe launched {n}, {norms} GroupNorm calls")
        norms_in_all[0] += norms
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    pages = []
    for f in range(corrections):
        pred = observe(u8[f])
        scr = robot.scribble_frame(pred, gt[f], 2, f, n_frames, seq)
        mask, n, norms = launches_delta(lambda: s.correct(scr.to_json()))
        require(n == with_norms({}, norms),
                f"stream correct launched {n}, {norms} GroupNorm calls")
        norms_in_all[0] += norms
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
    want = with_norms({k: v * n_obs for k, v in per_observe.items()},
                      norms_in_all[0])
    require(launches == {k: want.get(k, 0) for k in launches},
            f"stream launches {launches}, expected {want}")
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
        m, n, norms = launches_delta(lambda: s32.observe(f))
        f32_ms.append((time.perf_counter() - t0) * 1e3)
        require(n == with_norms({"global_matching": 1, "local_matching": 1},
                                norms),
                f"f32 stream observe launched {n}, {norms} GroupNorm calls")
        require(m.shape == gt.shape[1:], "f32 stream mask")
    log(f"[stream] f32 memory (bf16 queries matched in f32: kernel 1's f32 "
        f"variant), 1 live page: observe {', '.join(f'{t:.1f}' for t in f32_ms)}"
        f" ms per frame")


def ring_call(q, k, onehot, valid, devices):
    """Kernel 6's ring (`context_parallel_matching`, schedule
    "ring_kernel") over `devices`, timed over CUDA events on the caller's
    stream, which the ring orders before its first step and after its
    last. -> (result, ms)."""
    from cvpr2020_manet_tpu_torch.parallel.cp_matching import (
        context_parallel_matching)
    from cvpr2020_manet_tpu_torch.parallel.mesh import create_mesh
    mesh = create_mesh(data=1, context=len(devices), devices=devices)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = context_parallel_matching(q, k, onehot, valid, mesh,
                                    schedule="ring_kernel")
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def kernel_ring(dev, nq: int, page_rows: int, pages: int, c_real: int,
                c: int, o: int):
    """Kernel 6 at the cp stream's shape: a 1080p frame's f32 queries
    against `pages` memory pages on a ring of `pages` members on one card,
    2 live objects + background in an O=4 bucket (the last object has no
    pixels). The 4-ring against the plain ring (tol) and bit-identical to
    kernel 1's f32 variant over all rows; rings of 1 and 2 members and 3
    repeated 4-rings bit-identical to it (the repeats are the timed runs);
    a 3-ring over 3 pages bit-identical to kernel 1 and a 1-ring over them;
    distinct cards when there are two."""
    from cvpr2020_manet_tpu_torch.kernels import build
    from cvpr2020_manet_tpu_torch.ops.global_matching_cuda import (
        global_matching_prepared, prepare_ref)
    from cvpr2020_manet_tpu_torch.ops.ring_matching_cuda import (
        ring_matching_step_plain)
    from cvpr2020_manet_tpu_torch.parallel.cp_matching import ring_kernel
    from cvpr2020_manet_tpu_torch.parallel.mesh import (
        create_mesh, shard_context)
    g = torch.Generator().manual_seed(6)
    live = o - 1
    nk = pages * page_rows
    q, k, labels = global_inputs(g, nq, nk, c_real, c, live)
    q, k = q.to(dev), k.to(dev)
    onehot = torch.nn.functional.one_hot(labels, o).float().to(dev)
    valid = torch.ones(nk, device=dev)
    ring = [dev] * pages

    torch.cuda.synchronize()
    build.reset_launches()
    got, first_ms = ring_call(q, k, onehot, valid, ring)
    launches = dict(build.LAUNCHES)
    want_launches = {n: pages * pages if n == "ring_matching" else 0
                     for n in launches}
    require(launches == want_launches,
            f"ring launched {launches}, expected {want_launches}")

    mesh = create_mesh(data=1, context=pages, devices=ring)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = ring_kernel(q, *(shard_context(x, mesh) for x in (k, onehot, valid)),
                       ring, step_fn=ring_matching_step_plain)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err, share = check_outputs("ring matching", got, want, live,
                               TOL_GLOBAL_F32)
    del want
    b = prepare_ref(k, onehot)
    require(torch.equal(got, global_matching_prepared(q, b)),
            "the ring is not bit-identical to kernel 1 over all rows")
    n_rows = int((b.src_idx >= 0).sum())           # labelled reference pixels
    bytes_in = nbytes(q, b.neg2pixels, b.sqnorm, b.block_obj, got)
    del b
    for n in range(1, pages):
        if pages % n == 0:
            out, _ = ring_call(q, k, onehot, valid, [dev] * n)
            require(torch.equal(out, got),
                    f"a {n}-member ring differs from the {pages}-ring")
    reps = []
    for _ in range(3):
        out, t = ring_call(q, k, onehot, valid, ring)
        require(torch.equal(out, got), "a repeated ring run differs")
        reps.append(t)
    ms = statistics.median(reps)
    # the odd ring: 3 members over the first 3 pages
    n3 = 3 * page_rows
    sub = (k[:n3], onehot[:n3], valid[:n3])
    out3, _ = ring_call(q, *sub, [dev] * 3)
    require(torch.equal(out3, global_matching_prepared(
        q, prepare_ref(k[:n3], onehot[:n3]))),
        "the 3-ring is not bit-identical to kernel 1 over its rows")
    require(torch.equal(ring_call(q, *sub, [dev])[0], out3),
            "the 3-ring differs from a 1-ring over the same rows")
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        cards = [torch.device("cuda", i)
                 for i in range(pages if n_cards >= pages else 2)]
        card_ms = []
        for _ in range(4):                 # the first run pays each card's
            out, t = ring_call(q, k, onehot, valid, cards)   # first use
            require(torch.equal(out, got), "the ring over distinct cards "
                    "differs from the one-card ring")
            card_ms.append(t)
        log(f"[cp] ring over {len(cards)} distinct cards (peer copies): "
            f"bit-identical to the one-card ring; "
            f"{', '.join(f'{t:.1f}' for t in card_ms)} ms")
    else:
        log(f"[cp] ring over distinct cards: not run, {n_cards} card "
            "visible (the one-card rings share cuda:0)")
    # the library's cross terms: each of the ring's members computes the
    # whole Nq x Nk product on this card
    one_ms, chunks = cross_term_ms(torch.matmul, q, k.T.contiguous(), 4,
                                   reps=1)
    library_ms = pages * one_ms
    b_ms, b_by = bound(pages * 3 * 2.0 * nq * n_rows * c, H100_TF32_FLOPS,
                       bytes_in)
    fma_ms = bound(pages * 2.0 * nq * n_rows * c, H100_F32_FLOPS, bytes_in)[0]
    log(f"[cp] ring_matching (kernel 6) Nq={nq} Nk={nk} ({pages} pages, "
        f"labelled {n_rows}) C={c} O={o} f32 on a {pages}-member ring on "
        f"one card: {share:.3f} of live-object outputs below 0.99, "
        f"max|err| vs the plain ring {err:.3g} (tol {TOL_GLOBAL_F32}); "
        f"bit-identical to kernel 1 over all rows, to rings of 1 and 2 "
        f"members and over 3 repeats (a 3-ring over 3 pages to kernel 1 "
        f"and a 1-ring there); launches {launches}; "
        f"ring {ms:.1f} ms (runs {', '.join(f'{t:.1f}' for t in reps)}; "
        f"first {first_ms:.1f}), plain ring {plain_ms:.1f} ms, torch.matmul "
        f"of the members' cross terms {library_ms:.1f} ms ({pages} x "
        f"{one_ms:.1f} over {chunks} query chunks), bound {b_ms:.1f} ms by "
        f"{b_by} (3 TF32 products per pair; f32 FMA bound {fma_ms:.1f} ms)")
    return dict(name="ring_matching", route="cuda",
                source="cvpr2020_manet_tpu_torch/csrc/ring_matching.cu",
                replaces="cvpr2020_manet_tpu/ops/ring_matching_pallas.py:55",
                launches=launches["ring_matching"], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


def cp_stream(dev, model, mesh, image_size=(1080, 1920), corrections=3,
              observes=2) -> None:
    """The 1080p f32 stream (default backend) single-device and with
    `cp_mesh`, driven in lockstep: the same frames and corrections, equal
    masks at every call; per observe 1 kernel-1 launch single-device and
    one per member with the mesh, kernel 6 none (the allgather
    schedule, as in JAX)."""
    from cvpr2020_manet_tpu_torch.config import Config, EvalConfig
    from cvpr2020_manet_tpu_torch.data import SyntheticDataset
    from cvpr2020_manet_tpu_torch.engine.streaming import StreamingIVOS
    from cvpr2020_manet_tpu_torch.interactive.robot import (
        InteractiveScribblesRobot)
    from cvpr2020_manet_tpu_torch.kernels import build

    cfg = Config(model=model.cfg, eval=EvalConfig(image_size=image_size))
    n_frames = corrections + observes
    ds = SyntheticDataset(image_size=image_size, num_frames=n_frames,
                          num_objects=2, num_sequences=1, scribble_sets=1)
    seq = ds.sequences()[0]
    gt = ds.gt_masks(seq)
    u8 = (np.clip(ds.images(seq), 0, 1) * 255).astype(np.uint8)
    robot = InteractiveScribblesRobot()
    members = len(mesh.context_devices)
    streams = {"single": StreamingIVOS(cfg, model, device=dev),
               "cp": StreamingIVOS(cfg, model, device=dev, cp_mesh=mesh)}
    per_observe = {"single": {"global_matching": 1, "local_matching": 1},
                   "cp": {"global_matching": members, "local_matching": 1}}
    for s in streams.values():
        s.reset(2)

    def both(call, arg):
        out, ms = {}, {}
        for name, s in streams.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[name], n, norms = launches_delta(
                lambda: getattr(s, call)(arg))
            ms[name] = (time.perf_counter() - t0) * 1e3
            want = with_norms(per_observe[name] if call == "observe" else {},
                              norms)
            require(n == want, f"{name} stream {call} launched {n}, "
                    f"{norms} GroupNorm calls")
        require(np.array_equal(out["single"], out["cp"]),
                f"cp stream {call}: masks differ from the single-device "
                "stream's")
        return out["cp"], ms

    torch.cuda.synchronize()
    build.reset_launches()
    for f in range(corrections):
        pred, _ = both("observe", u8[f])
        both("correct", robot.scribble_frame(pred, gt[f], 2, f, n_frames,
                                             seq).to_json())
    require(streams["cp"].live_pages() == 4,
            f"{streams['cp'].live_pages()} live pages")
    timed = [both("observe", f) for f in u8[corrections:]]
    launches = dict(build.LAUNCHES)
    require(launches["ring_matching"] == 0, "the cp stream launched kernel 6")
    labelled = float(np.mean([(m > 0).mean() for m, _ in timed]))
    ms = {name: ", ".join(f"{t[name]:.1f}" for _, t in timed)
          for name in streams}
    log(f"[cp] stream {image_size[0]}x{image_size[1]}, f32 memory, 4 live "
        f"pages over {members} members on one card: observe {ms['cp']} ms "
        f"(single-device {ms['single']} ms); masks equal to the "
        f"single-device stream at all {2 * corrections + observes} calls; "
        f"non-background share {labelled:.3f}; launches {launches} over "
        f"{n_frames} observes and {corrections} corrections of each stream")


def cp_eval(dev, model, mesh, image_size=(480, 854), n_frames=16,
            rounds=3) -> None:
    """The flagship at 480p with stacked memory (3 slots), single-device
    and with `cp_mesh`, on the same scribbles (the robot's on the first
    run's masks): equal masks every round; per round one matching call,
    so 1 kernel-1 launch single-device and one per member with the mesh,
    and n_frames - 1 local ones."""
    from cvpr2020_manet_tpu_torch.config import Config, EvalConfig
    from cvpr2020_manet_tpu_torch.data import SyntheticDataset
    from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
    from cvpr2020_manet_tpu_torch.interactive.robot import (
        InteractiveScribblesRobot)
    from cvpr2020_manet_tpu_torch.kernels import build

    cfg = Config(model=model.cfg, eval=EvalConfig(
        image_size=image_size, max_interactions=rounds,
        matching_memory="stacked"))
    ds = SyntheticDataset(image_size=image_size, num_frames=n_frames,
                          num_objects=2, num_sequences=1, scribble_sets=1)
    seq = ds.sequences()[0]
    gt = ds.gt_masks(seq)
    n_obj = ds.num_objects(seq)
    members = len(mesh.context_devices)
    robot = InteractiveScribblesRobot()
    scribbles, results = [], {}
    for name, cp_mesh in (("single", None), ("cp", mesh)):
        ev = Evaluator(cfg, model, device=dev, cp_mesh=cp_mesh)
        st = ev.start_sequence(ds.images(seq), n_obj)
        masks, per_round, walls = np.zeros_like(gt), [], []
        want = {"global_matching": members if cp_mesh is not None else 1,
                "local_matching": n_frames - 1}
        for r in range(rounds):
            if len(scribbles) == r:
                scribbles.append(
                    robot.interact(seq, masks, gt, n_obj).to_json())
            torch.cuda.synchronize()
            build.reset_launches()
            t0 = time.perf_counter()
            with norm_calls() as norms:
                masks = ev.run_round(st, scribbles[r], gt.shape[1:], n_obj)
            walls.append((time.perf_counter() - t0) * 1e3)
            launches = dict(build.LAUNCHES)
            want_r = with_norms(want, norms[0])
            require(norms[0] > 0 and launches == {
                k: want_r.get(k, 0) for k in launches},
                    f"cp eval ({name}) round {r} launched {launches}, "
                    f"expected {want_r}")
            per_round.append(masks)
        results[name] = per_round
        log(f"[cp] eval {image_size[0]}x{image_size[1]}, {n_frames} "
            f"frames, stacked memory, {name}"
            f"{f' ({members} members)' if cp_mesh is not None else ''}: "
            f"rounds {', '.join(f'{t:.1f}' for t in walls)} ms; launches "
            f"per round {want}")
    ref = results["single"]
    for r, (a, b) in enumerate(zip(ref, results["cp"])):
        require(np.array_equal(a, b),
                f"cp eval round {r}: masks differ from the single-device "
                "round's")
    labelled = ", ".join(f"{(m > 0).mean():.3f}" for m in ref)
    log(f"[cp] eval: masks with and without the mesh equal in all "
        f"{rounds} rounds (non-background shares {labelled})")


CP_ARTIFACT_MEMBERS = 4


def cp_artifact_inputs(dev):
    """The cp stream observe's matching at 1080p, made from a seed: 130,560
    f32 queries against 4 filled memory pages (522,240 rows), 100 real
    channels of 128, 3 live objects in an O=4 bucket. -> (q, k, onehot)
    on `dev`."""
    g = torch.Generator().manual_seed(7)
    nq = 272 * 480
    q, k, labels = global_inputs(g, nq, 4 * nq, 100, 128, 3)
    onehot = torch.nn.functional.one_hot(labels, 4).float()
    return q.to(dev), k.to(dev), onehot.to(dev)


def cp_artifact_child(path: str, out_path: str, device: str) -> None:
    """Run in a fresh process (`python -c`): load the cp artifact at `path`
    onto CP_ARTIFACT_MEMBERS members of `device` with only `utils.export`
    and the mesh of the port imported, call it once to warm up, once with
    the launch counters reset, then time it; save the output to
    `out_path` and print one JSON line."""
    from cvpr2020_manet_tpu_torch.kernels import build
    from cvpr2020_manet_tpu_torch.parallel.mesh import create_mesh
    from cvpr2020_manet_tpu_torch.utils import export
    dev = torch.device(device)
    t = time.perf_counter()
    art = export.load_artifact(path, mesh=create_mesh(
        1, CP_ARTIFACT_MEMBERS, [dev] * CP_ARTIFACT_MEMBERS))
    load_s = time.perf_counter() - t
    args = cp_artifact_inputs(dev)
    art(*args)
    torch.cuda.synchronize()
    build.reset_launches()
    out = art(*args)
    torch.cuda.synchronize()
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    ms = time_ms(lambda: art(*args), reps=5, warmup=0)
    torch.save(out.cpu(), out_path)
    print(json.dumps({
        "load_s": load_s, "launches": launches, "p50_ms": ms,
        "port_modules": sorted(m for m in sys.modules
                               if m.startswith("cvpr2020_manet_tpu_torch"))}))


def cp_artifact(dev) -> None:
    """The context-parallel matching artifact (`utils/export.py`) at the
    cp stream observe's shape over CP_ARTIFACT_MEMBERS members of the card:
    exported, saved with its mesh and loaded in a fresh process
    (`cp_artifact_child`); its output bit-equal to the live `cp_match_flat`
    on the same inputs and within TOL_EXPORT of single-device kernel 1, one
    kernel-1 launch a member a call, a mesh of another size refused."""
    from cvpr2020_manet_tpu_torch.ops.global_matching_cuda import (
        global_matching_prepared, prepare_ref)
    from cvpr2020_manet_tpu_torch.parallel.cp_matching import cp_match_flat
    from cvpr2020_manet_tpu_torch.parallel.mesh import create_mesh
    from cvpr2020_manet_tpu_torch.utils import export as ex
    n = CP_ARTIFACT_MEMBERS
    members = [dev] * n
    mesh = create_mesh(1, n, members)
    args = cp_artifact_inputs(dev)
    t = time.perf_counter()
    ep = ex.export_cp_matching(mesh, *args)
    export_s = time.perf_counter() - t
    targets = [str(node.target) for node in ep.graph.nodes
               if node.op == "call_function"]
    require(targets.count("manet.global_matching.default") == n,
            f"the cp graph holds {targets.count('manet.global_matching.default')}"
            f" kernel-1 nodes, expected {n}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cp.ivosx")
        t = time.perf_counter()
        manifest = ex.save_artifact(ep, path, mesh=mesh)
        save_s = time.perf_counter() - t
        require(manifest["mesh"] == {"data": 1, "context": n},
                f"manifest mesh {manifest['mesh']}")
        mb = os.path.getsize(path) / 2**20
        out_path = os.path.join(tmp, "cp_out.pt")
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", "import sys; from chip_smoke import "
             "cp_artifact_child; cp_artifact_child(*sys.argv[1:])", path,
             out_path, str(dev)], cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=600)
        require(proc.returncode == 0,
                f"cp artifact process: {proc.stderr[-3000:]}")
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        child_s = time.perf_counter() - t
        got = torch.load(out_path)
        try:
            ex.load_artifact(path, mesh=create_mesh(1, n // 2,
                                                    members[:n // 2]))
            refused = None
        except ValueError as e:
            refused = str(e)
        require(refused is not None and "exported for a 1 x 4" in refused,
                f"a {n // 2}-member mesh was not refused: {refused}")
    live, launches, _ = launches_delta(lambda: cp_match_flat(*args, mesh))
    torch.cuda.synchronize()
    require(launches == {"global_matching": n},
            f"the live cp call launched {launches}")
    require(child["launches"] == {"global_matching": n},
            f"the cp artifact launched {child['launches']}, expected "
            f"{n} kernel-1 launches")
    require(torch.equal(got, live.cpu()),
            "the cp artifact's output differs from the live cp_match_flat")
    single = global_matching_prepared(args[0], prepare_ref(args[1], args[2]))
    err = (live - single).abs().max().item()
    require(err <= TOL_EXPORT, f"cp artifact vs single-device kernel 1: {err}")
    live_ms = time_ms(lambda: cp_match_flat(*args, mesh), reps=5, warmup=1)
    log(f"[cp] artifact: cp_match_flat over {n} members of the card, "
        f"{args[0].shape[0]} f32 queries against {args[1].shape[0]} rows: "
        f"exported in {export_s:.2f} s ({len(targets)} graph operations, "
        f"{n} kernel-1 nodes), saved in {save_s:.2f} s, {mb:.2f} MB; a "
        f"fresh process ({child_s:.1f} s, of it load {child['load_s']:.2f} "
        f"s) launched {child['launches']} a call; p50 {child['p50_ms']:.2f}"
        f" ms a call against the live call's {live_ms:.2f} ms; output "
        f"bit-equal to the live call, max|d| against single-device kernel 1 "
        f"{err:.3g} (tol {TOL_EXPORT}); a {n // 2}-member mesh refused "
        f"('{refused}'); port modules in the process: "
        f"{', '.join(child['port_modules'])}")
    if torch.cuda.device_count() < 2:
        log("[cp] artifact over distinct cards: not verified, this machine "
            "has one card (tests/test_torch_export_cuda.py::"
            "test_cp_artifact_on_distinct_cards runs it on two)")


def cp_phase(dev, model) -> dict:
    """Context-parallel serving on a ring of 4 members on the card, each
    part with the launch counters reset just before it. -> kernel 6's
    entry of the kernels line."""
    from cvpr2020_manet_tpu_torch.parallel.mesh import create_mesh
    t0 = time.perf_counter()
    entry = kernel_ring(dev, 272 * 480, 272 * 480, 4, 100, 128, 4)
    torch.cuda.empty_cache()
    mesh = create_mesh(data=1, context=4, devices=[dev] * 4)
    cp_stream(dev, model, mesh)
    torch.cuda.empty_cache()
    cp_eval(dev, model, mesh)
    torch.cuda.empty_cache()
    cp_artifact(dev)
    log(f"[cp] phase took {time.perf_counter() - t0:.1f} s")
    return entry


def batch_phase(dev, model, ingest: str, batch=4, n_frames=16,
                image_size=(480, 864), batches=3, objects=2,
                group_norms=True) -> None:
    """BatchPropagator on `batches` synthetic batches of `batch` clips of
    `objects` objects: one warm-up batch, then the CLI's timing loops
    (`timed_batches`: serial and pipelined frames/s, planar YUV made
    before the clock) over the others; the launch counters must show B
    (T - 1) launches of the global and of the local kernel per batch, and
    one of kernel 7 a GroupNorm call where the model has GroupNorms
    (`group_norms`), else none."""
    from cvpr2020_manet_tpu_torch.data import SyntheticDataset
    from cvpr2020_manet_tpu_torch.engine.propagate_batch import (
        BatchPropagator, timed_batches)
    from cvpr2020_manet_tpu_torch.config import Config, EvalConfig

    cfg = Config(model=model.cfg, eval=EvalConfig(image_size=image_size))
    prop = BatchPropagator(cfg, model, ingest=ingest, device=dev)
    ds = SyntheticDataset(image_size=image_size, num_frames=n_frames,
                          num_objects=objects, num_sequences=batch * batches,
                          scribble_sets=1)
    names = ds.sequences()
    data = []
    for i in range(0, len(names), batch):
        seqs = names[i:i + batch]
        frames = np.stack([(np.clip(ds.images(q), 0, 1) * 255).astype(np.uint8)
                           for q in seqs])
        first = np.stack([ds.gt_masks(q)[0, ::4, ::4] for q in seqs])
        data.append((frames, first.astype(np.int32),
                     np.full(batch, objects)))
    backend = getattr(model, "matching_backend", "auto")
    arch = model.cfg.arch
    gkernel = ("global_matching_int8" if backend == "int8"
               else "global_matching")
    per_batch = {gkernel: batch * (n_frames - 1),
                 "local_matching": batch * (n_frames - 1)}
    prop.propagate(*data[0])                       # warm-up
    timed = data[1:]
    (serial_s, pipe_s, labels), n, norms = launches_delta(
        lambda: timed_batches(prop, timed))
    runs = 2 * len(timed)                          # serial and pipelined
    require((norms > 0) == group_norms and n == with_norms(
        {k: v * runs for k, v in per_batch.items()}, norms),
            f"{arch}: {runs} batches launched {n}, expected {per_batch} each "
            f"and {norms} of kernel 7")
    for (frames, first, _), lab in zip(timed, labels):
        require(lab.shape == frames.shape[:4] and lab.max() <= objects,
                "batch labels")
        seed_up = np.repeat(np.repeat(first, 4, axis=1), 4, axis=2)
        require(float((lab[:, 0] == seed_up).mean()) > 0.95,
                "frame 0 reproduces the first mask")
    fps = batch * n_frames / statistics.median(serial_s)
    log(f"[batch] {arch}, {backend!r} matching, {ingest} ingest, {batch} x "
        f"{n_frames} frames of {objects} objects at "
        f"{image_size[0]}x{image_size[1]}: serial {fps:.1f} frames/s "
        f"(batches {', '.join(f'{t * 1e3:.0f}' for t in serial_s)} ms), "
        f"pipelined {batch * n_frames / pipe_s:.1f} frames/s; launches {n} "
        f"over {len(timed)} serial and {len(timed)} pipelined batches")


def feelvos_phase(dev) -> None:
    """FEELVOS at its published widths (`feelvos_config()`: Xception-65,
    the separable 7x7 head, frozen BatchNorm; random weights from a seed,
    the norms at the identity) through `batch_phase`: 4 clips x 16 frames
    of 5 objects (object bucket 9) at 480p from YUV 4:2:0, B (T - 1)
    launches of kernel 1 and of kernel 2 (the full stride-4 grid) a batch
    and no GroupNorm call."""
    from cvpr2020_manet_tpu_torch.config import feelvos_config
    from cvpr2020_manet_tpu_torch.models.feelvos import FEELVOS
    t0 = time.perf_counter()
    model = FEELVOS(feelvos_config().model, device=dev, seed=0)
    log(f"[batch] FEELVOS on {dev} in {time.perf_counter() - t0:.2f} s "
        f"({sum(p.numel() for p in model.parameters())} params)")
    batch_phase(dev, model, "yuv420", objects=5, group_norms=False)
    del model
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# The export phase: serving artifacts on torch.export (utils/export.py),
# written by the export CLI on the card and served from a fresh process
# that loads no model code.
# --------------------------------------------------------------------- #

EXPORT_FRAMES = 16
EXPORT_SIZE = (480, 854)        # the CLI's defaults; padded to 480 x 864
# A loaded bundle runs the graph traced from the live functions: the same
# ATen operations and the same kernels on the same inputs, so its outputs
# are held to the export CLI's --check tolerance.
TOL_EXPORT = 1e-5


def export_loop_inputs(o: int, image_size, seed: int = 0):
    """The serving loop's inputs, made from a seed: EXPORT_FRAMES uint8
    frames of `image_size` (noise with two squares that move a pixel or
    two a frame) and positive scribbles for 2 objects on frame 0 at the
    padded feature grid. -> (frames (T, H, W, 3) uint8, pos (h, w, O)
    f32)."""
    rng = np.random.default_rng(seed)
    h, w = image_size
    frames = rng.integers(0, 256, (EXPORT_FRAMES, h, w, 3), dtype=np.uint8)
    for t in range(EXPORT_FRAMES):
        frames[t, 100 + t:220 + t, 200 + 2 * t:360 + 2 * t] = (230, 40, 40)
        frames[t, 260:380, 500 - t:640 - t] = (40, 40, 230)
    hh, ww = (h + (-h) % 16) // 4, (w + (-w) % 16) // 4
    pos = np.zeros((hh, ww, o), np.float32)
    pos[35:45, 60:80, 1] = 1.0
    pos[75:85, 130:150, 2] = 1.0
    return frames, pos


def bundle_loop(call, frames, pos, device):
    """The serving loop a host drives from a bundle: `extract` on every
    frame, `interact` and `aggregate_first` on frame 0, `propagate` on
    frames 1..T-1 against frame 0's pixels labelled by its interaction
    probabilities (one round: gmap_prev ones; the previous frame's
    embedding and probabilities for local matching), `aggregate_update`
    once. `call`: entry name -> callable. -> (probabilities (T, h, w, O),
    the updated memory, {entry: [host ms of each call, synchronized]})."""
    import torch.nn.functional as F
    times: dict[str, list[float]] = {}

    def timed(name, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = call[name](*args)
        torch.cuda.synchronize()
        times.setdefault(name, []).append((time.perf_counter() - t) * 1e3)
        return out

    frames = torch.from_numpy(frames).to(device)
    pos = torch.from_numpy(pos).to(device)
    hh, ww, o = pos.shape
    obj_valid = (torch.arange(o, device=device) <= 2).float()
    feats = [timed("extract", f) for f in frames]
    feat0, emb0 = feats[0]
    bg = F.one_hot(torch.zeros(hh, ww, dtype=torch.long, device=device),
                   o).float()
    int_feats, probs = timed("interact", feat0, pos, torch.zeros_like(pos),
                             bg)
    mem = timed("aggregate_first", int_feats)
    ref_emb = emb0.reshape(-1, emb0.shape[-1])
    onehot = F.one_hot(probs.argmax(-1).reshape(-1), o).float()
    ones = torch.ones(hh, ww, o, device=device)
    out = [probs]
    for t in range(1, len(feats)):
        feat, emb = feats[t]
        probs_t, _ = timed("propagate", feat, emb, ref_emb, onehot, ones,
                           feats[t - 1][1], out[-1], mem, obj_valid)
        out.append(probs_t)
    mem = timed("aggregate_update", int_feats, mem)
    return torch.stack(out), mem, times


def export_child(path: str, out_path: str) -> None:
    """Run in a fresh process (`python -c`): load the bundle at `path`
    with only `utils.export` of the port imported, drive `bundle_loop`
    twice (the first warms up), the launch counters reset before the
    second, save its outputs to `out_path` and print one JSON line: the
    load seconds, per-entry p50 ms, the launches, the outputs' checksums
    and whether the model code was loaded."""
    from cvpr2020_manet_tpu_torch.kernels import build
    from cvpr2020_manet_tpu_torch.utils import export
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    bundle = export.load_bundle(path)
    load_s = time.perf_counter() - t
    frames, pos = export_loop_inputs(bundle.manifest["num_objects"] + 1,
                                     bundle.manifest["image_size"])
    dev = bundle["extract"].device
    bundle_loop(bundle, frames, pos, dev)
    build.reset_launches()
    probs, mem, times = bundle_loop(bundle, frames, pos, dev)
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    torch.save({"probs": probs.cpu(), "mem": mem.cpu()}, out_path)
    # each graph's operations, of them the metadata asserts that
    # torch.export puts beside every dtype cast (the host runs each one),
    # and its GroupNorm ops (kernel 7)
    nodes = {}
    for name in bundle.names:
        ops = [str(n.target) for n in bundle[name].exported.graph.nodes
               if n.op == "call_function"]
        nodes[name] = [len(ops),
                       ops.count("aten._assert_tensor_metadata.default"),
                       norm_nodes(bundle[name].exported)]
    print(json.dumps({
        "load_s": load_s, "launches": launches, "nodes": nodes,
        "p50_ms": {k: statistics.median(v) for k, v in times.items()},
        "calls": {k: len(v) for k, v in times.items()},
        "checksums": {"probs_sq": float(probs.double().square().sum()),
                      "labels": int(probs.argmax(-1).sum()),
                      "mem": float(mem.double().sum())},
        "models_loaded": sorted(m for m in sys.modules if m.startswith(
            "cvpr2020_manet_tpu_torch.models")),
        "port_modules": sorted(m for m in sys.modules
                               if m.startswith("cvpr2020_manet_tpu_torch"))}))


def export_cli_timed(argv) -> dict:
    """`export_cli.main(argv)` with its export and save timed (the card
    synchronized after each) and its stdout captured: -> the manifest, the
    check's line, the export and save seconds and the CLI's wall."""
    import contextlib
    import io
    from cvpr2020_manet_tpu_torch.utils import export as ex
    from cvpr2020_manet_tpu_torch.utils import export_cli
    spans: dict[str, float] = {}

    def timed(kind, fn):
        def run(*args, **kw):
            t = time.perf_counter()
            result = fn(*args, **kw)
            torch.cuda.synchronize()
            spans[kind] = time.perf_counter() - t
            return result
        return run

    names = {"export_serving_bundle": "export_s", "export_forward": "export_s",
             "save_bundle": "save_s", "save_artifact": "save_s"}
    originals = {n: getattr(ex, n) for n in names}
    out = io.StringIO()
    t = time.perf_counter()
    try:
        for n, kind in names.items():
            setattr(ex, n, timed(kind, originals[n]))
        with contextlib.redirect_stdout(out):
            export_cli.main(argv)
    finally:
        for n, fn in originals.items():
            setattr(ex, n, fn)
    lines = out.getvalue().strip().splitlines()
    return dict(manifest=json.loads(lines[0]), check=lines[-1],
                wall_s=time.perf_counter() - t, **spans)


def dispatch_cost(dev) -> None:
    """The host time a call through each `manet::*` custom op adds to a
    direct call of its launcher (the wrappers' path before the ops): both
    on one tiny input whose kernel takes a few microseconds, so that
    back-to-back calls run at the host's pace; the mean over 500 calls,
    in turns (launcher, op, op, launcher)."""
    import torch.nn.functional as F
    from cvpr2020_manet_tpu_torch.ops.global_matching_cuda import (
        _launch, _launch_int8, prepare_ref, prepare_ref_int8)
    from cvpr2020_manet_tpu_torch.ops.local_matching_cuda import (
        _launch as local_launch, prepare_local)
    g = torch.Generator().manual_seed(5)
    k = torch.randn(512, 100, generator=g).to(dev, torch.bfloat16)
    q = torch.randn(256, 100, generator=g).to(dev, torch.bfloat16)
    onehot = F.one_hot(torch.arange(512) % 3, 4).float().to(dev)
    b, b8 = prepare_ref(k, onehot), prepare_ref_int8(k, onehot)
    local = prepare_local(*(torch.randn(8, 8, 100, generator=g).to(dev)
                            for _ in range(2)),
                          F.one_hot(torch.arange(64) % 4, 4).float()
                          .reshape(8, 8, 4).to(dev))
    pairs = {
        "global_matching": (lambda: _launch(q, b, False),
                            lambda: torch.ops.manet.global_matching(q, *b)),
        "global_matching_int8": (
            lambda: _launch_int8(q, b8),
            lambda: torch.ops.manet.global_matching_int8(q, *b8)),
        "local_matching": (
            lambda: local_launch(*local, 2, False),
            lambda: torch.ops.manet.local_matching(*local, 2))}

    def host_us(fn, calls=500):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / calls * 1e6

    for name, (launch, op) in pairs.items():
        l1, o1, o2, l2 = (host_us(f) for f in (launch, op, op, launch))
        log(f"[export] {name} custom op: {o1:.1f}, {o2:.1f} us a call, its "
            f"launcher {l1:.1f}, {l2:.1f} us (tiny input, back-to-back "
            f"calls at the host's pace): the op adds "
            f"{(o1 + o2 - l1 - l2) / 2:.1f} us a call (16 matching calls a "
            f"round, 120 a batch of 4 x 16 frames)")


def export_phase(dev, model, model_i8) -> None:
    """Serving artifacts at the flagship ModelConfig() (seed 0, the
    weights of `model` and `model_i8`), 480x854, uint8 frames, an
    8-object bucket: the default and the int8 bundle and the fused round,
    each written by the export CLI on the card with --check; each bundle
    served from a fresh process over EXPORT_FRAMES frames (15 propagates:
    15 launches of the global kernel and 15 of kernel 2, one of kernel 7
    per GroupNorm node run, no model code loaded) and held against the
    same loop on the live module; then tiny bundles exported on the CPU
    (f32 through the CLI, and bf16, whose norms the graph holds as
    `manet::group_norm`), moved to the card."""
    import dataclasses
    import tempfile
    from cvpr2020_manet_tpu_torch.config import tiny_test_config
    from cvpr2020_manet_tpu_torch.models import MANet
    from cvpr2020_manet_tpu_torch.utils import export as ex
    t_phase = time.perf_counter()
    dispatch_cost(dev)
    o = model.cfg.max_objects + 1
    frames, pos = export_loop_inputs(o, EXPORT_SIZE)
    with tempfile.TemporaryDirectory() as tmp:
        for backend, live in (("auto", model), ("int8", model_i8)):
            kernel = ("global_matching_int8" if backend == "int8"
                      else "global_matching")
            path = os.path.join(tmp, f"bundle_{backend}.ivosx")
            run = export_cli_timed(["--out", path, "--bundle", "--check",
                                    "--device", "cuda",
                                    "--matching_backend", backend])
            require(run["check"].endswith("direct apply"), run["check"])
            mb = os.path.getsize(path) / 2**20
            log(f"[export] bundle ({backend}): exported in "
                f"{run['export_s']:.2f} s, saved in {run['save_s']:.2f} s, "
                f"{mb:.1f} MB; CLI with --check {run['wall_s']:.2f} s "
                f"('{run['check']}'); entries "
                + json.dumps({n: [e["length"], e["in_avals"][0][0]]
                              for n, e in run["manifest"]["entries"].items()}))
            out_path = os.path.join(tmp, f"loop_{backend}.pt")
            t = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c", "import sys; from chip_smoke import "
                 "export_child; export_child(*sys.argv[1:])", path, out_path],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                capture_output=True, text=True, timeout=600)
            require(proc.returncode == 0,
                    f"bundle loop process ({backend}): {proc.stderr[-3000:]}")
            child = json.loads(proc.stdout.strip().splitlines()[-1])
            child_s = time.perf_counter() - t
            norms = sum(child["nodes"][e][2] * k
                        for e, k in child["calls"].items())
            require(norms > 0, f"bundle ({backend}): no GroupNorm node ran")
            want = {kernel: EXPORT_FRAMES - 1,
                    "local_matching": EXPORT_FRAMES - 1, NORM_KERNEL: norms}
            require(child["launches"] == want,
                    f"bundle loop ({backend}) launched {child['launches']}, "
                    f"expected {want}")
            require(not child["models_loaded"],
                    f"the bundle process loaded {child['models_loaded']}")
            got = torch.load(out_path)
            fns = ex.build_serving_fns(live, EXPORT_SIZE, o - 1, pad_to=16)
            fns = dict(fns, extract=ex.wrap_raw_image(*fns["extract"]))
            with torch.no_grad():
                bundle_loop({n: fn for n, (fn, _) in fns.items()}, frames,
                            pos, dev)                        # warm-up
                probs, mem, live_times = bundle_loop(
                    {n: fn for n, (fn, _) in fns.items()}, frames, pos, dev)
            err_p = (got["probs"] - probs.cpu()).abs().max().item()
            err_m = (got["mem"].float() - mem.float().cpu()).abs().max().item()
            require(max(err_p, err_m) <= TOL_EXPORT,
                    f"bundle ({backend}) vs live: probs {err_p}, mem {err_m}")
            require(bool(torch.isfinite(got["probs"]).all()), "finite probs")
            live_p50 = {k: statistics.median(v) for k, v in live_times.items()}
            log(f"[export] bundle ({backend}) in a fresh process "
                f"({child_s:.1f} s, of it load {child['load_s']:.2f} s): "
                f"{EXPORT_FRAMES} frames, launches {child['launches']} "
                f"(one global launch per propagated frame; the Evaluator "
                f"makes one per round), no model module loaded (port "
                f"modules: {', '.join(child['port_modules'])}); p50 ms "
                + ", ".join(f"{k} {v:.2f} (live {live_p50[k]:.2f}) x"
                            f"{child['calls'][k]}"
                            for k, v in child["p50_ms"].items())
                + f"; graph operations (of them metadata asserts, "
                f"GroupNorm ops) {child['nodes']}"
                + f"; checksums {child['checksums']}; against the live "
                f"module max|dprob|={err_p:.3g}, max|dmem|={err_m:.3g} "
                f"(tol {TOL_EXPORT})")

        # the fused round artifact (uint8 frames), run once on the card
        path = os.path.join(tmp, "round.ivosx")
        run = export_cli_timed(["--out", path, "--check", "--device",
                                "cuda"])
        require(run["check"].endswith("direct apply"), run["check"])
        t = time.perf_counter()
        art = ex.load_artifact(path)
        load_s = time.perf_counter() - t
        fn, _ = ex.wrap_raw_image(*ex.build_round_forward(
            model, EXPORT_SIZE, o - 1, pad_to=16))
        img = torch.from_numpy(frames[0]).to(dev)
        posd = torch.from_numpy(pos).to(dev)
        got, n, _ = launches_delta(
            lambda: art(img, posd, torch.zeros_like(posd)))
        want = {"global_matching": 1, "local_matching": 1,
                NORM_KERNEL: norm_nodes(art.exported)}
        require(want[NORM_KERNEL] > 0 and n == want,
                f"the fused round launched {n}, expected {want}")
        with torch.no_grad():
            err = (got - fn(img, posd, torch.zeros_like(posd))).abs().max()
        require(err.item() <= TOL_EXPORT, f"fused round vs live: {err}")
        log(f"[export] fused round: exported in {run['export_s']:.2f} s, "
            f"saved in {run['save_s']:.2f} s, "
            f"{os.path.getsize(path) / 2**20:.1f} MB, loaded in "
            f"{load_s:.2f} s; one call launched {n}; max|dprob| against "
            f"the live module {err.item():.3g} (tol {TOL_EXPORT})")

        # tiny bundles exported on the CPU (a build host without a card),
        # moved to the card by move_to_device_pass: f32 through the CLI,
        # and bf16, whose norms the graph holds as manet::group_norm
        path = os.path.join(tmp, "tiny_cpu.ivosx")
        export_cli_timed(["--out", path, "--tiny", "--bundle", "--device",
                          "cpu"])
        path16 = os.path.join(tmp, "tiny_cpu_bf16.ivosx")
        tiny = tiny_test_config()
        ex.save_bundle(ex.export_serving_bundle(
            MANet(dataclasses.replace(tiny.model, dtype="bfloat16"),
                  device="cpu", seed=0).eval(), tiny.eval.image_size,
            tiny.model.max_objects, pad_to=tiny.eval.pad_to), path16)
        for what, p in (("f32", path), ("bf16", path16)):
            on_cpu = ex.load_bundle(p)
            on_card = ex.load_bundle(p, device=dev)
            g = torch.Generator().manual_seed(4)
            args = [torch.randn(shape, generator=g).to(getattr(torch, dt))
                    for shape, dt in on_cpu["propagate"].manifest["in_avals"]]
            o_tiny = args[3].shape[-1]
            args[3] = torch.nn.functional.one_hot(args[3].argmax(-1),
                                                  o_tiny).float()
            want_out = on_cpu["propagate"](*args)
            got, n, _ = launches_delta(
                lambda: on_card["propagate"](*[a.to(dev) for a in args]))
            torch.cuda.synchronize()
            norms = norm_nodes(on_card["propagate"].exported)
            require((norms > 0) == (what == "bf16")
                    and n == with_norms({"global_matching": 1,
                                         "local_matching": 1}, norms),
                    f"the moved {what} bundle launched {n}, {norms} "
                    f"GroupNorm nodes")
            err = max((a.cpu().float() - b.float()).abs().max().item()
                      for a, b in zip(got, want_out))
            if what == "f32":
                # the tiny round's card-vs-CPU tolerance
                require(err <= TOL_ROUND_PROBS, f"moved bundle vs CPU: {err}")
            else:
                require(all(bool(torch.isfinite(a).all()) for a in got),
                        "moved bf16 bundle: finite outputs")
            log(f"[export] tiny {what} bundle exported on the CPU, moved to "
                f"{dev}: propagate launched {n}; max|d| against the CPU "
                f"{err:.3g}"
                + (f" (tol {TOL_ROUND_PROBS}: cuDNN and the kernels sum in "
                   f"other orders)" if what == "f32" else
                   " (bf16 convolutions on both: not gated; the CPU tests "
                   "hold the graph to the live module bit for bit)"))
    log(f"[export] phase took {time.perf_counter() - t_phase:.1f} s")


# --------------------------------------------------------------------- #
# The tools phase: the port's measuring entry points, each through its
# main(argv) at the JAX scripts' defaults, the flagship Config().
# --------------------------------------------------------------------- #

# (module, argv, the kernels its run must launch), all at the JAX scripts'
# defaults: about 80 s together on the card.
TOOL_RUNS = (
    ("bench_matching_kernel", [], ("global_matching",)),
    ("bench_matching_kernel", ["--int8"], ("global_matching_int8",)),
    ("bench_matching_kernel", ["--local"], ("local_matching",)),
    ("bench_streaming", [], ("global_matching", "local_matching")),
    ("bench_train", ["--stage", "1"],
     ("global_matching_argmin", "local_matching_argmin")),
    ("bench_train", ["--stage", "1", "--pipelined"],
     ("global_matching_argmin", "local_matching_argmin")),
    ("bench_train", ["--stage", "2"],
     ("global_matching_argmin", "local_matching_argmin")),
    ("bench_train", ["--stage", "2", "--pipelined"],
     ("global_matching_argmin", "local_matching_argmin")),
    ("profile_stages", [], ("global_matching", "local_matching")),
    ("profile_stages", ["--int8"],
     ("global_matching", "global_matching_int8", "local_matching")),
    ("profile_encode", [], ()),
    ("run_artifact", [], ("global_matching", "local_matching")),
)


def tools_phase(kind: str) -> None:
    """Each entry point of TOOL_RUNS in this process, with PyTorch's
    default TF32 flags (as from the command line): its lines logged, its
    JSON line's figure finite and positive and its device the card; the
    kernels it names launched in its run, and each `bench_matching_kernel`
    run's kernel at least iters x reps times, so that its timed window ran
    the hand-written kernel; `run_artifact`'s bundle masks bitwise equal
    to the live chain's."""
    import contextlib
    import importlib
    import io
    t_phase = time.perf_counter()
    flags = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False      # PyTorch's defaults
    torch.backends.cudnn.allow_tf32 = True
    try:
        for name, argv, kernels in TOOL_RUNS:
            mod = importlib.import_module(f"cvpr2020_manet_tpu_torch.{name}")
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc, launches, _ = launches_delta(lambda: mod.main(argv))
            wall = time.perf_counter() - t0
            lines = out.getvalue().strip().splitlines()
            what = " ".join([name, *argv])
            for line in lines:
                log(f"[tools] {line}")
            rec = json.loads(lines[-1])
            figure = rec["warm_round_s" if name == "run_artifact"
                         else "value"]
            require(rc == 0, f"{what} exited {rc}")
            require(np.isfinite(figure) and figure > 0,
                    f"{what}: figure {figure}")
            require(rec["device"] == kind, f"{what} ran on {rec['device']}")
            for k in kernels:
                require(launches.get(k, 0) > 0, f"{what} launched {launches}")
            if name == "bench_matching_kernel":
                want = rec["iters"] * rec["reps"]
                require(launches.get(rec["kernel"], 0) >= want,
                        f"{what}: {launches} launches, {want} timed calls")
            if name == "run_artifact":
                require(rec["mask_parity_bitwise"] is True,
                        f"{what}: bundle masks differ from the live chain")
            log(f"[tools] {what}: {wall:.1f} s, launches {launches}")
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = flags
    log(f"[tools] phase took {time.perf_counter() - t_phase:.1f} s")


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
    step_s = statistics.median(times[1:] or times)
    log(f"[train] {name}: batch {b}, crop {cfg.train.crop_size}; median "
        f"step {'after the first ' if steps > 1 else ''}"
        f"{step_s * 1e3:.1f} ms, {b / step_s:.2f} "
        f"samples/s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{launches} over {steps} steps")
    check_steps(name, losses, launches, per_step)
    return {k: launches[k] // steps for k in per_step}


def check_steps(name: str, losses, launches, per_step: dict[str, int]):
    """Finite losses, and over their steps `per_step` launches of each
    argmin kernel a step and none of the serving kernels: kernel 7 none
    either, since every norm of a training step records a backward."""
    require(all(np.isfinite(losses)), f"{name}: a loss is not finite")
    for kernel, n in launches.items():
        want = per_step.get(kernel, 0) * len(losses)
        require(n == want, f"{name}: {kernel} launched {n} times, "
                f"{want} expected")


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
    torch.cuda.empty_cache()
    train_data_phase(dev)
    return per_step


# --------------------------------------------------------------------- #
# The trainers' CLIs on DAVIS and YouTube-VOS trees this script writes
# (tests/_torch_davis_tree.py), as a user runs them.
# --------------------------------------------------------------------- #

# (name, frames, objects, seed)
TRAIN_DAVIS = (("train_a", 14, 2, 5), ("train_b", 10, 3, 6))
TRAIN_YTVOS = (("vid_a", 12, 2, 7), ("vid_b", 10, 3, 8))
YTVOS_SIZE = (720, 1280)
LOADER_WORKERS = 4


def trainer_cli(cli, trainer_cls, argv, per_step: dict[str, int]) -> dict:
    """`cli.main(argv)` as a user runs it, its stdout kept, the launch
    counters reset just before: each `train_step` timed to its end (it
    returns host floats), the loop's walls between step ends (the feed's
    wait included), the trainer and, at the first step, a copy of its
    parameters. The launches must be `per_step` a step, finite losses."""
    import contextlib
    import io

    from cvpr2020_manet_tpu_torch.kernels import build
    run = {"step_s": [], "ends": [], "losses": []}
    real = trainer_cls.train_step

    def timed(trainer, batch):
        if not run["ends"]:
            run["trainer"] = trainer
            run["first_params"] = {k: v.detach().clone() for k, v in
                                   trainer.model.state_dict().items()}
        t = time.perf_counter()
        metrics = real(trainer, batch)
        torch.cuda.synchronize()
        run["ends"].append(time.perf_counter())
        run["step_s"].append(run["ends"][-1] - t)
        run["losses"].append(metrics["loss"])
        return metrics

    out = io.StringIO()
    trainer_cls.train_step = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            cli.main(argv)
    finally:
        trainer_cls.train_step = real
    run["wall_s"] = time.perf_counter() - t0
    run["launches"] = dict(build.LAUNCHES)
    run["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    run["stdout"] = out.getvalue()
    check_steps(" ".join(argv), run["losses"], run["launches"], per_step)
    run["loop_s"] = list(np.diff(run["ends"]))
    return run


def fed_steps(trainer, batches, steps: int, per_step: dict[str, int]):
    """`steps` steps of `trainer` on the next batches of `batches`, the
    counters reset just before. -> the loop's walls (the feed's wait
    included)."""
    from cvpr2020_manet_tpu_torch.kernels import build
    build.reset_launches()
    walls, losses = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(trainer.train_step(next(batches))["loss"])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    check_steps("fed steps", losses, dict(build.LAUNCHES), per_step)
    return walls


def loader_rate(it, batches: int, batch: int) -> tuple[float, float]:
    """(seconds to the iterator's first batch, samples/s of the `batches`
    batches after it)."""
    t = time.perf_counter()
    next(it)
    first = time.perf_counter() - t
    t = time.perf_counter()
    for _ in range(batches):
        next(it)
    return first, batches * batch / (time.perf_counter() - t)


def train_data_phase(dev) -> None:
    """Stage 1 through its CLI on a 480p DAVIS tree (`--uint8 --grain`, 4
    workers, a snapshot), the loader alone, the same trainer fed
    synchronously and through `prefetch_to_device`; stage 2 through its
    CLI on a 720p YouTube-VOS tree from the stage-1 snapshot
    (`--init_from`)."""
    import tempfile

    from cvpr2020_manet_tpu_torch.config import Config
    from cvpr2020_manet_tpu_torch.data.grain_pipeline import (
        make_train_iterator)
    from cvpr2020_manet_tpu_torch.engine import train_stage1, train_stage2
    from cvpr2020_manet_tpu_torch.engine.prefetch import prefetch_to_device
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from _torch_davis_tree import write_davis_tree, write_ytvos_tree

    t_phase = time.perf_counter()
    cfg = Config()
    b = cfg.train.batch_size
    per_step = {"global_matching_argmin": b, "local_matching_argmin": 2 * b}
    with tempfile.TemporaryDirectory() as tmp:
        davis, ytvos = os.path.join(tmp, "DAVIS"), os.path.join(tmp, "yt")
        snap = os.path.join(tmp, "stage1")
        t0 = time.perf_counter()
        write_davis_tree(davis, DAVIS_SIZE, TRAIN_DAVIS, 1)
        write_ytvos_tree(ytvos, YTVOS_SIZE, TRAIN_YTVOS)
        log(f"[train] wrote a {DAVIS_SIZE[1]}x{DAVIS_SIZE[0]} DAVIS tree "
            f"{TRAIN_DAVIS} and a {YTVOS_SIZE[1]}x{YTVOS_SIZE[0]} "
            f"YouTube-VOS tree {TRAIN_YTVOS} in "
            f"{time.perf_counter() - t0:.2f} s")

        # stage 1: the CLI, uint8 batches from 4 loader workers
        s1 = trainer_cli(train_stage1, train_stage1.Trainer, [
            "--davis_root", davis, "--uint8", "--grain", "--grain_workers",
            str(LOADER_WORKERS), "--steps", "4", "--snapshot_dir", snap],
            per_step)
        trainer = s1["trainer"]
        final = {k: v.detach().clone()
                 for k, v in trainer.model.state_dict().items()}
        log(f"[train] stage 1 CLI on DAVIS (--uint8 --grain, "
            f"{LOADER_WORKERS} workers): batch {b}, crop "
            f"{cfg.train.crop_size}; losses "
            f"{', '.join(f'{v:.6f}' for v in s1['losses'])}; steps "
            f"{', '.join(f'{t * 1e3:.1f}' for t in s1['step_s'])} ms, "
            f"median loop wall after the first "
            f"{statistics.median(s1['loop_s']) * 1e3:.1f} ms (sync feed); "
            f"the CLI {s1['wall_s']:.1f} s; peak device memory "
            f"{s1['peak_gib']:.2f} GiB; launches {s1['launches']}")

        # the loader alone, then the same trainer on its batches: the
        # synchronous feed and prefetch_to_device, in turns
        _, rate0 = loader_rate(make_train_iterator(
            davis, cfg, num_workers=0, emit_uint8=True), 2, b)
        it = make_train_iterator(davis, cfg, num_workers=LOADER_WORKERS,
                                 emit_uint8=True, seed=1)
        first, rate4 = loader_rate(it, 12, b)
        log(f"[train] loader alone (uint8 DAVIS clips, batch {b}): "
            f"{rate0:.1f} samples/s in this process, {rate4:.1f} samples/s "
            f"from {LOADER_WORKERS} workers ({first:.2f} s from their start "
            f"to the first batch)")
        # synchronous, prefetched, prefetched, synchronous: 4 steps each
        torch.cuda.reset_peak_memory_stats()
        feed = prefetch_to_device(it, dev, size=2)
        sync = fed_steps(trainer, it, 4, per_step)
        pre = fed_steps(trainer, feed, 8, per_step)
        sync += fed_steps(trainer, it, 4, per_step)
        feed.close()
        it.close()
        log(f"[train] stage 1 fed from {LOADER_WORKERS} workers: median "
            f"step {statistics.median(sync) * 1e3:.1f} ms synchronous "
            f"(steps {', '.join(f'{t * 1e3:.1f}' for t in sync)}), "
            f"{statistics.median(pre) * 1e3:.1f} ms through "
            f"prefetch_to_device (steps "
            f"{', '.join(f'{t * 1e3:.1f}' for t in pre)}); peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del trainer, s1, it, feed
        torch.cuda.empty_cache()

        # stage 2: the CLI on YouTube-VOS from the stage-1 snapshot
        b2, rounds, frames = 2, cfg.train.stage2_rounds, 3
        n = 2 * b2 * rounds * frames
        s2 = trainer_cli(train_stage2, train_stage2.Stage2Trainer, [
            "--ytvos_root", ytvos, "--clip_len", str(frames), "--batch",
            str(b2), "--init_from", snap, "--steps", "3"],
            {"global_matching_argmin": n, "local_matching_argmin": n})
        require("initialized from stage-1 step 4" in s2["stdout"],
                f"stage 2 --init_from: {s2['stdout'][:300]}")
        same = all(torch.equal(s2["first_params"][k], v)
                   for k, v in final.items())
        require(same and set(s2["first_params"]) == set(final),
                "stage 2 did not start from stage 1's parameters")
        log(f"[train] stage 2 CLI on YouTube-VOS ({YTVOS_SIZE[1]}x"
            f"{YTVOS_SIZE[0]}, --clip_len {frames} --init_from, float "
            f"batches in this process): batch {b2}; its first step's "
            f"parameters equal stage 1's last; losses "
            f"{', '.join(f'{v:.6f}' for v in s2['losses'])}; steps "
            f"{', '.join(f'{t * 1e3:.1f}' for t in s2['step_s'])} ms, "
            f"median loop wall after the first "
            f"{statistics.median(s2['loop_s']) * 1e3:.1f} ms; peak device "
            f"memory {s2['peak_gib']:.2f} GiB; launches {s2['launches']}")
    log(f"[train] the data runs took {time.perf_counter() - t_phase:.1f} s")


# --------------------------------------------------------------------- #
# The dist phase: data-parallel ranks, the context-parallel train step and
# the norms other than GroupNorm, at the flagship Config().
# --------------------------------------------------------------------- #

DIST_BATCH = 8                  # global batch of the data-parallel runs
CP_MEMBERS = 4                  # context members of the cp step, one card
TOL_CP_LOSS = 1e-4              # cp step against the one-device step, rel


def _tests_on_path():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if path not in sys.path:
        sys.path.insert(0, path)


def _stage_records(records, stage):
    return [r for r in records if r.get("stage") == stage and r["step"] >= 0]


def dist_two_ranks(cfg) -> None:
    """2 ranks on the one card, two processes (tests/_torch_dist_worker.py,
    which imports only the port) over Gloo on CUDA tensors: global batch
    8, 3 stage-1 and 2 stage-2 steps, each rank on its half. Equal losses
    and parameter hashes across ranks after every step (and at the start);
    per rank and stage-1 step B_local kernel-4 and 2 B_local kernel-5
    launches (stage 2: 2 B_local R F each)."""
    import tempfile
    _tests_on_path()
    from _torch_dist_worker import run_ranks
    bl = DIST_BATCH // 2
    rounds, frames = cfg.train.stage2_rounds, 3
    per_step = {1: {"global_matching_argmin": bl,
                    "local_matching_argmin": 2 * bl},
                2: {"global_matching_argmin": 2 * bl * rounds * frames,
                    "local_matching_argmin": 2 * bl * rounds * frames}}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        outs = run_ranks([dict(rank=r, world=2, device="cuda",
                               backend="gloo", mode="train", tiny=False,
                               batch=DIST_BATCH, steps1=3, steps2=2,
                               out=tmp) for r in range(2)], timeout=900)
    wall = time.perf_counter() - t0
    ranks = [[json.loads(line) for line in o.splitlines()
              if line.startswith("{")] for o in outs]
    require(ranks[0][0]["hash"] == ranks[1][0]["hash"],
            "dist: the ranks start from different weights")
    for stage, steps in ((1, 3), (2, 2)):
        a, b = (_stage_records(r, stage) for r in ranks)
        require(len(a) == len(b) == steps, f"dist: stage {stage} steps")
        for x, y in zip(a, b):
            require(x["loss"] == y["loss"] and np.isfinite(x["loss"]),
                    f"dist: stage {stage} step {x['step']} losses "
                    f"{x['loss']} / {y['loss']}")
            require(x["hash"] == y["hash"],
                    f"dist: stage {stage} step {x['step']}: the ranks' "
                    f"parameters differ")
            for r in (x, y):
                require(r["launches"] == per_step[stage],
                        f"dist: stage {stage} launches {r['launches']}, "
                        f"expected {per_step[stage]}")
        for rank, recs in enumerate((a, b)):
            steps_ms = [r["step_s"] * 1e3 for r in recs]
            reduce_ms = [r["allreduce_s"] * 1e3 for r in recs]
            share = [r["allreduce_s"] / r["step_s"] for r in recs]
            losses = [r["loss"] for r in recs]
            log(f"[dist] 2 ranks, gloo on one card, stage {stage}, rank "
                f"{rank}: batch {bl} a rank; losses "
                f"{', '.join(f'{v:.6f}' for v in losses)}; "
                f"steps {', '.join(f'{t:.1f}' for t in steps_ms)} ms; "
                f"gradient all-reduce "
                f"{', '.join(f'{t:.1f}' for t in reduce_ms)} ms "
                f"(share {', '.join(f'{v:.3f}' for v in share)}); peak "
                f"device memory {max(r['peak_gib'] for r in recs):.2f} GiB; "
                f"launches a step {recs[-1]['launches']}")
    log(f"[dist] 2 ranks: equal losses and parameter hashes after every "
        f"step of both stages; the two processes took {wall:.1f} s")


def dist_cli_nccl(cfg) -> None:
    """The stage-1 CLI with --distributed --num_processes 1 on NCCL in this
    process (a one-rank group: no coordinator), with --snapshot_dir, for 3
    steps, then resumed for 3 more; with two cards or more, the 2-rank CLI
    on NCCL in two processes."""
    import tempfile

    import torch.distributed as dist

    from cvpr2020_manet_tpu_torch.engine import train_stage1
    from cvpr2020_manet_tpu_torch.parallel import distributed
    b = cfg.train.batch_size
    per_step = {"global_matching_argmin": b, "local_matching_argmin": 2 * b}
    joined = []
    real = distributed.initialize

    def recorded(*args, **kw):
        out = real(*args, **kw)
        joined.append((out, dist.get_backend()))
        return out

    distributed.initialize = recorded
    try:
        with tempfile.TemporaryDirectory() as tmp:
            argv = ["--synthetic", "--steps", "3", "--distributed",
                    "--num_processes", "1", "--snapshot_dir", tmp]
            runs = [trainer_cli(train_stage1, train_stage1.Trainer, argv,
                                per_step) for _ in range(2)]
            snaps = sorted(int(d) for d in os.listdir(tmp))
    finally:
        distributed.initialize = real
    require(joined == [((0, 1), "nccl")] * 2,
            f"dist: the CLI joined {joined}, expected one NCCL rank twice")
    require(not dist.is_initialized(), "dist: the CLI left its group open")
    require("resumed from step 3" in runs[1]["stdout"] and snaps == [3, 6],
            f"dist: resume {runs[1]['stdout'][:200]!r}, snapshots {snaps}")
    for name, run in zip(("first", "resumed"), runs):
        log(f"[dist] stage 1 CLI --distributed --num_processes 1 (nccl), "
            f"{name} run: losses "
            f"{', '.join(f'{v:.6f}' for v in run['losses'])}; steps "
            f"{', '.join(f'{t * 1e3:.1f}' for t in run['step_s'])} ms; the "
            f"CLI {run['wall_s']:.1f} s; launches {run['launches']}")
    n = torch.cuda.device_count()
    if n < 2:
        log(f"[dist] the 2-rank CLI on NCCL skipped: {n} card on this "
            f"machine, and NCCL refuses two ranks on one card")
        return
    from cvpr2020_manet_tpu_torch.parallel.distributed import free_port
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cvpr2020_manet_tpu_torch.engine.train_stage1",
         "--synthetic", "--steps", "2", "--distributed", "--coordinator",
         f"127.0.0.1:{port}", "--num_processes", "2", "--process_id",
         str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=os.path.dirname(os.path.abspath(__file__)))
        for r in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, out in zip(procs, outs):
        require(p.returncode == 0, f"dist: 2-rank NCCL CLI: {out[-2000:]}")
    log(f"[dist] 2-rank stage 1 CLI on NCCL over cuda:0 and cuda:1: "
        f"{time.perf_counter() - t0:.1f} s; rank 0: "
        f"{outs[0].strip().splitlines()[-1]}")


def dist_cp_step(dev, cfg) -> None:
    """`make_cp_train_step` on 4 context members of the one card against
    the one-device step, 3 steps at batch 8, each on the same weights and
    batch (the one-device trainer takes the cp trainer's weights before
    every step, so the float drift of two independent runs, whose
    gradient sums differ in order, stays out of the comparison): every
    sample's cp map against the one-device kernel-4 map of the same
    embeddings (TOL_GLOBAL; 0 expected, the per-pair arithmetic does not
    depend on the tile and the min is exact), the losses to TOL_CP_LOSS
    relative, and B x 4 kernel-4 and 2B kernel-5 launches a step."""
    from cvpr2020_manet_tpu_torch.engine import train_stage1
    from cvpr2020_manet_tpu_torch.engine.train_stage1 import (
        Trainer, make_cp_train_step, synthetic_batch)
    from cvpr2020_manet_tpu_torch.kernels import build
    from cvpr2020_manet_tpu_torch.ops.trainable import GlobalMatchingTrainable
    from cvpr2020_manet_tpu_torch.parallel.mesh import create_mesh
    b = cfg.train.batch_size
    one = Trainer(cfg, device=dev)
    cp = Trainer(cfg, device=dev)
    mesh = create_mesh(data=1, context=CP_MEMBERS,
                       devices=[torch.device("cuda", 0)] * CP_MEMBERS)
    step = make_cp_train_step(cp.model, cfg, mesh)
    inputs, maps = [], []
    real = train_stage1.trainable_local_then_min

    def recorded(query, ref, gate, devices):
        inputs.append((query.detach(), ref.detach(), gate))
        gm = real(query, ref, gate, devices)
        maps.append(gm.detach())
        return gm

    want = {"global_matching_argmin": b * CP_MEMBERS,
            "local_matching_argmin": 2 * b}
    rng = np.random.default_rng(cfg.train.seed + 7)
    train_stage1.trainable_local_then_min = recorded
    try:
        for i in range(3):
            batch = synthetic_batch(cfg, rng)
            one.model.load_state_dict(cp.model.state_dict())
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss_one = one.train_step(batch)["loss"]
            torch.cuda.synchronize()
            one_s = time.perf_counter() - t
            inputs.clear()
            maps.clear()
            build.reset_launches()
            t = time.perf_counter()
            loss_cp = step(cp.state, batch)["loss"]
            torch.cuda.synchronize()
            cp_s = time.perf_counter() - t
            launches = {k: v for k, v in build.LAUNCHES.items() if v}
            with torch.no_grad():
                single = [GlobalMatchingTrainable.apply(*x) for x in inputs]
            err = max(float((g - s).abs().max())
                      for g, s in zip(maps, single, strict=True))
            rel = abs(loss_cp - loss_one) / abs(loss_one)
            log(f"[dist] cp step {i} ({CP_MEMBERS} members of {dev}, batch "
                f"{b}): loss {loss_cp:.6f} against the one-device step's "
                f"{loss_one:.6f} (rel {rel:.3g}); max|cp map - one-device "
                f"map| {err:.3g} over {len(single)} samples (tol "
                f"{TOL_GLOBAL}); step {cp_s * 1e3:.1f} ms against "
                f"{one_s * 1e3:.1f} ms; launches {launches}")
            require(err <= TOL_GLOBAL, f"cp step map error {err}")
            require(np.isfinite(loss_cp) and rel <= TOL_CP_LOSS,
                    f"cp step loss {loss_cp} vs {loss_one}")
            require(launches == want, f"cp step launches {launches}, "
                    f"expected {want}")
    finally:
        train_stage1.trainable_local_then_min = real


def write_resnet101_pth(path: str, seed: int = 0) -> None:
    """A synthetic torchvision-layout `resnet101` state dict as a .pth:
    He-scaled convs, BatchNorm near the identity (each block's last BN at
    gamma 0.2, so the residual sums stay at scale over 33 blocks)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(name, cin, cout, k):
        sd[f"{name}.weight"] = torch.randn(
            (cout, cin, k, k), generator=g) * (2.0 / (cin * k * k)) ** 0.5

    def bn(name, c, gamma=1.0):
        u = lambda: torch.rand(c, generator=g)          # noqa: E731
        sd[f"{name}.weight"] = gamma * (0.9 + 0.2 * u())
        sd[f"{name}.bias"] = 0.01 * torch.randn(c, generator=g)
        sd[f"{name}.running_mean"] = 0.01 * torch.randn(c, generator=g)
        sd[f"{name}.running_var"] = 0.9 + 0.2 * u()
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0)

    conv("conv1", 3, 64, 7)
    bn("bn1", 64)
    cin = 64
    for s, n in enumerate((3, 4, 23, 3)):
        ch = 64 * 2 ** s
        for blk in range(n):
            t = f"layer{s + 1}.{blk}"
            conv(f"{t}.conv1", cin, ch, 1)
            bn(f"{t}.bn1", ch)
            conv(f"{t}.conv2", ch, ch, 3)
            bn(f"{t}.bn2", ch)
            conv(f"{t}.conv3", ch, ch * 4, 1)
            bn(f"{t}.bn3", ch * 4, gamma=0.2)
            if blk == 0:
                conv(f"{t}.downsample.0", cin, ch * 4, 1)
                bn(f"{t}.downsample.1", ch * 4)
            cin = ch * 4
    sd["fc.weight"] = 0.01 * torch.randn((1000, cin), generator=g)
    sd["fc.bias"] = torch.zeros(1000)
    torch.save(sd, path)


def dist_norms(dev, cfg) -> None:
    """The norms other than GroupNorm at ResNet-101 depths: 'frozen' from a
    synthetic torchvision resnet101 .pth (load_torch_file ->
    convert_torch_resnet -> load_backbone_into), 2 stage-1 steps and one
    480p round through the Evaluator (1 kernel-1 and 15 kernel-2
    launches); 'ln' one step and one round; 'bn' one extract_features at
    480p, and the Evaluator refusing it."""
    import dataclasses
    import tempfile

    from cvpr2020_manet_tpu_torch.config import Config
    from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
    from cvpr2020_manet_tpu_torch.engine.train_stage1 import Trainer
    from cvpr2020_manet_tpu_torch.models import MANet
    from cvpr2020_manet_tpu_torch.utils.pretrained import (
        convert_torch_resnet, load_backbone_into, load_torch_file)
    b = cfg.train.batch_size
    per_step = {"global_matching_argmin": b, "local_matching_argmin": 2 * b}

    def with_norm(norm):
        return dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, norm=norm))

    for norm, steps in (("frozen", 2), ("ln", 1)):
        ncfg = with_norm(norm)
        trainer = Trainer(ncfg, device=dev)
        if norm == "frozen":
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "resnet101.pth")
                t0 = time.perf_counter()
                write_resnet101_pth(path)
                t1 = time.perf_counter()
                sd = load_torch_file(path)
                converted = convert_torch_resnet(sd)
                load_backbone_into(trainer.model, converted)
                t2 = time.perf_counter()
                mb = os.path.getsize(path) / 2**20
            stem = trainer.model.encoder.backbone.stem_norm.weight
            require(torch.equal(stem.cpu(), converted["stem_norm.weight"]),
                    "frozen: the pretrained stem did not load")
            log(f"[dist] frozen: a synthetic torchvision resnet101 .pth "
                f"({len(sd)} tensors, {mb:.1f} MB) written in {t1 - t0:.2f} "
                f"s, loaded, converted ({len(converted)} backbone tensors, "
                f"BN folded) and loaded into the model in {t2 - t1:.2f} s")
        run_trainer(f"norm={norm!r} stage 1", trainer, ncfg, steps=steps,
                    per_step=per_step)
        serving = MANet(ncfg.model, device=dev)
        serving.load_state_dict(trainer.model.state_dict())
        del trainer
        main_path(dev, serving, f"dist {norm}", "global_matching",
                  uint8=False, rounds=1)
        del serving
        torch.cuda.empty_cache()

    bn_cfg = dataclasses.replace(cfg.model, norm="bn", head_norm="bn")
    model = MANet(bn_cfg, device=dev)
    x = torch.randn((2, 480, 864, 3), generator=torch.Generator().manual_seed(
        1)).to(dev)
    mean0 = model.encoder.backbone.stem_norm.mean.clone()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with torch.no_grad():
        feat, emb = model.extract_features(x)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    require(bool(torch.isfinite(feat.float()).all()
                 and torch.isfinite(emb.float()).all())
            and feat.shape == (2, 120, 216, cfg.model.decoder_channels),
            f"bn extract_features {tuple(feat.shape)}")
    require(not torch.equal(mean0, model.encoder.backbone.stem_norm.mean),
            "bn: the running statistics did not move")
    try:
        Evaluator(Config(model=bn_cfg), model, device=dev)
        require(False, "the Evaluator accepted norm='bn'")
    except ValueError as e:
        require("batch_stats" in str(e), f"bn refusal: {e}")
        log(f"[dist] bn: extract_features of 2 480x864 frames {ms:.1f} ms "
            f"(first call), finite, running statistics updated; the "
            f"Evaluator refuses it: {e}")


def dist_phase(dev) -> None:
    """Data-parallel ranks, the cp train step and the other norms, at the
    flagship Config()."""
    import dataclasses

    from cvpr2020_manet_tpu_torch.config import Config
    t_phase = time.perf_counter()
    cfg = Config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=DIST_BATCH))
    for name, part in (("2 ranks", lambda: dist_two_ranks(cfg)),
                       ("NCCL CLI", lambda: dist_cli_nccl(cfg)),
                       ("cp step", lambda: dist_cp_step(dev, cfg)),
                       ("norms", lambda: dist_norms(dev, cfg))):
        t = time.perf_counter()
        part()
        torch.cuda.empty_cache()
        log(f"[dist] {name} took {time.perf_counter() - t:.1f} s")
    log(f"[dist] phase took {time.perf_counter() - t_phase:.1f} s")


# --------------------------------------------------------------------- #
# The quality phase: the train -> release -> eval entry point
# (train_eval_flagship.py) at the flagship Config(), as a user runs it.
# --------------------------------------------------------------------- #

QUALITY_ARGV = ["--steps1", "8", "--steps2", "4", "--sequences", "1",
                "--sets", "1", "--rounds", "3"]
QUALITY_KEYS = ["per_round_jf", "auc", "jf_at_60s", "p50_round_ms",
                "entry_frames"]
QUALITY_ABLATE_KEYS = ["ablate_per_round_jf", "ablate_auc",
                       "memory_auc_delta"]


def quality_cli(argv) -> dict:
    """`train_eval_flagship.main(argv)` as `python -m
    cvpr2020_manet_tpu_torch.train_eval_flagship` runs it, the launch
    counters reset just before; each trainer step's, each sequence start's
    and each eval round's launches recorded. -> dict: its exit code, its
    JSON line, its verdict line, each stage's record (`train`'s), the
    launches of each stage-1 step, stage-2 step, start and round, the
    GroupNorm calls of each start and round (`norms`), the run's launches
    in all, its wall."""
    import contextlib
    import io

    from cvpr2020_manet_tpu_torch import train_eval_flagship as tef
    from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
    from cvpr2020_manet_tpu_torch.engine.train_stage1 import Trainer
    from cvpr2020_manet_tpu_torch.engine.train_stage2 import Stage2Trainer
    from cvpr2020_manet_tpu_torch.kernels import build

    run = {"stage1": [], "stage2": [], "starts": [], "rounds": [],
           "records": [], "norms": {"starts": [], "rounds": []}}

    def counted(real, key):
        def method(self, *args, **kw):
            out, launched, norms = launches_delta(
                lambda: real(self, *args, **kw))
            run[key].append(launched)
            if key in run["norms"]:
                run["norms"][key].append(norms)
            return out
        return method

    def recorded(*args, **kw):
        rec = real_train(*args, **kw)
        run["records"].append(rec)
        return rec

    patched = ((Trainer, "train_step", "stage1"),
               (Stage2Trainer, "train_step", "stage2"),
               (Evaluator, "start_sequence", "starts"),
               (Evaluator, "run_round", "rounds"))
    reals = [getattr(cls, name) for cls, name, _ in patched]
    real_train = tef.train
    out = io.StringIO()
    for (cls, name, key), real in zip(patched, reals):
        setattr(cls, name, counted(real, key))
    tef.train = recorded
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            run["rc"] = tef.main(argv)
    finally:
        for (cls, name, _), real in zip(patched, reals):
            setattr(cls, name, real)
        tef.train = real_train
    torch.cuda.synchronize()
    run["wall_s"] = time.perf_counter() - t0
    run["launches"] = dict(build.LAUNCHES)
    lines = out.getvalue().strip().splitlines()
    run["verdict"], run["line"] = lines[-2], json.loads(lines[-1])
    return run


def summed_launches(deltas) -> dict[str, int]:
    """The sum of `launches_delta` records, every kernel's count (0 where
    none launched), as `build.LAUNCHES` holds them."""
    from cvpr2020_manet_tpu_torch.kernels import build
    total = dict.fromkeys(build.LAUNCHES, 0)
    for launched in deltas:
        for k, v in launched.items():
            total[k] += v
    return total


def check_quality_launches(name, run, global_kernel, rounds, per_round):
    """Each recorded step, start and round launched its kernels as
    asserted (a start kernel 7 alone, once a GroupNorm call), and nothing
    launched outside them."""
    total = summed_launches(run["stage1"] + run["stage2"] + run["starts"]
                            + run["rounds"])
    require(total == run["launches"], f"quality {name}: launches outside "
            f"the steps and rounds: {run['launches']} vs {total}")
    require(len(run["rounds"]) == rounds, f"quality {name}: "
            f"{len(run['rounds'])} rounds, {rounds} expected")
    for launched, norms in zip(run["starts"], run["norms"]["starts"]):
        require(norms > 0 and launched == with_norms({}, norms),
                f"quality {name}: a start launched {launched}, {norms} "
                f"GroupNorm calls")
    for launched, norms in zip(run["rounds"], run["norms"]["rounds"]):
        require(norms > 0 and launched == with_norms(
            {global_kernel: 1, "local_matching": per_round}, norms),
                f"quality {name}: a round launched {launched}, {norms} "
                f"GroupNorm calls")


def quality_phase(dev) -> None:
    """`train_eval_flagship` at the flagship Config(): 8 stage-1 steps
    (crop 256, batch 2), 4 stage-2 steps (crop 192, 2 rounds), a release,
    then the eval leg and its memory-ablated leg (3 rounds, 1 sequence of
    16 480p frames, 3 objects entering mid-sequence); then the release
    evaluated in fresh calls, in the default and the int8 mode. Kernels 4
    and 5 against their plain versions at the two crops first."""
    import tempfile

    from cvpr2020_manet_tpu_torch.config import Config
    t_phase = time.perf_counter()
    cfg = Config()
    o, c_real, c = (cfg.model.max_objects + 1, cfg.model.embedding_dim,
                    cfg.model.embedding_dim_padded)
    # crop 192's 2,304 reference rows hold 8 live objects in one k-block
    # each: its split ties take 2 live objects (O = 3)
    for crop, tie_objects in ((256, o), (192, 3)):
        s = cfg.model.feature_stride
        kernel_global_argmin(dev, (crop // s, crop // s), c_real, c, o,
                             tie_objects)
        kernel_local_argmin(dev, (crop // (2 * s), crop // (2 * s)), c_real,
                            c, o, cfg.model.local_window)
    torch.cuda.empty_cache()

    b, rounds2, clip = 2, 2, 3          # the entry point's defaults
    rounds, frames = 3, 16
    with tempfile.TemporaryDirectory() as tmp:
        release = os.path.join(tmp, "rel")
        trained = quality_cli(QUALITY_ARGV + ["--ablate", "--release",
                                              release])
        line = trained["line"]
        require(list(line) == QUALITY_KEYS + QUALITY_ABLATE_KEYS,
                f"quality: JSON keys {list(line)}")
        require(trained["rc"] == int(not trained["verdict"].startswith(
            "OK")), f"quality: exit code {trained['rc']} against "
            f"{trained['verdict']!r}")
        for stage, per_step in (("stage1", {"global_matching_argmin": b,
                                            "local_matching_argmin": 2 * b}),
                                ("stage2", {
                                    k: 2 * b * rounds2 * clip for k in (
                                        "global_matching_argmin",
                                        "local_matching_argmin")})):
            i = 0 if stage == "stage1" else 1
            rec = trained["records"][i]
            steps = trained[stage]
            check_steps(f"quality {stage}", rec["losses"],
                        summed_launches(steps), per_step)
            log(f"[quality] {stage}: {len(steps)} steps, losses "
                f"{[round(x, 4) for x in rec['losses']]}, wall "
                f"{rec['wall_s']:.2f} s, median step {rec['step_ms']:.1f} "
                f"ms, peak device memory {rec['peak_gib']:.2f} GiB; "
                f"launches a step {steps[-1]}")
        check_quality_launches("trained", trained, "global_matching",
                               2 * rounds, frames - 1)
        log(f"[quality] trained: {json.dumps(line)}; {trained['verdict']}; "
            f"wall {trained['wall_s']:.1f} s")

        evaluated = {}
        for mode, extra, kernel in (("release", [], "global_matching"),
                                    ("release int8", ["--matching_int8"],
                                     "global_matching_int8")):
            run = quality_cli(QUALITY_ARGV + ["--eval_release", release]
                              + extra)
            require(not run["stage1"] and not run["stage2"],
                    f"quality {mode}: it trained")
            require(list(run["line"]) == QUALITY_KEYS,
                    f"quality {mode}: JSON keys {list(run['line'])}")
            check_quality_launches(mode, run, kernel, rounds, frames - 1)
            jf = run["line"]["per_round_jf"]
            require(all(0.0 <= x <= 1.0 for x in jf),
                    f"quality {mode}: J&F {jf}")
            log(f"[quality] {mode}: {json.dumps(run['line'])}; "
                f"{run['verdict']}; wall {run['wall_s']:.1f} s")
            evaluated[mode] = run["line"]
        require(evaluated["release"]["per_round_jf"] == line["per_round_jf"],
                f"quality: the release's per-round J&F "
                f"{evaluated['release']['per_round_jf']} differs from the "
                f"trained model's {line['per_round_jf']}")
    log(f"[quality] the release evaluated in a fresh call gives the "
        f"trained model's per-round J&F; phase took "
        f"{time.perf_counter() - t_phase:.1f} s")


# the port's kernel functions and the names of their template parameters
TEMPLATE_PARAMS = {"global_matching_tf32": (),
                   "global_matching_wgmma": ("argmin", "int8"),
                   "global_matching_fma_argmin": (),
                   "merge_splits": ("argmin",),
                   "local_matching_tf32": ("OB", "argmin")}


def ptxas_reports(text: str) -> list[tuple[str, str]]:
    """(kernel, "registers ..., spills ...") from a `ptxas -v` report."""
    out, fn, frame = [], "?", ""
    for line in text.splitlines():
        line = line.strip()
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            for short, params in TEMPLATE_PARAMS.items():
                at = fn.find(short)
                if at >= 0:     # a template's instance: its arguments
                    m = re.match(r"I((?:L[bi]\d+E)+)E", fn[at + len(short):])
                    args = [] if m is None else re.findall(
                        r"L[bi](\d+)E", m.group(1))
                    fn = short + ("" if not args else "<" + ", ".join(
                        f"{p}={a}" for p, a in zip(params, args)) + ">")
                    break
        elif "stack frame" in line:
            frame = line
        elif line.startswith("ptxas info") and "registers" in line:
            out.append((fn, f"{line.split(':', 1)[1].strip()}; {frame}"))
    return out


# kernel functions (a pattern of the SASS function name) and the
# tensor-core instruction each must be built on
ROUTES = (("global_matching_tf32", "HGMMA",
           "the f32 template (matching_tf32.cuh, kernels 1 f32 and 6)"),
          ("global_matching_wgmmaILb0ELb0E", "HGMMA",
           "kernel 1 bf16 (wgmma, min)"),
          ("global_matching_wgmmaILb1ELb0E", "HGMMA",
           "kernel 4 (wgmma, argmin)"),
          ("global_matching_wgmmaILb0ELb1E", "IGMMA",
           "kernel 3 (int8 wgmma, min)"),
          (r"local_matching_tf32ILi\d+ELb0E", "HMMA",
           "kernel 2 (3xTF32 mma.sync)"),
          (r"local_matching_tf32ILi\d+ELb1E", "HMMA",
           "kernel 5 (3xTF32 mma.sync, argmin)"))


def sass_routes(build) -> None:
    """Which tensor-core route each tensor-core kernel was built on: its
    wgmma (HGMMA; IGMMA for int8) and mma.sync (HMMA) instructions in the
    SASS of the built libraries (cuobjdump), and the dynamic shared memory
    of the f32 template and of kernel 2 at the main path's shape."""
    smem = build.kernel_function("global_matching",
                                 "manet_global_matching_tf32_smem", [])()
    local_smem = build.kernel_function(
        "local_matching", "manet_local_matching_smem", [ctypes.c_int] * 3)(
            128, 15, 4)
    log(f"[build] dynamic shared memory: f32 template {smem} B, kernel 2 "
        f"{local_smem} B a block (C = 128, w = 15, O = 4)")
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        log("[build] cuobjdump not found, routes not read from SASS")
        return
    sass = {}
    for lib in ("global_matching", "local_matching"):
        out = subprocess.run([tool, "-sass", build._library_path(lib)],
                             capture_output=True, text=True,
                             check=True).stdout
        for f in out.split("Function : ")[1:]:
            sass[f.splitlines()[0].strip()] = f
    for key, instr, what in ROUTES:
        fns = {n: f for n, f in sass.items() if re.search(key, n)}
        require(len(fns) > 0, f"{what}: not found in the SASS")
        for name, f in fns.items():
            counts = ", ".join(f"{f.count(i)} {i}"
                               for i in ("HGMMA", "IGMMA", "HMMA"))
            require(f.count(instr) > 0, f"{what} ({name}) has no {instr}")
            log(f"[build] {what}: {counts} instructions in the SASS of "
                f"{name[:70]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
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
    # PyTorch divides a CUDA tensor by a Python number as a multiply by its
    # reciprocal; the int8 quantizers divide by a tensor (IEEE, as JAX)
    from cvpr2020_manet_tpu_torch.ops.global_matching_cuda import _div127
    x = 3 * torch.rand(1 << 20, generator=torch.Generator().manual_seed(6))
    ieee = x / 127.0                                 # the CPU divides
    off = int(((x.to(dev) / 127.0).cpu() != ieee).sum())
    require(torch.equal(_div127(x.to(dev)).cpu(), ieee),
            "the int8 quantizers' division differs from IEEE on the card")
    log(f"[device] x / 127.0 on the card differs from IEEE division in "
        f"{off} of {x.numel()} values; the int8 quantizers' division "
        f"(_div127) equals it")

    # [2] build
    secs = build.build_all()
    count_graph_norms()
    log(f"[build] {len(build.KERNELS)} kernels ready in {secs:.1f} s "
        f"({len(build.BUILD_LOGS)} compiled now by nvcc, the others found "
        f"built from the same sources)")
    for name, text in build.BUILD_LOGS.items():
        for fn, report in ptxas_reports(text):
            log(f"[build] {name}: {fn}: {report}")
    sass_routes(build)

    # [3] kernels at their paths' shapes, and a tiny round vs the CPU
    round_480p = "480p round: 15 frames against one"
    page_1080p = "one 1080p frame against one memory page"
    kernels = [kernel_global(dev, 15 * 120 * 216, 120 * 216, 100, 128, 4,
                             torch.bfloat16, round_480p),
               kernel_local(dev, (60, 108), 100, 128, 4, 15, "480p round"),
               kernel_global_int8(dev, 15 * 120 * 216, 120 * 216, 100, 128, 4,
                                  round_480p),
               kernel_global_argmin(dev, (104, 104), 100, 128, 9),
               kernel_local_argmin(dev, (52, 52), 100, 128, 9, 15)]
    # the 1080p stream's shapes: global matching with int8 memory and with
    # f32 memory (kernel 1's f32 variant, 3xTF32), and local matching
    pages = {"global_matching_int8": kernel_global_int8(
                 dev, 272 * 480, 272 * 480, 100, 128, 4, page_1080p),
             "global_matching (f32)": kernel_global(
                 dev, 272 * 480, 272 * 480, 100, 128, 4, torch.float32,
                 page_1080p)}
    pages["local_matching"] = kernel_local(
        dev, (136, 240), 100, 128, 4, 15, "1080p stream, 1 launch per observe")
    # FEELVOS's batch step: a 480p frame at the full stride-4 grid, in the
    # 9-object bucket, against its clip's frame 0 and its frame t-1
    pages["global_matching (feelvos)"] = kernel_global(
        dev, 120 * 216, 120 * 216, 100, 128, 9, torch.bfloat16,
        "feelvos 480p batch: one frame against frame 0")
    pages["local_matching (feelvos)"] = kernel_local(
        dev, (120, 216), 100, 128, 9, 15, "feelvos 480p batch")
    for name, page in pages.items():
        log(f"[kernels] {name} at its path's shape: " + json.dumps(
            {k: page[k] for k in ("max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms",
                                  "splits", "epilogue_floor_ms")
             if k in page}))
    # kernel 7 at the 1080p stream's stem and layer 3 (norm3, with the
    # residual) and at the 720p batch's head over 4 clips
    norms = [kernel_group_norm(dev, (1, 64, 544, 960), 32, False,
                               "1080p stem"),
             kernel_group_norm(dev, (1, 1024, 68, 120), 32, True,
                               "1080p layer 3 norm3"),
             kernel_group_norm(dev, (4, 256, 180, 320), 32, False,
                               "720p head, 4 clips")]
    kernels.append(norms[0])
    for row in norms[1:]:
        log("[kernels] group_norm: " + json.dumps(
            {k: row[k] for k in ("max_abs_err", "max_ulps", "ms", "b2b_ms",
                                 "call_ms", "plain_ms", "bound_ms",
                                 "library_ms")}))
    # the batch engine's launch: one 480p frame's queries against its
    # clip's frame 0, where the query tiles alone do not fill the card
    batch_launch = kernel_global_int8(
        dev, 120 * 216, 120 * 216, 100, 128, 4,
        "batch launch: one 480p frame against frame 0", back_to_back=True)
    log("[kernels] global_matching_int8 at the batch engine's shape: "
        + json.dumps({k: batch_launch[k] for k in (
            "max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "splits", "epilogue_floor_ms")}))
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
    with tempfile.TemporaryDirectory() as davis_tmp:
        davis = davis_phase(davis_tmp)
        torch.cuda.empty_cache()
        reference_phase(davis)
    torch.cuda.empty_cache()
    stream_phase(dev, model_i8, model)
    torch.cuda.empty_cache()
    kernels.append(cp_phase(dev, model))
    torch.cuda.empty_cache()
    for m in (model_i8, model):
        for ingest in ("rgb", "yuv420"):
            batch_phase(dev, m, ingest)
    torch.cuda.empty_cache()
    feelvos_phase(dev)
    export_phase(dev, model, model_i8)
    del model, model_i8
    torch.cuda.empty_cache()
    tools_phase(kind)

    # [5] training: the flagship model; launches per stage-1 step; then
    # data-parallel ranks, the cp step and the other norms; then the
    # train -> release -> eval entry point
    launches.update(train_phase(dev))
    dist_phase(dev)
    torch.cuda.empty_cache()
    quality_phase(dev)
    for k in kernels:
        if "launches" not in k:            # kernel 6 counts its own ring
            k["launches"] = launches[k["name"]]

    # [6] result
    log(f"[result] all phases took {time.perf_counter() - t_start:.1f} s")
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
