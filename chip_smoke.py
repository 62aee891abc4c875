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
             serving kernels at 480p, the argmin kernels at the training
             shapes, with their winners and the gradients of the trainable
             Functions; then one tiny round on the card against the same
             round on the CPU;
4. main    — the flagship ModelConfig() (ResNet-101, bf16, random weights
             from a seed) through `Evaluator.run_session` on a synthetic
             480p sequence of 16 frames, 2 objects, 3 rounds; the launch
             counters, reset just before, must show 1 global- and 15
             local-matching launches per round;
5. train   — the flagship model through `Trainer.train_step` (stage 1,
             TrainConfig() defaults: crop 416, batch 8) for 4 steps and
             `Stage2Trainer.train_step` (crop 416, batch 2, 3 simulated
             rounds over 3-frame clips) for 3 steps: finite losses, step
             times, samples/s, peak memory, and the launch counters, reset
             just before each, must show the argmin kernels at B and 2B
             launches per stage-1 step and 2 B R F each per stage-2 step
             (the backward recomputes the checkpointed tails and rounds),
             and the serving kernels at none;
6. result  — one JSON line of the kernels, the nvidia-smi line, and the
             final `{"ok": true, "device": ...}` line.
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


def kernel_global(dev, n_frames: int, hw: tuple[int, int], c_real: int,
                  c: int, o: int):
    """Kernel 1 at the main path's shape: all T-1 frames of queries against
    one annotated frame, bf16, 2 live objects + background in an O=4
    bucket (the last object has no pixels)."""
    from cvpr2020_manet_tpu_torch.ops.global_matching_cuda import (
        global_matching_prepared, global_matching_prepared_plain, prepare_ref)
    g = torch.Generator().manual_seed(1)
    nk = hw[0] * hw[1]
    nq = n_frames * nk
    live = o - 1
    q, k, labels = global_inputs(g, nq, nk, c_real, c, live)
    q, k = q.to(dev, torch.bfloat16), k.to(dev, torch.bfloat16)
    onehot = torch.nn.functional.one_hot(labels, o).float().to(dev)
    b = prepare_ref(k, onehot)
    got = global_matching_prepared(q, b)
    want = global_matching_prepared_plain(q, b)
    torch.cuda.synchronize()
    err, share = check_outputs("global matching", got, want, live, TOL_GLOBAL)
    ms = time_ms(lambda: global_matching_prepared(q, b))
    plain_ms = time_ms(lambda: global_matching_prepared_plain(q, b))
    kt = k.T.contiguous()
    library_ms = time_ms(lambda: torch.matmul(q, kt))
    n_rows = int((b.src_idx >= 0).sum())       # labelled reference pixels
    b_ms, b_by = bound(2.0 * nq * n_rows * c, H100_BF16_FLOPS,
                       nbytes(q, b.neg2pixels, b.sqnorm, b.block_obj, got))
    log(f"[kernels] global_matching  Nq={nq} Nk={nk} (labelled {n_rows}) "
        f"C={c} O={o} bf16: {share:.3f} of live-object outputs below 0.99 "
        f"(min {MIN_UNSATURATED}), max|err|={err:.3g} (tol {TOL_GLOBAL}: f32 "
        f"accumulation in another order, in the tensor cores); kernel "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms, cross-term GEMM only "
        f"(torch.matmul bf16) {library_ms:.3f} ms, bound {b_ms:.3f} ms by "
        f"{b_by}")
    return dict(name="global_matching", route="cuda",
                source="cvpr2020_manet_tpu_torch/csrc/global_matching.cu",
                replaces="cvpr2020_manet_tpu/ops/matching_pallas.py:274",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


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


def main_path(dev, model_cfg, image_size=(480, 854), n_frames=16,
              rounds=3):
    """A model through the Evaluator's session loop (the flagship in
    `main`)."""
    from cvpr2020_manet_tpu_torch.config import Config, EvalConfig
    from cvpr2020_manet_tpu_torch.data import SyntheticDataset
    from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
    from cvpr2020_manet_tpu_torch.interactive.session import InteractiveSession
    from cvpr2020_manet_tpu_torch.kernels import build
    from cvpr2020_manet_tpu_torch.models import MANet

    cfg = Config(model=model_cfg, eval=EvalConfig(
        image_size=image_size, max_interactions=rounds))
    t0 = time.perf_counter()
    model = MANet(cfg.model, device=dev, seed=0)
    ev = Evaluator(cfg, model, device=dev)
    ds = SyntheticDataset(image_size=cfg.eval.image_size, num_frames=n_frames,
                          num_objects=2, num_sequences=1, scribble_sets=1)
    log(f"[main] model on {dev} in {time.perf_counter() - t0:.2f} s "
        f"({sum(p.numel() for p in model.parameters())} params)")
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
        log(f"[main] round {r}: {dt * 1e3:.1f} ms wall, "
            f"{n_frames / dt:.1f} frames/s")
    log(f"[main] encoder (start_sequence, {n_frames} frames): "
        f"{encode_s[0] * 1e3:.1f} ms; session {wall:.2f} s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"AUC {summary['auc']:.6f}, J&F@60s "
        f"{summary['metric_at_threshold']:.6f}")
    log(f"[main] launches: {launches} over {n_rounds} rounds "
        f"(per round: global {launches['global_matching'] / n_rounds:g}, "
        f"local {launches['local_matching'] / n_rounds:g})")
    require(n_rounds == rounds, f"{n_rounds} rounds ran, {rounds} expected")
    require(launches["global_matching"] == n_rounds,
            f"global matching launches {launches}")
    require(launches["local_matching"] == (n_frames - 1) * n_rounds,
            f"local matching launches {launches}")
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
    kernels = [kernel_global(dev, 15, (120, 216), 100, 128, 4),
               kernel_local(dev, (60, 108), 100, 128, 4, 15),
               kernel_global_argmin(dev, (104, 104), 100, 128, 9),
               kernel_local_argmin(dev, (52, 52), 100, 128, 9, 15)]
    tiny_round_reference()

    # [4] main path: the flagship model at 480p; launches over its 3 rounds
    from cvpr2020_manet_tpu_torch.config import ModelConfig
    launches = main_path(dev, ModelConfig())

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
