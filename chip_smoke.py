#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and nvcc. It
imports nothing of JAX. Phases (any failure exits non-zero):

1. device  — the card's name, and its name and power limit from nvidia-smi;
2. build   — nvcc builds every kernel from `cvpr2020_manet_tpu_torch/csrc`;
3. kernels — each kernel against its plain PyTorch version at the main
             path's shapes and dtypes (max abs error vs a stated tolerance,
             median ms over CUDA events, the plain version's ms, the bound,
             and a library call's ms where one exists); then one tiny round
             on the card against the same round on the CPU;
4. main    — the flagship ModelConfig() (ResNet-101, bf16, random weights
             from a seed) through `Evaluator.run_session` on a synthetic
             480p sequence of 16 frames, 2 objects, 3 rounds; the launch
             counters, reset just before, must show 1 global- and 15
             local-matching launches per round;
5. result  — one JSON line of the kernels, the nvidia-smi line, and the
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

    k = torch.zeros(nk, c)
    k[:, :c_real] = EMBED_SCALE * torch.randn(nk, c_real, generator=g)
    labels = torch.randint(0, live, (nk,), generator=g)
    choice = torch.stack([
        rows[torch.randint(len(rows), (nq,), generator=g)]
        for rows in ((labels == obj).nonzero()[:, 0] for obj in range(live))],
        dim=1)
    q = mixed_queries(k, choice, g, c_real)
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

    k = torch.zeros(h, w, c)
    k[..., :c_real] = EMBED_SCALE * torch.randn(h, w, c_real, generator=g)
    labels = torch.randint(0, live, (h, w), generator=g)
    # per query pixel, the first pixel of each live object among 8 random
    # ones in its window (-1 where an object is not among them)
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
    q = mixed_queries(k.reshape(h * w, c), choice, g, c_real).reshape(h, w, c)
    q, k = q.to(dev), k.to(dev)
    onehot = torch.nn.functional.one_hot(labels, o).float().to(dev)
    inputs = prepare_local(q, k, onehot)
    got = local_matching_prepared(*inputs, window)
    want = local_matching_prepared_plain(*inputs, window)
    torch.cuda.synchronize()
    err, share = check_outputs("local matching", got, want, live, TOL_LOCAL)
    ms = time_ms(lambda: local_matching_prepared(*inputs, window))
    plain_ms = time_ms(lambda: local_matching_prepared_plain(*inputs, window))
    # in-image (query, key) pairs of the window
    span = lambda n: sum(min(n - 1, i + window) - max(0, i - window) + 1
                         for i in range(n))
    pairs = span(h) * span(w)
    b_ms, b_by = bound(2.0 * pairs * c, H100_F32_FLOPS, nbytes(*inputs, got))
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

    # [3] kernels at the main path's shapes, and a tiny round vs the CPU
    kernels = [kernel_global(dev, 15, (120, 216), 100, 128, 4),
               kernel_local(dev, (60, 108), 100, 128, 4, 15)]
    tiny_round_reference()

    # [4] main path: the flagship model at 480p
    from cvpr2020_manet_tpu_torch.config import ModelConfig
    launches = main_path(dev, ModelConfig())
    for k in kernels:
        k["launches"] = launches[k["name"]]

    # [5] result
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
