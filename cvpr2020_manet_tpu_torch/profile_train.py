"""Where a training step's time goes on the GPU: one traced step of each
trainer at the flagship width, split into its forward, backward and
optimizer update. It is the source of the training breakdown in PERF.md
("Where the time goes").

    python -m cvpr2020_manet_tpu_torch.profile_train [--out PATH]

Stage 1 is `Trainer(Config())` (TrainConfig() defaults: crop 416, batch
8); stage 2 is `Stage2Trainer` at batch 2 (3 simulated rounds over 3-frame
clips), as `chip_smoke.py` runs them. Each trainer takes `WARM_STEPS`
untraced steps, then one step under torch.profiler (CPU + CUDA
activities), with a synchronise after each phase. Per phase it prints the
wall time, the device-busy time (the sum of kernel durations on the one
stream), the idle share and the device time by layer (the kernel-name
rules of `profile_round`, with cuDNN's backward kernels apart; forward
convolutions inside the backward phase are the checkpoint recompute).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from collections import defaultdict

import numpy as np
import torch

from cvpr2020_manet_tpu_torch.profile_round import layer_of

WARM_STEPS = 2      # the first step pays first-call costs
PHASES = ("forward", "backward", "optimizer")


def train_layer_of(name: str) -> str:
    if "dgrad" in name or "wgrad" in name:
        return "convolutions, backward (cuDNN)"
    return layer_of(name)


def profile_step(trainer, loss_fn, batch, *args) -> dict:
    """One traced step of `trainer` (forward `loss_fn(batch, step, *args)`)
    on a host batch: per phase, wall ms, device-busy ms, idle share, kernel
    count and device ms by layer."""
    from cvpr2020_manet_tpu_torch.engine.train_stage1 import to_device
    state = trainer.state
    dev_batch = to_device(batch, trainer.device)
    walls = {}

    def run(phase, fn):
        with torch.profiler.record_function(phase):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            walls[phase] = time.perf_counter() - t0
        return out

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        loss, _ = run("forward", lambda: loss_fn(dev_batch, state.step, *args))
        run("backward", loss.backward)
        run("optimizer", state.apply_gradients)

    # each kernel counts in the phase during which the CPU op that launched
    # it started (the autograd thread's ops included); the phase ranges
    # themselves are skipped, as their GPU-side annotation spans kernels
    cpu_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CPU]
    spans = {e.name: (e.time_range.start, e.time_range.end)
             for e in cpu_events if e.name in PHASES}
    busy = defaultdict(float)
    count = defaultdict(int)
    by_layer = {p: defaultdict(float) for p in PHASES}
    by_kernel = {p: defaultdict(float) for p in PHASES}
    for e in cpu_events:
        if e.name in PHASES or not e.kernels:
            continue
        phase = next((p for p, (lo, hi) in spans.items()
                      if lo <= e.time_range.start <= hi), None)
        if phase is None:
            continue
        for k in e.kernels:
            busy[phase] += k.duration / 1e3
            count[phase] += 1
            by_layer[phase][train_layer_of(k.name)] += k.duration / 1e3
            by_kernel[phase][k.name[:100]] += k.duration / 1e3
    top = lambda d, n: dict(sorted(d.items(), key=lambda kv: -kv[1])[:n])
    return {p: {"wall_ms": walls[p] * 1e3, "device_busy_ms": busy[p],
                "idle_share": 1.0 - busy[p] / (walls[p] * 1e3),
                "kernels": count[p],
                "by_layer_ms": top(by_layer[p], len(by_layer[p])),
                "top_kernels_ms": top(by_kernel[p], 8)}
            for p in PHASES}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA device")

    from cvpr2020_manet_tpu_torch.config import Config
    from cvpr2020_manet_tpu_torch.engine import train_stage1, train_stage2

    cfg1 = Config()
    cfg2 = dataclasses.replace(cfg1, train=dataclasses.replace(
        cfg1.train, batch_size=2))
    result = {"device": torch.cuda.get_device_name(0)}
    for name, module, trainer_cls, cfg in (
            ("stage1", train_stage1, train_stage1.Trainer, cfg1),
            ("stage2", train_stage2, train_stage2.Stage2Trainer, cfg2)):
        trainer = trainer_cls(cfg, device="cuda")
        rng = np.random.default_rng(cfg.train.seed)
        for _ in range(WARM_STEPS):
            trainer.train_step(train_stage1.synthetic_batch(cfg, rng))
        batch = train_stage1.synthetic_batch(cfg, rng)
        args_ = ()
        if name == "stage2":
            args_ = ([int(s) for s in np.random.default_rng(1).integers(
                1 << 62, size=cfg.train.batch_size)],)
        phases = profile_step(trainer, module.make_loss_fn(trainer.model, cfg),
                              batch, *args_)
        result[name] = {"batch": cfg.train.batch_size,
                        "crop": list(cfg.train.crop_size), **phases}
        total = sum(p["wall_ms"] for p in phases.values())
        print(f"[profile] {result['device']} {name}: batch "
              f"{cfg.train.batch_size}, step {total:.1f} ms wall")
        for phase, p in phases.items():
            print(f"[profile]  {phase}: {p['wall_ms']:.1f} ms wall, device "
                  f"busy {p['device_busy_ms']:.1f} ms (idle share "
                  f"{p['idle_share']:.3f}), {p['kernels']} kernels")
            for layer, ms in p["by_layer_ms"].items():
                print(f"[profile]    {layer:32s} {ms:9.3f} ms")
            for kernel, ms in p["top_kernels_ms"].items():
                print(f"[profile]      {ms:9.3f} ms  {kernel}")
        del trainer
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
