"""Where the serving paths' time goes on the GPU: a torch.profiler trace of
one step of the flagship model. It is the source of the per-layer
breakdowns in PERF.md ("Where the time goes").

    python -m cvpr2020_manet_tpu_torch.profile_round [--path round] \
        [--frames 16] [--out PATH]

Builds the flagship `ModelConfig()` with seeded random weights and traces
one step of a path (CPU + CUDA activities) after `WARM_STEPS` untraced
ones:

- `round`: one interactive round of a synthetic 480p sequence of
  `--frames` frames (`Evaluator.run_round`);
- `stream`: one 1080p `StreamingIVOS.observe` of a uint8 frame with the
  int8 matching backend, after 3 corrections (4 live memory pages);
- `batch`: one `BatchPropagator.propagate` of 4 clips x `--frames` frames
  at 480p, uint8 RGB, int8 matching.

Prints the step's wall time, the device-busy time (the sum of kernel
durations on the one stream) and idle share, the device time by layer
(kernel-name rules below) and the top kernels; with `--out`, writes the
same as JSON. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import numpy as np
import torch

# kernel-name substring -> layer; first match wins
LAYERS = (
    ("global_matching", "global matching kernel"),
    ("local_matching", "local matching kernel"),
    ("conv", "convolutions (cuDNN)"),
    ("xmma", "convolutions (cuDNN)"),
    ("cutlass", "convolutions (cuDNN)"),
    ("gemm", "matmul / convolutions"),
    ("group_norm", "group norm"),
    ("GroupNorm", "group norm"),
    ("RowwiseMoments", "group norm"),
    ("softmax", "softmax"),
    ("reduce", "reductions (argmax, min, sum)"),
    ("sort", "sort / bucketing"),
    ("Sort", "sort / bucketing"),
    ("scan", "sort / bucketing"),
    ("cat", "copies / cat / index"),
    ("index", "copies / cat / index"),
    ("copy", "copies / cat / index"),
    ("Memcpy", "copies / cat / index"),
    ("elementwise", "elementwise"),
)
WARM_STEPS = 2      # step 0 pays first-call costs; step 1 is steady state


def layer_of(name: str) -> str:
    for key, layer in LAYERS:
        if key in name:
            return layer
    return "other"


def round_step(cfg, frames: int):
    """-> (prepare, run): the robot's scribbles, then one interactive
    round at 480p on them."""
    from cvpr2020_manet_tpu_torch.data import SyntheticDataset
    from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
    from cvpr2020_manet_tpu_torch.interactive.robot import (
        InteractiveScribblesRobot)
    from cvpr2020_manet_tpu_torch.models import MANet
    ev = Evaluator(cfg, MANet(cfg.model, device="cuda", seed=0))
    ds = SyntheticDataset(image_size=cfg.eval.image_size, num_frames=frames,
                          num_objects=2, num_sequences=1, scribble_sets=1)
    seq = ds.sequences()[0]
    gt = ds.gt_masks(seq)
    n_obj = ds.num_objects(seq)
    st = ev.start_sequence(ds.images(seq), n_obj)
    robot = InteractiveScribblesRobot()
    masks = np.zeros_like(gt)
    scr = None

    def prepare():
        nonlocal scr
        scr = robot.interact(seq, masks, gt, n_obj).to_json()

    def run():
        nonlocal masks
        masks = ev.run_round(st, scr, gt.shape[1:], n_obj)
    return prepare, run


def stream_step(cfg):
    """-> (prepare, run): one 1080p int8 observe with 4 live pages."""
    import dataclasses
    from cvpr2020_manet_tpu_torch.data import SyntheticDataset
    from cvpr2020_manet_tpu_torch.engine.streaming import StreamingIVOS
    from cvpr2020_manet_tpu_torch.interactive.robot import (
        InteractiveScribblesRobot)
    from cvpr2020_manet_tpu_torch.models import MANet
    cfg = dataclasses.replace(cfg, eval=dataclasses.replace(
        cfg.eval, image_size=(1080, 1920)))
    s = StreamingIVOS(cfg, MANet(cfg.model, device="cuda", seed=0,
                                 matching_backend="int8"))
    ds = SyntheticDataset(image_size=cfg.eval.image_size, num_frames=4,
                          num_objects=2, num_sequences=1, scribble_sets=1)
    seq = ds.sequences()[0]
    gt = ds.gt_masks(seq)
    u8 = (np.clip(ds.images(seq), 0, 1) * 255).astype(np.uint8)
    robot = InteractiveScribblesRobot()
    s.reset(2)
    for f in range(3):
        pred = s.observe(u8[f])
        s.correct(robot.scribble_frame(pred, gt[f], 2, f, 4, seq).to_json())
    return (lambda: None), (lambda: s.observe(u8[3]))


def batch_step(cfg, frames: int, batch: int = 4):
    """-> (prepare, run): one batch of clips propagated at 480p."""
    from cvpr2020_manet_tpu_torch.data import SyntheticDataset
    from cvpr2020_manet_tpu_torch.engine.propagate_batch import (
        BatchPropagator)
    from cvpr2020_manet_tpu_torch.models import MANet
    prop = BatchPropagator(cfg, MANet(cfg.model, device="cuda", seed=0,
                                      matching_backend="int8"))
    h, w = (n + (-n) % cfg.eval.pad_to for n in cfg.eval.image_size)
    ds = SyntheticDataset(image_size=(h, w), num_frames=frames, num_objects=2,
                          num_sequences=batch, scribble_sets=1)
    seqs = ds.sequences()
    clips = np.stack([(np.clip(ds.images(q), 0, 1) * 255).astype(np.uint8)
                      for q in seqs])
    first = np.stack([ds.gt_masks(q)[0, ::4, ::4] for q in seqs])
    return (lambda: None), (lambda: prop.propagate(
        clips, first.astype(np.int32), np.full(batch, 2)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", choices=["round", "stream", "batch"],
                    default="round")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_round: needs a CUDA device")

    from cvpr2020_manet_tpu_torch.config import Config, EvalConfig, ModelConfig
    cfg = Config(model=ModelConfig(), eval=EvalConfig())
    prepare, run = {"round": lambda: round_step(cfg, args.frames),
                    "stream": lambda: stream_step(cfg),
                    "batch": lambda: batch_step(cfg, args.frames)}[args.path]()

    def timed():
        prepare()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    warm = [timed() for _ in range(WARM_STEPS)]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall = timed()

    per_kernel = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = evt.time_range.elapsed_us()
            per_kernel[evt.name][0] += us
            per_kernel[evt.name][1] += 1
    busy_ms = sum(v[0] for v in per_kernel.values()) / 1e3
    by_layer = defaultdict(float)
    for name, (us, _) in per_kernel.items():
        by_layer[layer_of(name)] += us / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    result = {
        "device": torch.cuda.get_device_name(0),
        "path": args.path,
        "frames": args.frames,
        "warm_step_ms": [w * 1e3 for w in warm],
        "step_ms": wall * 1e3,
        "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (wall * 1e3),
        "kernel_launches": sum(v[1] for v in per_kernel.values()),
        "by_layer_ms": dict(sorted(by_layer.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": n[:120], "ms": us / 1e3, "count": c}
                        for n, (us, c) in top],
    }
    print(f"[profile] {result['device']}: {args.path} step "
          f"{result['step_ms']:.2f} ms "
          f"wall, device busy {busy_ms:.2f} ms (idle share "
          f"{result['idle_share']:.3f}), {result['kernel_launches']} kernels")
    for layer, ms in result["by_layer_ms"].items():
        print(f"[profile]   {layer:32s} {ms:9.3f} ms")
    for k in result["top_kernels"]:
        print(f"[profile]   {k['ms']:9.3f} ms x{k['count']:<5d} {k['name']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
