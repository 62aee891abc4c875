"""Training throughput of the port's trainers, stage 1 or stage 2: the
counterpart of the JAX package's `scripts/bench_train.py`.

    python -m cvpr2020_manet_tpu_torch.bench_train --stage 1 --batch 2 \\
        --crop 256 --steps 6 [--pipelined [--prefetch]] [--uint8] [--cpu]

Prints one JSON line {"metric": "train_stageN_clips_per_sec", ...}: the
JAX script's keys, and "device" (the card's name, or "cpu"). The timing
includes the host-to-device upload of each batch (the trainer's operating
point) but not the making of the synthetic batches: two are built
beforehand and alternated. A synchronous step reads its metrics as
floats, so it waits for the card. `--pipelined` runs every step with
`train_step(batch, sync=False)`, and the timed window ends when the last
step's metrics are read, which waits for the card once. `--prefetch`
(with `--pipelined`) feeds the batches through
`engine/prefetch.prefetch_to_device`. The steps launch kernels 4 and 5
(the argmin matching kernels, `ops/trainable.py`).

Runs on the card, and raises without CUDA unless `--cpu` is given (the
kernels' plain versions, figures labelled "cpu").
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from cvpr2020_manet_tpu_torch.config import Config, tiny_test_config
from cvpr2020_manet_tpu_torch.device import synchronize, tool_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--stage", type=int, choices=(1, 2), default=1)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--crop", type=int, default=256)
    p.add_argument("--steps", type=int, default=6, help="timed steps")
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--stage2_rounds", type=int, default=None)
    p.add_argument("--num_objects", type=int, default=2)
    p.add_argument("--tiny", action="store_true",
                   help="tiny_test_config() instead of the flagship Config()")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain versions of the kernels)")
    p.add_argument("--pipelined", action="store_true",
                   help="no per-step metrics read (train_step(sync=False)): "
                        "the host queues the next step while the card runs")
    p.add_argument("--prefetch", action="store_true",
                   help="with --pipelined: upload batches ahead on a side "
                        "stream (engine/prefetch.py)")
    p.add_argument("--uint8", action="store_true",
                   help="uint8 batches, normalized on the device "
                        "(ingest_batch): 4x fewer upload bytes")
    args = p.parse_args(argv)
    dev, device_name = tool_device(args.cpu)

    from cvpr2020_manet_tpu_torch.engine.train_stage1 import (
        Trainer, synthetic_batch)
    from cvpr2020_manet_tpu_torch.engine.train_stage2 import Stage2Trainer
    base = tiny_test_config() if args.tiny else Config()
    train_kw = {"batch_size": args.batch, "crop_size": (args.crop, args.crop)}
    if args.stage2_rounds is not None:
        train_kw["stage2_rounds"] = args.stage2_rounds
    cfg = dataclasses.replace(
        base, train=dataclasses.replace(base.train, **train_kw))
    trainer = (Trainer if args.stage == 1 else Stage2Trainer)(cfg, device=dev)

    rng = np.random.default_rng(0)
    batches = [synthetic_batch(cfg, rng, num_objects=args.num_objects,
                               random_entry=args.stage == 2,
                               as_uint8=args.uint8)
               for _ in range(2)]

    if args.pipelined:
        stream = (batches[i % 2] for i in range(args.warmup + args.steps))
        if args.prefetch:
            from cvpr2020_manet_tpu_torch.engine.prefetch import (
                prefetch_to_device)
            stream = prefetch_to_device(stream, dev)
        for _ in range(args.warmup):
            trainer.train_step(next(stream), sync=False)
        synchronize(dev)
        t0 = time.perf_counter()
        for batch in stream:
            metrics = trainer.train_step(batch, sync=False)
        metrics = {k: float(v) for k, v in metrics.items()}  # waits
        dt = (time.perf_counter() - t0) / args.steps
    else:
        for i in range(args.warmup):
            trainer.train_step(batches[i % 2])
        t0 = time.perf_counter()
        for i in range(args.steps):
            metrics = trainer.train_step(batches[i % 2])  # floats: waits
        dt = (time.perf_counter() - t0) / args.steps

    print(json.dumps({
        "metric": f"train_stage{args.stage}_clips_per_sec",
        "value": args.batch / dt,
        "unit": "clips/s",
        "ms_per_step": 1000 * dt,
        "batch": args.batch,
        "crop": args.crop,
        "stage2_rounds": cfg.train.stage2_rounds if args.stage == 2 else None,
        "pipelined": args.pipelined,
        "uint8": args.uint8,
        "devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
        "final_loss": metrics["loss"],
        "device": device_name,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
