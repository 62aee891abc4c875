"""Streaming serving latency: `StreamingIVOS.observe` wall time a frame at a
given resolution with paged round memory, the counterpart of the JAX
package's `scripts/bench_streaming.py` (its config 5).

    python -m cvpr2020_manet_tpu_torch.bench_streaming \\
        [--image_size 1080 1920] [--frames 6] [--corrections 1] \\
        [--pages N] [--ingest rgb|yuv420] [--tiny] [--cpu]

The flagship model (seeded random weights, default matching backend:
kernel 1 on the f32 memory, kernel 2) serves a synthetic sequence of
uint8 frames (or their planar YUV 4:2:0 pairs, packed outside every timed
loop, as a video decoder delivers them). After a warm-up (an observe, the
corrections, an observe), each of `--frames` frames is observed
synchronously (upload, compute and mask download in series; the p50 is
the metric), then the same frames are issued back to back through
`observe_async`, each mask's download overlapping the later frames.

Prints one JSON line {"metric": "streaming_observe_p50_ms", ...}: the JAX
script's keys, and "device". Runs on the card, and raises without CUDA
unless `--cpu` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

from cvpr2020_manet_tpu_torch.config import Config, tiny_test_config
from cvpr2020_manet_tpu_torch.device import tool_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--image_size", type=int, nargs=2, default=(1080, 1920))
    p.add_argument("--frames", type=int, default=6, help="timed frames")
    p.add_argument("--corrections", type=int, default=1)
    p.add_argument("--pages", type=int, default=None,
                   help="matching-memory pages (eval.max_interactions)")
    p.add_argument("--num_objects", type=int, default=2)
    p.add_argument("--ingest", choices=["rgb", "yuv420"], default="rgb",
                   help="frame format: yuv420 sends the decoder's planar "
                        "(y, uv) pair, half the bytes of RGB")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    dev, device_name = tool_device(args.cpu)

    from cvpr2020_manet_tpu_torch.data import SyntheticDataset
    from cvpr2020_manet_tpu_torch.data.davis import (
        IMAGENET_MEAN, IMAGENET_STD)
    from cvpr2020_manet_tpu_torch.engine.streaming import StreamingIVOS
    from cvpr2020_manet_tpu_torch.models import MANet
    base = tiny_test_config() if args.tiny else Config()
    eval_kw = {"image_size": tuple(args.image_size)}
    if args.pages is not None:
        eval_kw["max_interactions"] = args.pages
    cfg = dataclasses.replace(
        base, eval=dataclasses.replace(base.eval, **eval_kw))
    model = MANet(cfg.model, device=dev, seed=0, matching_backend="auto")
    h, w = cfg.eval.image_size
    s = StreamingIVOS(cfg, model, device=dev)
    s.reset(num_objects=args.num_objects)

    ds = SyntheticDataset(image_size=(h, w), num_frames=args.frames + 2,
                          num_sequences=1, num_objects=args.num_objects,
                          scribble_sets=1)
    seq = ds.sequences()[0]
    frames = np.clip((ds.images(seq) * IMAGENET_STD + IMAGENET_MEAN) * 255.0,
                     0, 255).astype(np.uint8)
    if args.ingest == "yuv420":
        from cvpr2020_manet_tpu_torch.utils.ingest import rgb_to_yuv420_host
        ph, pw = h + h % 2, w + w % 2
        ys, uvs = rgb_to_yuv420_host(
            np.pad(frames, ((0, 0), (0, ph - h), (0, pw - w), (0, 0))))
        frames = [(ys[i], uvs[i]) for i in range(ys.shape[0])]
    n = len(frames)

    # warm-up: the first observe and correction pay first-call costs
    s.observe(frames[0])
    for _ in range(args.corrections):
        s.correct(ds.initial_scribbles(seq, 0).to_json())
    s.observe(frames[1])

    lat = []
    for i in range(args.frames):
        t0 = time.perf_counter()
        mask = s.observe(frames[(i + 2) % n])
        mask.sum()
        lat.append(time.perf_counter() - t0)

    futs = []
    t0 = time.perf_counter()
    for i in range(args.frames):
        futs.append(s.observe_async(frames[(i + 2) % n]))
    for f in futs:
        f.result().sum()
    pipe_ms = 1000 * (time.perf_counter() - t0) / args.frames

    p50 = float(np.median(lat))
    print(json.dumps({
        "metric": "streaming_observe_p50_ms",
        "value": 1000 * p50,
        "unit": "ms/frame",
        "image_size": [h, w],
        "memory_pages": s.capacity,
        "live_pages": s.live_pages(),
        "num_objects": args.num_objects,
        "mask_bits": s._bits,
        "fps": 1.0 / p50,
        "pipelined_ms_per_frame": pipe_ms,
        "pipelined_fps": 1000.0 / pipe_ms,
        "ingest": args.ingest,
        "device": device_name,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
