"""Microbenchmark of one matching kernel at production shapes, the
counterpart of the JAX package's `scripts/bench_matching_kernel.py`.

    python -m cvpr2020_manet_tpu_torch.bench_matching_kernel \\
        [--nq 25920] [--nk 25920] [--objects 3] [--channels 128] \\
        [--iters 20] [--reps 5] [--int8 | --local] [--cpu]

Global matching (the eval round's hot loop): Nq query rows against Nk
reference rows bucketed by object once (`prepare_ref`), then
`global_matching_prepared`, kernel 1 on bf16; with `--int8` the float
query against the int8 reference (`prepare_ref_int8`,
`global_matching_prepared_int8`: kernel 3, which quantizes the query in
its prologue). `--local`: local matching (kernel 2) of a 120 x 216 frame
against its predecessor in a 31 x 31 window (window 15), on inputs
prepared once (`prepare_local`).

Each rep times `--iters` back-to-back calls with CUDA events (the host
queues them ahead of the card, so the host's work per call is left out
where the card is the slower side), after one warm call that builds and
loads the kernel; the best rep is the result, in ms a call and TFLOP/s.
The operations are counted as the JAX script counts them: 2 Nq K C for
global matching, K the bucketed key count with its padding rows (padded
blocks do real work), and 2 h w 31^2 C for local matching.

Prints the JAX script's lines (the label, one line a rep, then
"best: X ms/call, Y TFLOP/s"), then one JSON line
{"metric": "matching_kernel_ms_per_call", ...}. Runs on the card, and
raises without CUDA unless `--cpu` is given (the plain versions: the
harness, not a benchmark).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from cvpr2020_manet_tpu_torch.device import tool_device
from cvpr2020_manet_tpu_torch.utils.profiling import elapsed_ms

LOCAL_HW = (120, 216)      # 480p at stride 4
LOCAL_WINDOW = 15          # ModelConfig.local_window: a 31 x 31 window


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nq", type=int, default=25920)   # 480p stride 4: 120x216
    p.add_argument("--nk", type=int, default=25920)
    p.add_argument("--objects", type=int, default=3)  # bg + 2, typical DAVIS
    p.add_argument("--channels", type=int, default=128)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--local", action="store_true",
                   help="time the local-matching kernel instead")
    p.add_argument("--int8", action="store_true",
                   help="global matching on the int8 reference (kernel 3)")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain versions on the CPU (the harness, "
                        "not a benchmark)")
    args = p.parse_args(argv)
    if args.local and args.int8:
        raise SystemExit("--local has no int8 variant; drop one flag")
    dev, device_name = tool_device(args.cpu)

    g = torch.Generator().manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g).to(dev, dtype)

    if args.local:
        from cvpr2020_manet_tpu_torch.ops.local_matching_cuda import (
            local_matching_prepared, prepare_local)
        h, w = LOCAL_HW
        onehot = torch.randint(0, 2, (h, w, args.objects), generator=g)
        prepared = prepare_local(randn(h, w, args.channels,
                                       dtype=torch.bfloat16),
                                 randn(h, w, args.channels,
                                       dtype=torch.bfloat16),
                                 onehot.to(dev, torch.float32))

        def call():
            return local_matching_prepared(*prepared, LOCAL_WINDOW)

        side = 2 * LOCAL_WINDOW + 1
        flops_it = 2.0 * h * w * side * side * args.channels
        kernel = "local_matching"
        label = f"local_matching h{h} w{w} C{args.channels}"
    else:
        from cvpr2020_manet_tpu_torch.ops import global_matching_cuda as gm
        dtype = torch.float32 if args.int8 else torch.bfloat16
        q = randn(args.nq, args.channels, dtype=dtype)
        ref = randn(args.nk, args.channels, dtype=dtype)
        labels = torch.randint(0, args.objects, (args.nk,), generator=g)
        onehot = torch.nn.functional.one_hot(labels, args.objects).to(
            dev, torch.float32)
        if args.int8:
            bucketed = gm.prepare_ref_int8(ref, onehot)
            keys = bucketed.pixels.shape[0]

            def call():
                return gm.global_matching_prepared_int8(q, bucketed)
        else:
            bucketed = gm.prepare_ref(ref, onehot)
            keys = bucketed.neg2pixels.shape[0]

            def call():
                return gm.global_matching_prepared(q, bucketed)

        nkb, tk = bucketed.sqnorm.shape
        flops_it = 2.0 * args.nq * keys * args.channels
        kernel = "global_matching_int8" if args.int8 else "global_matching"
        label = (f"{kernel} nq{args.nq} nk{args.nk} o{args.objects} "
                 f"TK{tk} (nkb={nkb})")

    with torch.inference_mode():
        first_ms = elapsed_ms(call, 1, dev)
        print(f"{label}: first call (kernel build and load) "
              f"{first_ms / 1e3:.1f}s", flush=True)
        best = float("inf")
        for _ in range(args.reps):
            dt = elapsed_ms(call, args.iters, dev) / 1e3 / args.iters
            best = min(best, dt)
            print(f"  {dt * 1e3:.3f} ms/call  "
                  f"{flops_it / dt / 1e12:.1f} TFLOP/s", flush=True)
    print(f"best: {best * 1e3:.3f} ms/call, "
          f"{flops_it / best / 1e12:.1f} TFLOP/s")
    print(json.dumps({
        "metric": "matching_kernel_ms_per_call",
        "value": best * 1e3,
        "unit": "ms/call",
        "tflops": flops_it / best / 1e12,
        "kernel": kernel,
        "shape": label,
        "iters": args.iters,
        "reps": args.reps,
        "device": device_name,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
