"""The readings that a cell's limits are set from.

    python3 manet_bench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, in one process: the cell's set-up and a window of
`--seconds` at its own load, then the check twice over the same sample:
the program's answers against the reference (the lower readings), and
the control's, the reference one step below the configuration's
precision put in the program's place (the upper readings). One JSON line
a seed. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from manet_bench import common  # noqa: E402


def readings(cell: str, seed: int, seconds: float, device,
             bench_dir: str = common.BENCH_DIR) -> dict:
    """{"program": numbers, "control": numbers} of one seed."""
    wl = common.load_json("workloads", cell, bench_dir)
    config = common.load_json("configs", wl["config"], bench_dir)
    driver = common.load_module("traffic", wl["traffic"]["driver"], bench_dir)
    traffic = driver.Traffic(common.Cell(cell, wl, config, seed, device))
    traffic.setup()
    log = traffic.window(seconds)
    traffic.free_program()
    return traffic.check(log, control=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    common.cache_env()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        out = readings(args.workload, seed, args.seconds, torch.device("cuda"))
        print(json.dumps({"workload": args.workload, "seed": seed, **out}),
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
