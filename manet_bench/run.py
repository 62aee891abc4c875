"""Run one cell of the benchmark of the MANet port (`cvpr2020_manet_tpu_torch`).

    python3 manet_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA devices as
the cell asks for. The run sets up (imports, the kernels built or loaded,
weights and inputs made on the device from the seed, every shape of the
cell's traffic warmed up), drives the traffic for `--seconds` (with
`--trace 1`, a slice of it untraced and again under the profiler), then
holds the answers against the plain reference and prints one JSON line:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer ones, as `BENCHMARK.json` lists
them), `device`, with `--trace 1` `breakdown`, and last `checks`, each
compared number beside its limit; the same numbers end standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from manet_bench import common  # noqa: E402


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(man: dict, cell: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, bench_dir: str = common.BENCH_DIR,
             log=print) -> dict:
    """One run of `cell`; -> the result line as a dict."""
    import torch

    from manet_bench.judge import verdict

    wl = common.load_json("workloads", cell, bench_dir)
    config = common.load_json("configs", wl["config"], bench_dir)
    driver = common.load_module("traffic", wl["traffic"]["driver"], bench_dir)
    c = common.Cell(cell, wl, config, seed, device)
    cuda = device.type == "cuda"
    t = common.now()
    if cuda:
        from cvpr2020_manet_tpu_torch.kernels import build
        build.build_all()
    traffic = driver.Traffic(c)
    parts = {"imports_s": t - t_start, "kernels_s": common.now() - t}
    traffic.setup()
    common.synchronize(device)
    setup_s = common.now() - t_start
    log("setup_s " + " ".join(f"{k} {v:.3f}" for k, v in
                              {**parts, **traffic.parts}.items()))
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    if trace:
        t = common.now()
        wlog, tr = traffic.traced()
        attempted = len(wlog.requests)
        log(f"traced slice and its reduction {common.now() - t:.1f} s: "
            f"{len(tr.dev_start)} device ops, {len(tr.rt_start)} launch "
            f"calls, {len(tr.op_name)} host ops")
        for m in common.cell_metrics(man, cell, "per_layer"):
            value = common.load_module("metrics", m["name"], bench_dir).read(tr)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        a, b = tr.window()
        busy = tr.busy_ns(a, b) / 1e9
    else:
        wlog = traffic.window(seconds)
        attempted = len(wlog.requests)
        values = dict(traffic.end_to_end(wlog), setup_s=setup_s)
        for m in common.cell_metrics(man, cell, "end_to_end"):
            if m["name"] in values:
                result["metrics"][m["name"]] = {"value": values[m["name"]],
                                                "unit": m["unit"]}
    common.synchronize(device)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    result["attempted"] = attempted + wlog.failed
    result["failed"] = wlog.failed
    result["device"] = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(0) if cuda else device.type,
        "count": wl["chips"], "memory_peak_bytes": peak}
    if trace:
        result["device"].update(busy_s=busy, window_s=(b - a) / 1e9)
        result["breakdown"] = tr.breakdown()
        tr = None
    traffic.free_program()
    t = common.now()
    numbers = traffic.check(wlog)["program"]
    log(f"check {common.now() - t:.1f} s: {json.dumps(numbers)}")
    ok, checks = verdict(numbers, wl["check"]["limits"])
    result["correct"] = ok and wlog.failed == 0
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    common.cache_env()
    import torch

    man = common.manifest()
    wl = common.load_json("workloads", args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    log(f"card: {_power_limit()}")
    result = run_cell(man, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda"), T_START,
                      log=log)
    found = common.forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {', '.join(found)}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
