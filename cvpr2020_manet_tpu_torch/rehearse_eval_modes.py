"""DAVIS-val-scale dress rehearsal of the eval CLI's modes, PyTorch port of
the JAX package's `scripts/rehearse_eval_modes.py`.

Runs the fake-DAVIS val-scale session (`data/fake_davis.py`) through the
port's `engine/eval_davis` CLI, each leg in its own process:

  1. default     — uninterrupted baseline (the equality reference for
                   leg 2)
  2. resume      — same config, `kill -9`'d mid-session after >= N item
                   checkpoints, restarted with --resume; the final
                   report's metric rows must EQUAL leg 1's (timing differs)
  3. stacked     — --matching_memory stacked (live-page bucketing x the
                   104-frame bucket x 8 rounds)
  4. int8        — --matching_int8 (kernel 3; round p50s at val scale)

    python -m cvpr2020_manet_tpu_torch.rehearse_eval_modes \\
        --root out/fake_davis [--checkpoint out/rel] \\
        [--legs default,resume,stacked,int8] [--rounds 8] [--out DIR]

The tree is written first if `--root` holds none. Prints one JSON line
per leg (the CLI's line: AUC, per-bucket p50s; plus the leg's wall) and a
final summary line; exits 1 if any leg fails or the resumed report
differs. The CLI runs on `cuda` (it has no device flag, as in JAX).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

from cvpr2020_manet_tpu_torch.interactive.session import read_report_csv

METRIC_COLS = ["sequence", "scribble_idx", "interaction", "object_id",
               "frame", "jaccard", "contour"]
LEG_FLAGS = {
    "default": [],
    "stacked": ["--matching_memory", "stacked"],
    "int8": ["--matching_int8"],
}
POLL_S = 0.1


def _cli(root, report, rounds, extra=(), checkpoint=None) -> list[str]:
    """The eval CLI's command line for one leg."""
    cmd = [sys.executable, "-m", "cvpr2020_manet_tpu_torch.engine.eval_davis",
           "--davis_root", root, "--rounds", str(rounds),
           "--report", report] + list(extra)
    if checkpoint:
        cmd += ["--checkpoint", checkpoint]
    return cmd


def _items_in_csv(report) -> int:
    """Completed (sequence, scribble set) items in a report checkpoint (the
    CLI replaces it atomically after each item)."""
    try:
        rows = read_report_csv(report)
    except (OSError, ValueError):
        return 0
    return len({(r["sequence"], r["scribble_idx"]) for r in rows})


def _metric_rows(report) -> list[tuple]:
    """The report's metric columns, rows sorted, scores to 10 decimals."""
    rows = [tuple(round(r[c], 10) if isinstance(r[c], float) else r[c]
                  for c in METRIC_COLS) for r in read_report_csv(report)]
    return sorted(rows)


def _run_leg(name, cmd, log_path):
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=log, text=True)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(f"[{name}] FAILED rc={proc.returncode}; stderr tail:",
              file=sys.stderr)
        with open(log_path) as f:
            print("".join(f.readlines()[-20:]), file=sys.stderr)
        return None, wall
    line = proc.stdout.strip().splitlines()[-1]
    return json.loads(line), wall


def _kill_after(cmd, report, n_items, log_path) -> int | None:
    """Start `cmd`; SIGKILL it once `report` holds `n_items` completed
    items. -> the items at the kill, or None if the run ended first."""
    with open(log_path, "w") as lf:
        child = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=lf)
    try:
        deadline = time.monotonic() + 3600
        while time.monotonic() < deadline and child.poll() is None:
            n = _items_in_csv(report)
            if n >= n_items:
                child.send_signal(signal.SIGKILL)
                child.wait(60)
                return n
            time.sleep(POLL_S)
        return None
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(60)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True, help="fake-DAVIS tree "
                   "(written here by data/fake_davis.py if missing)")
    p.add_argument("--rounds", type=int, default=8)
    p.add_argument("--legs", default="default,resume,stacked,int8")
    p.add_argument("--checkpoint", default=None,
                   help="release dir (seeded random weights otherwise: "
                        "latency, memory and resume do not depend on them)")
    p.add_argument("--out", default="out/rehearsal")
    p.add_argument("--kill_after_items", type=int, default=3,
                   help="resume leg: SIGKILL once this many items are "
                        "checkpointed (15 items in all at val scale)")
    p.add_argument("--cli_extra", default="",
                   help="extra args appended to every eval_davis leg "
                        "(smoke tests: '--tiny --max_frames 4 ...')")
    args = p.parse_args(argv)
    extra_common = args.cli_extra.split()

    os.makedirs(args.out, exist_ok=True)
    if not os.path.isdir(os.path.join(args.root, "JPEGImages")):
        from cvpr2020_manet_tpu_torch.data import fake_davis
        print(f"generating fake-DAVIS tree at {args.root}", flush=True)
        t0 = time.perf_counter()
        fake_davis.write_tree(args.root)
        print(f"tree written in {time.perf_counter() - t0:.1f} s",
              flush=True)

    legs = [s.strip() for s in args.legs.split(",") if s.strip()]
    results, failed = {}, []
    for leg in legs:
        report = os.path.join(args.out, f"report_{leg}.csv")
        log = os.path.join(args.out, f"{leg}.stderr")
        if leg not in LEG_FLAGS and leg != "resume":
            print(f"unknown leg {leg!r}", file=sys.stderr)
            failed.append(leg)
            continue
        if leg == "resume" and "default" not in results:
            print("[resume] needs the default leg first", file=sys.stderr)
            failed.append(leg)
            continue
        if os.path.exists(report):
            os.remove(report)
        flags = ["--resume"] if leg == "resume" else LEG_FLAGS[leg]
        cmd = _cli(args.root, report, args.rounds, flags + extra_common,
                   args.checkpoint)
        killed_at = None
        if leg == "resume":
            print(f"[resume] launch + kill -9 after {args.kill_after_items} "
                  f"items", flush=True)
            killed_at = _kill_after(
                cmd, report, args.kill_after_items,
                os.path.join(args.out, "resume_killed.stderr"))
            if killed_at is None:
                print("[resume] kill window missed (run finished first?) "
                      "— still exercising the restart path", flush=True)
        else:
            print(f"[{leg}] {' '.join(cmd)}", flush=True)
        rec, wall = _run_leg(leg, cmd, log)
        if rec is None:
            failed.append(leg)
            continue
        rec.update(leg=leg, wall_s=round(wall, 1))
        if leg == "resume":
            equal = _metric_rows(os.path.join(
                args.out, "report_default.csv")) == _metric_rows(report)
            rec.update(killed_after_items=killed_at,
                       report_equals_uninterrupted=equal)
            if not equal:
                print("[resume] REPORT MISMATCH vs uninterrupted run",
                      file=sys.stderr)
                failed.append(leg)
        results[leg] = rec
        print(json.dumps(rec), flush=True)

    print(json.dumps({"summary": {k: {
        "auc": v.get("auc"), "wall_s": v.get("wall_s"),
        "p50_by_frame_bucket": v.get("p50_by_frame_bucket")}
        for k, v in results.items()}, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
