"""Interactive DAVIS evaluation entry point (SURVEY.md L5 eval driver),
PyTorch port of the JAX package's `engine/eval_davis.py`.

DAVIS adapter -> InteractiveSession -> Evaluator, ending in the
time-vs-quality report (AUC, J&F@60s) and optional mask/report dumps:

    python -m cvpr2020_manet_tpu_torch.engine.eval_davis \\
        --davis_root /data/DAVIS --rounds 8 --report out/report.csv

It runs on `cuda` (no device flag, as in JAX); the model's weights are
seeded, so two runs without `--checkpoint` give the same masks. The last
stdout line is one JSON object: auc, jf_at_60s, p50_round_latency_s,
rounds_run and p50_by_frame_bucket.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

from cvpr2020_manet_tpu_torch.device import resolve_device


def build_evaluator(cfg, checkpoint: str | None = None,
                    context_parallel: int = 1,
                    matching_backend: str = "auto"):
    """The seeded model (weights from `seed=0`, or the release export at
    `checkpoint`) in an Evaluator on `resolve_device(None)`.
    `context_parallel > 1` shards the matching memory over a
    ('data'=1, 'context'=n) mesh: every visible card, or n members of the
    CPU when the device is the CPU."""
    from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
    from cvpr2020_manet_tpu_torch.models import MANet
    from cvpr2020_manet_tpu_torch.utils.checkpoint import load_release

    device = resolve_device(None)
    model = MANet(cfg.model, device=device, seed=0,
                  matching_backend=matching_backend)
    if checkpoint:
        model.load_state_dict(load_release(model.state_dict(), checkpoint))
    cp_mesh = None
    if context_parallel > 1:
        # matching-memory rows shard over 'context'; per-shard matching
        # combines with an all-gather-min (parallel/cp_matching.py)
        from cvpr2020_manet_tpu_torch.parallel.mesh import create_mesh
        members = (None if device.type == "cuda"
                   else [device] * context_parallel)
        cp_mesh = create_mesh(data=1, context=context_parallel,
                              devices=members)
    return Evaluator(cfg, model, device=device, cp_mesh=cp_mesh)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--davis_root", required=True)
    p.add_argument("--subset", default="val")
    p.add_argument("--rounds", type=int, default=8)
    p.add_argument("--scribble_sets", type=int, default=3)
    p.add_argument("--max_time", type=float, default=None,
                   help="per-item time budget in s, scaled by object count "
                        "(davisinteractive max_time semantics)")
    p.add_argument("--checkpoint", default=None,
                   help="release export directory (utils/checkpoint.py)")
    p.add_argument("--report", default=None, help="CSV path for the report")
    p.add_argument("--matching_int8", action="store_true",
                   help="int8 global matching (the serving mode, kernel 3)")
    p.add_argument("--resume", action="store_true",
                   help="resume an interrupted run from --report: the "
                        "report is checkpointed after EVERY completed "
                        "(sequence, scribble-set) item, and on restart "
                        "items already in the CSV are skipped (their rows "
                        "seed the final summary). Local sessions only.")
    p.add_argument("--save_masks", default=None,
                   help="dir for final-round masks as DAVIS indexed PNGs")
    # default None -> inherit from the base config (so --tiny stays
    # self-consistent: its eval shapes come from tiny_test_config)
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--image_size", type=int, nargs=2, default=None)
    p.add_argument("--matching_memory", default=None,
                   choices=["min_fused", "stacked"],
                   help="round-memory mode (config.EvalConfig)")
    p.add_argument("--mask_stride", type=int, default=None,
                   help="mask readback stride (config.EvalConfig): 2 "
                        "quarters the mask download")
    p.add_argument("--gmap_refresh", type=float, default=None,
                   help="leaky min-fusion fraction (config.EvalConfig); "
                        "0 = reference-exact hard min (default)")
    p.add_argument("--context_parallel", type=int, default=1,
                   help="shard the matching memory over this many devices "
                        "('context' mesh axis, all-gather-min combine); "
                        "pairs with --matching_memory stacked")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model config (smoke tests)")
    p.add_argument("--host", default=None,
                   help="http(s) URL of an interactive.service evaluation "
                        "server: scoring/robot run remotely, local DAVIS "
                        "supplies the frames (upstream remote mode)")
    return p


def _config(args):
    from cvpr2020_manet_tpu_torch.config import Config, tiny_test_config
    base = tiny_test_config() if args.tiny else Config()
    overrides = dict(max_interactions=args.rounds,
                     scribble_sets=args.scribble_sets,
                     max_time=args.max_time)
    for flag in ("max_frames", "matching_memory", "mask_stride",
                 "gmap_refresh"):
        if getattr(args, flag) is not None:
            overrides[flag] = getattr(args, flag)
    if args.image_size is not None:
        overrides["image_size"] = tuple(args.image_size)
    return dataclasses.replace(
        base, eval=dataclasses.replace(base.eval, **overrides),
        davis_root=args.davis_root)


def _local_session(args, ds):
    """The in-process session, with the --resume state read from and
    checkpointed to --report."""
    from cvpr2020_manet_tpu_torch.interactive.session import (
        InteractiveSession, read_report_csv, write_report_csv)
    skip_items, seed_rows, on_item_end = set(), None, None
    if args.resume:
        if not args.report:
            raise SystemExit("--resume needs --report (the CSV is the "
                             "resume state)")
        if os.path.exists(args.report):
            seed_rows = read_report_csv(args.report)
            # an item's rows are only written when the item FINISHES (see
            # on_item_end below), so presence in the CSV means complete
            skip_items = {(r["sequence"], r["scribble_idx"])
                          for r in seed_rows}
            print(f"resume: {len(skip_items)} completed items found in "
                  f"{args.report}", file=sys.stderr, flush=True)

        def on_item_end(seq, set_idx):
            # checkpoint the report after every completed item: temp +
            # rename, so a kill mid-write cannot corrupt the resume state
            os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
            tmp = args.report + ".tmp"
            write_report_csv(session.get_report(), tmp)
            os.replace(tmp, args.report)
    session = InteractiveSession(ds, max_interactions=args.rounds,
                                 max_time=args.max_time,
                                 skip_items=skip_items, seed_rows=seed_rows,
                                 on_item_end=on_item_end)
    return session


def main(argv=None):
    from cvpr2020_manet_tpu_torch.data.davis import DavisEvalDataset
    from cvpr2020_manet_tpu_torch.interactive.session import write_report_csv

    args = _parser().parse_args(argv)
    cfg = _config(args)
    ds = DavisEvalDataset(args.davis_root, subset=args.subset,
                          scribble_sets=args.scribble_sets)
    if args.matching_int8 and args.context_parallel > 1:
        raise SystemExit("--matching_int8 is single-device serving mode; "
                         "the context-parallel path shards f32 matching "
                         "(parallel/cp_matching.py) — drop one flag")
    evaluator = build_evaluator(
        cfg, args.checkpoint, context_parallel=args.context_parallel,
        matching_backend="int8" if args.matching_int8 else "auto")
    if args.host:
        if args.resume:
            raise SystemExit("--resume needs a local session (the remote "
                             "service owns the report) — drop --host")
        from cvpr2020_manet_tpu_torch.interactive.service import RemoteSession
        session = RemoteSession(args.host, max_nb_interactions=args.rounds,
                                max_time=args.max_time, images=ds)
    else:
        session = _local_session(args, ds)

    t_start = time.perf_counter()
    n_items = len(ds.sequences()) * args.scribble_sets

    save_fn = None
    if args.save_masks:
        from cvpr2020_manet_tpu_torch.utils.colormap import save_indexed_png

        def save_fn(seq, set_idx, round_idx, masks):
            # the final round overwrites earlier ones: the directory holds
            # the last-round masks in DAVIS layout
            d = os.path.join(args.save_masks, f"scribble{set_idx + 1}", seq)
            os.makedirs(d, exist_ok=True)
            for t in range(masks.shape[0]):
                save_indexed_png(os.path.join(d, f"{t:05d}.png"), masks[t])

    def on_masks(seq, set_idx, round_idx, masks):
        # per-round progress to stderr: a DAVIS-val session is hundreds of
        # rounds over tens of minutes (upstream davisinteractive logs each
        # interaction the same way)
        dt = evaluator.round_latencies[-1] if evaluator.round_latencies \
            else float("nan")
        print(f"[{time.perf_counter() - t_start:7.1f}s] {seq} set {set_idx} "
              f"round {round_idx}: {masks.shape[0]} frames in {dt:.2f}s "
              f"({n_items} items total)", file=sys.stderr, flush=True)
        if save_fn is not None:
            save_fn(seq, set_idx, round_idx, masks)

    summary = evaluator.run_session(session, on_masks=on_masks)

    if args.report:
        os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
        write_report_csv(session.get_report(), args.report)
    lat = np.asarray(evaluator.round_latencies)
    # per-frame-bucket p50: DAVIS val spans the 32/64/104 buckets and the
    # long-sequence rounds cost proportionally more
    per_bucket = {}
    for tb, _, dt in evaluator.round_records:
        per_bucket.setdefault(tb, []).append(dt)
    print(json.dumps({
        "auc": round(summary["auc"], 4),
        "jf_at_60s": round(summary["metric_at_threshold"], 4),
        "p50_round_latency_s": (round(float(np.median(lat)), 4)
                                if lat.size else None),
        "rounds_run": int(lat.size),
        "p50_by_frame_bucket": {
            str(tb): round(float(np.median(v)), 4)
            for tb, v in sorted(per_bucket.items())},
    }))
    if args.host:
        session.close()  # free the server-side session (report is in hand)


if __name__ == "__main__":
    main()
