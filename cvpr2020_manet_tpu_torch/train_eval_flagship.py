"""Flagship-scale synthetic train -> release -> interactive eval on the
card, PyTorch port of the JAX package's `scripts/train_eval_flagship.py`.

The production-scale end-to-end proof:
  stage-1 train (full ResNet-101, production dims)
  -> stage-2 train (multi-round interaction sim, MA gate under training)
  -> optional release export (`utils/checkpoint.export_release`)
  -> 8-round interactive protocol at 480p on a NON-SATURATING task:
     objects ENTER MID-SEQUENCE (SyntheticDataset entry_frames), so an
     early annotated frame cannot segment them — multi-round correction
     and the cross-round matching/MA memory retaining it are structurally
     necessary, and the per-round curve cannot saturate at round 0.
  -> metrics come out of the production path: InteractiveSession ->
     submit_masks -> get_report() / get_global_summary() (AUC, J&F@60s).
  -> optional --ablate leg re-runs the protocol with the cross-round
     memories disabled (Evaluator ablate_memory) to quantify the MA
     contribution on the same task.

    python -m cvpr2020_manet_tpu_torch.train_eval_flagship --steps1 600 \\
        --steps2 300 --sequences 4 --objects 3 --ablate --release out/rel
    python -m cvpr2020_manet_tpu_torch.train_eval_flagship \\
        --eval_release out/rel [--matching_int8]

The last stdout line is one JSON object with the JAX script's keys; the
exit code is 1 when the last round's J&F does not beat the first's.
AUC and J&F@60s read the J&F curve on the session's clock (model and
robot seconds), so they depend on how fast the rounds run as well as on
the masks. `--tiny` runs the tiny config (a logic smoke; `--device cpu`
runs it on the CPU).

The functions below are the pieces: `train` (either trainer's loop on
synthetic batches), `start_stage2`, `production_model`, `run_protocol`,
`per_round_jf`; `train_eval_synthetic.py` and the port's quality gate
compose them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time

import numpy as np
import torch

from cvpr2020_manet_tpu_torch.config import (
    Config, EvalConfig, tiny_test_config)
from cvpr2020_manet_tpu_torch.data import SyntheticDataset
from cvpr2020_manet_tpu_torch.device import resolve_device
from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
from cvpr2020_manet_tpu_torch.engine.train_stage1 import (
    Trainer, synthetic_batch)
from cvpr2020_manet_tpu_torch.engine.train_stage2 import Stage2Trainer
from cvpr2020_manet_tpu_torch.interactive.session import (
    InteractiveSession, compensated_mean)
from cvpr2020_manet_tpu_torch.models import MANet
from cvpr2020_manet_tpu_torch.utils.checkpoint import (
    export_release, load_release)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--steps1", type=int, default=600,
                   help="stage-1 training steps")
    p.add_argument("--steps2", type=int, default=300,
                   help="stage-2 training steps (0 = skip the stage-2 leg)")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--crop", type=int, default=256)
    p.add_argument("--crop2", type=int, default=192,
                   help="stage-2 crop (the multi-round simulation holds "
                        "R x F full activation sets)")
    p.add_argument("--rounds2", type=int, default=2,
                   help="simulated rounds per stage-2 sample")
    p.add_argument("--rounds", type=int, default=8)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--sequences", type=int, default=4)
    p.add_argument("--objects", type=int, default=3)
    p.add_argument("--sets", type=int, default=3,
                   help="initial scribble sets per sequence (DAVIS uses 3)")
    p.add_argument("--ablate", action="store_true",
                   help="also run the memory-ablated protocol (MA delta)")
    p.add_argument("--release", default=None,
                   help="export dir for the trained release checkpoint")
    p.add_argument("--eval_release", default=None,
                   help="skip training; load params from this release dir "
                        "and run the eval protocol only")
    p.add_argument("--gmap_refresh", type=float, default=0.0,
                   help="leaky min-fusion fraction (config.EvalConfig)")
    p.add_argument("--mask_stride", type=int, default=1,
                   help="mask readback stride (config.EvalConfig)")
    p.add_argument("--matching_int8", action="store_true",
                   help="eval leg uses the int8 global-matching backend "
                        "(serving mode, kernel 3)")
    p.add_argument("--device", default="cuda",
                   help="torch device (the CPU only when asked for)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model + tiny eval resolution (logic smoke; "
                        "NOT a flagship measurement)")
    return p.parse_args(argv)


def build_config(args) -> Config:
    """The flagship Config() (or the tiny one) with the run's train and
    eval overrides, as the JAX script builds it."""
    if args.tiny:
        base = tiny_test_config()
        cfg = dataclasses.replace(base, eval=dataclasses.replace(
            base.eval, max_frames=args.frames))
        crop = base.train.crop_size[0]
    else:
        cfg = Config(eval=EvalConfig(max_frames=args.frames))
        crop = args.crop
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, crop_size=(crop, crop), batch_size=args.batch,
        total_steps=args.steps1))
    if args.gmap_refresh > 0.0 or args.mask_stride != 1:
        cfg = dataclasses.replace(cfg, eval=dataclasses.replace(
            cfg.eval, gmap_refresh=args.gmap_refresh,
            mask_stride=args.mask_stride))
    return cfg


def train(trainer, cfg: Config, steps: int, rng: np.random.Generator, *,
          num_objects: int | None = None, random_entry: bool = False,
          name: str = "stage1", log_every: int = 100) -> dict:
    """`steps` optimizer steps of `trainer` (either stage) on
    `synthetic_batch(cfg, rng, ...)` batches. -> {"losses": every step's
    loss, "wall_s": the loop's wall (batches included), "step_ms": the
    median step after the first, "peak_gib": peak device memory on a
    card, else None}."""
    cuda = trainer.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(trainer.device)
        torch.cuda.reset_peak_memory_stats(trainer.device)
    losses, step_s = [], []
    t0 = time.perf_counter()
    for step in range(steps):
        batch = synthetic_batch(cfg, rng, num_objects=num_objects,
                                random_entry=random_entry)
        t = time.perf_counter()
        m = trainer.train_step(batch)         # host floats: synchronized
        step_s.append(time.perf_counter() - t)
        losses.append(m["loss"])
        if step % log_every == 0:
            print(f"{name} step {step}: loss={m['loss']:.4f}", flush=True)
    rec = {"losses": losses, "wall_s": time.perf_counter() - t0,
           "step_ms": 1e3 * statistics.median(step_s[1:] or step_s)
           if step_s else float("nan"),
           "peak_gib": (torch.cuda.max_memory_allocated(trainer.device)
                        / 2**30 if cuda else None)}
    peak = "" if rec["peak_gib"] is None else \
        f", peak device memory {rec['peak_gib']:.2f} GiB"
    print(f"{name}: {steps} steps in {rec['wall_s']:.0f}s, median step "
          f"{rec['step_ms']:.1f} ms (final loss "
          f"{losses[-1] if losses else float('nan'):.4f}){peak}", flush=True)
    return rec


def start_stage2(cfg2: Config, stage1_model: torch.nn.Module, device
                 ) -> Stage2Trainer:
    """A stage-2 trainer holding the stage-1 weights, copied into its
    model in place before its first step; its optimizer starts fresh (the
    JAX script's `state.replace(params=...)`)."""
    t2 = Stage2Trainer(cfg2, device=device)
    t2.model.load_state_dict(stage1_model.state_dict())
    return t2


def production_model(cfg: Config, state_dict, device,
                     matching_int8: bool = False) -> MANet:
    """The serving model (the plain eval kernels, not the trainers'
    argmin-routed ones) holding `state_dict`; both models have the same
    parameter names, and the load is strict."""
    model = MANet(cfg.model, device=device,
                  matching_backend="int8" if matching_int8 else "auto")
    model.load_state_dict(state_dict)
    return model


def per_round_jf(rows) -> list[float]:
    """Each interaction's mean J&F over the report rows, interactions in
    ascending order, each mean compensated over its rows in report order:
    the JAX script's `groupby("interaction").jf.mean()` without pandas."""
    by_round: dict[int, list[float]] = {}
    for r in rows:
        by_round.setdefault(r["interaction"], []).append(
            0.5 * (r["jaccard"] + r["contour"]))
    return [compensated_mean(v) for _, v in sorted(by_round.items())]


def run_protocol(ev: Evaluator, ds, rounds: int):
    """One interactive session of `rounds` rounds over `ds`. -> (the
    global summary, the report rows)."""
    sess = InteractiveSession(ds, max_interactions=rounds)
    summary = ev.run_session(sess)
    return summary, sess.get_report()


def eval_leg(args, cfg: Config, model: MANet, device
             ) -> tuple[dict, list[float]]:
    """The protocol (and with --ablate the memory-ablated one) on the
    eval task. -> (the JSON line's object with the JAX script's keys, the
    unrounded per-round J&F)."""
    # the non-saturating task: objects enter at staggered mid-sequence
    # frames — rounds whose annotated frame precedes an object's entry
    # cannot see it; later rounds must, and the memories must retain it
    entry = [int(i * args.frames / (args.objects + 1))
             for i in range(args.objects)]
    ds = SyntheticDataset(image_size=cfg.eval.image_size,
                          num_frames=args.frames,
                          num_sequences=args.sequences,
                          num_objects=args.objects,
                          scribble_sets=args.sets, seed=77,
                          entry_frames=entry)
    print(f"eval task: {args.sequences} seq x {args.sets} sets, "
          f"{args.objects} objects entering at frames {entry}, "
          f"gmap_refresh={cfg.eval.gmap_refresh}", flush=True)
    ev = Evaluator(cfg, model, device=device)
    summary, rows = run_protocol(ev, ds, args.rounds)
    per_round = per_round_jf(rows)
    out = {
        "per_round_jf": [round(x, 3) for x in per_round],
        "auc": round(summary["auc"], 3),
        "jf_at_60s": round(float(summary["metric_at_threshold"]), 3),
        "p50_round_ms": round(1000 * float(np.median(ev.round_latencies)),
                              0),
        "entry_frames": entry,
    }
    if args.ablate:
        ev_ab = Evaluator(cfg, model, device=device, ablate_memory=True)
        summary_ab, rows_ab = run_protocol(ev_ab, ds, args.rounds)
        out["ablate_per_round_jf"] = [round(x, 3)
                                      for x in per_round_jf(rows_ab)]
        out["ablate_auc"] = round(summary_ab["auc"], 3)
        out["memory_auc_delta"] = round(out["auc"] - out["ablate_auc"], 3)
    return out, per_round


def run(args) -> tuple[dict, list[float], dict]:
    """Train (unless --eval_release), export, evaluate. -> (the JSON
    line's object, the unrounded per-round J&F, each training stage's
    record from `train`)."""
    device = resolve_device(args.device)
    cfg = build_config(args)
    int8 = args.matching_int8
    if args.eval_release:
        model = MANet(cfg.model, device=device,
                      matching_backend="int8" if int8 else "auto")
        model.load_state_dict(load_release(model.state_dict(),
                                           args.eval_release))
        print(f"eval-only: params from {args.eval_release}", flush=True)
        out, per_round = eval_leg(args, cfg, model, device)
        return out, per_round, {}

    stages = {}
    trainer = Trainer(cfg, device=device)
    rng = np.random.default_rng(0)
    stages["stage1"] = train(trainer, cfg, args.steps1, rng,
                             num_objects=args.objects, random_entry=True)
    if args.steps2 > 0:
        cfg2 = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, total_steps=args.steps2,
            crop_size=(args.crop2, args.crop2), stage2_rounds=args.rounds2))
        t2 = start_stage2(cfg2, trainer.model, device)
        del trainer                # its activations and optimizer go first
        trainer = t2
        stages["stage2"] = train(trainer, cfg2, args.steps2, rng,
                                 num_objects=args.objects, random_entry=True,
                                 name="stage2")
    params = trainer.model.state_dict()
    if args.release:
        export_release(params, args.release)
        print(f"release exported to {args.release}", flush=True)
    # evaluate with the production model (plain eval kernels, not the
    # trainer's argmin variants): same weights, same masks, and the round
    # latency matches what eval_davis ships
    model = production_model(cfg, params, device, int8)
    del trainer, params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out, per_round = eval_leg(args, cfg, model, device)
    return out, per_round, stages


def main(argv=None) -> int:
    out, per_round, _ = run(parse_args(argv))
    first, last = per_round[0], per_round[-1]
    rc = int(last <= first)
    print("WARNING: rounds did not improve J&F" if rc else
          f"OK: rounds improve J&F {first:.3f} -> {last:.3f}")
    print(json.dumps(out))
    return rc


if __name__ == "__main__":
    sys.exit(main())
