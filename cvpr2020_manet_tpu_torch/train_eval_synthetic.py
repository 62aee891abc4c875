"""End-to-end quality smoke: train tiny stage 1 on synthetic clips, then
run the interactive protocol and compare AUC and J&F@last against the
untrained model. PyTorch port of the JAX package's
`scripts/train_eval_synthetic.py`, on the pieces of
`train_eval_flagship.py`.

    python -m cvpr2020_manet_tpu_torch.train_eval_synthetic --steps 300 \\
        [--device cpu]

The exit code is 1 when training does not improve J&F@last.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

from cvpr2020_manet_tpu_torch.config import Config, tiny_test_config
from cvpr2020_manet_tpu_torch.data import SyntheticDataset
from cvpr2020_manet_tpu_torch.device import resolve_device
from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
from cvpr2020_manet_tpu_torch.engine.train_stage1 import Trainer
from cvpr2020_manet_tpu_torch.train_eval_flagship import (
    production_model, run_protocol, train)


def evaluate(cfg: Config, model, device, rounds: int = 3
             ) -> tuple[float, float]:
    """-> (AUC, J&F at the last round: the mean of its rows' J and of
    their F, averaged) over 2 synthetic sequences of 2 objects."""
    ds = SyntheticDataset(image_size=cfg.eval.image_size,
                          num_frames=cfg.eval.max_frames,
                          num_sequences=2, num_objects=2, scribble_sets=1,
                          seed=123)
    summary, rows = run_protocol(Evaluator(cfg, model, device=device), ds,
                                 rounds)
    last = max(r["interaction"] for r in rows)
    at_last = [r for r in rows if r["interaction"] == last]
    jf_last = 0.5 * (np.mean([r["jaccard"] for r in at_last])
                     + np.mean([r["contour"] for r in at_last]))
    return summary["auc"], float(jf_last)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--device", default="cuda",
                   help="torch device (the CPU only when asked for)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = tiny_test_config()
    # size the poly-LR schedule to this run (tiny config defaults to 10)
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, total_steps=args.steps,
                                       base_lr=2e-2))
    trainer = Trainer(cfg, device=device)
    auc0, jf0 = evaluate(cfg, production_model(
        cfg, trainer.model.state_dict(), device), device)
    print(f"untrained: AUC={auc0:.3f} J&F@last={jf0:.3f}", flush=True)

    train(trainer, cfg, args.steps, np.random.default_rng(0), log_every=50)
    auc1, jf1 = evaluate(cfg, production_model(
        cfg, trainer.model.state_dict(), device), device)
    print(f"trained  : AUC={auc1:.3f} J&F@last={jf1:.3f}", flush=True)
    if jf1 <= jf0:
        print("WARNING: training did not improve interactive J&F")
        return 1
    print("OK: training improves interactive quality")
    return 0


if __name__ == "__main__":
    sys.exit(main())
