"""Reference-style evaluation: the upstream `davisinteractive` loop as
upstream MANet's eval script writes it, PyTorch port of the JAX package's
`scripts/reference_style_eval.py`.

The protocol loop below is written only against
`cvpr2020_manet_tpu_torch.davisinteractive.*`, the port's copy of the
toolkit's API; the port's MANet gives the masks. Code that drives the
external toolkit moves here by its import prefix and its model
construction; the loop does not change. The port's DAVIS CLI
(`engine/eval_davis.py`) is the production path; this script shows the
shim.

    python -m cvpr2020_manet_tpu_torch.reference_style_eval \\
        --synthetic --rounds 2
    python -m cvpr2020_manet_tpu_torch.reference_style_eval \\
        --davis_root /data/DAVIS --checkpoint ckpts/release \\
        --report out/report.csv

It runs on `cuda` (no device flag, as the DAVIS CLI; the model is
`engine/eval_davis.build_evaluator`'s: seeded weights, or the release
export at `--checkpoint`). The last stdout line is one JSON object: auc,
jf_at_60s and rows (the report's row count).
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--davis_root", default=None)
    p.add_argument("--subset", default="val")
    p.add_argument("--synthetic", action="store_true",
                   help="tiny synthetic dataset + tiny model (smoke)")
    p.add_argument("--rounds", type=int, default=8)
    p.add_argument("--checkpoint", default=None,
                   help="release export directory (utils/checkpoint.py)")
    p.add_argument("--report", default=None, help="CSV path for the report")
    args = p.parse_args(argv)

    from cvpr2020_manet_tpu_torch.config import Config, tiny_test_config
    from cvpr2020_manet_tpu_torch.engine.eval_davis import build_evaluator
    from cvpr2020_manet_tpu_torch.interactive.session import (
        write_report_csv)

    # ---- model side (the only part migration changes) ----------------
    dataset = None
    if args.synthetic:
        from cvpr2020_manet_tpu_torch.data import SyntheticDataset
        cfg = tiny_test_config()
        dataset = SyntheticDataset(image_size=cfg.eval.image_size,
                                   num_frames=cfg.eval.max_frames,
                                   num_sequences=1, num_objects=2,
                                   scribble_sets=1)
    else:
        cfg = Config()
    evaluator = build_evaluator(cfg, checkpoint=args.checkpoint)
    states = {}   # one model state per (sequence, scribble-set) item

    # ---- protocol loop: upstream davisinteractive API, unmodified ----
    from cvpr2020_manet_tpu_torch.davisinteractive.session import (
        DavisInteractiveSession)

    with DavisInteractiveSession(davis_root=args.davis_root,
                                 subset=args.subset,
                                 dataset=dataset,
                                 max_nb_interactions=args.rounds) as sess:
        while sess.next():
            sequence, scribbles, _first = sess.get_scribbles(only_last=True)
            ds = sess.dataset
            key = sess.current
            if key not in states:
                images = ds.images(sequence)
                states[key] = (evaluator.start_sequence(
                    images, ds.num_objects(sequence)), images.shape[1:3])
            state, hw = states[key]
            masks = evaluator.run_round(state, scribbles, hw,
                                        ds.num_objects(sequence))
            sess.submit_masks(masks)

    report = sess.get_report()
    summary = sess.get_global_summary()
    if args.report:
        os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
        write_report_csv(report, args.report)
    print(json.dumps({
        "auc": round(float(summary["auc"]), 4),
        "jf_at_60s": round(float(summary["metric_at_threshold"]), 4),
        "rows": len(report),
    }))


if __name__ == "__main__":
    main()
