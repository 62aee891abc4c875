"""Pinned quality-regression gate of the PyTorch port, on the CPU: the JAX
package's `tests/test_quality_gate.py` with its recipe, its four tests and
their bounds, through the port's trainers and Evaluator.

Recipe (the JAX gate's): `tiny_test_config()` at base_lr 2e-2 and a
600-step poly-LR horizon; 600 stage-1 steps on `synthetic_batch(cfg, rng)`
from `default_rng(0)`; 100 stage-2 steps on the stage-1 weights, from the
same rng; then the 8-round protocol over 4 synthetic sequences of 2
objects. Both gates start from the same weights: the JAX `Trainer(cfg)`
init, bridged into the port (`weights.load_flax_params`). Training and
eval go through `train_eval_flagship.py`'s pieces (`train`,
`start_stage2`, `production_model`, `run_protocol`, `per_round_jf`).

The JAX gate's docstring reports J&F@last 0.76-0.81 on a CPU. This gate,
on a CPU with one torch thread: per-round J&F
0.781, 0.795, 0.794, 0.797, 0.789, 0.787, 0.796, 0.796; AUC 0.800, 0.793
at gmap_refresh 0.7; the fixture 78 s. AUC reads the J&F curve on the
session's clock: these rounds take milliseconds, so AUC stays close to
the J&F curve.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu.config import tiny_test_config as jax_tiny
from cvpr2020_manet_tpu.engine.train_stage1 import Trainer as JaxTrainer
from cvpr2020_manet_tpu_torch import train_eval_flagship as tef
from cvpr2020_manet_tpu_torch.config import tiny_test_config
from cvpr2020_manet_tpu_torch.data import SyntheticDataset
from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
from cvpr2020_manet_tpu_torch.engine.train_stage1 import Trainer
from cvpr2020_manet_tpu_torch.interactive.metrics import jaccard
from cvpr2020_manet_tpu_torch.interactive.robot import (
    InteractiveScribblesRobot)
from cvpr2020_manet_tpu_torch.weights import load_flax_params

S1_STEPS = 600
S2_STEPS = 100
JF_FLOOR = 0.45           # JAX gate: measured 0.76-0.81; untrained ~0.07


def _gate_config(cfg):
    return dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, total_steps=S1_STEPS,
                                       base_lr=2e-2))


def _eval_dataset(cfg, **kw):
    kw = dict(dict(num_frames=cfg.eval.max_frames, num_sequences=4,
                   num_objects=2, scribble_sets=1, seed=123), **kw)
    return SyntheticDataset(image_size=cfg.eval.image_size, **kw)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is faster than many, and it keeps
    the parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained_eval_report():
    cfg = _gate_config(tiny_test_config())
    init = jax.device_get(JaxTrainer(_gate_config(jax_tiny())).state.params)
    trainer = Trainer(cfg, device="cpu")
    load_flax_params(trainer.model, init)
    rng = np.random.default_rng(0)
    rec = tef.train(trainer, cfg, S1_STEPS, rng, log_every=S1_STEPS)
    assert np.isfinite(rec["losses"][-1])

    # stage 2 on top of the stage-1 weights (the reference's recipe)
    trainer2 = tef.start_stage2(cfg, trainer.model, "cpu")
    rec = tef.train(trainer2, cfg, S2_STEPS, rng, name="stage2",
                    log_every=S2_STEPS)
    assert np.isfinite(rec["losses"][-1])

    model = tef.production_model(cfg, trainer2.model.state_dict(), "cpu")
    summary, rows = tef.run_protocol(Evaluator(cfg, model, device="cpu"),
                                     _eval_dataset(cfg), 8)
    return summary, rows, (cfg, model)


def test_trained_quality_above_floor(trained_eval_report):
    summary, rows, _ = trained_eval_report
    last = max(r["interaction"] for r in rows)
    jf_last = np.mean([0.5 * (r["jaccard"] + r["contour"]) for r in rows
                       if r["interaction"] == last])
    assert jf_last >= JF_FLOOR, (
        f"J&F@last={jf_last:.3f} < {JF_FLOOR} — interactive quality "
        f"regressed (the JAX gate measures ~0.76-0.81 after both stages)")
    assert summary["auc"] >= 0.35, summary["auc"]


def test_rounds_do_not_degrade_and_some_round_improves(trained_eval_report):
    """The MANet multi-round claim, in its seed-stable form: with the MA
    gate stage-2-trained, accumulating corrections across rounds never
    materially hurts, and at least one corrective round matches the
    initial one."""
    _, rows, _ = trained_eval_report
    per_round = tef.per_round_jf(rows)
    first = per_round[0]
    later = np.mean(per_round[4:])
    best = max(per_round[1:])
    assert later >= first - 0.02, (
        f"accumulated corrections degrade quality: round0={first:.3f}, "
        f"rounds4+mean={later:.3f} ({np.round(per_round, 3).tolist()})")
    assert best >= first - 0.005, (
        f"no corrective round matches round 0: round0={first:.3f}, "
        f"best={best:.3f}")


def test_gmap_refresh_settings_within_band(trained_eval_report):
    """Both gmap_refresh settings: exact reference semantics (refresh=0)
    and the leaky setting (refresh=0.7) clear the floor and sit within a
    small band of each other."""
    summary0, _, (cfg, model) = trained_eval_report
    cfg7 = dataclasses.replace(
        cfg, eval=dataclasses.replace(cfg.eval, gmap_refresh=0.7))
    summary7, _ = tef.run_protocol(Evaluator(cfg7, model, device="cpu"),
                                   _eval_dataset(cfg7), 8)
    auc0, auc7 = summary0["auc"], summary7["auc"]
    assert auc7 >= 0.35, f"refresh=0.7 collapsed: AUC={auc7:.3f}"
    assert abs(auc7 - auc0) <= 0.08, (
        f"refresh settings diverged beyond the measured band: "
        f"refresh=0 AUC={auc0:.3f}, refresh=0.7 AUC={auc7:.3f}")


def test_reacquires_object_after_occlusion_gap(trained_eval_report):
    """Occlusion re-acquisition: an object that vanishes for 2 frames
    re-enters with no local-matching or prev-mask support; only the
    global matching against the annotated frame can recover it."""
    _, _, (cfg, model) = trained_eval_report
    cfg = dataclasses.replace(
        cfg, eval=dataclasses.replace(cfg.eval, max_frames=6))
    t = 6
    ds = _eval_dataset(cfg, num_frames=t, num_sequences=1, seed=7,
                       hidden_spans={1: (2, 4)})
    seq = ds.sequences()[0]
    gt = ds.gt_masks(seq)
    # the task is well-posed: object 2 visible before and after the gap
    assert all((gt[f] == 2).any() for f in (0, 1, 4, 5))
    assert not any((gt[f] == 2).any() for f in (2, 3))

    ev = Evaluator(cfg, model, device="cpu")
    state = ev.start_sequence(ds.images(seq), 2)
    robot = InteractiveScribblesRobot()
    # annotate frame 0 (pre-occlusion): re-acquisition at frame 4 can then
    # only come from global matching back to frame 0
    scr = robot.scribble_frame(np.zeros_like(gt[0]), gt[0], 2, 0, t, seq)
    masks = ev.run_round(state, scr.to_json(), gt.shape[1:], 2)

    j_post = np.mean([jaccard(masks[f] == 2, gt[f] == 2) for f in (4, 5)])
    assert j_post >= 0.35, (
        f"object not re-acquired after occlusion gap: J(post-gap)="
        f"{j_post:.3f} (global matching should recover it from frame 0)")
