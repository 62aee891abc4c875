"""The port's train -> release -> eval entry points (`train_eval_flagship.py`,
`train_eval_synthetic.py`) on the CPU, against the JAX package's pieces as
`scripts/train_eval_flagship.py` composes them.

Both runs start from the JAX `Trainer(cfg)` init, bridged into the port
(`weights.load_flax_params`), and take the same synthetic batches. Stage
2's random strokes are replaced in both packages by the same deterministic
function (as in `tests/test_torch_train.py::test_stage2_step_vs_jax`): the
packages draw them from different generators. AUC reads the J&F curve on
the session's clock, and JAX's first round holds its compile time, so both
sessions run on the same counter clock here (every read a quarter second
later): AUC then compares the quality curves alone.

Tolerances: losses per step to rtol 1e-4 (`LOSS_TOL`, as in
`tests/test_torch_train.py`); per-round J&F and AUC to 2e-3 absolute.
Largest errors seen: losses 7.6e-08 relative (stage 1; stage 2 0);
per-round J&F and AUC 0 in the default leg, 4.4e-05 in the ablated leg.
"""

import dataclasses
import functools
import importlib.util
import itertools
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu.config import tiny_test_config as jax_tiny
from cvpr2020_manet_tpu.engine import train_stage1 as js1
from cvpr2020_manet_tpu.engine import train_stage2 as js2
from cvpr2020_manet_tpu.interactive import session as jsession
from cvpr2020_manet_tpu.models import MANet as JaxMANet
from cvpr2020_manet_tpu_torch import train_eval_flagship as tef
from cvpr2020_manet_tpu_torch import train_eval_synthetic as tes
from cvpr2020_manet_tpu_torch.engine import train_stage1 as ts1
from cvpr2020_manet_tpu_torch.engine import train_stage2 as ts2
from cvpr2020_manet_tpu_torch.weights import load_flax_params
from test_torch_train import (
    LOSS_TOL, _fake_scribbles_jax, _fake_scribbles_torch)

ROOT = pathlib.Path(__file__).resolve().parents[1]
JF_TOL = 2e-3
TINY = ["--tiny", "--device", "cpu", "--steps1", "3", "--steps2", "2",
        "--crop2", "32", "--frames", "4", "--objects", "2",
        "--sequences", "2", "--sets", "1", "--rounds", "3"]
ABLATE_KEYS = {"ablate_per_round_jf", "ablate_auc", "memory_auc_delta"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "train_eval_flagship_jax", ROOT / "scripts" / "train_eval_flagship.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_config(args):
    """The JAX script's config for --tiny (its `main`, lines 99-115)."""
    base = jax_tiny()
    cfg = dataclasses.replace(base, eval=dataclasses.replace(
        base.eval, max_frames=args.frames))
    crop = base.train.crop_size[0]
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, crop_size=(crop, crop), batch_size=args.batch,
        total_steps=args.steps1))


def _counter_clock(cls):
    """`cls` (either package's InteractiveSession) on a clock of its own
    that advances a quarter second a read."""
    def make(dataset, **kw):
        return cls(dataset, time_fn=functools.partial(
            next, itertools.count(0.0, 0.25)), **kw)
    return make


def _recording(module, seen):
    """`module.run_protocol`, recording each call's summary and per-round
    J&F unrounded."""
    real = module.run_protocol

    def run_protocol(ev, ds, rounds):
        summary, result = real(ev, ds, rounds)
        per_round = (tef.per_round_jf(result) if isinstance(result, list)
                     else result.tolist())
        seen.append((summary["auc"], per_round))
        return summary, result
    return run_protocol


def test_tiny_run_matches_jax_pieces(monkeypatch, capsys):
    """A --tiny --ablate run of the port's entry point (3 stage-1 and 2
    stage-2 steps, then both eval legs) against the same steps and legs
    through the JAX package: losses per step, per-round J&F and AUC of both
    legs, and the JSON line's keys and values."""
    monkeypatch.setattr(js2, "_synthesize_scribbles", _fake_scribbles_jax)
    monkeypatch.setattr(ts2, "_synthesize_scribbles", _fake_scribbles_torch)
    monkeypatch.setattr(jsession, "InteractiveSession",
                        _counter_clock(jsession.InteractiveSession))
    monkeypatch.setattr(tef, "InteractiveSession",
                        _counter_clock(tef.InteractiveSession))
    args = tef.parse_args(TINY + ["--ablate"])

    # the JAX side, as its script's main composes it
    script = _jax_script()
    jcfg = _jax_config(args)
    jtrainer = js1.Trainer(jcfg)
    init = jax.device_get(jtrainer.state.params)
    rng = np.random.default_rng(0)
    want_losses = {"stage1": [], "stage2": []}
    for _ in range(args.steps1):
        m = jtrainer.train_step(js1.synthetic_batch(
            jcfg, rng, num_objects=args.objects, random_entry=True))
        want_losses["stage1"].append(float(m["loss"]))
    jcfg2 = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, total_steps=args.steps2,
        crop_size=(args.crop2, args.crop2), stage2_rounds=args.rounds2))
    jt2 = js2.Stage2Trainer(jcfg2)
    jt2.state = jt2.state.replace(params=jtrainer.state.params)
    for _ in range(args.steps2):
        m = jt2.train_step(js1.synthetic_batch(
            jcfg2, rng, num_objects=args.objects, random_entry=True))
        want_losses["stage2"].append(float(m["loss"]))
    want_seen = []
    monkeypatch.setattr(script, "run_protocol",
                        _recording(script, want_seen))
    script._eval_leg(args, jcfg, JaxMANet(jcfg.model),
                     {"params": jax.device_get(jt2.state.params)})
    # its JSON line, then its verdict line
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-2])

    # the port's entry point, from the same initial weights
    def trainer_from_jax(cfg, device=None):
        trainer = ts1.Trainer(cfg, device=device)
        load_flax_params(trainer.model, init)
        return trainer
    monkeypatch.setattr(tef, "Trainer", trainer_from_jax)
    got_seen = []
    monkeypatch.setattr(tef, "run_protocol", _recording(tef, got_seen))
    out, per_round, stages = tef.run(args)

    for stage, losses in want_losses.items():
        np.testing.assert_allclose(stages[stage]["losses"], losses,
                                   err_msg=stage, **LOSS_TOL)
    assert len(got_seen) == len(want_seen) == 2        # default, ablated
    for (auc, jf), (want_auc, want_jf) in zip(got_seen, want_seen):
        assert len(jf) == args.rounds
        np.testing.assert_allclose(jf, want_jf, rtol=0, atol=JF_TOL)
        assert abs(auc - want_auc) <= JF_TOL
    assert per_round == got_seen[0][1]
    assert list(out) == list(want)
    assert out["entry_frames"] == want["entry_frames"]
    for key in ("per_round_jf", "ablate_per_round_jf", "auc", "ablate_auc",
                "jf_at_60s", "memory_auc_delta"):
        # values rounded to 3 decimals on both sides
        np.testing.assert_allclose(out[key], want[key], rtol=0,
                                   atol=JF_TOL + 1e-3, err_msg=key)


def test_release_then_eval_release_and_json_keys(tmp_path, capsys):
    """--release exports the trained weights; --eval_release evaluates
    them in a fresh call with the same per-round J&F. Without --ablate the
    JSON keys are JAX's less the three that JAX's `_eval_leg` adds under
    --ablate."""
    release = str(tmp_path / "rel")
    rc = tef.main(TINY + ["--release", release])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].startswith("WARNING" if rc else "OK")
    trained = json.loads(lines[-1])
    assert (tmp_path / "rel" / "params.pt").is_file()
    assert list(trained) == ["per_round_jf", "auc", "jf_at_60s",
                             "p50_round_ms", "entry_frames"]
    assert not ABLATE_KEYS & set(trained)
    rc2 = tef.main(TINY + ["--eval_release", release])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == f"eval-only: params from {release}"
    evaluated = json.loads(lines[-1])
    assert evaluated["per_round_jf"] == trained["per_round_jf"]
    assert evaluated["auc"] == pytest.approx(trained["auc"], abs=JF_TOL)
    assert rc2 == rc
    with pytest.raises(FileExistsError):
        tef.main(TINY + ["--release", release])


@pytest.mark.parametrize("per_round,rc", [([0.4, 0.5], 0), ([0.5, 0.4], 1),
                                          ([0.5, 0.5], 1)])
def test_exit_code_rule(monkeypatch, capsys, per_round, rc):
    """Exit 1 unless the last round's J&F beats the first's (JAX's rule);
    the verdict line comes before the JSON line, which stays last."""
    out = {"per_round_jf": per_round}
    monkeypatch.setattr(tef, "run", lambda args: (out, per_round, {}))
    assert tef.main(TINY) == rc
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("WARNING" if rc else "OK")
    assert json.loads(lines[-1]) == out


def test_train_eval_synthetic_on_cpu(capsys):
    """The tiny stage-1 quality smoke runs on the CPU and its exit code
    follows its J&F@last before and after training."""
    rc = tes.main(["--steps", "3", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    before = [s for s in lines if s.startswith("untrained")]
    after = [s for s in lines if s.startswith("trained")]
    assert len(before) == len(after) == 1
    jf0 = float(before[0].split("J&F@last=")[1])
    jf1 = float(after[0].split("J&F@last=")[1])
    assert lines[-1].startswith("WARNING" if rc else "OK")
    if abs(jf1 - jf0) > 1e-3:               # the log rounds to 3 decimals
        assert rc == int(jf1 <= jf0)
