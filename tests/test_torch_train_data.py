"""The trainers on real-data trees in the PyTorch port against the JAX
package, on the CPU: the device-side uint8 ingest, uint8 synthetic
batches, a stage-1 step on a uint8 DAVIS batch and a stage-2 step on padded
6-frame clips (weights bridged from the Flax init, held as
tests/test_torch_train.py holds the synthetic steps), and the CLIs on DAVIS
and YouTube-VOS trees: `--uint8 --grain`, `--init_from`, and
`propagate_batch --dataset ytvos`."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu.data.davis import DavisTrainDataset as JaxTrain
from cvpr2020_manet_tpu.engine import train_stage1 as js1
from cvpr2020_manet_tpu.engine import train_stage2 as js2
from cvpr2020_manet_tpu.models import MANet as JaxMANet
from cvpr2020_manet_tpu_torch.engine import propagate_batch as tpb
from cvpr2020_manet_tpu_torch.engine import train_stage1 as ts1
from cvpr2020_manet_tpu_torch.engine import train_stage2 as ts2
from cvpr2020_manet_tpu_torch.utils.checkpoint import CheckpointManager
from cvpr2020_manet_tpu_torch.weights import load_flax_params
from test_torch_train import (  # noqa: F401  (fixtures)
    LOSS_TOL, _assert_params_equal, _configs, _fake_scribbles_jax,
    _fake_scribbles_torch, _jax_state, _one_torch_thread, flax_params)

CPU = lambda device=None: torch.device("cpu")  # noqa: E731


def test_ingest_batch_equals_jax():
    """uint8 images -> normalized f32 and uint8 labels -> int32, bit for
    bit on the CPU; a float batch passes through unchanged."""
    rng = np.random.default_rng(0)
    batch = {"images": rng.integers(0, 256, (2, 3, 5, 7, 3), dtype=np.uint8),
             "labels": rng.integers(0, 4, (2, 3, 5, 7), dtype=np.uint8),
             "obj_valid": np.ones((2, 3), np.float32)}
    want = js1.ingest_batch({k: jnp.asarray(v) for k, v in batch.items()})
    got = ts1.ingest_batch({k: torch.from_numpy(v) for k, v in batch.items()})
    for key in batch:
        assert got[key].numpy().dtype == np.asarray(want[key]).dtype, key
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    floats = {"images": torch.zeros(1, 3, 4, 4, 3),
              "labels": torch.zeros(1, 3, 4, 4, dtype=torch.int32)}
    out = ts1.ingest_batch(floats)
    assert out["images"] is floats["images"]
    assert out["labels"] is floats["labels"]


def test_synthetic_batch_uint8_equals_jax():
    jcfg, tcfg = _configs()
    for kw in (dict(as_uint8=True, batch_size=3),
               dict(as_uint8=True, random_entry=True, num_objects=1)):
        want = js1.synthetic_batch(jcfg, np.random.default_rng(4), **kw)
        got = ts1.synthetic_batch(tcfg, np.random.default_rng(4), **kw)
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key])
    assert got["images"].dtype == np.uint8


def test_stage1_step_on_uint8_davis_batch_vs_jax(flax_params, davis_root):
    """Two stage-1 steps on uint8 DAVIS batches from JAX's sampler (the
    port's sampler gives the same arrays: tests/test_torch_davis_train.py):
    losses each step and parameters after, under test_torch_train.py's
    tolerances."""
    jcfg, tcfg = _configs(bootstrap_warmup_steps=2)
    ds = JaxTrain(davis_root, jcfg, seed=3, emit_uint8=True)
    batches = [ds.batch(2) for _ in range(2)]
    assert batches[0]["images"].dtype == np.uint8
    jmodel = JaxMANet(jcfg.model, matching_backend="jnp",
                      trainable_matching=True)
    jstep = jax.jit(js1.make_train_step(jmodel, jcfg))
    jstate = _jax_state(flax_params, jcfg)
    trainer = ts1.Trainer(tcfg, device="cpu")
    load_flax_params(trainer.model, flax_params)
    for batch in batches:
        jstate, want = jstep(jstate, batch)
        got = trainer.train_step(batch)
        for key in ("loss", "loss_prop", "loss_int"):
            np.testing.assert_allclose(got[key], float(want[key]),
                                       err_msg=key, **LOSS_TOL)
    _assert_params_equal(jstate.params, trainer.model)


def test_stage2_step_on_padded_clips_vs_jax(flax_params, davis_root,
                                            monkeypatch):
    """One stage-2 step on uint8 6-frame clips of the 4-frame fixture
    sequences (2 padded frames each, frame_valid 0), the strokes replaced
    by the same deterministic function in both packages: the padded frames
    are never annotated and carry no loss, and the loss and the parameters
    after the update equal JAX's."""
    monkeypatch.setattr(js2, "_synthesize_scribbles", _fake_scribbles_jax)
    monkeypatch.setattr(ts2, "_synthesize_scribbles", _fake_scribbles_torch)
    jcfg, tcfg = _configs()
    batch = JaxTrain(davis_root, jcfg, clip_len=6, seed=4,
                     emit_uint8=True).batch(2)
    assert batch["frame_valid"].tolist() == [[1, 1, 1, 1, 0, 0]] * 2
    jmodel = JaxMANet(jcfg.model, matching_backend="jnp",
                      trainable_matching=True)
    jstate, want = jax.jit(js2.make_train_step(jmodel, jcfg))(
        _jax_state(flax_params, jcfg), batch, jax.random.PRNGKey(0))
    trainer = ts2.Stage2Trainer(tcfg, device="cpu")
    load_flax_params(trainer.model, flax_params)
    got = trainer.train_step(batch)
    np.testing.assert_allclose(got["loss"], float(want["loss"]), **LOSS_TOL)
    _assert_params_equal(jstate.params, trainer.model)


def test_trainer_clis_on_davis_and_ytvos_trees(davis_root, tmp_path,
                                               monkeypatch, capsys):
    """Stage 1 on the DAVIS tree with `--uint8 --grain` (in-process), then
    stage 2 from its snapshot (`--init_from`) on a YouTube-VOS tree at
    `--clip_len 6`: at step 0 its parameters are the snapshot's and its
    optimizer is fresh; then a step trains."""
    from _torch_davis_tree import write_ytvos_tree

    monkeypatch.setattr(ts1, "resolve_device", CPU)
    monkeypatch.setattr(ts2, "resolve_device", CPU)
    snap1, snap2 = str(tmp_path / "s1"), str(tmp_path / "s2")
    ts1.main(["--tiny", "--davis_root", davis_root, "--uint8", "--grain",
              "--grain_workers", "0", "--steps", "2", "--snapshot_dir",
              snap1])
    assert "step 0: loss=" in capsys.readouterr().out
    assert CheckpointManager(snap1).latest_step() == 2

    yt = str(tmp_path / "yt")
    write_ytvos_tree(yt, (64, 96), [("v1", 4, 2, 0), ("v2", 3, 1, 1)])
    ts2.main(["--tiny", "--ytvos_root", yt, "--clip_len", "6", "--uint8",
              "--init_from", snap1, "--steps", "0", "--snapshot_dir", snap2])
    assert "initialized from stage-1 step 2" in capsys.readouterr().out
    s1 = torch.load(f"{snap1}/2/state.pt", weights_only=True)
    s2 = torch.load(f"{snap2}/0/state.pt", weights_only=True)
    assert s2["step"] == 0 and s2["optimizer"]["state"] == {}
    for key, value in s1["model"].items():
        assert torch.equal(s2["model"][key], value), key
    ts2.main(["--tiny", "--ytvos_root", yt, "--clip_len", "6",
              "--init_from", snap1, "--steps", "1", "--sim_rounds", "2"])
    out = capsys.readouterr().out
    assert "initialized from stage-1 step 2" in out and "step 0: loss=" in out


def test_cli_flags_that_raise(davis_root, monkeypatch):
    """`--grain` needs a dataset; multi-process training is not ported
    and says where it is queued."""
    monkeypatch.setattr(ts1, "resolve_device", CPU)
    with pytest.raises(ValueError, match="--grain"):
        ts1.main(["--tiny", "--grain", "--steps", "1"])
    for flags in (["--distributed"], ["--num_processes", "2"],
                  ["--coordinator", "localhost:1234"], ["--process_id", "0"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ts1.main(["--tiny", "--steps", "1", *flags])
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ts2.main(["--tiny", "--steps", "1", *flags])


def test_propagate_batch_cli_on_ytvos(tmp_path, monkeypatch, capsys):
    from _torch_davis_tree import write_ytvos_tree

    yt = str(tmp_path / "yt")
    write_ytvos_tree(yt, (64, 96), [("v1", 4, 2, 0), ("v2", 5, 1, 1)])
    monkeypatch.setattr(tpb, "resolve_device", CPU)
    tpb.main(["--tiny", "--dataset", "ytvos", "--data_root", yt,
              "--batch", "1", "--frames", "4", "--timed_batches", "1",
              "--image_size", "64", "96"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "batched_propagation_fps" and rec["value"] > 0
    assert rec["image_size"] == [64, 96] and rec["timed_batches"] == 1
