"""Data-parallel training of the PyTorch port (`parallel/distributed.py`,
the trainers' all-reduce), on the CPU over Gloo.

The real thing, not a mock, as `tests/test_distributed.py` runs the JAX
package: 2 CPU processes (tests/_torch_dist_worker.py) join a Gloo group
on a free localhost port and run stage-1 and stage-2 steps, each on its
own half of the global batch. Both ranks report the same loss and
bitwise-equal parameters after every step, and they equal one process
training on the whole batch to `tests/test_torch_train.py`'s tolerances
(losses rtol 1e-4, parameters atol 1e-5: the gradient is summed in
another order). Stage 2 equals too: every rank draws the strokes' seeds
of the whole global batch and takes its slice, so no sample's draw
depends on its place in the local batch (the worst frame is an argmin).
"""

import json
import os

import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu_torch.config import tiny_test_config
from cvpr2020_manet_tpu_torch.engine import train_stage1, train_stage2
from cvpr2020_manet_tpu_torch.parallel import distributed

from _torch_dist_worker import free_port, run_ranks

LOSS_TOL = dict(rtol=1e-4, atol=0)
PARAM_TOL = dict(rtol=0, atol=1e-5)
GLOBAL_BATCH = 4


def _records(out: str) -> list[dict]:
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny single-process references run faster on one intra-op
    thread, and the parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------- one process, no group


def test_local_batch_size(monkeypatch):
    assert distributed.local_batch_size(4) == 4
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    assert distributed.local_batch_size(4) == 2
    with pytest.raises(ValueError, match="not divisible"):
        distributed.local_batch_size(3)


@pytest.fixture
def recorded_init(monkeypatch):
    """`initialize` with the group join recorded instead of made."""
    for k in ("MANET_COORDINATOR", "MANET_NUM_PROCESSES", "MANET_PROCESS_ID",
              "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    calls = []
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda backend, **kw: calls.append(dict(
                            kw, backend=backend)))
    monkeypatch.setattr(distributed.dist, "get_rank",
                        lambda *a: calls[-1]["rank"])
    monkeypatch.setattr(distributed.dist, "get_world_size",
                        lambda *a: calls[-1]["world_size"])
    return calls


def test_initialize_resolves_args_then_env(recorded_init, monkeypatch):
    """Explicit arguments win over the MANET_* variables, which win over a
    single process; a CPU rank defaults to Gloo and a named backend is
    passed through as it is."""
    monkeypatch.setenv("MANET_COORDINATOR", "envhost:1234")
    monkeypatch.setenv("MANET_NUM_PROCESSES", "3")
    monkeypatch.setenv("MANET_PROCESS_ID", "2")
    assert distributed.initialize(device="cpu") == (2, 3)
    assert recorded_init[-1] == dict(
        init_method="tcp://envhost:1234", rank=2, world_size=3,
        backend="gloo")
    assert distributed.initialize("host:5", 2, 1, device="cpu") == (1, 2)
    assert recorded_init[-1]["init_method"] == "tcp://host:5"
    distributed.initialize("host:5", 2, 0, backend="nccl", device="cpu")
    assert recorded_init[-1]["backend"] == "nccl"
    # a group of one needs no coordinator: a free localhost port
    for k in ("MANET_COORDINATOR", "MANET_PROCESS_ID"):
        monkeypatch.delenv(k)
    assert distributed.initialize(num_processes=1, device="cpu") == (0, 1)
    assert recorded_init[-1]["init_method"].startswith("tcp://127.0.0.1:")


def test_initialize_raises_without_cuda(recorded_init, monkeypatch):
    """A rank defaults to the card, and without one raises instead of
    joining on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed.initialize("host:5", 2, 0)
    assert recorded_init == []


def test_initialize_refuses_silent_fallback(recorded_init, monkeypatch):
    """One of several processes (WORLD_SIZE or MANET_NUM_PROCESSES > 1)
    that cannot join a group raises instead of training as rank 0 of 1;
    with no such evidence it is a single process."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="refusing"):
        distributed.initialize(device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed.initialize(device="cpu") == (0, 1)
    monkeypatch.setenv("MANET_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="coordinator"):
        distributed.initialize(device="cpu")
    with pytest.raises(RuntimeError, match="MANET_PROCESS_ID"):
        distributed.initialize("host:5", device="cpu")
    assert recorded_init == []


# ------------------------------------------------------ two Gloo processes


def _single_process_params(stage: int, steps: int):
    """One process on the whole global batches the workers split; -> (its
    losses, its parameters)."""
    import dataclasses
    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=GLOBAL_BATCH))
    cls = train_stage1.Trainer if stage == 1 else train_stage2.Stage2Trainer
    trainer = cls(cfg, device="cpu")
    seed0 = 1000 if stage == 1 else 2000
    losses = [trainer.train_step(train_stage1.synthetic_batch(
        cfg, np.random.default_rng(seed0 + i)))["loss"]
        for i in range(steps)]
    return losses, trainer.model.state_dict()


@pytest.fixture(scope="module")
def two_rank_job(tmp_path_factory):
    """2 Gloo CPU ranks: 2 stage-1 steps, a snapshot saved by rank 0 and
    restored by both, 1 stage-2 step; -> (records per rank, out dir)."""
    out = tmp_path_factory.mktemp("dist")
    spec = dict(world=2, device="cpu", mode="train", tiny=True,
                batch=GLOBAL_BATCH, steps1=2, steps2=1, out=str(out),
                snapshot=str(out / "snap"))
    outs = run_ranks([dict(spec, rank=r) for r in range(2)])
    return [_records(o) for o in outs], out


def _per_stage(records, stage):
    return [r for r in records if r.get("stage") == stage and r["step"] >= 0]


def test_two_ranks_start_equal_and_stay_bitwise_equal(two_rank_job):
    """Both ranks draw the same weights from the seed on the CPU, and after
    every step report the same loss and bitwise-equal parameters, though
    each trained on its own half of the batch."""
    (r0, r1), _ = two_rank_job
    assert r0[0]["step"] == -1 and r0[0]["hash"] == r1[0]["hash"]
    for stage in (1, 2):
        a, b = _per_stage(r0, stage), _per_stage(r1, stage)
        assert len(a) == len(b) == (2 if stage == 1 else 1)
        for x, y in zip(a, b):
            assert x["batch_local"] == GLOBAL_BATCH // 2
            assert x["loss"] == y["loss"] and np.isfinite(x["loss"])
            assert x["hash"] == y["hash"]


def test_two_ranks_snapshot_restores_on_every_rank(two_rank_job):
    """Rank 0 saves behind a barrier; both ranks restore the same state,
    equal to the one they trained."""
    (r0, r1), _ = two_rank_job
    trained = _per_stage(r0, 1)[-1]["hash"]
    for records in (r0, r1):
        restored = [r for r in records if "restore_hash" in r]
        assert restored == [{"restored_step": 2, "restore_hash": trained}]


@pytest.mark.parametrize("stage", [1, 2])
def test_two_ranks_equal_one_process_on_the_full_batch(two_rank_job, stage):
    """The 2-rank steps equal one process's steps on the concatenated
    batch: losses at LOSS_TOL, parameters at PARAM_TOL."""
    (r0, _), out = two_rank_job
    steps = 2 if stage == 1 else 1
    losses, params = _single_process_params(stage, steps)
    np.testing.assert_allclose([r["loss"] for r in _per_stage(r0, stage)],
                               losses, **LOSS_TOL)
    got = torch.load(out / f"stage{stage}.pt", weights_only=True)
    assert set(got) == set(params)
    for k, v in params.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k,
                                   **PARAM_TOL)


# ---------------------------------------------------------------- the CLIs


def test_cli_two_ranks_then_stage2_from_the_snapshot(tmp_path):
    """Both trainers' CLIs with --distributed --coordinator --num_processes
    --process_id: stage 1 for 2 steps on 2 ranks (each its own shard of
    the synthetic clips), snapshot and log written once (by rank 0); then
    stage 2 on 2 ranks --init_from that snapshot."""
    snap, logs = tmp_path / "s1", tmp_path / "logs"

    def specs(cli, argv):
        return [dict(mode="cli", cli=cli, device="cpu", argv=argv + [
            "--distributed", "--coordinator", "127.0.0.1:{port}",
            "--num_processes", "2", "--process_id", str(r)]) for r in (0, 1)]

    def run(cli, argv):
        port = free_port()
        return run_ranks([dict(s, argv=[a.format(port=port) for a in
                                        s["argv"]]) for s in specs(cli, argv)])

    common = ["--tiny", "--synthetic", "--batch", "4", "--steps", "2"]
    run("stage1", common + ["--snapshot_dir", str(snap), "--log_dir",
                            str(logs)])
    assert sorted(os.listdir(snap)) == ["2"]
    # the loop logs every log_every // 10 steps: step 0 here, once
    lines = (logs / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["step"] for line in lines] == [0]
    outs = run("stage2", common[:-1] + ["1", "--init_from", str(snap)])
    assert all("initialized from stage-1 step 2" in o for o in outs)


def test_cli_one_rank_group_resumes(tmp_path, monkeypatch):
    """--distributed --num_processes 1 joins a one-rank Gloo group in this
    process (no coordinator needed), trains, snapshots, leaves the group;
    a second run resumes from the snapshot."""
    import torch.distributed as dist
    cpu = lambda device=None: torch.device("cpu")  # noqa: E731
    for module in (distributed, train_stage1):
        monkeypatch.setattr(module, "resolve_device", cpu)
    snap = str(tmp_path / "s")
    argv = ["--tiny", "--synthetic", "--steps", "1", "--distributed",
            "--num_processes", "1", "--snapshot_dir", snap]
    train_stage1.main(argv)
    assert not dist.is_initialized()
    train_stage1.main(argv)
    assert not dist.is_initialized()
    assert sorted(os.listdir(snap)) == ["1", "2"]
