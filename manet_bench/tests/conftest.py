"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's folder
with a tiny configuration and tiny versions of every cell, run with
`device="cpu"` (the kernels' plain versions)."""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import shutil
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

from manet_bench import common  # noqa: E402

SEED = 2 ** 31 + 12345          # seeds may pass 32 signed bits


def tiny_config(backend="auto") -> dict:
    from cvpr2020_manet_tpu_torch.config import TrainConfig, tiny_test_config
    m = dataclasses.asdict(tiny_test_config().model)
    m.update(local_downsample=2, local_window=3)
    t = dataclasses.asdict(TrainConfig(crop_size=(64, 64), batch_size=2))
    return {"source": "tiny_test_config", "model": m,
            "matching_backend": backend,
            "eval": {"image_size": [64, 96], "max_frames": 8,
                     "frame_buckets": [4, 8]}, "train": t, "reduced": []}


def tiny_workload(cell: str, config: str) -> dict:
    wl = common.load_json("workloads", cell)
    wl = copy.deepcopy(wl)
    wl["config"] = config
    t = wl["traffic"]
    if t["driver"] == "interactive_rounds":
        t.update(videos=[{"name": "a", "frames": 5, "objects": 1},
                         {"name": "b", "frames": 8, "objects": 2}],
                 rounds_per_session=3, trace_sessions=1)
    elif t["driver"] == "live_stream":
        t.update(pool_frames=8, trace_frames=4)
        wl["check"].update(sample_from_first=8, sample_frames=3)
    else:
        t.update(pool_batches=2, checked_steps=2, trace_steps=1)
    return wl


CELLS = ("davis480_rounds", "stream1080_int8", "train_stage1_416")


@pytest.fixture
def bench(tmp_path):
    """(bench_dir, manifest): the benchmark's folder copied, with
    `tiny_<cell>` beside every cell, on a tiny configuration; the
    manifest lists the tiny cells wherever it lists the real ones."""
    d = tmp_path / "manet_bench"
    shutil.copytree(common.BENCH_DIR, d,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = common.manifest()
    for cell in CELLS:
        real = common.load_json("workloads", cell)
        name = f"tiny_{real['config']}"
        backend = common.load_json("configs", real["config"]).get(
            "matching_backend", "auto")
        (d / "configs" / f"{name}.json").write_text(
            json.dumps(tiny_config(backend=backend)))
        (d / "workloads" / f"tiny_{cell}.json").write_text(
            json.dumps(tiny_workload(cell, name)))
        for m in man["end_to_end"] + man["per_layer"]:
            if cell in m.get("workloads", ()):
                m["workloads"].append(f"tiny_{cell}")
    return str(d), man


@pytest.fixture
def run_tiny(bench):
    """run_tiny(cell, trace=False, seconds=1.0, seed=SEED) -> the result
    line of one CPU run of a tiny cell."""
    from manet_bench.run import run_cell
    bench_dir, man = bench

    def run(cell, trace=False, seconds=1.0, seed=SEED):
        return run_cell(man, cell, seed, seconds, trace, torch.device("cpu"),
                        common.now(), bench_dir=bench_dir, log=lambda m: None)

    return run


@pytest.fixture
def card():
    """The card, or a skip: tests of the card decide here, never at
    import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
