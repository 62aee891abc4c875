"""The batch and protocol cells on the CPU at a tiny size: each cell's
set-up, window, traced slice and check; the check catching a broken
batch engine; and the readers of their metrics on hand-built traces (None
on a trace without the program's spans, as a program without them
gives)."""

from __future__ import annotations

import copy
import json

import numpy as np
import pytest
import torch

from manet_bench import common
from manet_bench.run import run_cell
from manet_bench.tests.conftest import SEED, tiny_config
from manet_bench.tracing import Trace

NEW = ("ytvos720_batch", "davis_eval_robot")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_new_workload(cell: str, config: str) -> dict:
    wl = copy.deepcopy(common.load_json("workloads", cell))
    wl["config"] = config
    t = wl["traffic"]
    if t["driver"] == "batch_propagation":
        # both object buckets (4 and 9), a clip padded to its batch's
        # length, a last batch of one clip
        t.update(batch=2, clips=[{"frames": 4, "objects": 1},
                                 {"frames": 3, "objects": 5},
                                 {"frames": 4, "objects": 2}])
    else:
        # a 128 x 176 tree: the fake tree's objects are 120 pixels wide
        t.update(sequences=[["a", 5, 2], ["b", 3, 1]], image_size=[128, 176],
                 rounds=3, trace_items=1)
    return wl


# what the protocol cell reports: it is out of BENCHMARK.json for its
# spread (PERF.md §7), so the tiny cell is listed here by hand
ROBOT_REPORTS = ("round_p90_ms", "frames_per_s", "idle_share.serve")
SESSION_METRIC = {"name": "session.submit_ms", "unit": "ms",
                  "better": "lower", "source": "program_span",
                  "layer": "protocol stack", "moves": "round_p90_ms"}


@pytest.fixture
def new_bench(bench):
    """The `bench` fixture's folder and manifest with `tiny_<cell>` beside
    each new cell."""
    d, man = bench
    for m in man["end_to_end"] + man["per_layer"]:
        if m["name"] in ROBOT_REPORTS:
            m["workloads"].append("davis_eval_robot")
    man["per_layer"].append({**SESSION_METRIC,
                             "workloads": ["davis_eval_robot"]})
    for cell in NEW:
        real = common.load_json("workloads", cell)
        name = f"tiny_{real['config']}"
        cfg = tiny_config()
        if cell == "ytvos720_batch":
            cfg["model"]["max_objects"] = 8
        with open(f"{d}/configs/{name}.json", "w") as f:
            json.dump(cfg, f)
        with open(f"{d}/workloads/tiny_{cell}.json", "w") as f:
            json.dump(tiny_new_workload(cell, name), f)
        for m in man["end_to_end"] + man["per_layer"]:
            if cell in m.get("workloads", ()):
                m["workloads"].append(f"tiny_{cell}")
    return d, man


def _run(new_bench, cell, trace=False):
    d, man = new_bench
    return run_cell(man, cell, SEED, 1.0, trace, torch.device("cpu"),
                    common.now(), bench_dir=d, log=lambda m: None)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", NEW)
def test_new_cell_prints_a_result_line(new_bench, cell, trace):
    res = _run(new_bench, f"tiny_{cell}", trace)
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    json.dumps(res)
    _, man = new_bench
    kind = "per_layer" if trace else "end_to_end"
    listed = {m["name"]: m["unit"]
              for m in common.cell_metrics(man, f"tiny_{cell}", kind)}
    if not trace:
        assert set(res["metrics"]) == set(listed)
    for name, m in res["metrics"].items():
        assert listed[name] == m["unit"]
    limits = common.load_json("workloads", cell)["check"]["limits"]
    assert set(res["checks"]) == set(limits)
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


def test_batch_window_counts_real_frames(new_bench):
    """frames/s counts each clip's real frames, not its padding: the
    window's batches alternate between 7 and 4 real frames."""
    d, _ = new_bench
    wl = common.load_json("workloads", "tiny_ytvos720_batch", d)
    cfg = common.load_json("configs", wl["config"], d)
    drv = common.load_module("traffic", wl["traffic"]["driver"], d)
    t = drv.Traffic(common.Cell("x", wl, cfg, SEED, torch.device("cpu")))
    t.setup()
    assert [b["shape"] for b in t.batches] == [(2, 4), (1, 4)]
    assert [b["frames"] for b in t.batches] == [7, 4]
    y = t.batches[0]["upload"][0]
    # the 3-frame clip is padded with its last frame
    np.testing.assert_array_equal(y[4 + 3], y[4 + 2])
    log = t.window(0.5)
    assert [b["frames"] for b in log.batches] == \
        [(7, 4)[k % 2] for k in range(len(log.batches))]
    assert t.end_to_end(log)["frames_per_s"] == pytest.approx(
        sum(b["frames"] for b in log.batches) / log.seconds)
    run = {i for b in log.batches for i in b["clips"]}
    assert 1 in t.sample and set(log.kept) == set(t.sample) & run


def _alter(labels: np.ndarray) -> np.ndarray:
    return (labels + 1) % 3


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered",
                                   "memory_unseeded"])
def test_batch_fault_is_caught(new_bench, monkeypatch, fault):
    """A clip whose frames all keep the first frame's probabilities, labels
    altered after the download, and a memory seeded from zeros: each
    comes out not correct."""
    from cvpr2020_manet_tpu_torch.engine import propagate_batch as pb
    if fault == "state_unchanged":
        def propagate(self, *a, **k):
            prev = a[7]
            logits, gm = real(self, *a, **k)
            return torch.log(prev.clamp(min=1e-30)), gm

        real = pb.MANet.propagate
        monkeypatch.setattr(pb.MANet, "propagate", propagate)
    elif fault == "answer_altered":
        real_drain = pb.BatchPropagator.drain

        def drain(fetches, bits):
            return _alter(real_drain(fetches, bits))

        monkeypatch.setattr(pb.BatchPropagator, "drain", staticmethod(drain))
    else:
        real_agg = pb.MANet.aggregate_memory

        def aggregate(self, feats, memory, first):
            return real_agg(self, torch.zeros_like(feats), memory, first)

        monkeypatch.setattr(pb.MANet, "aggregate_memory", aggregate)
    assert _run(new_bench, "tiny_ytvos720_batch")["correct"] is False


def test_robot_rasterizer_draws_the_programs_pixels():
    """The harness's own rasterizer of a scribble JSON gives the program's
    raster, padded, on robot-style paths."""
    from cvpr2020_manet_tpu_torch.interactive.scribbles import scribbles2mask
    drv = common.load_module("traffic", "davis_protocol")
    r = np.random.default_rng(3)
    h, w = 37, 53
    lines = [{"path": r.random((int(r.integers(1, 9)), 2)).tolist(),
              "object_id": int(r.integers(0, 4))} for _ in range(12)]
    want = scribbles2mask({"sequence": "s", "scribbles": [lines]}, (h, w))[0]
    got = drv.raster(lines, (h, w), 16)
    assert got.shape == (48, 64)
    np.testing.assert_array_equal(got[:h, :w], want)
    assert (got[h:] == -1).all() and (got[:, w:] == -1).all()


# ------------------------------------------------------------- readers

MS = 1_000_000
MAIN = 1


def _trace(ops, spans, dev=(), rt=(), info=None) -> Trace:
    """ops: (name, start ms, end ms); spans: {name: [(start, end) ms]};
    dev: device intervals in ms; rt: launch calls in ms."""
    ops = [("bench.window", 0.0, 100.0), *ops]

    def ns(x):
        return np.asarray([round(v * MS) for v in x], np.int64)

    return Trace(dev_start=ns([a for a, _ in dev]),
                 dev_end=ns([b for _, b in dev]),
                 dev_name=["kernel"] * len(dev), rt_start=ns(rt),
                 op_name=[o[0] for o in ops],
                 op_start=ns([o[1] for o in ops]),
                 op_end=ns([o[2] for o in ops]),
                 op_thread=np.full(len(ops), MAIN, np.int64),
                 spans={"bench.window": [(0, 100 * MS)],
                        **{k: [(round(a * MS), round(b * MS)) for a, b in v]
                           for k, v in spans.items()}},
                 info=info or {})


BATCH_OPS = [("manet.batch.upload", 0.5, 1.0),
             ("manet.batch.dispatch", 1.0, 4.0),
             ("manet.batch.drain", 6.0, 9.0),
             ("manet.batch.dispatch", 11.0, 14.0),
             ("manet.batch.drain", 15.0, 16.0)]
BATCH_SPANS = {"bench.batch": [(1.0, 9.5), (11.0, 20.0)]}
# batch 1: 6 ms busy over 10 frames; batch 2: 4 ms (one interval
# straddles its end) over 5 frames
BATCH_DEV = [(1.5, 4.5), (5.0, 8.0), (12.0, 15.0), (19.0, 22.0)]
BATCH_RT = [1.1, 1.2, 1.3, 2.0, 11.5, 12.0, 30.0]
BATCH_INFO = {"batches": [10, 5]}
SUBMIT_OPS = [("manet.session.submit", 1.0, 3.0),
              ("manet.session.submit.score", 1.0, 2.0),
              ("manet.session.submit", 5.0, 9.0),
              ("manet.session.submit", 10.0, 11.0)]

CASES = [
    ("batch.device_ms_per_frame", BATCH_OPS, BATCH_SPANS, 0.7),
    ("batch.launch_calls_per_frame", BATCH_OPS, BATCH_SPANS, 0.4),
    ("batch.drain_ms", BATCH_OPS, BATCH_SPANS, 2.0),
    ("session.submit_ms", SUBMIT_OPS, {}, 2.0),
]


def _reader(name):
    return common.load_module("metrics", name).read


@pytest.mark.parametrize("name,ops,spans,want", CASES,
                         ids=[c[0] for c in CASES])
def test_new_reader_reads_its_trace(name, ops, spans, want):
    got = _reader(name)(_trace(ops, spans, BATCH_DEV, BATCH_RT, BATCH_INFO))
    assert got == pytest.approx(want, abs=1e-9)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_new_reader_finds_nothing_without_its_source(name):
    """The parent program's trace (the harness's spans, no `manet.batch.*`
    or `manet.session.*`), and a trace with no device operation or launch
    (a CPU run)."""
    parent = _trace([], {}, BATCH_DEV, BATCH_RT, {})
    assert _reader(name)(parent) is None
    ops, spans = {c[0]: (c[1], c[2]) for c in CASES}[name]
    assert _reader(name)(_trace(ops, spans, (), (), BATCH_INFO)) is None


def test_new_metrics_are_listed_with_their_cells():
    man = common.manifest()
    listed = {m["name"]: m for m in man["per_layer"]}
    for name, _, _, _ in CASES:
        m = listed.get(name, SESSION_METRIC)
        if name.startswith("batch"):
            assert m["workloads"] == ["ytvos720_batch"]
        mod = common.load_module("metrics", name)
        assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
    for name in ("global_matching_roofline", "local_matching_roofline",
                 "idle_share.serve", "mfu.serve"):
        assert "ytvos720_batch" in listed[name]["workloads"]
    cells = {w["name"] for w in man["workloads"]}
    assert "ytvos720_batch" in cells and "davis_eval_robot" not in cells
    assert SESSION_METRIC["name"] not in listed
