"""The `feelvos_davis480_batch` cell on the CPU at a tiny size: its
set-up, window, traced slice and check through the harness's `run_cell`;
the check catching a broken program; the work counts against hand counts
and the flop counter; the two roofline readers on hand-built traces.

The tiny cell keeps the cell's traffic, schedule and limits and cuts the
configuration (`feelvos_config(tiny=True)`: Xception-65 whole, 32-wide
ASPP, decoder and head) and the clips (3 clips of 3-4 frames, 1-5
objects, in batches of 2), at 64 x 96.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu_torch.config import feelvos_config

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from manet_bench import common, counting_feelvos as cf  # noqa: E402
from manet_bench.reference.feelvos import FeelvosRef, param_shapes  # noqa: E402
from manet_bench.run import run_cell  # noqa: E402
from manet_bench.span_kernels import launched_ns  # noqa: E402
from manet_bench.tracing import Trace  # noqa: E402

CELL = "feelvos_davis480_batch"
SEED = 2 ** 31 + 2345            # seeds may pass 32 signed bits
METRICS = ("separable_encoder_roofline", "separable_head_roofline")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_config() -> dict:
    m = dataclasses.asdict(feelvos_config(tiny=True).model)
    m.update(max_objects=8, local_window=3)
    real = common.load_json("configs", "feelvos_x65_davis480_batch")
    return {**real, "model": m, "eval": {"image_size": [64, 96],
                                         "pad_to": 16}}


@pytest.fixture
def bench(tmp_path):
    """(bench_dir, manifest) with `tiny_<cell>` beside the cell."""
    d = tmp_path / "manet_bench"
    shutil.copytree(common.BENCH_DIR, d,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (d / "configs" / "tiny_feelvos.json").write_text(
        json.dumps(tiny_config()))
    wl = copy.deepcopy(common.load_json("workloads", CELL))
    wl["config"] = "tiny_feelvos"
    wl["traffic"].update(batch=2, clips=[{"frames": 4, "objects": 1},
                                         {"frames": 3, "objects": 5},
                                         {"frames": 4, "objects": 2}])
    (d / "workloads" / f"tiny_{CELL}.json").write_text(json.dumps(wl))
    man = common.manifest()
    for m in man["end_to_end"] + man["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(f"tiny_{CELL}")
    return str(d), man


def _run(bench, trace=False):
    d, man = bench
    return run_cell(man, f"tiny_{CELL}", SEED, 0.5, trace,
                    torch.device("cpu"), common.now(), bench_dir=d,
                    log=lambda m: None)


@pytest.mark.parametrize("trace", [False, True])
def test_cell_prints_a_correct_result_line(bench, trace):
    res = _run(bench, trace)
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    json.dumps(res)
    _, man = bench
    kind = "per_layer" if trace else "end_to_end"
    listed = {m["name"]: m["unit"]
              for m in common.cell_metrics(man, f"tiny_{CELL}", kind)}
    if not trace:
        assert set(res["metrics"]) == set(listed) == {"frames_per_s",
                                                      "setup_s"}
    for name, m in res["metrics"].items():
        assert listed[name] == m["unit"]
    limits = common.load_json("workloads", CELL)["check"]["limits"]
    assert set(res["checks"]) == set(limits)
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


def _alter(labels: np.ndarray) -> np.ndarray:
    return (labels + 1) % 3


def _no_relu(layer, x):
    """A separable layer without any of its ReLUs."""
    return layer.pw_norm(layer.pw(layer.dw_norm(layer.dw(x))))


@pytest.mark.parametrize("fault", ["maps_of_another_object",
                                   "probabilities_stale", "norms_not_loaded",
                                   "answer_altered", "head_relus_dropped",
                                   "middle_flow_relus_dropped"])
def test_fault_is_caught(bench, monkeypatch, fault):
    """The head fed the next object's maps; the probabilities handed on
    unchanged from the first frame; the program's norms left at their
    own values instead of the loaded ones; labels altered after the
    download; the head's ReLUs dropped (all but its first layer's
    depthwise one); the middle flow's ReLUs (each separable layer's
    leading one) dropped. Each comes out not correct."""
    from cvpr2020_manet_tpu_torch.engine import propagate_batch as pb
    from cvpr2020_manet_tpu_torch.models import feelvos as fv
    from cvpr2020_manet_tpu_torch.models import heads, xception
    if fault == "head_relus_dropped":
        def head(self, maps, pre):
            first = self.layers[0]
            cf = first.dw.weight.shape[0] - maps.shape[1]
            x = first.pw_norm(self._first(maps, cf, cf + maps.shape[1]) + pre)
            for layer in self.layers[1:]:
                x = _no_relu(layer, x)
            return self.logit(x)

        monkeypatch.setattr(heads.SeparableSegHead, "forward", head)
    elif fault == "middle_flow_relus_dropped":
        real_unit = xception.XceptionUnit.forward

        def unit(self, x, tap=None):
            if self.kind != "sum":
                return real_unit(self, x, tap)
            y = x
            for layer in self.sep:
                y = _no_relu(layer, y)
            return y + x, None

        monkeypatch.setattr(xception.XceptionUnit, "forward", unit)
    elif fault == "maps_of_another_object":
        real_maps = fv.FEELVOS._maps

        def maps(self, gm, lm, prev):
            return real_maps(self, gm, lm, prev).roll(1, 0)

        monkeypatch.setattr(fv.FEELVOS, "_maps", maps)
    elif fault == "probabilities_stale":
        def clip_head(self, clip, i, feat_t, gm, lm, prev):
            return torch.log(prev.clamp(min=1e-30))

        monkeypatch.setattr(fv.FEELVOS, "clip_head", clip_head)
    elif fault == "norms_not_loaded":
        real_load = fv.FEELVOS.load_state_dict

        def load(self, sd, strict=True):
            """Every frozen norm at the port's own initial values (scale 1,
            shift 0), the rest loaded."""
            def own(k, v):
                if "norm" not in k.rsplit(".", 2)[-2]:
                    return v
                return torch.ones_like(v) if k.endswith(".weight") \
                    else torch.zeros_like(v)
            return real_load(self, {k: own(k, v) for k, v in sd.items()},
                             strict=strict)

        monkeypatch.setattr(fv.FEELVOS, "load_state_dict", load)
    else:
        real_drain = pb.BatchPropagator.drain

        def drain(fetches, bits):
            return _alter(real_drain(fetches, bits))

        monkeypatch.setattr(pb.BatchPropagator, "drain", staticmethod(drain))
    assert _run(bench)["correct"] is False


def test_window_counts_real_frames_and_every_upload(bench):
    """frames/s counts each clip's real frames; the traced slice's
    encoder work covers every upload in it (one more than its batches)
    and the head's the real propagated frames and live objects."""
    d, _ = bench
    wl = common.load_json("workloads", f"tiny_{CELL}", d)
    cfg = common.load_json("configs", wl["config"], d)
    drv = common.load_module("traffic", wl["traffic"]["driver"], d)
    t = drv.Traffic(common.Cell("x", wl, cfg, SEED, torch.device("cpu")))
    t.setup()
    assert [b["frames"] for b in t.batches] == [7, 4]
    log, tr = t.traced()
    assert [k for k, _ in t.uploaded] == [0, 1, 0]
    m = cfg["model"]
    enc = cf.encoder_layers(m, 64, 96)
    shared, per_object = cf.head_layers(m, 16, 24)
    assert tr.info["separable_encoder_least_s"] == pytest.approx(cf.least_s(
        [(lay, 7 + 4 + 7, 3) for lay in enc]))
    steps, objects = 3 + 2 + 3, 3 * 2 + 2 * 6 + 3 * 3
    assert tr.info["separable_head_least_s"] == pytest.approx(cf.least_s(
        [(lay, steps, steps) for lay in shared]
        + [(lay, objects, steps) for lay in per_object]))
    assert tr.info["batches"] == [7, 4]
    assert set(log.kept) == set(t.sample)
    assert all(set(k) == {"probs", "labels", "feat", "emb"}
               for k in log.kept.values())


# ------------------------------------------------------------- counts

def test_depthwise_and_pointwise_layers_by_hand():
    """One depthwise 3x3 (rate 2) and one pointwise layer, counted by
    hand: 2 operations a multiply-add, bf16 activations read and written
    once, f32 parameters."""
    px = 30 * 54
    sep = cf.separable("s", 728, 1024, 3, px, px)
    dw_ops = 2 * 728 * 9 * px                 # one tap of one channel
    pw_ops = 2 * 728 * 1024 * px
    assert sep.flops == dw_ops + pw_ops
    assert sep.bytes == 2 * (728 * px + 1024 * px)
    assert sep.params == 728 * 9 + 2 * 728 + 728 * 1024 + 2 * 1024
    pw = cf.conv("p", 2048, 256, 1, px, px)
    assert pw.flops == 2 * 2048 * 256 * px
    assert pw.bytes == 2 * (2048 + 256) * px
    least = cf.least_s([(sep, 3, 1)])
    assert least == pytest.approx(max(3 * sep.flops / 989e12,
                                      (3 * sep.bytes + 4 * sep.params)
                                      / 3.35e12))


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "published"])
def test_counts_match_the_flop_counter(tiny):
    """The encoder's and the head's operations equal what
    `torch.utils.flop_counter` counts of the reference (on the meta
    device), the plain head counting the first layer once an object."""
    from torch.utils.flop_counter import FlopCounterMode
    m = dataclasses.asdict(feelvos_config(tiny=tiny).model)
    meta = torch.device("meta")
    ref = FeelvosRef({k: torch.empty(s, device=meta)
                      for k, s in param_shapes(m).items()}, m)
    hp, wp = (64, 96) if tiny else (480, 864)
    h, w, o = hp // 4, wp // 4, 3
    with FlopCounterMode(display=False) as enc:
        ref.encoder(torch.empty((1, 3, hp, wp), device=meta))
    maps = torch.empty((h, w, o), device=meta)
    with FlopCounterMode(display=False) as head:
        ref.head(torch.empty((h, w, m["decoder_channels"]), device=meta),
                 maps, maps, maps, torch.empty(o, device=meta))
    assert cf.flops(cf.encoder_layers(m, hp, wp)) == enc.get_total_flops()
    shared, per_object = cf.head_layers(m, h, w)
    assert o * (cf.flops(shared) + cf.flops(per_object)) == \
        head.get_total_flops()


# ------------------------------------------------------------- readers

MS = 1_000_000


def _trace(info, corr=True) -> Trace:
    """Two encode spans on thread 1 (0-10 ms, 20-30 ms), a head span on
    thread 1 (40-50 ms) and one on thread 2 (40-50 ms); launches inside
    and outside them, each with its kernel."""
    from manet_bench.span_kernels import SpanTrace

    def ns(x):
        return np.asarray([round(v * MS) for v in x], np.int64)

    ops = [("bench.window", 0, 100, 1), ("manet.batch.encode", 0, 10, 1),
           ("manet.batch.encode", 20, 30, 1), ("manet.batch.head", 40, 50, 1),
           ("manet.batch.head", 40, 50, 2)]
    # launch: (time, thread, correlation); kernel: (start, end, corr)
    launches = [(1, 1, 11), (2, 1, 12), (21, 1, 13), (15, 1, 14),
                (41, 1, 15), (42, 3, 16), (43, 2, 17)]
    kernels = [(3, 5, 11), (5, 6, 12), (22, 26, 13), (16, 18, 14),
               (44, 47, 15), (47, 48, 16), (48, 50, 17), (60, 61, 99)]
    fields = dict(
        dev_start=ns([k[0] for k in kernels]),
        dev_end=ns([k[1] for k in kernels]),
        dev_name=["k"] * len(kernels), rt_start=ns([x[0] for x in launches]),
        op_name=[o[0] for o in ops], op_start=ns([o[1] for o in ops]),
        op_end=ns([o[2] for o in ops]),
        op_thread=np.asarray([o[3] for o in ops], np.int64),
        spans={"bench.window": [(0, 100 * MS)]}, info=info)
    if not corr:
        return Trace(**fields)
    return SpanTrace(
        **fields, rt_corr=np.asarray([x[2] for x in launches], np.int64),
        rt_thread=np.asarray([x[1] for x in launches], np.int64),
        dev_corr=np.asarray([k[2] for k in kernels], np.int64))


INFO = {"separable_encoder_least_s": 0.0035, "separable_head_least_s": 0.001}


def test_launched_ns_ties_kernels_to_their_spans():
    tr = _trace(INFO)
    # encode: kernels 11, 12, 13 (2 + 1 + 4 ms); 14 was launched outside
    assert launched_ns(tr, "manet.batch.encode") == 7 * MS
    # head: 15 (thread 1) and 17 (thread 2, in its own span); 16's launch
    # was on a thread without a span
    assert launched_ns(tr, "manet.batch.head") == 5 * MS
    assert launched_ns(tr, "manet.batch.clip") is None


@pytest.mark.parametrize("name,want", [(METRICS[0], 50.0), (METRICS[1], 20.0)])
def test_reader_reads_its_trace(name, want):
    read = common.load_module("metrics", name).read
    assert read(_trace(INFO)) == pytest.approx(want)


@pytest.mark.parametrize("name", METRICS)
def test_reader_finds_nothing_without_its_source(name):
    """A plain trace (no correlation ids), a trace without the program's
    spans (the parent's), without the work count, or without device
    operations (a CPU run)."""
    read = common.load_module("metrics", name).read
    assert read(_trace(INFO, corr=False)) is None
    assert read(_trace({})) is None
    tr = _trace(INFO)
    tr.op_name = ["bench.window"] + ["other"] * (len(tr.op_name) - 1)
    assert read(tr) is None
    tr = _trace(INFO)
    tr.dev_start = tr.dev_start[:0]
    assert read(tr) is None


def test_cell_and_metrics_are_listed():
    man = common.manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    assert cells[CELL]["chips"] == 1
    assert cells[CELL]["config"] == "feelvos_x65_davis480_batch"
    config = {c["name"]: c for c in man["configs"]}[cells[CELL]["config"]]
    assert config["reduced"] == []
    listed = {m["name"]: m for m in man["per_layer"]}
    for name in METRICS:
        m = listed[name]
        assert m["workloads"] == [CELL] and m["moves"] == "frames_per_s"
        assert m["unit"] == "%" and m["source"] == "device_trace"
        mod = common.load_module("metrics", name)
        assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
    for name in ("global_matching_roofline", "local_matching_roofline",
                 "idle_share.serve", "mfu.serve", "batch.device_ms_per_frame",
                 "batch.launch_calls_per_frame", "batch.drain_ms"):
        assert CELL in listed[name]["workloads"]
    assert CELL not in listed["group_norm.fused_share"]["workloads"]
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert CELL in e2e["frames_per_s"]["workloads"]
