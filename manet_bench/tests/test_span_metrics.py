"""The readers of the program's phase spans (`manet.*`), on hand-built
traces whose spans, runtime calls and device intervals are known; and
None on a trace without them, as a program that records no span gives."""

from __future__ import annotations

import numpy as np
import pytest

from manet_bench import common
from manet_bench.tracing import Trace

MS = 1_000_000      # ns
MAIN, POOL = 1, 2   # threads


def _trace(ops, dev=(), info=None) -> Trace:
    """ops: (name, start ms, end ms, thread); dev: (start ms, end ms)."""
    ops = [("bench.window", 0.0, 100.0, MAIN), *ops]

    def ns(x):
        return np.asarray([round(v * MS) for v in x], np.int64)

    return Trace(dev_start=ns([a for a, _ in dev]),
                 dev_end=ns([b for _, b in dev]),
                 dev_name=["kernel"] * len(dev),
                 rt_start=np.zeros(0, np.int64),
                 op_name=[o[0] for o in ops],
                 op_start=ns([o[1] for o in ops]),
                 op_end=ns([o[2] for o in ops]),
                 op_thread=np.asarray([o[3] for o in ops], np.int64),
                 spans={"bench.window": [(0, 100 * MS)]},
                 info=info or {})


def _sync(t, thread=MAIN, name="cudaStreamSynchronize"):
    return (name, t, t + 0.01, thread)


ROUNDS = [
    # round 1: rasterize 0.2, dispatch 1.3 with 2 syncs of its own (the
    # pool's and the wait's do not count), unpack 0.9
    ("manet.start.pad", 0.1, 0.5, MAIN),
    ("manet.round", 1.0, 4.0, MAIN),
    ("manet.round.rasterize", 1.0, 1.2, MAIN),
    ("manet.round.dispatch", 1.2, 2.5, MAIN),
    _sync(1.3), _sync(1.6, name="cuStreamSynchronize"), _sync(1.7, POOL),
    ("manet.round.wait", 2.5, 3.0, MAIN), _sync(2.6),
    ("manet.round.unpack", 3.0, 3.9, MAIN),
    # round 2 (segmented): rasterize 0.4, dispatch 2.0 with 3 syncs,
    # unpack 0.3 + 0.2
    ("manet.round", 5.0, 9.0, MAIN),
    ("manet.round.rasterize", 5.0, 5.4, MAIN),
    ("manet.round.dispatch", 5.4, 7.4, MAIN),
    _sync(5.5), _sync(6.0, name="cudaDeviceSynchronize"), _sync(7.0),
    ("manet.round.wait", 7.4, 7.6, MAIN),
    ("manet.round.unpack", 7.6, 7.9, MAIN),
    ("manet.round.wait", 7.9, 8.0, MAIN),
    ("manet.round.unpack", 8.0, 8.2, MAIN),
    # an unpack outside any round is not the round's
    ("manet.round.unpack", 9.5, 9.9, MAIN),
    ("manet.start.pad", 10.0, 10.8, MAIN),
]
ROUND_DEV = [(1.5, 2.9), (5.6, 7.8)]
STARTS = {"starts": [{"frames": 4, "seconds": 0.01},
                     {"frames": 8, "seconds": 0.02}]}

STREAM = [
    # frame 1: ingest 2.0; the mask on the host at 7.0 (the pool's
    # download returns), tail 3.0
    ("manet.observe", 0.0, 10.0, MAIN),
    ("manet.observe.ingest", 0.0, 2.0, MAIN),
    ("cudaMemcpyAsync", 1.5, 1.6, MAIN), _sync(1.6),
    ("manet.observe.dispatch", 2.0, 3.0, MAIN),
    ("manet.observe.wait", 3.0, 10.0, MAIN),
    ("cudaMemcpyAsync", 3.1, 3.2, POOL),
    ("cudaStreamSynchronize", 3.2, 7.0, POOL),
    # frame 2: ingest 1.0; the mask on the host at 18.0, tail 2.0
    ("manet.observe", 12.0, 20.0, MAIN),
    ("manet.observe.ingest", 12.0, 13.0, MAIN),
    ("manet.observe.dispatch", 13.0, 14.0, MAIN),
    ("manet.observe.wait", 14.0, 20.0, MAIN),
    ("cudaMemcpyAsync", 14.1, 14.2, POOL),
    ("cudaStreamSynchronize", 14.2, 18.0, POOL),
]
# device intervals on a clock shifted against the host's: the tail reads
# the runtime calls, never these (one straddles frame 1's end)
STREAM_DEV = [(2.5, 5.0), (4.0, 11.0), (13.5, 16.0), (16.5, 19.5)]

CASES = [
    ("round.rasterize_ms", ROUNDS, ROUND_DEV, 0.3),
    ("round.enqueue_ms", ROUNDS, ROUND_DEV, 1.65),
    ("round.enqueue_syncs", ROUNDS, ROUND_DEV, 2.5),
    ("round.unpack_ms", ROUNDS, ROUND_DEV, 0.7),
    ("start_sequence.pad_ms_per_frame", ROUNDS, ROUND_DEV, 0.1),
    ("stream.ingest_ms", STREAM, STREAM_DEV, 1.5),
    ("stream.host_tail_ms", STREAM, STREAM_DEV, 2.5),
]


def _reader(name):
    return common.load_module("metrics", name).read


@pytest.mark.parametrize("name,ops,dev,want", CASES,
                         ids=[c[0] for c in CASES])
def test_reader_reads_the_program_spans(name, ops, dev, want):
    got = _reader(name)(_trace(ops, dev, info=STARTS))
    assert got == pytest.approx(want, abs=1e-9)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_reader_finds_nothing_without_program_spans(name):
    """The parent program's trace: the harness's spans around each call,
    device work and runtime calls, no `manet.*` span; and a trace with the
    spans but no device operation (a CPU run)."""
    parent = [("bench.round", 1.0, 4.0, MAIN),
              ("bench.start_sequence", 0.1, 0.9, MAIN),
              ("bench.observe", 12.0, 20.0, MAIN), _sync(1.3)]
    assert _reader(name)(_trace(parent, ROUND_DEV, info=STARTS)) is None
    ops = ROUNDS if name.startswith(("round", "start")) else STREAM
    assert _reader(name)(_trace(ops, (), info=STARTS)) is None


def test_metrics_are_listed_with_their_cells():
    man = common.manifest()
    listed = {m["name"]: m for m in man["per_layer"]}
    for name, ops, _, _ in CASES:
        m = listed[name]
        assert m["source"] == "program_span"
        assert m["workloads"] == (["davis480_rounds"] if ops is ROUNDS
                                  else ["stream1080_int8"])
        mod = common.load_module("metrics", name)
        assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
