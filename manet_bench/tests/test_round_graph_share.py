"""The reader of `round.graph_share`: 100 x the round's replayed sweep
steps over its steps, on hand-built traces of the program's
`manet.round.step` / `manet.round.replay` spans; None without step spans,
as a program that graphs nothing gives, or without device work."""

from __future__ import annotations

import pytest

from manet_bench import common
from manet_bench.tests.test_span_metrics import (MAIN, ROUND_DEV, ROUNDS,
                                                 STARTS, _sync, _trace)

NAME = "round.graph_share"

# three sweep steps: two in the first round, one in the second; each
# replays its graph inside the step
STEPS = [
    ("manet.round.step", 1.8, 2.0, MAIN),
    ("manet.round.replay", 1.85, 1.95, MAIN),
    ("manet.round.step", 2.0, 2.2, MAIN),
    ("manet.round.replay", 2.05, 2.15, MAIN),
    ("manet.round.step", 7.1, 7.3, MAIN),
    ("manet.round.replay", 7.15, 7.25, MAIN),
]


def _read(ops, dev=ROUND_DEV):
    return common.load_module("metrics", NAME).read(
        _trace(ops, dev, info=STARTS))


@pytest.mark.parametrize("replayed,want", [
    ((1.85, 2.05, 7.15), 100.0),
    ((1.85,), 100.0 / 3),
    ((), 0.0),
], ids=["all", "one_of_three", "none"])
def test_graph_share_counts_the_steps_that_replayed(replayed, want):
    """Steps run as they are (no replay span in them) lower the share."""
    ops = [o for o in STEPS
           if o[0] == "manet.round.step" or o[1] in replayed]
    assert _read(ROUNDS + ops) == pytest.approx(want, abs=1e-9)


def test_graph_share_finds_nothing_without_step_spans():
    """The parent program's trace (the harness's spans, no step span) and
    a trace with the spans but no device operation (a CPU run)."""
    parent = [("bench.round", 1.0, 4.0, MAIN), _sync(1.3)]
    assert _read(parent) is None
    assert _read(ROUNDS) is None
    assert _read(ROUNDS + STEPS, dev=()) is None


def test_graph_share_is_listed_with_its_cell():
    listed = {m["name"]: m for m in common.manifest()["per_layer"]}
    m = listed[NAME]
    assert (m["source"], m["unit"], m["better"]) == (
        "program_span", "%", "higher")
    assert m["workloads"] == ["davis480_rounds"]
    mod = common.load_module("metrics", NAME)
    assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
