"""The control on the card: the reference one step below the
configuration's precision, put in the program's place at the cell's own
size, fails a limit that the program passes. Run on the card with
`python -m pytest manet_bench/tests -m cuda`; each window is long enough
to reach the rounds the check samples."""

from __future__ import annotations

import pytest

from manet_bench import common
from manet_bench.control import readings
from manet_bench.judge import verdict


@pytest.mark.cuda
@pytest.mark.parametrize("cell,seconds", [("davis480_rounds", 25.0),
                                          ("stream1080_int8", 12.0)])
def test_control_fails_where_the_program_passes(card, cell, seconds):
    limits = common.load_json("workloads", cell)["check"]["limits"]
    out = readings(cell, 97, seconds, card)
    assert verdict(out["program"], limits)[0]
    assert not verdict(out["control"], limits)[0]
