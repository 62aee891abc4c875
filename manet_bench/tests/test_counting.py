"""The roofline and MFU yardstick against hand counts at small shapes."""

from __future__ import annotations

import itertools

import pytest

from manet_bench import counting
from manet_bench.tests.conftest import tiny_config


def test_global_matching_counts_real_pairs():
    w = counting.global_matching(nq=3, nk=5, c=4, objects=2, backend="bf16")
    assert w.ops == 2 * 4 * 3 * 5
    assert w.bytes == (3 + 5) * 4 * 2 + 3 * 2 * 4
    assert w.peak == "bf16"
    w8 = counting.global_matching(nq=3, nk=5, c=4, objects=2, backend="int8")
    assert w8.ops == w.ops and w8.peak == "int8"
    assert w8.bytes == 3 * 4 * 2 + 5 * (4 + 4) + 3 * 2 * 4


@pytest.mark.parametrize("h,w,window", [(3, 4, 1), (5, 7, 2), (4, 4, 15)])
def test_local_matching_counts_in_window_pairs(h, w, window):
    pairs = sum(1 for y, x, dy, dx in itertools.product(
        range(h), range(w), range(-window, window + 1),
        range(-window, window + 1))
        if 0 <= y + dy < h and 0 <= x + dx < w)
    work = counting.local_matching(h, w, c=3, objects=2, window=window)
    assert work.ops == 2 * 3 * pairs
    assert work.peak == "tf32"


@pytest.mark.parametrize("backend", ["bf16", "int8"])
def test_no_share_above_100_at_a_plausible_time(backend):
    """A kernel as fast as its least time reads 100%; any real one is
    slower and reads less."""
    for work in (counting.global_matching(25920 * 103, 25920, 100, 3,
                                          backend),
                 counting.local_matching(60, 108, 100, 3, 15)):
        least_ns = work.least_s() * 1e9
        assert counting.share(work, round(least_ns)) == pytest.approx(
            100.0, rel=1e-3)
        assert counting.share(work, int(least_ns * 1.5)) < 100.0
    assert counting.share(counting.Work(), 1000) is None
    assert counting.share(work, 0) is None


def test_model_flops_match_a_hand_count():
    m = tiny_config()["model"]
    h, w = 16, 24
    fl = counting.model_flops(m, (4 * h, 4 * w))
    cd, cma, hc = m["decoder_channels"], m["ma_channels"], m["head_channels"]

    def conv(cin, cout, k):
        return 2 * cin * cout * k * k * h * w

    head = (conv(cd + 3 + cma, hc, 3) + 2 * conv(hc, hc, 3)
            + conv(hc, 1, 1))
    assert fl["head_object"] == head
    assert fl["gate_object"] == conv(2 * cma, cma, 3)
    assert fl["interact_object"] == (conv(cd + 3, hc, 3) + conv(hc, hc, 3)
                                     + conv(hc, cma, 3) + conv(cma, 1, 1))
    assert fl["encoder_frame"] > 0
