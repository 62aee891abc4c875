"""`group_norm.fused_share` on hand-built traces: kernel 7's statistics
launches over those plus aten's, by device-operation name; None where
neither kernel ran."""

from __future__ import annotations

import numpy as np
import pytest

from manet_bench import common
from manet_bench.tracing import Trace

NAME = "group_norm.fused_share"
FUSED = "(anonymous namespace)::group_norm_stats(__nv_bfloat16 const*, " \
        "float2*, long, int, long)"
APPLY = "void (anonymous namespace)::group_norm_apply<true, true>(...)"
ATEN = "void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel" \
       "<float, float>(long, float, float const*, float*, float*)"
OTHER = ["void at::native::elementwise_kernel<128, 2>(...)",
         "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwc_tn",
         "global_matching_wgmma<false, true>"]


def _trace(names) -> Trace:
    n = len(names)
    ns = np.arange(n, dtype=np.int64) * 1000
    return Trace(dev_start=ns, dev_end=ns + 500, dev_name=list(names),
                 rt_start=np.zeros(0, np.int64), op_name=[],
                 op_start=np.zeros(0, np.int64),
                 op_end=np.zeros(0, np.int64),
                 op_thread=np.zeros(0, np.int64), spans={}, info={})


@pytest.mark.parametrize("names,want", [
    ([FUSED, APPLY] * 5 + OTHER, 100.0),
    ([ATEN] * 4 + OTHER, 0.0),
    ([FUSED, APPLY] * 3 + [ATEN], 75.0),
    (OTHER + [APPLY], None),
    ([], None),
], ids=["change", "parent", "mixed", "no_stats_kernel", "empty"])
def test_share_of_the_statistics_launches(names, want):
    got = common.load_module("metrics", NAME).read(_trace(names))
    assert got == (None if want is None else pytest.approx(want))


def test_metric_is_listed_with_its_cells():
    listed = {m["name"]: m for m in common.manifest()["per_layer"]}
    m = listed[NAME]
    mod = common.load_module("metrics", NAME)
    assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
    assert m["source"] == "device_trace" and m["unit"] == "%"
    assert sorted(m["workloads"]) == ["davis480_rounds", "stream1080_int8",
                                      "ytvos720_batch"]
