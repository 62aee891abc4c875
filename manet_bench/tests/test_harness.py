"""The harness on the CPU at a tiny size: the result line, finding files
by name, the manifest's rules and the import guard."""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from manet_bench import common

CELLS = ("davis480_rounds", "stream1080_int8", "train_stage1_416")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_traffic_driver_prints_a_result_line(run_tiny, bench, cell, trace):
    res = run_tiny(f"tiny_{cell}", trace=trace)
    assert set(res) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    json.dumps(res)
    _, man = bench
    kind = "per_layer" if trace else "end_to_end"
    listed = {m["name"]: m["unit"]
              for m in common.cell_metrics(man, f"tiny_{cell}", kind)}
    for name, m in res["metrics"].items():
        assert listed[name] == m["unit"]
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        # every end-to-end metric the cell lists is reported (on the CPU
        # the device-only per-layer metrics find nothing and stay out)
        assert set(res["metrics"]) == set(listed)
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


def test_new_files_are_found_by_name(run_tiny, bench):
    """A cell, a configuration and a per-layer metric added as new files
    and manifest entries, with no edit to any file already there."""
    bench_dir, man = bench
    wl = common.load_json("workloads", "tiny_davis480_rounds", bench_dir)
    cfg = common.load_json("configs", wl["config"], bench_dir)
    with open(os.path.join(bench_dir, "configs", "dummy_config.json"),
              "w") as f:
        json.dump(cfg, f)
    wl["config"] = "dummy_config"
    with open(os.path.join(bench_dir, "workloads", "dummy_cell.json"),
              "w") as f:
        json.dump(wl, f)
    with open(os.path.join(bench_dir, "metrics", "dummy.rounds.py"),
              "w") as f:
        f.write("LAYER = 'dummy'\nMOVES = 'round_p90_ms'\n\n"
                "def read(trace):\n"
                "    return float(len(trace.spans['bench.round']))\n")
    man["end_to_end"][0]["workloads"].append("dummy_cell")
    man["per_layer"].append({"name": "dummy.rounds", "unit": "rounds",
                             "better": "higher", "source": "program_span",
                             "layer": "dummy", "moves": "round_p90_ms",
                             "workloads": ["dummy_cell"]})
    res = run_tiny("dummy_cell", trace=True)
    assert res["metrics"]["dummy.rounds"]["value"] == 3.0
    res = run_tiny("dummy_cell")
    assert "round_p90_ms" in res["metrics"]


def test_manifest_rules():
    man = common.manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in man[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"]: w for w in man["workloads"]}
    for m in man["per_layer"]:
        assert os.path.exists(os.path.join(common.BENCH_DIR, "metrics",
                                           f"{m['name']}.py"))
        for cell in m["workloads"]:
            reported = {x["name"] for x in
                        common.cell_metrics(man, cell, "end_to_end")}
            assert m["moves"] in reported, (m["name"], cell)
    for w in man["workloads"]:
        wl = common.load_json("workloads", w["name"])
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
        assert wl["why"] == w["why"] and len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
        assert os.path.exists(os.path.join(
            common.BENCH_DIR, "traffic", f"{wl['traffic']['driver']}.py"))
        reported = common.cell_metrics(man, w["name"], "end_to_end")
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert common.cell_metrics(man, w["name"], "per_layer")
    for c in man["configs"]:
        f = json.load(open(os.path.join(common.ROOT, c["file"])))
        assert f["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in cells.values())


def test_no_forbidden_module_after_a_run(tmp_path):
    """A tiny run in a fresh process loads neither JAX nor the JAX
    package (compared by whole top-level names)."""
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {common.ROOT!r})\n"
        "from manet_bench.tests.conftest import tiny_config\n"
        "from manet_bench import common\n"
        "from manet_bench.traffic import interactive_rounds as d\n"
        "wl = common.load_json('workloads', 'davis480_rounds')\n"
        "wl['traffic'].update(videos=[{'name': 'a', 'frames': 4, "
        "'objects': 1}], rounds_per_session=2)\n"
        "t = d.Traffic(common.Cell('x', wl, tiny_config(), 1, "
        "torch.device('cpu')))\n"
        "t.setup(); log = t.window(0.2); t.free_program(); t.check(log)\n"
        "print(common.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(common.BENCH_DIR, "reference")
    for name in os.listdir(ref_dir):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref_dir, name)).read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            for m in mods:
                top = m.split(".", 1)[0]
                assert top not in common.FORBIDDEN + (
                    "cvpr2020_manet_tpu_torch",), (name, m)


def test_cuda_less_machine_exits_without_a_result(tmp_path):
    """Without a card the command exits non-zero and prints no line."""
    out = subprocess.run(
        [sys.executable, os.path.join(common.BENCH_DIR, "run.py"),
         "--workload", "davis480_rounds", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=common.ROOT,
        timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
