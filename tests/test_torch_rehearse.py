"""The port's val-scale rehearsal orchestrator (`rehearse_eval_modes.py`)
on a tiny DAVIS tree, on the CPU: all four legs of the eval CLI, each in
its own process, through `tests/_torch_eval_davis_cpu.py` (the CLI with
its device resolved to the CPU)."""

import json
import pathlib
import sys

from cvpr2020_manet_tpu_torch import rehearse_eval_modes as rehearse
from cvpr2020_manet_tpu_torch.interactive.session import write_report_csv

HELPER = str(pathlib.Path(__file__).parent / "_torch_eval_davis_cpu.py")


def test_four_legs_on_cpu(davis_root, tmp_path, monkeypatch, capsys):
    """default, resume (killed after one checkpointed item, restarted with
    --resume), stacked and int8: every leg's CLI line, the resumed
    report's metric rows equal to the default leg's, exit code 0."""
    cli = rehearse._cli
    # the same command line, run by the CPU helper instead of `-m`
    monkeypatch.setattr(rehearse, "_cli", lambda *a, **k: [
        sys.executable, HELPER] + cli(*a, **k)[3:])
    out = tmp_path / "out"
    rc = rehearse.main([
        "--root", davis_root, "--rounds", "2", "--out", str(out),
        "--kill_after_items", "1",
        "--cli_extra", "--tiny --max_frames 4 --image_size 64 96"])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    assert rc == 0
    legs = {rec["leg"]: rec for rec in lines[:-1]}
    assert list(legs) == ["default", "resume", "stacked", "int8"]
    for rec in legs.values():
        assert 0.0 <= rec["auc"] <= 1.0
        assert rec["rounds_run"] > 0 and rec["wall_s"] > 0
        assert rec["p50_by_frame_bucket"]
    assert legs["resume"]["report_equals_uninterrupted"] is True
    # 2 sequences x 3 scribble sets x 2 rounds x 2 objects x 4 frames
    assert len(rehearse._metric_rows(str(out / "report_default.csv"))) == 96
    assert lines[-1]["failed"] == []
    assert set(lines[-1]["summary"]) == set(legs)


def test_report_items_and_rows(tmp_path):
    """The resume leg's readers: completed items in a report checkpoint
    (none for a missing file), and metric rows that ignore the row order
    and the timing column."""
    path = str(tmp_path / "r.csv")
    assert rehearse._items_in_csv(path) == 0
    rows = [dict(sequence=s, scribble_idx=k, interaction=0, object_id=1,
                 frame=f, jaccard=0.5 + f / 10, contour=0.25, timing=t)
            for t, (s, k, f) in enumerate([("a", 0, 0), ("a", 0, 1),
                                            ("a", 1, 0), ("b", 0, 0)])]
    write_report_csv(rows, path)
    assert rehearse._items_in_csv(path) == 3
    other = str(tmp_path / "s.csv")
    write_report_csv([dict(r, timing=9.0) for r in reversed(rows)], other)
    assert rehearse._metric_rows(path) == rehearse._metric_rows(other)
    write_report_csv([dict(r, jaccard=0.0) for r in rows], other)
    assert rehearse._metric_rows(path) != rehearse._metric_rows(other)
