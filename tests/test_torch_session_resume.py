"""The port's session resume hooks, DavisInteractiveSession and report CSV
helpers against the JAX package's session (pandas).

- `test_session_resume_hooks` and `test_davisinteractive_compat_constructor`
  of tests/test_session.py, each on the port's session and held against
  JAX's on the same synthetic data;
- `write_report_csv` writes the text `DataFrame.to_csv(index=False)`
  writes, apart from the `timing` values (wall clock);
- `read_report_csv` round-trips exactly;
- a run resumed from the CSV has the uninterrupted run's summary exactly,
  and JAX's resumed summary within 1e-12 (pandas' float parser need not
  round-trip every repr).
"""

import io

import numpy as np
import pandas as pd
import pytest

from cvpr2020_manet_tpu.data import SyntheticDataset as JaxSynthetic
from cvpr2020_manet_tpu.interactive.session import (
    DavisInteractiveSession as JaxDavisSession)
from cvpr2020_manet_tpu.interactive.session import (
    InteractiveSession as JaxSession)
from cvpr2020_manet_tpu_torch.data import SyntheticDataset
from cvpr2020_manet_tpu_torch.interactive.session import (
    REPORT_COLUMNS, DavisInteractiveSession, InteractiveSession,
    read_report_csv, write_report_csv)

def _fake_clock():
    state = {"t": 0.0}

    def clock():
        state["t"] += 1.0
        return state["t"]
    return clock


def _oracle(ds, seq, round_idx):
    """Ground truth after round 0, nothing in round 0."""
    gt = ds.gt_masks(seq)
    return np.zeros_like(gt) if round_idx == 0 else gt.copy()


def _drive(session, ds, predict=_oracle):
    rounds = {}
    with session as sess:
        while sess.next():
            seq, _, _ = sess.get_scribbles(only_last=True)
            r = rounds.get(sess.current, 0)
            sess.submit_masks(predict(ds, seq, r))
            rounds[sess.current] = r + 1
    return session


def _datasets(**kw):
    return SyntheticDataset(**kw), JaxSynthetic(**kw)


def test_session_resume_hooks():
    """on_item_end fires exactly once per finished item (the last one
    too), and a session resumed from a partial report reproduces the full
    run's report and summary exactly; the port's rows and summaries equal
    JAX's."""
    ds, jds = _datasets(num_sequences=2, scribble_sets=2, num_frames=3)
    done, jdone = [], []
    full = _drive(InteractiveSession(
        ds, max_interactions=3, time_fn=_fake_clock(),
        on_item_end=lambda s, i: done.append((s, i))), ds)
    jfull = _drive(JaxSession(
        jds, max_interactions=3, time_fn=_fake_clock(),
        on_item_end=lambda s, i: jdone.append((s, i))), jds)
    all_items = [(s, i) for s in ds.sequences() for i in range(2)]
    assert done == jdone == all_items            # once per item, in order
    assert full.finished and jfull.finished
    full_report = full.get_report()
    assert full_report == jfull.get_report().to_dict("records")

    completed = set(all_items[:2])
    seed = [r for r in full_report
            if (r["sequence"], r["scribble_idx"]) in completed]
    resumed = _drive(InteractiveSession(ds, max_interactions=3,
                                        time_fn=_fake_clock(),
                                        skip_items=completed,
                                        seed_rows=seed), ds)
    jseed = [r for r in jfull.get_report().to_dict("records")
             if (r["sequence"], r["scribble_idx"]) in completed]
    jresumed = _drive(JaxSession(jds, max_interactions=3,
                                 time_fn=_fake_clock(),
                                 skip_items=completed, seed_rows=jseed), jds)
    assert resumed.get_report() == full_report
    assert resumed.get_report() == jresumed.get_report().to_dict("records")
    for got, want in ((resumed.get_global_summary(),
                       full.get_global_summary()),
                      (resumed.get_global_summary(),
                       jresumed.get_global_summary())):
        assert got["auc"] == want["auc"]
        assert got["metric_at_threshold"] == want["metric_at_threshold"]
        np.testing.assert_array_equal(got["curve"][1], want["curve"][1])


def test_davisinteractive_compat_constructor(tmp_path):
    """Upstream's constructor signature (host/key ignored,
    max_nb_interactions, max_time, dataset= override); save_report_dir
    gets the report JAX's session writes there."""
    ds, jds = _datasets(num_sequences=1, scribble_sets=1, num_frames=2)
    reports = {}
    for name, cls, data in (("port", DavisInteractiveSession, ds),
                            ("jax", JaxDavisSession, jds)):
        out = tmp_path / name
        with cls(host="localhost", max_nb_interactions=2, max_time=None,
                 dataset=data, save_report_dir=str(out),
                 time_fn=_fake_clock()) as sess:
            assert sess.max_interactions == 2
            assert sess.next()
            seq, scribbles, first = sess.get_scribbles()
            assert first and scribbles["scribbles"]
            sess.submit_masks(np.zeros_like(data.gt_masks(seq)))
        reports[name] = (out / "report.csv").read_text()
    assert reports["port"] == reports["jax"]
    for cls in (DavisInteractiveSession, JaxDavisSession):
        with pytest.raises(ValueError, match="davis_root"):
            cls()


def _shifted(ds, seq, round_idx):
    """Ground truth shifted right by round_idx + 1 pixels: J and F values
    that are not 0 or 1, and errors for the robot in every round."""
    return np.roll(ds.gt_masks(seq), round_idx + 1, axis=2)


def _drive_shifted(session, ds):
    return _drive(session, ds, _shifted)


def test_report_csv_text_equals_pandas(tmp_path):
    """The same rows through write_report_csv and DataFrame.to_csv give
    the same text; against a JAX run (its own wall clock), the text of
    every column but timing."""
    ds, jds = _datasets(num_sequences=2, scribble_sets=2, num_frames=3)
    rows = _drive_shifted(InteractiveSession(ds, max_interactions=3),
                          ds).get_report()
    path = tmp_path / "r.csv"
    write_report_csv(rows, str(path))
    buf = io.StringIO()
    pd.DataFrame(rows, columns=REPORT_COLUMNS).to_csv(buf, index=False)
    assert path.read_text() == buf.getvalue()

    jrows = _drive_shifted(JaxSession(jds, max_interactions=3),
                           jds).get_report()
    buf = io.StringIO()
    jrows.to_csv(buf, index=False)

    def untimed(text):
        return [line.rsplit(",", 1)[0] for line in text.splitlines()]
    assert untimed(path.read_text()) == untimed(buf.getvalue())
    write_report_csv([], str(path))
    buf = io.StringIO()
    pd.DataFrame([], columns=REPORT_COLUMNS).to_csv(buf, index=False)
    assert path.read_text() == buf.getvalue()


def test_read_report_csv_round_trips(tmp_path):
    rng = np.random.default_rng(3)
    rows = [dict(sequence="seq,1" if i == 3 else f"s{i % 2}",
                 scribble_idx=i % 3, interaction=i, object_id=1 + i % 2,
                 frame=i, jaccard=float(rng.random()),
                 contour=float(rng.random() ** 9),
                 timing=float(rng.random() * 1e-7)) for i in range(40)]
    rows[0]["jaccard"] = 1.0
    path = str(tmp_path / "r.csv")
    write_report_csv(rows, path)
    back = read_report_csv(path)
    assert back == rows
    for r in back:
        assert type(r["sequence"]) is str and type(r["frame"]) is int
        assert type(r["timing"]) is float


def test_resumed_summary_equals_uninterrupted_and_jax(tmp_path):
    """Interrupt after the first two items (their rows in the CSV the CLI
    writes), resume from it: the port's report and summary equal its
    uninterrupted run's exactly (the counter clock gives every item the
    same timings); JAX, resumed from the same CSV through pandas, agrees
    within 1e-12."""
    ds, jds = _datasets(num_sequences=2, scribble_sets=2, num_frames=3)
    full = _drive_shifted(InteractiveSession(
        ds, max_interactions=3, time_fn=_fake_clock()), ds)
    items = [(s, i) for s in ds.sequences() for i in range(2)]
    completed = set(items[:2])
    path = str(tmp_path / "r.csv")
    write_report_csv([r for r in full.get_report()
                      if (r["sequence"], r["scribble_idx"]) in completed],
                     path)
    seed = read_report_csv(path)
    skip = {(r["sequence"], r["scribble_idx"]) for r in seed}
    assert skip == completed
    resumed = _drive_shifted(InteractiveSession(
        ds, max_interactions=3, time_fn=_fake_clock(), skip_items=skip,
        seed_rows=seed), ds)
    assert resumed.get_report() == full.get_report()
    got, want = resumed.get_global_summary(), full.get_global_summary()
    assert got["auc"] == want["auc"]
    assert got["metric_at_threshold"] == want["metric_at_threshold"]
    np.testing.assert_array_equal(got["curve"][1], want["curve"][1])

    jseed = pd.read_csv(path).to_dict("records")
    jresumed = _drive_shifted(JaxSession(
        jds, max_interactions=3, time_fn=_fake_clock(), skip_items=skip,
        seed_rows=jseed), jds)
    jgot = jresumed.get_global_summary()
    assert abs(jgot["auc"] - got["auc"]) <= 1e-12
    assert abs(jgot["metric_at_threshold"]
               - got["metric_at_threshold"]) <= 1e-12
