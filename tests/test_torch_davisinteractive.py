"""The port's `davisinteractive` shim (`cvpr2020_manet_tpu_torch.
davisinteractive`) against the JAX-backed top-level shim, on the CPU.

Each test is the counterpart of one in `tests/test_davisinteractive_shim.py`:
the same numpy payloads, masks and trees go through both shims, and the
results must be equal (scribbles, operations, robot payloads, storage
rows, reports, decoded frames and drawn images) or, for the metrics,
within METRIC_TOL (the same counts divided in the same order: the port's
boundary F runs the native C++, the JAX shim's per-object columns SciPy;
the largest difference seen is 0). Session reports compare whole rows:
both sessions run on the same counter clock (a quarter second a read), so
the timing column and the summaries agree too.

The reference-style script runs both packages' `--synthetic --rounds 2
--report` on the same bridged weights (`checkpoints` of
`tests/test_torch_eval_davis.py`), in lockstep (`_Lockstep`: argmax ties
take JAX's labels) and on the counter clock: equal report rows, read with
`read_report_csv`, and an equal JSON line.
"""

import functools
import itertools
import json
import logging as stdlib_logging
import sys

import numpy as np
import pytest
import torch

import davisinteractive as jdi
from cvpr2020_manet_tpu.data import SyntheticDataset as JaxSynthetic
from cvpr2020_manet_tpu.engine.evaluator import Evaluator as JaxEvaluator
from cvpr2020_manet_tpu.interactive import session as jax_session_mod
from cvpr2020_manet_tpu_torch import davisinteractive as pdi
from cvpr2020_manet_tpu_torch import reference_style_eval
from cvpr2020_manet_tpu_torch.data import SyntheticDataset
from cvpr2020_manet_tpu_torch.engine import eval_davis
from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
from cvpr2020_manet_tpu_torch.interactive import session as port_session_mod
from cvpr2020_manet_tpu_torch.interactive.session import read_report_csv
from test_torch_eval_davis import _Lockstep, checkpoints  # noqa: F401

METRIC_TOL = 1e-12


def _payload(sequence="seq", frames=3):
    """A small payload annotated on two frames, in protocol JSON."""
    lines0 = [
        {"path": [[0.1, 0.1], [0.8, 0.1]], "object_id": 1},
        {"path": [[0.1, 0.9], [0.9, 0.9]], "object_id": 0},
    ]
    lines2 = [{"path": [[0.5, 0.2], [0.5, 0.8]], "object_id": 2}]
    scr = [[] for _ in range(frames)]
    scr[0] = lines0
    scr[2 % frames] = lines2
    return {"sequence": sequence, "scribbles": scr}


def _curvy_payload(frames=3):
    """Lines of several nodes, for the Bezier and points-only modes."""
    return {"sequence": "seq", "scribbles": [
        [{"path": [[0.1, 0.2], [0.4, 0.7], [0.8, 0.3], [0.9, 0.9]],
          "object_id": 1}],
        [],
        [{"path": [[0.9, 0.1], [0.2, 0.5], [0.6, 0.95]], "object_id": 2},
         {"path": [[0.05, 0.05]], "object_id": 0}]][:frames]}


def _both(module: str):
    """The JAX shim's and the port's submodule `module`."""
    import importlib
    return (importlib.import_module(f"davisinteractive.{module}"),
            importlib.import_module(
                f"cvpr2020_manet_tpu_torch.davisinteractive.{module}"))


def _counter():
    return functools.partial(next, itertools.count(0.0, 0.25))


def _rows(report):
    """A report as a list of plain dicts: the JAX session's DataFrame or the
    port's list of rows."""
    if hasattr(report, "to_dict"):
        report = report.to_dict("records")
    return [{k: (v.item() if hasattr(v, "item") else v) for k, v in r.items()}
            for r in report]


# ---------------------------------------------------------------- utils


def test_annotated_frames_and_is_empty():
    j, p = _both("utils.scribbles")
    for pay in (_payload(), _curvy_payload(),
                {"sequence": "s", "scribbles": [[], []]}):
        assert p.annotated_frames(pay) == j.annotated_frames(pay)
        assert p.is_empty(pay) == j.is_empty(pay)
        for obj in (0, 1, 2, 3):
            assert (p.annotated_frames_object(pay, obj)
                    == j.annotated_frames_object(pay, obj))
    assert p.annotated_frames(_payload()) == [0, 2]
    assert p.is_empty({"sequence": "s", "scribbles": [[], []]})


def test_fuse_scribbles():
    j, p = _both("utils.scribbles")
    a, b = _payload(), _curvy_payload()
    assert p.fuse_scribbles(a, b) == j.fuse_scribbles(a, b)
    assert len(p.fuse_scribbles(a, a)["scribbles"][0]) == 4
    for m in (j, p):
        with pytest.raises(ValueError, match="different sequences"):
            m.fuse_scribbles(a, _payload(sequence="other"))


def test_scribbles2mask_default_matches_jax():
    j, p = _both("utils.scribbles")
    from cvpr2020_manet_tpu_torch.interactive import scribbles as fw
    for pay in (_payload(), _curvy_payload()):
        got = p.scribbles2mask(pay, (24, 32))
        np.testing.assert_array_equal(got, j.scribbles2mask(pay, (24, 32)))
        np.testing.assert_array_equal(got, fw.scribbles2mask(pay, (24, 32)))
        assert got.shape == (3, 24, 32) and got.dtype == np.int32


def test_scribbles2mask_points_only_matches_jax():
    j, p = _both("utils.scribbles")
    for pay in (_payload(), _curvy_payload()):
        pts = p.scribbles2mask(pay, (24, 32), bresenham=False)
        np.testing.assert_array_equal(
            pts, j.scribbles2mask(pay, (24, 32), bresenham=False))
        full = p.scribbles2mask(pay, (24, 32))
        assert np.count_nonzero(pts >= 0) < np.count_nonzero(full >= 0)
        assert np.all(full[pts >= 0] == pts[pts >= 0])


@pytest.mark.parametrize("nb_points", [11, 2000])
def test_scribbles2mask_bezier_matches_jax(nb_points):
    j, p = _both("utils.scribbles")
    for pay in (_payload(), _curvy_payload()):
        np.testing.assert_array_equal(
            p.scribbles2mask(pay, (24, 32), bezier_curve_sampling=True,
                             nb_points=nb_points),
            j.scribbles2mask(pay, (24, 32), bezier_curve_sampling=True,
                             nb_points=nb_points))
    # two control points: the Bezier curve is the straight segment
    line = {"sequence": "s", "scribbles": [
        [{"path": [[0.1, 0.1], [0.8, 0.1]], "object_id": 1}]]}
    if nb_points == 2000:
        np.testing.assert_array_equal(
            p.scribbles2mask(line, (24, 32), bezier_curve_sampling=True,
                             nb_points=nb_points),
            p.scribbles2mask(line, (24, 32)))


@pytest.mark.parametrize("kwargs", [
    dict(only_annotated_frame=True, default_value=-7),
    dict(only_annotated_frame=True, bresenham=False),
    dict(only_annotated_frame=True, bezier_curve_sampling=True)])
def test_scribbles2mask_only_annotated_frame_matches_jax(kwargs):
    j, p = _both("utils.scribbles")
    for pay in (_payload(), _curvy_payload()):
        m = p.scribbles2mask(pay, (24, 32), **kwargs)
        np.testing.assert_array_equal(m, j.scribbles2mask(pay, (24, 32),
                                                          **kwargs))
        assert np.all(m[1] == kwargs.get("default_value", -1))


def test_scribbles2points_matches_jax():
    j, p = _both("utils.scribbles")
    for pay in (_payload(), _curvy_payload()):
        for res in (None, (24, 32)):
            xp, yp = p.scribbles2points(pay, output_resolution=res)
            xj, yj = j.scribbles2points(pay, output_resolution=res)
            np.testing.assert_array_equal(xp, xj)
            np.testing.assert_array_equal(yp, yj)
            assert xp.dtype == xj.dtype and yp.dtype == yj.dtype
    x, y = p.scribbles2points(_payload())
    assert x.shape == (6, 3) and set(y.tolist()) == {0, 1, 2}


def test_operations_match_jax():
    j, p = _both("utils.operations")
    for pts in ([[0, 0], [3, 0], [3, 2]], [[5, 5]], [[2, 7], [9, 1],
                                                      [0, 0], [4, 4]]):
        np.testing.assert_array_equal(p.bresenham(np.array(pts)),
                                      j.bresenham(np.array(pts)))
    line = p.bresenham(np.array([[0, 0], [3, 0], [3, 2]]))
    assert (line == [3, 0]).all(axis=1).sum() == 1
    rng = np.random.default_rng(0)
    for n in (1, 2, 5):
        ctrl = rng.random((n, 2))
        np.testing.assert_array_equal(p.bezier_curve(ctrl, nb_points=37),
                                      j.bezier_curve(ctrl, nb_points=37))
    for m in (j, p):
        with pytest.raises(ValueError, match=r"\(N, 2\)"):
            m.bresenham(np.zeros((3, 3)))


# -------------------------------------------------------------- metrics


@pytest.mark.parametrize("nb_objects", [None, 3])
def test_metrics_match_jax(nb_objects):
    """Upstream order (y_true, y_pred), nb_objects inferred or given,
    averaged and per object, bound_th: equal to JAX's within METRIC_TOL."""
    j, p = _both("metrics")
    rng = np.random.default_rng(0)
    gt = np.zeros((3, 48, 64), np.int32)
    gt[:, 8:30, 6:40] = 1
    gt[:, 20:44, 30:60] = 2
    pred = gt.copy()
    pred[:, :12] = 0
    pred[1, 30:40, 10:20] = 2
    pred[2] = rng.integers(0, 3, size=(48, 64))
    for avg in (True, False):
        for fn, kw in (("batched_jaccard", {}),
                       ("batched_f_measure", {}),
                       ("batched_f_measure", {"bound_th": 0.02})):
            got = getattr(p, fn)(gt, pred, average_over_objects=avg,
                                 nb_objects=nb_objects, **kw)
            want = getattr(j, fn)(gt, pred, average_over_objects=avg,
                                  nb_objects=nb_objects, **kw)
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=METRIC_TOL)
    jo = p.batched_jaccard(gt, pred, average_over_objects=False)
    assert jo.shape == (3, 2)
    np.testing.assert_allclose(jo.mean(axis=1), p.batched_jaccard(gt, pred),
                               rtol=0, atol=METRIC_TOL)


# ---------------------------------------------------------------- robot


@pytest.mark.parametrize("kwargs", [{}, dict(kernel_size=0.15,
                                             min_nb_nodes=3),
                                    dict(max_kernel_radius=4, nb_points=8)])
def test_robot_payloads_match_jax(kwargs):
    j, p = _both("robot")
    ds = JaxSynthetic(num_sequences=1, scribble_sets=1, num_frames=3)
    seq = ds.sequences()[0]
    gt = ds.gt_masks(seq)
    pred = np.zeros_like(gt)
    pred[0] = gt[0]
    rj = j.InteractiveScribblesRobot(**kwargs)
    rp = p.InteractiveScribblesRobot(**kwargs)
    for kw in ({}, {"frame": 1}, {"nb_objects": 2, "annotated": [0]}):
        got = rp.interact(seq, pred, gt, **kw)
        assert got == rj.interact(seq, pred, gt, **kw)
        assert isinstance(got, dict) and got["sequence"] == seq
        assert len(got["scribbles"]) == gt.shape[0]
    assert [i for i, lines in enumerate(
        rp.interact(seq, pred, gt, frame=1)["scribbles"]) if lines] == [1]


# -------------------------------------------------------------- session


def test_session_save_report_dir_matches_jax(tmp_path):
    """save_report_dir: the report CSV lands on disk when the session
    closes; the port's rows equal JAX's."""
    j, p = _both("session")
    reports = {}
    for name, module, dataset in (("jax", j, JaxSynthetic),
                                  ("port", p, SyntheticDataset)):
        ds = dataset(num_sequences=1, scribble_sets=1, num_frames=3)
        gt = ds.gt_masks(ds.sequences()[0])
        out = tmp_path / name
        with module.DavisInteractiveSession(
                dataset=ds, max_nb_interactions=2, save_report_dir=str(out),
                time_fn=_counter()) as sess:
            while sess.next():
                sess.submit_masks(gt)
        reports[name] = read_report_csv(str(out / "report.csv"))
        assert len(reports[name]) == len(sess.get_report())
    assert reports["port"] == reports["jax"]


def test_session_upstream_style_loop_matches_jax():
    """The reference eval loop, written only against the shims' imports:
    the same submissions give equal rows and summaries."""
    assert pdi.__is_manet_tpu_shim__ and jdi.__is_manet_tpu_shim__
    assert pdi.__version__ == jdi.__version__
    results = {}
    for name, top, dataset in (
            ("jax", "davisinteractive", JaxSynthetic),
            ("port", "cvpr2020_manet_tpu_torch.davisinteractive",
             SyntheticDataset)):
        import importlib
        ds = dataset(num_sequences=1, scribble_sets=2, num_frames=3)
        gt = {s: ds.gt_masks(s) for s in ds.sequences()}
        session = importlib.import_module(f"{top}.session")
        scribbles_mod = importlib.import_module(f"{top}.utils.scribbles")
        seen = []
        with session.DavisInteractiveSession(
                host="localhost", dataset=ds, max_nb_interactions=2,
                time_fn=_counter()) as sess:
            while sess.next():
                seq, scribbles, first = sess.get_scribbles(only_last=True)
                frames = scribbles_mod.annotated_frames(scribbles)
                h, w = gt[seq].shape[1:]
                seen.append((seq, frames, scribbles_mod.scribbles2mask(
                    scribbles, (h, w)).tolist(), first))
                sess.submit_masks(gt[seq] if not first
                                  else np.zeros_like(gt[seq]))
        results[name] = (seen, _rows(sess.get_report()),
                         sess.get_global_summary(max_time=10.0,
                                                 at_threshold=5.0))
    (sj, rj, gj), (sp, rp, gp) = results["jax"], results["port"]
    assert sp == sj and len(sp) == 2 * 2
    assert rp == rj
    assert gp["auc"] == gj["auc"] and 0.0 < gp["auc"] <= 1.0
    assert gp["metric_at_threshold"] == gj["metric_at_threshold"]


def test_evaluation_service_is_the_ports():
    """`evaluation.service` re-exports the port's server; a remote session
    through it scores as the JAX shim's server does."""
    j, p = _both("evaluation.service")
    from cvpr2020_manet_tpu_torch.interactive import service as port_service
    assert p.serve is port_service.serve
    assert p.EvaluationService is port_service.EvaluationService
    assert p.RemoteSession is port_service.RemoteSession
    rows = {}
    for name, module, dataset in (("jax", j, JaxSynthetic),
                                  ("port", p, SyntheticDataset)):
        ds = dataset(num_sequences=1, scribble_sets=1, num_frames=3)
        gt = ds.gt_masks(ds.sequences()[0])
        srv, thread = module.serve(ds)
        try:
            sess = pdi.DavisInteractiveSession(
                host=f"http://127.0.0.1:{srv.server_address[1]}",
                max_nb_interactions=1)
            assert isinstance(sess, p.RemoteSession)
            while sess.next():
                sess.submit_masks(gt)
            rows[name] = [{k: r[k] for k in r if k != "timing"}
                          for r in _rows(sess.get_report())]
        finally:
            srv.shutdown()
            thread.join(timeout=10)
    assert rows["port"] == rows["jax"] and len(rows["port"]) == 2 * 3


# -------------------------------------------------------------- dataset


def test_dataset_davis_over_tree_matches_jax(davis_root):
    """`Davis` over a DAVIS tree: subsets, metadata, scribbles and
    annotations equal to the JAX shim's; frames from the port's JPEG
    decoder bit-equal to PIL's (the JAX shim's)."""
    j, p = _both("dataset")
    dj, dp = j.Davis(davis_root), p.Davis(davis_root)
    assert dp.sets == dj.sets and dp.sets["val"] == ["seq_a", "seq_b"]
    dp.check_files(["seq_a"])
    assert dp.sequence_metadata("seq_a") == dj.sequence_metadata("seq_a") \
        == {"num_frames": 4, "num_scribbles": 3, "num_objects": 2,
            "image_size": (96, 64)}
    assert dp.dataset == dj.dataset
    for idx in (1, 3):
        assert dp.load_scribble("seq_b", idx) == dj.load_scribble("seq_b",
                                                                  idx)
    for seq in ("seq_a", "seq_b"):
        ann = dp.load_annotations(seq)
        np.testing.assert_array_equal(ann, dj.load_annotations(seq))
        assert ann.dtype == np.int32 and ann.shape == (4, 64, 96)
        imgs = dp.load_images(seq)
        np.testing.assert_array_equal(imgs, dj.load_images(seq))
        assert imgs.dtype == np.uint8 and imgs.shape == (4, 64, 96, 3)


def test_dataset_davis_requires_root(monkeypatch, davis_root):
    j, p = _both("dataset")
    monkeypatch.delenv("DATASET_DAVIS", raising=False)
    for m in (j, p):
        with pytest.raises(ValueError, match="root dir"):
            m.Davis()
    monkeypatch.setenv("DATASET_DAVIS", davis_root)
    assert p.Davis().sets == j.Davis().sets


def test_dataset_davis_check_files_raises_as_jax(davis_root):
    j, p = _both("dataset")
    msgs = []
    for m in (j, p):
        with pytest.raises(FileNotFoundError, match="no_such_seq") as e:
            m.Davis(davis_root).check_files(["no_such_seq"])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# -------------------------------------------------------------- storage


def _store_two(st):
    st.store_interactions_results(
        "user", "sess1", "seq_a", 1, 1, 2.5,
        objects_idx=[1, 1, 2, 2], frames_idx=[0, 1, 0, 1],
        jaccard=[0.5, 0.6, 0.7, 0.8], contour=[0.4, 0.5, 0.6, 0.7])
    st.store_interactions_results(
        "user", "sess1", "seq_a", 1, 2, 1.5,
        objects_idx=[1, 2], frames_idx=[0, 0],
        jaccard=[0.9, 0.95], contour=[0.9, 0.9])
    st.store_interactions_results(
        "user", "sess2", "seq_b", 3, 1, 0.5,
        objects_idx=[1], frames_idx=[2], jaccard=[1.0], contour=[0.0])


def test_local_storage_rows_match_jax():
    j, p = _both("storage")
    sj, sp = j.LocalStorage(), p.LocalStorage()
    assert isinstance(sp, p.AbstractStorage)
    assert p.AbstractStorage.COLUMNS == j.AbstractStorage.COLUMNS
    _store_two(sj)
    _store_two(sp)
    for sid in (None, "sess1", "sess2", "other"):
        got = sp.get_report(sid)
        assert _rows(got) == _rows(sj.get_report(sid))
        assert all(list(r) == p.AbstractStorage.COLUMNS for r in got)
    assert len(sp.get_report("sess1")) == 6 and sp.get_report("other") == []
    assert (sp.get_annotated_frames("sess1", "seq_a", 1)
            == sj.get_annotated_frames("sess1", "seq_a", 1) == [0, 1])


@pytest.mark.parametrize("args", [
    ("u", "s", "q", 1, 1, 0.0, [1], [0, 1], [0.5], [0.5]),
    ("u", "s", "q", 1, 1, 0.0, [1], [0], [1.5], [0.5]),
    ("u", "s", "q", 1, 1, 0.0, [1], [0], [0.5], [-0.1]),
    ("u", "s", "q", 1, 2, 0.0, [1], [0], [0.5], [0.5]),
    ("u", "s", "q", 1, 1, 0.0, [1], [0], [float("nan")], [0.5])],
    ids=["length", "jaccard", "contour", "order", "nan"])
def test_local_storage_validates_as_jax(args):
    j, p = _both("storage")
    msgs = []
    for m in (j, p):
        with pytest.raises(ValueError) as e:
            m.LocalStorage().store_interactions_results(*args)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# -------------------------------------------------------------- logging


def test_logging_shim_matches_jax(caplog):
    j, p = _both("logging")
    records = {}
    for name, m in (("jax", j), ("port", p)):
        m.set_info_level()
        caplog.clear()
        with caplog.at_level(stdlib_logging.INFO, logger="davisinteractive"):
            m.info("hello %s", "world")
            m.warning("careful")
            m.debug("hidden")
        records[name] = [(r.name, r.levelname, r.getMessage())
                         for r in caplog.records]
    assert records["port"] == records["jax"] == [
        ("davisinteractive", "INFO", "hello world"),
        ("davisinteractive", "WARNING", "careful")]


# ------------------------------------------------------------ visualize


def test_draw_scribble_matches_jax():
    """Bit-equal images, with and without the canvas resize (PIL's
    BILINEAR in the JAX shim, the port's native resize here)."""
    j, p = _both("utils.visualization")
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (40, 60, 3), dtype=np.uint8)
    payload = _payload(frames=2)
    for kw in ({"width": 3}, {"width": 1}, {"output_size": (80, 120)},
               {"output_size": (31, 47), "width": 5}):
        for frame in (0, 1):
            got = p.draw_scribble(img, payload, frame, **kw)
            np.testing.assert_array_equal(
                got, j.draw_scribble(img, payload, frame, **kw))
            assert got.dtype == np.uint8
    assert (p.draw_scribble(img, payload, 1) == img).all()  # no strokes
    assert (p.draw_scribble(img, payload, 0) != img).any()


class _RecordingAxes:
    def __init__(self):
        self.calls = []

    def plot(self, x, y, **kw):
        self.calls.append((np.asarray(x).tolist(), np.asarray(y).tolist(),
                           kw))


def test_plot_scribble_matches_jax():
    """`plot_scribble` draws on the caller's axes (any object with
    `plot`): the same lines and colors as the JAX shim."""
    j, p = _both("utils.visualization")
    for payload in (_payload(), _curvy_payload()):
        for kw in ({}, {"output_size": (24, 32), "linewidth": 2}):
            axes = {}
            for name, m in (("jax", j), ("port", p)):
                ax = _RecordingAxes()
                assert m.plot_scribble(ax, payload, 0, **kw) is ax
                axes[name] = ax.calls
            assert axes["port"] == axes["jax"] and axes["port"]


# ------------------------------------------------------------ the shim


def test_shim_names_and_isolation():
    """Every public name of the JAX shim exists in the port's, and the
    port's does not take the name `davisinteractive` in sys.modules."""
    for module, names in (
            ("", ["DavisInteractiveSession", "__version__",
                  "__is_manet_tpu_shim__"]),
            ("session", ["DavisInteractiveSession"]),
            ("dataset", ["Davis"]),
            ("storage", ["AbstractStorage", "LocalStorage"]),
            ("robot", ["InteractiveScribblesRobot"]),
            ("metrics", ["batched_jaccard", "batched_f_measure"]),
            ("evaluation", ["service"]),
            ("evaluation.service", ["EvaluationService", "RemoteSession",
                                    "serve"]),
            ("utils", ["operations", "scribbles", "visualization"]),
            ("utils.operations", ["bresenham", "bezier_curve"]),
            ("utils.scribbles", ["annotated_frames",
                                 "annotated_frames_object", "is_empty",
                                 "scribbles2mask", "scribbles2points",
                                 "fuse_scribbles"]),
            ("utils.visualization", ["plot_scribble", "draw_scribble"]),
            ("logging", ["set_logging_level", "set_info_level", "debug",
                         "info", "warning", "error"])):
        j, p = _both(module) if module else (jdi, pdi)
        assert sorted(getattr(p, "__all__")) == sorted(getattr(j, "__all__"))
        for n in names:
            assert hasattr(p, n), (module, n)
    assert sys.modules["davisinteractive"] is jdi
    assert pdi.DavisInteractiveSession is (
        port_session_mod.DavisInteractiveSession)


# ------------------------------------------------- the reference script


def test_reference_style_eval_matches_jax(tmp_path, checkpoints, capsys,
                                          monkeypatch):
    """Both packages' reference-style scripts, `--synthetic --rounds 2
    --report`, on the same bridged weights: equal report rows and an equal
    JSON line with the keys auc, jf_at_60s and rows."""
    from scripts.reference_style_eval import main as jax_main

    jdir, tdir = checkpoints
    monkeypatch.setattr(eval_davis, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    step = _Lockstep(int8=False)
    monkeypatch.setattr(JaxEvaluator, "run_round",
                        step.jax_run_round(JaxEvaluator.run_round))
    monkeypatch.setattr(Evaluator, "run_round",
                        step.port_run_round(Evaluator.run_round))
    for module in (jax_session_mod, port_session_mod):
        real_init = module.InteractiveSession.__init__

        def on_counter(self, *a, _init=real_init, **kw):
            _init(self, *a, time_fn=_counter(), **kw)
        monkeypatch.setattr(module.InteractiveSession, "__init__",
                            on_counter)
    reports, lines = {}, {}
    try:
        for name, main, ckpt in (("jax", jax_main, jdir),
                                 ("port", reference_style_eval.main, tdir)):
            reports[name] = str(tmp_path / name / "report.csv")
            main(["--synthetic", "--rounds", "2", "--checkpoint", ckpt,
                  "--report", reports[name]])
            lines[name] = json.loads(
                capsys.readouterr().out.strip().splitlines()[-1])
    finally:
        torch.set_num_threads(n)
    assert step.next == len(step.rounds) == 2
    assert set(lines["port"]) == {"auc", "jf_at_60s", "rows"}
    assert lines["port"] == lines["jax"] and lines["port"]["rows"] > 0
    rows = read_report_csv(reports["port"])
    assert len(rows) == lines["port"]["rows"]
    assert rows == read_report_csv(reports["jax"])
