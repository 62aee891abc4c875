"""The port's remote evaluation service (interactive/service.py): the cases
of tests/test_service.py on the port's server and client, and the two
packages against each other over the same wire format: the port's
RemoteSession against JAX's server, and JAX's RemoteSession against the
port's server, with equal report rows and summaries."""

import functools
import json
import threading
import urllib.request
import zlib

import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from cvpr2020_manet_tpu.interactive import service as jax_service
from cvpr2020_manet_tpu.interactive.session import (
    InteractiveSession as JaxSession)
from cvpr2020_manet_tpu_torch.data.synthetic import SyntheticDataset
from cvpr2020_manet_tpu_torch.engine import eval_davis
from cvpr2020_manet_tpu_torch.interactive import service
from cvpr2020_manet_tpu_torch.interactive.service import (
    EvaluationService, RemoteSession, serve)
from cvpr2020_manet_tpu_torch.interactive.session import (
    REPORT_COLUMNS, DavisInteractiveSession, InteractiveSession)

SCORE_COLS = REPORT_COLUMNS[:-1]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # tiny shapes: parallel test workers would oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def server():
    ds = SyntheticDataset(num_sequences=2, scribble_sets=2, num_frames=3)
    srv, thread = serve(ds, port=0)
    yield srv, ds
    srv.shutdown()
    thread.join(timeout=10)


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setattr(eval_davis, "resolve_device",
                        lambda device=None: torch.device("cpu"))


def _url(srv):
    return f"http://127.0.0.1:{srv.server_address[1]}"


def _degraded(gt: np.ndarray, t_keep: int = 0) -> np.ndarray:
    """Ground truth on frame t_keep, background elsewhere: real errors for
    the robot to scribble on every round."""
    pred = np.zeros_like(gt)
    pred[t_keep] = gt[t_keep]
    return pred


def _run(session, ds, rounds_log=None):
    with session as sess:
        while sess.next():
            seq, scribbles, first = sess.get_scribbles()
            assert scribbles["sequence"] == seq
            if rounds_log is not None:
                rounds_log.append((seq, first))
            sess.submit_masks(_degraded(ds.gt_masks(seq)))
        report = sess.get_report()
        summary = sess.get_global_summary()
    return report, summary


def _scores(rows):
    return [[r[c] for c in SCORE_COLS] for r in rows]


def test_remote_session_full_protocol(server):
    srv, ds = server
    log = []
    report, summary = _run(RemoteSession(_url(srv), max_nb_interactions=3),
                           ds, log)
    assert 4 <= len(log) <= 12
    assert sum(first for _, first in log) == 4
    assert report and list(report[0]) == REPORT_COLUMNS
    assert 0.0 < summary["auc"] <= 1.0
    assert summary["curve"] is not None and len(summary["curve"][0]) == 481


def test_remote_matches_local_scores(server):
    srv, ds = server
    remote_report, _ = _run(
        RemoteSession(_url(srv), max_nb_interactions=3), ds)
    local_report, _ = _run(InteractiveSession(ds, max_interactions=3), ds)
    assert _scores(remote_report) == _scores(local_report)


def test_davis_session_http_host_returns_remote(server):
    srv, _ = server
    sess = DavisInteractiveSession(host=_url(srv), max_nb_interactions=2)
    assert isinstance(sess, RemoteSession)
    with sess:
        assert sess.next()
        seq, scribbles, first = sess.get_scribbles(only_last=True)
        assert first and scribbles["scribbles"]


def test_run_session_drives_remote_like_local(server, cpu):
    """Evaluator.run_session over a RemoteSession gives the local session's
    scores; the client's dataset view has no ground truth."""
    from cvpr2020_manet_tpu_torch.config import tiny_test_config

    srv, ds = server
    cfg = tiny_test_config()
    remote = RemoteSession(_url(srv), max_nb_interactions=2, images=ds)
    assert not hasattr(remote.dataset, "gt_masks")
    s_remote = eval_davis.build_evaluator(cfg).run_session(remote)
    local = InteractiveSession(ds, max_interactions=2)
    s_local = eval_davis.build_evaluator(cfg).run_session(local)
    assert _scores(remote.get_report()) == _scores(local.get_report())
    # the time axis differs (HTTP round trips land on the curve)
    assert np.isclose(s_remote["auc"], s_local["auc"], atol=0.01)
    assert np.isclose(s_remote["metric_at_threshold"],
                      s_local["metric_at_threshold"], atol=0.01)
    remote.close()
    with pytest.raises(RuntimeError, match="404"):
        remote.get_report()


def test_eval_davis_cli_remote_host(davis_root, cpu, capsys):
    """`eval_davis --host http://...` drives the full CLI against a served
    DAVIS tree."""
    from cvpr2020_manet_tpu_torch.data.davis import DavisEvalDataset

    ds = DavisEvalDataset(davis_root, subset="train", scribble_sets=1)
    srv, _ = serve(ds)
    try:
        eval_davis.main(["--davis_root", davis_root, "--subset", "train",
                         "--tiny", "--rounds", "2", "--scribble_sets", "1",
                         "--host", _url(srv)])
    finally:
        srv.shutdown()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["rounds_run"] >= 2 and 0.0 <= out["auc"] <= 1.0


def test_session_registry_bounded():
    ds = SyntheticDataset(num_sequences=1, scribble_sets=1, num_frames=2)
    svc = EvaluationService(ds, max_sessions=3)
    sids = [svc.start_session() for _ in range(5)]
    assert len(svc._sessions) == 3
    for sid in sids[:2]:                      # oldest two evicted
        with pytest.raises(KeyError):
            svc.get(sid)
    svc.get(sids[-1])


def test_concurrent_sessions_and_dataset_info(server):
    srv, ds = server
    infos, errors = [], []

    def client():
        try:
            sess = RemoteSession(_url(srv), max_nb_interactions=2)
            infos.append(sess.dataset._meta())
            rows = []
            _run(sess, ds, rows)
            assert len(rows) > 0
            infos.append(len(sess.get_report()))
        except Exception as e:  # surfaces in the main thread
            errors.append(e)

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    metas = [i for i in infos if isinstance(i, dict)]
    counts = [i for i in infos if isinstance(i, int)]
    assert len(metas) == len(counts) == 4
    assert all(m == metas[0] for m in metas)
    assert all(c == counts[0] and c > 0 for c in counts)


def test_remote_errors_surface(server):
    srv, _ = server
    sess = RemoteSession(_url(srv))
    with pytest.raises(RuntimeError, match="RuntimeError"):
        sess.submit_masks(np.zeros((3, 32, 48), np.uint8))
    bad = RemoteSession.__new__(RemoteSession)
    bad.host, bad.timeout, bad.session_id = sess.host, 5.0, "deadbeef"
    with pytest.raises(RuntimeError, match="404"):
        bad.next()


def test_eviction_prefers_finished_sessions():
    ds = SyntheticDataset(num_sequences=1, scribble_sets=1, num_frames=3)
    svc = EvaluationService(ds, max_sessions=2)
    done = svc.start_session(max_nb_interactions=1)
    sess, _ = svc.get(done)
    while sess.next():
        sess.submit_masks(ds.gt_masks(ds.sequences()[0]))
    assert sess.finished
    live = svc.start_session(max_nb_interactions=8)
    svc.get(live)[0].next()                      # live session, mid-item
    third = svc.start_session(max_nb_interactions=8)
    with pytest.raises(KeyError):
        svc.get(done)
    svc.get(live)
    svc.get(third)


def test_masks_endpoint_rejects_bomb_and_bad_shape(server):
    srv, _ = server
    base = _url(srv)

    def post(path, data=b"", headers=None):
        req = urllib.request.Request(base + path, data=data,
                                     headers=headers or {}, method="POST")
        try:
            with urllib.request.urlopen(req) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    sid = post("/api/session")[1]["session_id"]
    post(f"/api/session/{sid}/next")
    bomb = zlib.compress(b"\0" * (1 << 20), level=9)
    code, body = post(f"/api/session/{sid}/masks", bomb,
                      {"X-Shape": "3,4,4"})
    assert code == 400 and "decompress" in body["error"]
    code, body = post(f"/api/session/{sid}/masks", zlib.compress(b"\0"),
                      {"X-Shape": "100000,10000,10000"})
    assert code == 400 and "out of bounds" in body["error"]


def _counter_clock():
    state = {"t": 0.0}

    def clock():
        state["t"] += 1.0
        return state["t"]
    return clock


@pytest.mark.parametrize("direction", ["port_client_jax_server",
                                       "jax_client_port_server"])
def test_cross_package_wire_format(monkeypatch, direction):
    """Each package's client against the other's server, the servers'
    sessions on a counter clock: the report rows and the summary equal a
    local port session's on the same data and clock."""
    kw = dict(num_sequences=2, scribble_sets=2, num_frames=3)
    ds, jds = SyntheticDataset(**kw), JaxSynthetic(**kw)
    monkeypatch.setattr(service, "InteractiveSession", functools.partial(
        InteractiveSession, time_fn=_counter_clock()))
    monkeypatch.setattr(jax_service, "InteractiveSession", functools.partial(
        JaxSession, time_fn=_counter_clock()))
    if direction == "port_client_jax_server":
        srv, _ = jax_service.serve(jds, port=0)
        client = RemoteSession(_url(srv), max_nb_interactions=3)
    else:
        srv, _ = serve(ds, port=0)
        client = jax_service.RemoteSession(_url(srv), max_nb_interactions=3)
    try:
        report, summary = _run(client, ds)
    finally:
        srv.shutdown()
    if direction == "jax_client_port_server":
        report = report.to_dict("records")
    local_report, local_summary = _run(InteractiveSession(
        ds, max_interactions=3, time_fn=_counter_clock()), ds)
    assert [[r[c] for c in REPORT_COLUMNS] for r in report] == \
        [[r[c] for c in REPORT_COLUMNS] for r in local_report]
    assert summary["auc"] == local_summary["auc"]
    assert summary["metric_at_threshold"] == \
        local_summary["metric_at_threshold"]
    np.testing.assert_array_equal(summary["curve"][1],
                                  local_summary["curve"][1])
