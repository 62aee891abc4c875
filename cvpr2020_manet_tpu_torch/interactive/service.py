"""Remote interactive-evaluation service (SURVEY.md C20, L6), PyTorch
port of the JAX package's `interactive/service.py`: the same server, client
and wire format, on the standard library alone (`http.server`, `urllib`,
`zlib`), so that a JAX server and a port client talk to each other, and
the other way round. Reports are row lists.

The upstream `davisinteractive` package runs in two modes: a local
service (in-process) and a REMOTE one, where `DavisInteractiveSession`
is pointed at an evaluation server's URL and the scribble handout /
mask scoring / robot all happen server-side — this is how the actual
DAVIS interactive challenge was hosted (ref: davisinteractive
`session.DavisInteractiveSession(host='https://server', key=...)`,
`evaluation.service.EvaluationService`). Our local mode is
`interactive.session.InteractiveSession`; this module adds the remote
half: the server owns the dataset, ground truth, robot, and the wall
clock (so a client cannot game the time-vs-quality curve), while the
model side stays a thin HTTP client with the
exact same `next / get_scribbles / submit_masks / get_report /
get_global_summary` surface.

Wire format (stdlib-only, no external deps):
  GET  /api/dataset                          -> sequences + per-sequence
       num_objects / num_scribble_sets / num_frames (NO ground truth)
  POST /api/session                          -> {"session_id": ...}
  POST /api/session/<id>/next                -> {"more": bool,
                                                 "current": [seq, set] | null}
  GET  /api/session/<id>/scribbles?only_last -> {"sequence", "scribbles",
                                                 "first_scribble"}
  POST /api/session/<id>/masks   body = zlib(uint8 C-order), header
       X-Shape: "T,H,W"                      -> {"ok": true}
  GET  /api/session/<id>/report              -> {"columns", "rows"}
  GET  /api/session/<id>/summary?max_time&at -> {"auc", "metric_at_threshold",
                                                 "curve": [grid, values]}
  DELETE /api/session/<id>                   -> {"ok": true}

Masks ride zlib-compressed (label maps compress ~50x; the transfer is
host<->host, not the device path). Each session is serialized by its own
lock; distinct sessions score concurrently (ThreadingHTTPServer).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
import uuid
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from cvpr2020_manet_tpu_torch.interactive.session import (
    REPORT_COLUMNS, InteractiveSession)


class UnknownSession(KeyError):
    pass


class BodyTooLarge(ValueError):
    pass


# Request-body hard cap. Masks ride zlib-compressed (a 100-frame 1080p
# uint8 label volume is ~200 MB raw but compresses ~50x); anything past
# this is either misuse or a decompression-bomb attempt.
MAX_BODY_BYTES = 64 << 20
# Hard cap on DECOMPRESSED mask bytes (~100 frames x 4K), enforced with
# a bounded decompress so a zlib bomb cannot materialize gigabytes.
MAX_MASK_BYTES = 1 << 30


class EvaluationService:
    """Server-side registry: one `InteractiveSession` per session id.

    Sessions outlive the protocol loop (reports stay queryable) but the
    registry is bounded: past `max_sessions`, the oldest session is
    evicted — a long-running server does not accumulate report rows
    without bound. `DELETE /api/session/<id>` frees one eagerly."""

    def __init__(self, dataset, *, robot=None, max_sessions: int = 64):
        self.dataset = dataset
        self.robot = robot
        self.max_sessions = max_sessions
        self._sessions: Dict[str, InteractiveSession] = {}
        self._locks: Dict[str, threading.Lock] = {}
        self._last_use: Dict[str, float] = {}
        self._registry_lock = threading.Lock()
        self._info_lock = threading.Lock()
        self._info: Optional[Dict[str, Any]] = None

    def _evict_one_locked(self) -> None:
        """Drop one session to make room. FINISHED sessions go first
        (their reports were retrievable since the protocol loop closed);
        among live ones, evict the least-recently-used that is not
        mid-request (lock held) — evicting an actively-served session
        would 404 its client mid-protocol."""
        by_age = sorted(self._sessions, key=lambda s: self._last_use[s])
        pick = next((s for s in by_age if self._sessions[s].finished), None)
        if pick is None:
            pick = next((s for s in by_age
                         if not self._locks[s].locked()), by_age[0])
        del self._sessions[pick], self._locks[pick], self._last_use[pick]

    def start_session(self, *, max_nb_interactions: int = 8,
                      max_time: Optional[float] = None,
                      metric_to_optimize: str = "J_AND_F") -> str:
        sess = InteractiveSession(
            self.dataset, max_interactions=max_nb_interactions,
            max_time=max_time, metric_to_optimize=metric_to_optimize,
            robot=self.robot)
        sid = uuid.uuid4().hex[:12]
        with self._registry_lock:
            while len(self._sessions) >= self.max_sessions:
                self._evict_one_locked()
            self._sessions[sid] = sess
            self._locks[sid] = threading.Lock()
            self._last_use[sid] = time.monotonic()
        return sid

    def get(self, sid: str) -> Tuple[InteractiveSession, threading.Lock]:
        with self._registry_lock:
            if sid not in self._sessions:
                raise UnknownSession(sid)
            self._last_use[sid] = time.monotonic()
            return self._sessions[sid], self._locks[sid]

    def close_session(self, sid: str) -> None:
        with self._registry_lock:
            self._sessions.pop(sid, None)
            self._locks.pop(sid, None)
            self._last_use.pop(sid, None)

    def dataset_info(self) -> Dict[str, Any]:
        """Public (non-ground-truth) dataset metadata for clients.

        Computed once and cached, under a lock: on a real DAVIS tree it
        decodes every GT PNG (for frame/object counts), which must not
        happen per request — nor concurrently when two clients race the
        first GET /api/dataset on the threading server."""
        with self._info_lock:
            if self._info is None:
                ds = self.dataset
                seqs = list(ds.sequences())
                self._info = {
                    "sequences": seqs,
                    "num_objects": {s: int(ds.num_objects(s)) for s in seqs},
                    "num_scribble_sets": {
                        s: int(ds.num_scribble_sets(s)) for s in seqs},
                    "num_frames": {
                        s: int(ds.gt_masks(s).shape[0]) for s in seqs},
                }
            return self._info


def _make_handler(service: EvaluationService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # silence per-request stderr spam
            pass

        def _json(self, payload: Dict[str, Any], status: int = 200):
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, status: int, msg: str):
            self._json({"error": msg}, status=status)

        def _route(self) -> Tuple[str, list, Dict[str, list]]:
            u = urlparse(self.path)
            return u.path, [p for p in u.path.split("/") if p], parse_qs(
                u.query)

        def _body(self) -> bytes:
            n = int(self.headers.get("Content-Length", "0"))
            if n > MAX_BODY_BYTES:
                # cannot safely drain an oversized body on keep-alive;
                # drop the connection after the error response
                self.close_connection = True
                raise BodyTooLarge(f"request body {n} B > "
                                   f"{MAX_BODY_BYTES} B cap")
            return self.rfile.read(n) if n else b""

        # -- verbs --------------------------------------------------------
        def do_POST(self):
            _, parts, _ = self._route()
            # ALWAYS drain the body first: on a keep-alive connection an
            # error response with unread body bytes would leave those
            # bytes to be parsed as the client's next request line
            try:
                raw = self._body()
            except BodyTooLarge as e:
                return self._error(413, str(e))
            try:
                if parts == ["api", "session"]:
                    params = json.loads(raw) if raw else {}
                    sid = service.start_session(
                        max_nb_interactions=int(
                            params.get("max_nb_interactions", 8)),
                        max_time=params.get("max_time"),
                        metric_to_optimize=params.get(
                            "metric_to_optimize", "J_AND_F"))
                    return self._json({"session_id": sid})
                if len(parts) == 4 and parts[:2] == ["api", "session"]:
                    sess, lock = service.get(parts[2])
                    if parts[3] == "next":
                        with lock:
                            more = sess.next()
                            cur = list(sess.current) if more else None
                        return self._json({"more": more, "current": cur})
                    if parts[3] == "masks":
                        x_shape = self.headers.get("X-Shape")
                        if x_shape is None:
                            return self._error(400, "missing X-Shape header")
                        shape = tuple(int(x) for x in x_shape.split(","))
                        expected = int(np.prod(shape))
                        if not 0 < expected <= MAX_MASK_BYTES:
                            return self._error(
                                400, f"X-Shape {shape} out of bounds")
                        # bounded decompress: a zlib bomb stops at
                        # expected+1 bytes instead of materializing GBs
                        d = zlib.decompressobj()
                        buf = d.decompress(raw, expected + 1)
                        if len(buf) != expected or d.unconsumed_tail:
                            return self._error(
                                400, f"mask payload does not decompress "
                                     f"to X-Shape {shape}")
                        masks = np.frombuffer(
                            buf, dtype=np.uint8).reshape(shape)
                        with lock:
                            sess.submit_masks(masks)
                        return self._json({"ok": True})
                return self._error(404, f"no route {self.path}")
            except UnknownSession as e:
                return self._error(404, f"unknown session {e}")
            except Exception as e:  # surface as 400, keep the server up
                return self._error(400, f"{type(e).__name__}: {e}")

        def do_GET(self):
            _, parts, query = self._route()
            try:
                self._body()  # drain: same keep-alive invariant as do_POST
            except BodyTooLarge as e:
                return self._error(413, str(e))
            try:
                if parts == ["api", "dataset"]:
                    return self._json(service.dataset_info())
                if len(parts) != 4 or parts[:2] != ["api", "session"]:
                    return self._error(404, f"no route {self.path}")
                sess, lock = service.get(parts[2])
                if parts[3] == "scribbles":
                    only_last = query.get("only_last", ["0"])[0] == "1"
                    with lock:
                        seq, scr, first = sess.get_scribbles(
                            only_last=only_last)
                    return self._json({"sequence": seq, "scribbles": scr,
                                       "first_scribble": first})
                if parts[3] == "report":
                    with lock:
                        rows = sess.get_report()
                    return self._json({
                        "columns": REPORT_COLUMNS,
                        "rows": [[r[c] for c in REPORT_COLUMNS]
                                 for r in rows]})
                if parts[3] == "summary":
                    kw = {}
                    if "max_time" in query:
                        kw["max_time"] = float(query["max_time"][0])
                    if "at" in query:
                        kw["at_threshold"] = float(query["at"][0])
                    with lock:
                        s = sess.get_global_summary(**kw)
                    curve = s.get("curve")
                    return self._json({
                        "auc": s["auc"],
                        "metric_at_threshold": s["metric_at_threshold"],
                        "curve": None if curve is None else
                        [np.asarray(c).tolist() for c in curve]})
                return self._error(404, f"no route {self.path}")
            except UnknownSession as e:
                return self._error(404, f"unknown session {e}")
            except Exception as e:
                return self._error(400, f"{type(e).__name__}: {e}")

        def do_DELETE(self):
            _, parts, _ = self._route()
            try:
                self._body()  # drain: same keep-alive invariant as do_POST
            except BodyTooLarge as e:
                return self._error(413, str(e))
            if len(parts) == 3 and parts[:2] == ["api", "session"]:
                service.close_session(parts[2])
                return self._json({"ok": True})
            return self._error(404, f"no route {self.path}")

    return Handler


def serve(dataset, *, host: str = "127.0.0.1", port: int = 0, robot=None
          ) -> Tuple[ThreadingHTTPServer, threading.Thread]:
    """Start an evaluation server in a daemon thread; returns it bound
    (``server.server_address`` carries the OS-chosen port when 0)."""
    service = EvaluationService(dataset, robot=robot)
    server = ThreadingHTTPServer((host, port), _make_handler(service))
    server.service = service
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


class _RemoteDatasetView:
    """Client-side dataset: frames come from a LOCAL image source (the
    model side owns the video, as in the hosted DAVIS challenge), metadata
    from the server's /api/dataset — and there is deliberately no
    `gt_masks`: ground truth lives only server-side. Where the source
    offers raw uint8 frames (`images_uint8`), the view offers them too, so
    that a remote run feeds the model the frames a local run feeds it."""

    def __init__(self, session: "RemoteSession", images_source=None):
        self._session = session
        self._images = images_source
        self._info = None
        if hasattr(images_source, "images_uint8"):
            self.images_uint8 = images_source.images_uint8

    def _meta(self) -> Dict[str, Any]:
        if self._info is None:
            self._info = self._session._get("/api/dataset")
        return self._info

    def sequences(self):
        return list(self._meta()["sequences"])

    def num_objects(self, seq: str) -> int:
        return int(self._meta()["num_objects"][seq])

    def num_scribble_sets(self, seq: str) -> int:
        return int(self._meta()["num_scribble_sets"][seq])

    def num_frames(self, seq: str) -> int:
        return int(self._meta()["num_frames"][seq])

    def images(self, seq: str) -> np.ndarray:
        if self._images is None:
            raise RuntimeError(
                "RemoteSession has no local image source: pass images=... "
                "(any adapter with .images(seq)) to drive a model loop")
        return self._images.images(seq)


class RemoteSession:
    """Client with the exact `InteractiveSession` surface, over HTTP.

    `DavisInteractiveSession(host='http://server:port', ...)` constructs
    one of these (session.py) — the same source-level loop (including
    `Evaluator.run_session`) drives local and remote evaluation, as with
    the upstream package's two modes. `images` is the client-local frame
    source (e.g. a `DavisEvalDataset` over the local DAVIS images);
    scoring and ground truth stay server-side. The server session is kept
    alive past `__exit__` so reports remain queryable; `close()` frees it.
    """

    def __init__(self, host: str, *, max_nb_interactions: int = 8,
                 max_time: Optional[float] = None,
                 metric_to_optimize: str = "J_AND_F", timeout: float = 60.0,
                 images=None):
        self.host = host.rstrip("/")
        self.timeout = timeout
        self.dataset = _RemoteDatasetView(self, images)
        self._current: Optional[Tuple[str, int]] = None
        self.session_id = self._post("/api/session", json.dumps({
            "max_nb_interactions": max_nb_interactions,
            "max_time": max_time,
            "metric_to_optimize": metric_to_optimize,
        }).encode())["session_id"]

    # -- transport ---------------------------------------------------------
    def _request(self, method: str, path: str, body: Optional[bytes] = None,
                 headers: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
        req = urllib.request.Request(
            self.host + path, data=body, method=method,
            headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")
            try:
                detail = json.loads(detail).get("error", detail)
            except ValueError:
                pass
            raise RuntimeError(
                f"{method} {path} -> HTTP {e.code}: {detail}") from None

    def _post(self, path, body=None, headers=None):
        return self._request("POST", path, body, headers)

    def _get(self, path):
        return self._request("GET", path)

    # -- InteractiveSession surface ----------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        # keep the server session: reports/summary are fetched after the
        # protocol loop closes (run_session does exactly this)
        return False

    def close(self) -> None:
        """Free the server-side session (reports become unavailable)."""
        try:
            self._request("DELETE", f"/api/session/{self.session_id}")
        except (RuntimeError, OSError):
            pass  # server gone; nothing to release client-side

    @property
    def current(self) -> Optional[Tuple[str, int]]:
        """(sequence, scribble_set) of the round handed out by `next()`."""
        return self._current

    def next(self) -> bool:
        r = self._post(f"/api/session/{self.session_id}/next")
        self._current = None if r["current"] is None else tuple(r["current"])
        return r["more"]

    def get_scribbles(self, only_last: bool = False):
        r = self._get(f"/api/session/{self.session_id}/scribbles"
                      f"?only_last={int(only_last)}")
        return r["sequence"], r["scribbles"], r["first_scribble"]

    def submit_masks(self, masks: np.ndarray) -> None:
        masks = np.ascontiguousarray(np.asarray(masks, dtype=np.uint8))
        self._post(
            f"/api/session/{self.session_id}/masks",
            zlib.compress(masks.tobytes(), level=1),
            headers={"X-Shape": ",".join(str(s) for s in masks.shape),
                     "Content-Type": "application/octet-stream"})

    def get_report(self) -> list[Dict[str, Any]]:
        """The server session's report rows, keyed by REPORT_COLUMNS."""
        r = self._get(f"/api/session/{self.session_id}/report")
        return [dict(zip(r["columns"], row)) for row in r["rows"]]

    def get_global_summary(self, max_time: float = 240.0,
                           at_threshold: float = 60.0) -> Dict[str, Any]:
        s = self._get(f"/api/session/{self.session_id}/summary"
                      f"?max_time={max_time}&at={at_threshold}")
        if s["curve"] is not None:
            s["curve"] = tuple(np.asarray(c) for c in s["curve"])
        return s


def main(argv=None):
    """Serve a DAVIS tree (or the synthetic fixture) for remote eval:

        python -m cvpr2020_manet_tpu_torch.interactive.service \
            --davis_root /data/DAVIS --subset val --port 8080
    """
    import argparse

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--davis_root", default=None)
    p.add_argument("--subset", default="val")
    p.add_argument("--synthetic", action="store_true",
                   help="serve the synthetic fixture dataset (testing)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    args = p.parse_args(argv)

    if args.synthetic:
        from cvpr2020_manet_tpu_torch.data.synthetic import SyntheticDataset
        dataset = SyntheticDataset()
    elif args.davis_root:
        from cvpr2020_manet_tpu_torch.data.davis import DavisEvalDataset
        dataset = DavisEvalDataset(args.davis_root, subset=args.subset)
    else:
        p.error("pass --davis_root or --synthetic")
    server, thread = serve(dataset, host=args.host, port=args.port)
    print(f"evaluation service on http://{args.host}:"
          f"{server.server_address[1]}", flush=True)
    try:
        thread.join()
    except KeyboardInterrupt:
        server.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
