"""Interactive benchmark session — local-service equivalent of
`davisinteractive.session.DavisInteractiveSession` (SURVEY.md C20, L6).

Copy of the JAX package's `interactive/session.py` without pandas: the
report is a list of row dicts, the summary is built with numpy, giving the
same numbers, and `write_report_csv` / `read_report_csv` write and read
the CSV that `DataFrame.to_csv(index=False)` writes for the report.

Protocol (HIGH confidence, SURVEY.md §1):
  for each sequence × scribble set:
    round 0: hand-drawn initial scribbles       -> model -> masks
    rounds 1..R-1: robot scribbles on the worst frame of the previous
    submission -> model -> masks
  every submission is scored (per-frame, per-object J and boundary F) and
  timestamped; the report yields the time-vs-quality curve -> AUC and
  J&F@60s.

API mirrors the external package: context manager, `next()`,
`get_scribbles(only_last=...)`, `submit_masks(...)`, `get_report()`,
`get_global_summary()`.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

from cvpr2020_manet_tpu_torch.interactive.metrics import batched_f_measure
from cvpr2020_manet_tpu_torch.interactive.robot import InteractiveScribblesRobot
from cvpr2020_manet_tpu_torch.interactive.scribbles import (
    Scribbles, annotated_frames)
from cvpr2020_manet_tpu_torch.utils.profiling import annotate

REPORT_COLUMNS = [
    "sequence", "scribble_idx", "interaction", "object_id", "frame",
    "jaccard", "contour", "timing",
]


class InteractiveSession:
    def __init__(self, dataset, *, max_interactions: int = 8,
                 max_time: Optional[float] = None,
                 metric_to_optimize: str = "J_AND_F",
                 robot: Optional[InteractiveScribblesRobot] = None,
                 time_fn=time.perf_counter,
                 skip_items=None, seed_rows=None, on_item_end=None):
        """`time_fn` is the clock of the per-round timestamps (tests inject
        a counter). skip_items/seed_rows/on_item_end RESUME an interrupted
        run: skip_items is a set of completed (sequence, scribble_idx)
        pairs dropped from the work queue, seed_rows re-seeds their report
        rows (so the final summary spans the whole dataset), and
        on_item_end(sequence, scribble_idx) fires exactly once when an item
        finishes — the hook callers use to checkpoint the report after
        every item (engine/eval_davis.py --resume)."""
        self.dataset = dataset
        self.max_interactions = max_interactions
        # davisinteractive semantics: per-(sequence x scribble-set) time
        # budget in seconds, scaled by the sequence's object count; the
        # item stops when EITHER budget is exhausted. Timing includes the
        # scribble-robot time (it is part of the service wall clock).
        self.max_time = max_time
        self.metric = metric_to_optimize
        self.robot = robot or InteractiveScribblesRobot()
        self._time = time_fn
        self.on_item_end = on_item_end
        # (sequence, scribble_set) work queue
        skip = skip_items or set()
        self._queue = [(s, i) for s in dataset.sequences()
                       for i in range(dataset.num_scribble_sets(s))
                       if (s, i) not in skip]
        self._seed_rows = list(seed_rows) if seed_rows is not None else []
        self._pos = -1
        self._interaction = 0          # rounds done for current item
        self._scribbles: Optional[Scribbles] = None   # accumulated
        self._last_scribbles: Optional[Scribbles] = None
        self._annotated: list[int] = []
        self._rows: list[dict] = []
        self._t_handout = 0.0
        self._elapsed = 0.0            # accumulated model time, current item
        self._awaiting_submit = False

    # -- context manager -------------------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    # -- protocol ---------------------------------------------------------
    def next(self) -> bool:
        """Advance to the next interaction. False when the session is done."""
        if self._awaiting_submit:
            raise RuntimeError("submit_masks() before calling next() again")
        if self._pos < 0 or self._interaction >= self.max_interactions:
            if self._pos >= 0 and self.on_item_end is not None:
                # the item at _pos just finished (all rounds done or
                # stopped early): fires once per item, the last one too,
                # on the final next() that returns False
                self.on_item_end(*self._queue[self._pos])
            self._pos += 1
            if self._pos >= len(self._queue):
                return False
            seq, set_idx = self._queue[self._pos]
            self._interaction = 0
            self._elapsed = 0.0
            self._annotated = []
            init = self.dataset.initial_scribbles(seq, set_idx)
            self._scribbles = init
            self._last_scribbles = init
        self._awaiting_submit = True
        self._t_handout = self._time()
        return True

    @property
    def current(self):
        return self._queue[self._pos]

    @property
    def finished(self) -> bool:
        """True once next() has exhausted the work queue (the report
        stays queryable; the session accepts no more masks)."""
        return self._pos >= len(self._queue)

    def get_scribbles(self, only_last: bool = False):
        """-> (sequence, scribbles_json, first_scribble)."""
        seq, _ = self.current
        scr = self._last_scribbles if only_last else self._scribbles
        return seq, scr.to_json(), self._interaction == 0

    def submit_masks(self, masks: np.ndarray) -> None:
        """Score a full-video label map (T, H, W) and prepare next round.

        Spans (`utils/profiling.annotate`, recorded only while a profiler
        runs on the calling thread): `manet.session.submit` over the
        call, with `manet.session.submit.score` (the ground truth read and
        the per-object J and F) and `manet.session.submit.robot` (the
        robot's next scribbles, on rounds that have a next one)."""
        with annotate("manet.session.submit"):
            if not self._awaiting_submit:
                raise RuntimeError("call next() before submit_masks()")
            dt = self._time() - self._t_handout
            self._elapsed += dt
            seq, set_idx = self.current
            with annotate("manet.session.submit.score"):
                gt = self.dataset.gt_masks(seq)
                n_obj = self.dataset.num_objects(seq)
                masks = np.asarray(masks)
                assert masks.shape == gt.shape, (masks.shape, gt.shape)

                self._annotated.extend(annotated_frames(self._last_scribbles))
                for obj in range(1, n_obj + 1):
                    m_obj, g_obj = masks == obj, gt == obj
                    jj = np.array([_iou(m_obj[t], g_obj[t])
                                   for t in range(gt.shape[0])])
                    ff = batched_f_measure(
                        m_obj.view(np.uint8), g_obj.view(np.uint8), 1)
                    for t in range(gt.shape[0]):
                        self._rows.append(dict(
                            sequence=seq, scribble_idx=set_idx,
                            interaction=self._interaction, object_id=obj,
                            frame=t, jaccard=float(jj[t]),
                            contour=float(ff[t]), timing=self._elapsed))

            self._interaction += 1
            self._awaiting_submit = False
            if (self.max_time is not None
                    and self._elapsed >= self.max_time * max(n_obj, 1)):
                # time budget for this item exhausted (davisinteractive stops
                # on max_time OR max_nb_interactions, whichever first)
                self._interaction = self.max_interactions
            if self._interaction < self.max_interactions:
                with annotate("manet.session.submit.robot"):
                    t_robot = self._time()
                    new = self.robot.interact(
                        seq, masks, gt, n_obj, annotated=self._annotated)
                    # robot time is service time: it lands in the NEXT round's
                    # cumulative timestamp, as in the upstream local service
                    self._elapsed += self._time() - t_robot
                if not annotated_frames(new):
                    # prediction is (near-)perfect: the robot has nothing to
                    # correct — end this item early
                    self._interaction = self.max_interactions
                else:
                    self._last_scribbles = new
                    self._scribbles = self._scribbles.merge(new)

    # -- reporting ----------------------------------------------------------
    def get_report(self) -> List[Dict[str, Any]]:
        """Per-(round, object, frame) score rows, keyed by REPORT_COLUMNS:
        the seed rows of a resumed run first, then this run's."""
        return [{k: row[k] for k in REPORT_COLUMNS}
                for row in self._seed_rows + self._rows]

    def get_global_summary(
        self, max_time: float = 240.0, at_threshold: float = 60.0
    ) -> Dict[str, Any]:
        """Time-vs-quality curve -> AUC (normalized) and J&F@threshold.

        Follows the davisinteractive summary semantics: for each
        (sequence, scribble set), quality at time t is the J&F of the last
        interaction whose cumulative model time is <= t (0 before the
        first); curves are averaged across items, AUC is the normalized
        integral over [0, max_time]. Items are visited in sorted key order
        and each round's J&F is the compensated mean of its rows in report
        order — the arithmetic of the pandas groupby in the JAX package, so
        the two summaries agree to the last bit.
        """
        rows = self.get_report()
        if not rows:
            return {"auc": 0.0, "metric_at_threshold": 0.0, "curve": None}
        # (sequence, scribble_idx) -> interaction -> (jf values, timings)
        items: Dict[tuple, Dict[int, tuple]] = {}
        for row in rows:
            rounds = items.setdefault(
                (row["sequence"], row["scribble_idx"]), {})
            jfs, times = rounds.setdefault(row["interaction"], ([], []))
            jfs.append(0.5 * (row["jaccard"] + row["contour"]))
            times.append(row["timing"])
        grid = np.linspace(0.0, max_time, 481)
        curves = []
        for key in sorted(items):
            q = np.zeros_like(grid)
            for _, (jfs, times) in sorted(items[key].items()):
                q[grid >= max(times)] = compensated_mean(jfs)
            curves.append(q)
        mean_curve = np.mean(curves, axis=0)
        auc = float(np.trapezoid(mean_curve, grid) / max_time)
        at = float(np.interp(at_threshold, grid, mean_curve))
        return {"auc": auc, "metric_at_threshold": at,
                "curve": (grid, mean_curve)}


def compensated_mean(values: List[float]) -> float:
    """Kahan-compensated sum in order, divided by the count."""
    total = comp = 0.0
    for v in values:
        y = v - comp
        t = total + y
        comp = t - total - y
        total = t
    return total / len(values)


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    union = np.count_nonzero(a | b)
    if union == 0:
        return 1.0
    return float(np.count_nonzero(a & b) / union)


# ------------------------------------------------------------ report CSV
_INT_COLUMNS = ("scribble_idx", "interaction", "object_id", "frame")
_FLOAT_COLUMNS = ("jaccard", "contour", "timing")


def write_report_csv(rows: List[Dict[str, Any]], path: str) -> None:
    """The report as `pd.DataFrame(rows, columns=REPORT_COLUMNS)
    .to_csv(path, index=False)` writes it: the header, ints as ints,
    floats as their shortest round-tripping repr."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(REPORT_COLUMNS)
        for row in rows:
            w.writerow([str(row["sequence"])]
                       + [str(int(row[k])) for k in _INT_COLUMNS]
                       + [repr(float(row[k])) for k in _FLOAT_COLUMNS])


def read_report_csv(path: str) -> List[Dict[str, Any]]:
    """Rows of a report CSV with their column types restored; floats read
    back exactly."""
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        if reader.fieldnames != REPORT_COLUMNS:
            raise ValueError(f"{path}: columns {reader.fieldnames}, expected "
                             f"{REPORT_COLUMNS}")
        return [{"sequence": r["sequence"],
                 **{k: int(r[k]) for k in _INT_COLUMNS},
                 **{k: float(r[k]) for k in _FLOAT_COLUMNS}}
                for r in reader]


class DavisInteractiveSession(InteractiveSession):
    """Constructor parity with
    `davisinteractive.session.DavisInteractiveSession` (SURVEY.md C20):

        with DavisInteractiveSession(host='localhost',
                                     davis_root='/data/DAVIS',
                                     subset='val',
                                     max_nb_interactions=8,
                                     max_time=None) as sess:
            while sess.next(): ...

    As upstream, `host` selects the mode: `'localhost'` (or any non-URL)
    runs the in-process local service; an `http(s)://` URL returns a
    `RemoteSession` speaking to an `interactive.service` evaluation server
    (the server owns dataset, ground truth, robot and the clock; `key`,
    `davis_root` and `subset` are server-side there). Pass `dataset=` to
    skip the DAVIS tree and use any adapter (e.g. the synthetic fixture).
    `save_report_dir`: the local session writes `report.csv` there when
    the protocol loop closes without an error."""

    def __new__(cls, host: str = "localhost", key: str = "",
                davis_root: Optional[str] = None, subset: str = "val",
                max_nb_interactions: int = 8,
                max_time: Optional[float] = None,
                metric_to_optimize: str = "J_AND_F",
                dataset=None, save_report_dir: Optional[str] = None,
                **kwargs):
        if isinstance(host, str) and host.startswith(("http://", "https://")):
            from cvpr2020_manet_tpu_torch.interactive.service import (
                RemoteSession)
            if dataset is None and davis_root is not None:
                # client-local frames (the model side owns the video; the
                # server owns ground truth and scoring)
                from cvpr2020_manet_tpu_torch.data.davis import (
                    DavisEvalDataset)
                dataset = DavisEvalDataset(davis_root, subset=subset)
            # not an instance of cls: __init__ below is skipped
            return RemoteSession(
                host, max_nb_interactions=max_nb_interactions,
                max_time=max_time, metric_to_optimize=metric_to_optimize,
                images=dataset)
        return super().__new__(cls)

    def __init__(self, host: str = "localhost", key: str = "",
                 davis_root: Optional[str] = None, subset: str = "val",
                 max_nb_interactions: int = 8,
                 max_time: Optional[float] = None,
                 metric_to_optimize: str = "J_AND_F",
                 dataset=None, save_report_dir: Optional[str] = None,
                 **kwargs):
        if dataset is None:
            if davis_root is None:
                raise ValueError("pass davis_root=... or dataset=...")
            from cvpr2020_manet_tpu_torch.data.davis import DavisEvalDataset
            dataset = DavisEvalDataset(davis_root, subset=subset)
        self._save_report_dir = save_report_dir
        super().__init__(dataset, max_interactions=max_nb_interactions,
                         max_time=max_time,
                         metric_to_optimize=metric_to_optimize, **kwargs)

    def __exit__(self, *exc):
        if self._save_report_dir is not None and exc[0] is None:
            os.makedirs(self._save_report_dir, exist_ok=True)
            write_report_csv(self.get_report(), os.path.join(
                self._save_report_dir, "report.csv"))
        return super().__exit__(*exc)
