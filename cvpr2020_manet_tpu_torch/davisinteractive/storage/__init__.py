"""`davisinteractive.storage`: stores of interaction results.

Upstream's evaluation service keeps per-interaction scores in a storage
backend: `LocalStorage` for local sessions, a database on the hosted
server. The port's session and service keep their own rows
(`interactive/session.py`); this module gives the upstream storage API to
code that makes a storage itself. Without pandas: `get_report` returns
the rows as a list of dicts keyed by `AbstractStorage.COLUMNS`, as the
port's `InteractiveSession.get_report` does.

Validation: per (session, sequence, scribble_idx) the interactions arrive
in order from 1, the result vectors have one length, and the metric
values lie in [0, 1] (NaN refused).
"""

import abc
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["AbstractStorage", "LocalStorage"]


class AbstractStorage(abc.ABC):
    COLUMNS = ["session_id", "sequence", "scribble_idx", "interaction",
               "object_id", "frame", "jaccard", "contour", "timing"]

    @abc.abstractmethod
    def store_interactions_results(self, user_id, session_id, sequence,
                                   scribble_idx, interaction, timing,
                                   objects_idx, frames_idx, jaccard,
                                   contour):
        """Store one interaction's per-(object, frame) J and F scores."""

    @abc.abstractmethod
    def get_report(self, session_id: Optional[str] = None
                   ) -> List[Dict[str, Any]]:
        """All stored rows (optionally one session's), keyed by COLUMNS."""


class LocalStorage(AbstractStorage):
    """In-memory store for locally evaluated sessions."""

    def __init__(self):
        self._rows: List[list] = []

    def store_interactions_results(self, user_id, session_id, sequence,
                                   scribble_idx, interaction, timing,
                                   objects_idx, frames_idx, jaccard,
                                   contour):
        del user_id  # single-user local store
        jaccard = np.asarray(jaccard, dtype=float).ravel()
        contour = np.asarray(contour, dtype=float).ravel()
        objects_idx = np.asarray(objects_idx, dtype=int).ravel()
        frames_idx = np.asarray(frames_idx, dtype=int).ravel()
        if not (len(jaccard) == len(contour) == len(objects_idx)
                == len(frames_idx)):
            raise ValueError("objects_idx, frames_idx, jaccard and contour "
                             "must all have the same length")
        for name, v in (("jaccard", jaccard), ("contour", contour)):
            # NaN fails this check too (comparisons with NaN are False)
            if v.size and not np.all((v >= 0.0) & (v <= 1.0)):
                raise ValueError(f"{name} values must be in [0, 1]")
        key = (session_id, sequence, int(scribble_idx))
        prev = max((r[3] for r in self._rows
                    if (r[0], r[1], r[2]) == key), default=0)
        if int(interaction) != prev + 1:
            raise ValueError(
                f"interaction {interaction} out of order for {key}: "
                f"expected {prev + 1}")
        for o, f, j, c in zip(objects_idx, frames_idx, jaccard, contour):
            self._rows.append([session_id, sequence, int(scribble_idx),
                               int(interaction), int(o), int(f),
                               float(j), float(c), float(timing)])
        return True

    def get_report(self, session_id: Optional[str] = None
                   ) -> List[Dict[str, Any]]:
        rows = self._rows if session_id is None else [
            r for r in self._rows if r[0] == session_id]
        return [dict(zip(self.COLUMNS, r)) for r in rows]

    def get_annotated_frames(self, session_id, sequence,
                             scribble_idx) -> List[int]:
        """Frames already scored for this item (the robot's exclusion
        list)."""
        key = (session_id, sequence, int(scribble_idx))
        return sorted({r[5] for r in self._rows
                       if (r[0], r[1], r[2]) == key})
