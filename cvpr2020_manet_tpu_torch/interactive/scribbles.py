"""Scribble schema + rasterization (SURVEY.md C15).

Pin-compatible with the `davisinteractive` scribble format (the external
package the reference calls — `davisinteractive.utils.scribbles`): a
scribble payload is

    {"sequence": str,
     "scribbles": [frames][ {"path": [[x, y], ...],   # normalized [0,1]
                             "object_id": int,
                             "start_time"/"end_time": optional} ]}

`scribbles2mask` rasterizes normalized polyline paths into per-pixel label
maps via Bresenham lines; unpainted pixels take `default_value` (-1), as in
davisinteractive. This module is host-side NumPy: scribble handling is the
one part of the interactive loop that legitimately lives on the host
(BASELINE north-star: "only the scribble event stays on host").
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import numpy as np


@dataclasses.dataclass
class Scribbles:
    """Typed wrapper around the davisinteractive scribble JSON payload."""

    sequence: str
    scribbles: List[List[Dict[str, Any]]]   # [frame][line]

    @property
    def num_frames(self) -> int:
        return len(self.scribbles)

    def to_json(self) -> Dict[str, Any]:
        return {"sequence": self.sequence, "scribbles": self.scribbles}

    @classmethod
    def from_json(cls, payload: Dict[str, Any]) -> "Scribbles":
        return cls(sequence=payload["sequence"],
                   scribbles=payload["scribbles"])

    def merge(self, other: "Scribbles") -> "Scribbles":
        """Accumulate another round's scribbles (per-frame concatenation)."""
        assert self.num_frames == other.num_frames
        return Scribbles(
            sequence=self.sequence,
            scribbles=[a + b for a, b in
                       zip(self.scribbles, other.scribbles)])


def annotated_frames(scribbles: Scribbles | Dict[str, Any]) -> List[int]:
    """Frames that carry at least one scribble line (davisinteractive
    `annotated_frames` semantics)."""
    frames = (scribbles.scribbles if isinstance(scribbles, Scribbles)
              else scribbles["scribbles"])
    return [i for i, lines in enumerate(frames) if len(lines) > 0]


def bresenham(p0: Sequence[int], p1: Sequence[int]) -> np.ndarray:
    """Integer line rasterization from p0 to p1 (inclusive), (N, 2) [x, y].

    Classic integer Bresenham — matches davisinteractive's
    `utils.operations.bresenham` behavior of returning every lattice pixel
    along the segment.
    """
    x0, y0 = int(p0[0]), int(p0[1])
    x1, y1 = int(p1[0]), int(p1[1])
    dx, dy = abs(x1 - x0), -abs(y1 - y0)
    sx = 1 if x0 < x1 else -1
    sy = 1 if y0 < y1 else -1
    err = dx + dy
    pts = []
    while True:
        pts.append((x0, y0))
        if x0 == x1 and y0 == y1:
            break
        e2 = 2 * err
        if e2 >= dy:
            err += dy
            x0 += sx
        if e2 <= dx:
            err += dx
            y0 += sy
    return np.asarray(pts, dtype=np.int64)


def scribbles2mask(
    scribbles: Scribbles | Dict[str, Any],
    output_resolution: tuple[int, int],
    *,
    only_annotated_frame: bool = False,
    default_value: int = -1,
    radius: int = 0,
) -> np.ndarray:
    """Rasterize scribbles to label maps (davisinteractive
    `scribbles2mask` semantics).

    Returns (num_frames, H, W) int32: `object_id` on scribbled pixels
    (background scribbles are object_id 0), `default_value` elsewhere.
    `radius` > 0 thickens lines with a square dilation of that radius.
    """
    if isinstance(scribbles, dict):
        scribbles = Scribbles.from_json(scribbles)
    h, w = output_resolution
    frames = range(scribbles.num_frames)
    if only_annotated_frame:
        frames = annotated_frames(scribbles)
    out = np.full((scribbles.num_frames, h, w), default_value, np.int32)
    for f in frames:
        for line in scribbles.scribbles[f]:
            path = np.asarray(line["path"], dtype=np.float64)
            if path.size == 0:
                continue
            obj = int(line["object_id"])
            # normalized [0,1] -> pixel centers; clamp to the frame
            px = np.clip(np.round(path[:, 0] * (w - 1)), 0, w - 1)
            py = np.clip(np.round(path[:, 1] * (h - 1)), 0, h - 1)
            pts = [np.array([[px[0], py[0]]], np.int64)]
            for i in range(len(path) - 1):
                pts.append(bresenham((px[i], py[i]), (px[i + 1], py[i + 1])))
            pts = np.concatenate(pts, axis=0)
            if radius > 0:
                offs = np.stack(np.meshgrid(
                    np.arange(-radius, radius + 1),
                    np.arange(-radius, radius + 1)), -1).reshape(-1, 2)
                pts = (pts[:, None, :] + offs[None]).reshape(-1, 2)
                pts[:, 0] = np.clip(pts[:, 0], 0, w - 1)
                pts[:, 1] = np.clip(pts[:, 1], 0, h - 1)
            out[f, pts[:, 1], pts[:, 0]] = obj
    return out


def scribble_masks_per_object(
    label_map: np.ndarray, num_objects: int
) -> tuple[np.ndarray, np.ndarray]:
    """Split a rasterized label map (H, W) into per-object pos/neg maps.

    Returns (pos (H, W, O), neg (H, W, O)) with O = num_objects + 1
    (index 0 = background). Negative map of object o = pixels scribbled as
    any *other* label (including background strokes) — the interaction
    branch's pos/neg scribble channels (SURVEY.md §1).
    """
    o = num_objects + 1
    scribbled = label_map >= 0
    pos = np.stack([(label_map == j) for j in range(o)], -1).astype(np.float32)
    neg = (scribbled[..., None] & ~(pos > 0)).astype(np.float32)
    return pos, neg
