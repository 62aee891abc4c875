"""`davisinteractive.utils.scribbles`: helpers on scribble payloads.

Scribble payloads are the protocol's JSON dicts:
`{'sequence': str, 'scribbles': [[{'path': [[x, y], ...],  # normalized
                                   'object_id': int,
                                   'start_time'/'end_time': ...}, ...]
                                  per frame]}`.

The default `scribbles2mask` (polyline rasterization with Bresenham)
runs the port's `interactive/scribbles.scribbles2mask`; the upstream-only
variants (`bezier_curve_sampling=True`, `bresenham=False`) are written
here over `operations`.
"""

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from cvpr2020_manet_tpu_torch.davisinteractive.utils import operations
from cvpr2020_manet_tpu_torch.interactive.scribbles import (
    Scribbles as _Scribbles,
    annotated_frames as _annotated_frames,
    scribbles2mask as _scribbles2mask)

__all__ = [
    "annotated_frames", "annotated_frames_object", "is_empty",
    "scribbles2mask", "scribbles2points", "fuse_scribbles",
]


def _scribbles(payload) -> _Scribbles:
    return (payload if isinstance(payload, _Scribbles)
            else _Scribbles.from_json(payload))


def annotated_frames(scribbles_data) -> List[int]:
    """Indices of frames carrying at least one scribble line."""
    return _annotated_frames(scribbles_data)


def annotated_frames_object(scribbles_data, object_id: int) -> List[int]:
    """Indices of frames carrying at least one line of `object_id`."""
    return [i for i, lines in enumerate(_scribbles(scribbles_data).scribbles)
            if any(int(line["object_id"]) == object_id for line in lines)]


def is_empty(scribbles_data) -> bool:
    """True when no frame carries any scribble line."""
    return not annotated_frames(scribbles_data)


def fuse_scribbles(scribbles_a, scribbles_b) -> Dict[str, Any]:
    """Merge two scribble payloads of the same sequence (per-frame line
    concatenation, the accumulation step of the interactive loop)."""
    a, b = _scribbles(scribbles_a), _scribbles(scribbles_b)
    if a.sequence != b.sequence:
        raise ValueError(
            f"different sequences: {a.sequence!r} vs {b.sequence!r}")
    return a.merge(b).to_json()


def scribbles2points(
    scribbles_data,
    output_resolution: Optional[Tuple[int, int]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Flatten a scribble payload into per-point samples.

    Returns `(X, Y)`: `X` is `(N, 3)` float, `[frame, y, x]` per path
    point, with `y`/`x` normalized in [0, 1] or, when
    `output_resolution=(H, W)` is given, scaled to pixel coordinates
    `round(p * (dim - 1))`; `Y` is `(N,)` int object ids.
    """
    xs, ys = [], []
    for f, lines in enumerate(_scribbles(scribbles_data).scribbles):
        for line in lines:
            path = np.asarray(line["path"], dtype=np.float64)
            obj = int(line["object_id"])
            for px, py in path.reshape(-1, 2):     # payload points are [x, y]
                xs.append((float(f), py, px))
                ys.append(obj)
    x = np.asarray(xs, dtype=np.float64).reshape(-1, 3)
    y = np.asarray(ys, dtype=np.int64)
    if output_resolution is not None and len(x):
        h, w = output_resolution
        x[:, 1] = np.round(x[:, 1] * (h - 1))
        x[:, 2] = np.round(x[:, 2] * (w - 1))
    return x, y


def scribbles2mask(
    scribbles,
    output_resolution: Tuple[int, int],
    bezier_curve_sampling: bool = False,
    nb_points: int = 1000,
    bresenham: bool = True,
    default_value: int = -1,
    only_annotated_frame: bool = False,
) -> np.ndarray:
    """Rasterize a scribble payload to `(num_frames, H, W)` int32 label
    maps: `object_id` on scribbled pixels, `default_value` elsewhere.

    Modes (upstream semantics):
    - default (`bresenham=True`, no Bezier): polyline rasterization, the
      port's `interactive/scribbles.scribbles2mask`;
    - `bezier_curve_sampling=True`: `nb_points` samples along the Bezier
      curve of each line's path, and those pixels;
    - `bresenham=False` (and no Bezier): the path's own points only, no
      line between them.
    """
    if not bezier_curve_sampling and bresenham:
        return _scribbles2mask(
            scribbles, output_resolution,
            only_annotated_frame=only_annotated_frame,
            default_value=default_value)

    sc = _scribbles(scribbles)
    h, w = output_resolution
    frames: Any = range(sc.num_frames)
    if only_annotated_frame:
        frames = annotated_frames(sc)
    out = np.full((sc.num_frames, h, w), default_value, np.int32)
    for f in frames:
        for line in sc.scribbles[f]:
            path = np.asarray(line["path"], dtype=np.float64)
            if path.size == 0:
                continue
            if bezier_curve_sampling:
                path = operations.bezier_curve(path, nb_points=nb_points)
            px = np.clip(np.round(path[:, 0] * (w - 1)), 0, w - 1)
            py = np.clip(np.round(path[:, 1] * (h - 1)), 0, h - 1)
            out[f, py.astype(np.int64), px.astype(np.int64)] = (
                int(line["object_id"]))
    return out
