"""`davisinteractive.utils.operations`: line and curve rasterization.

`bresenham(points)` rasterizes a polyline given as an (N, 2) integer
array, returning every lattice pixel along consecutive segments;
`bezier_curve(points, nb_points)` samples the Bezier curve whose control
points are the path's points. `bresenham` runs the port's pairwise
Bresenham (`interactive/scribbles.bresenham`) on each segment.
"""

from math import comb

import numpy as np

from cvpr2020_manet_tpu_torch.interactive.scribbles import (
    bresenham as _bresenham_pair)

__all__ = ["bresenham", "bezier_curve"]


def bresenham(points) -> np.ndarray:
    """Rasterize the polyline through `points` ((N, 2) int array of
    [x, y]): every lattice pixel on every consecutive segment, with the
    shared endpoint of adjacent segments emitted once."""
    points = np.asarray(points)
    if points.ndim != 2 or points.shape[1] != 2:
        raise ValueError(f"points must be (N, 2), got {points.shape}")
    if len(points) < 2:
        return points.astype(np.int64)
    segs = [_bresenham_pair(points[0], points[1])]
    for i in range(1, len(points) - 1):
        # drop the first pixel: it is the previous segment's endpoint
        segs.append(_bresenham_pair(points[i], points[i + 1])[1:])
    return np.concatenate(segs, axis=0)


def bezier_curve(points, nb_points: int = 1000) -> np.ndarray:
    """Bezier curve with `points` ((N, 2) float array) as control points,
    sampled at `nb_points` parameter values in [0, 1]:

        B(t) = sum_i C(n, i) t^i (1-t)^(n-i) P_i  (Bernstein basis).

    Returns an (nb_points, 2) float array. Used by
    `scribbles2mask(..., bezier_curve_sampling=True)`."""
    points = np.asarray(points, dtype=np.float64)
    if points.ndim != 2 or points.shape[1] != 2:
        raise ValueError(f"points must be (N, 2), got {points.shape}")
    n = len(points)
    if n == 0:
        return np.zeros((0, 2), np.float64)
    if n == 1:
        return np.repeat(points, nb_points, axis=0)
    t = np.linspace(0.0, 1.0, nb_points)[:, None]          # (S, 1)
    i = np.arange(n)[None, :]                              # (1, N)
    coef = np.array([comb(n - 1, k) for k in range(n)])[None, :]
    basis = coef * t ** i * (1.0 - t) ** (n - 1 - i)       # (S, N)
    return basis @ points
