"""Interactive scribbles robot (SURVEY.md C20, the `davisinteractive`
`robot.InteractiveScribblesRobot` capability).

Protocol role (HIGH confidence, SURVEY.md §1): after each round the service
(1) scores every frame, (2) picks the worst frame, (3) simulates human
corrective scribbles on that frame's error regions, and returns them.

Implementation note: davisinteractive skeletonizes each error region
(skimage medial axis) and walks the skeleton graph (networkx) for the
longest path. The same semantics — "a polyline along the SPINE of the
largest error region, safely inside it" — run in the native C++ kernel
(native/robot.cpp: exact-EDT proportional shrink + Zhang-Suen thinning +
double-BFS skeleton diameter, O(HW), ~10 ms at 480p vs ~20 s for the
pure-Python round-1 version). The compiler-free fallback implements the
SAME pipeline in numpy/SciPy (vectorized Zhang-Suen), so both paths
produce identical skeleton-spine scribbles — pinned by tests
parametrized over native/fallback: paths match, lie inside the error
region, are long enough, and label the correct object.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
from scipy import ndimage

from cvpr2020_manet_tpu_torch.interactive.metrics import jf_per_frame
from cvpr2020_manet_tpu_torch.interactive.scribbles import Scribbles


@dataclasses.dataclass(frozen=True)
class RobotParams:
    """Defaults match the upstream `InteractiveScribblesRobot` signature
    (kernel_size=0.15, max_kernel_radius=16, min_nb_nodes=4,
    nb_points=1000) so that the benchmark of record uses the same
    scribble geometry upstream's default robot would produce — the
    round-4 review flagged that uncapped erosion on large error regions
    retreats the spine further inside than upstream's robot. Pass
    `max_kernel_radius=None` / `max_path_points=None` explicitly for the
    uncapped geometry (docs/PARITY.md §robot)."""
    kernel_size: float = 0.15      # erosion kernel, relative to region size
    # Cap on the EDT shrink radius in pixels (upstream davisinteractive
    # `max_kernel_radius`, default 16); None = uncapped.
    max_kernel_radius: float | None = 16.0
    min_region_pixels: int = 10    # ignore smaller error regions
    min_path_nodes: int = 4        # drop degenerate scribbles (upstream
    #                                `min_nb_nodes`, default 4)
    sample_every: int = 4          # polyline subsampling stride (pixels)
    # Upper bound on emitted polyline nodes per scribble (upstream
    # davisinteractive `nb_points`, default 1000); None = unbounded. Long
    # spines are re-subsampled uniformly (endpoints kept) to fit.
    max_path_points: int | None = 1000
    max_objects_per_round: int = 4 # scribble at most this many objects


_NEIGH = [(-1, -1), (-1, 0), (-1, 1), (0, -1),
          (0, 1), (1, -1), (1, 0), (1, 1)]


def _bfs_farthest(component: np.ndarray, start: tuple[int, int]):
    """BFS over 8-connected True pixels; returns (farthest pixel, parents)."""
    h, w = component.shape
    dist = np.full((h, w), -1, np.int32)
    parent = {}
    dist[start] = 0
    queue = [start]
    far = start
    while queue:
        nxt = []
        for (y, x) in queue:
            for dy, dx in _NEIGH:
                yy, xx = y + dy, x + dx
                if 0 <= yy < h and 0 <= xx < w and component[yy, xx] \
                        and dist[yy, xx] < 0:
                    dist[yy, xx] = dist[y, x] + 1
                    parent[(yy, xx)] = (y, x)
                    nxt.append((yy, xx))
                    if dist[yy, xx] > dist[far]:
                        far = (yy, xx)
        queue = nxt
    return far, parent


def _diameter_path(component: np.ndarray) -> List[tuple[int, int]]:
    """Approximate longest geodesic path through a connected component."""
    ys, xs = np.nonzero(component)
    seed = (int(ys[0]), int(xs[0]))
    a, _ = _bfs_farthest(component, seed)
    b, parents = _bfs_farthest(component, a)
    path = [b]
    while path[-1] != a:
        path.append(parents[path[-1]])
    return path


def _zhang_suen_thin(img: np.ndarray) -> np.ndarray:
    """Zhang-Suen (1984) thinning, vectorized numpy. (H, W) bool -> bool.

    Same semantics as native/robot.cpp `thin_zhang_suen`: two simultaneous-
    deletion subiterations per sweep, repeated until stable — preserves
    8-connectivity, leaves a 1-px-wide skeleton. The vectorized form reads
    the image state from the START of each subiteration (exactly the
    C++ collect-then-delete behavior), so both paths produce identical
    skeletons."""
    img = img.astype(np.uint8)
    changed = True
    while changed:
        changed = False
        for step in (0, 1):
            p = np.pad(img, 1)
            # neighbors clockwise from north: p2..p9
            p2 = p[:-2, 1:-1]; p3 = p[:-2, 2:]; p4 = p[1:-1, 2:]
            p5 = p[2:, 2:]; p6 = p[2:, 1:-1]; p7 = p[2:, :-2]
            p8 = p[1:-1, :-2]; p9 = p[:-2, :-2]
            ring = (p2, p3, p4, p5, p6, p7, p8, p9)
            b = sum(n.astype(np.int32) for n in ring)
            seq = ring + (p2,)
            a = sum(((seq[i] == 0) & (seq[i + 1] == 1)).astype(np.int32)
                    for i in range(8))
            cond = (img == 1) & (b >= 2) & (b <= 6) & (a == 1)
            if step == 0:
                cond &= (p2 * p4 * p6 == 0) & (p4 * p6 * p8 == 0)
            else:
                cond &= (p2 * p4 * p8 == 0) & (p2 * p6 * p8 == 0)
            if cond.any():
                img[cond] = 0
                changed = True
    return img.astype(bool)


class InteractiveScribblesRobot:
    """Simulates corrective scribbles on the worst-scored frame."""

    def __init__(self, params: RobotParams = RobotParams()):
        self.params = params

    def worst_frame(self, pred: np.ndarray, gt: np.ndarray,
                    num_objects: int,
                    exclude: Optional[List[int]] = None) -> int:
        """Frame with lowest J&F; previously annotated frames excluded
        unless everything has been annotated."""
        scores = jf_per_frame(pred, gt, num_objects)
        order = np.argsort(scores, kind="stable")
        exclude = set(exclude or [])
        for idx in order:
            if int(idx) not in exclude:
                return int(idx)
        return int(order[0])

    def scribble_frame(self, pred_frame: np.ndarray, gt_frame: np.ndarray,
                       num_objects: int, frame_idx: int, num_frames: int,
                       sequence: str) -> Scribbles:
        """Scribbles over the largest error region of each object
        (object_id 0 = background corrections, as in davisinteractive)."""
        h, w = gt_frame.shape
        p = self.params
        lines = []
        # rank objects (incl. background 0) by error area, scribble the worst
        errors = []
        for obj in range(num_objects + 1):
            err = (gt_frame == obj) & (pred_frame != obj)
            area = np.count_nonzero(err)
            if area >= p.min_region_pixels:
                errors.append((area, obj, err))
        errors.sort(key=lambda t: -t[0])
        for _, obj, err in errors[:p.max_objects_per_round]:
            line = self._scribble_region(err, obj, (h, w))
            if line is not None:
                lines.append(line)
        frames = [[] for _ in range(num_frames)]
        frames[frame_idx] = lines
        return Scribbles(sequence=sequence, scribbles=frames)

    def _scribble_region(self, err: np.ndarray, obj: int,
                         shape: tuple[int, int]) -> Optional[dict]:
        p = self.params
        path = self._spine_path_native(err)
        if path is None:
            path = self._spine_path_fallback(err)
        if path is None or len(path) < p.min_path_nodes:
            return None
        # subsample long spines, but never below min_path_nodes: a fixed
        # stride would collapse e.g. a 4-node spine to 2 emitted nodes,
        # violating the param's "drop degenerate scribbles" contract
        stride = min(p.sample_every,
                     max(1, (len(path) - 1) // max(p.min_path_nodes - 1, 1)))
        sub = path[::stride]
        if sub[-1] != path[-1]:
            sub.append(path[-1])
        path = sub
        if p.max_path_points is not None and len(path) > p.max_path_points:
            # uniform re-subsample to the node budget, endpoints kept
            # (upstream `nb_points` semantics)
            idx = np.linspace(0, len(path) - 1,
                              p.max_path_points).round().astype(int)
            path = [path[i] for i in dict.fromkeys(idx.tolist())]
        h, w = shape
        norm = [[x / max(w - 1, 1), y / max(h - 1, 1)] for (y, x) in path]
        return {"path": norm, "object_id": int(obj),
                "start_time": 0.0, "end_time": 0.0}

    def _spine_path_native(self, err: np.ndarray) \
            -> Optional[List[tuple[int, int]]]:
        """Skeleton spine of the largest error region via native/robot.cpp
        (EDT shrink + Zhang-Suen thinning + skeleton diameter)."""
        from cvpr2020_manet_tpu_torch import native
        handle = native.lib()
        if handle is None:
            return None
        import ctypes
        p = self.params
        h, w = err.shape
        e = np.ascontiguousarray(err.astype(np.uint8))
        max_pts = h * w
        out = np.empty((max_pts, 2), np.int32)
        cap = p.max_kernel_radius if p.max_kernel_radius is not None else 0.0
        npts = handle.scribble_path(
            e.ctypes.data_as(ctypes.c_void_p), h, w,
            ctypes.c_float(p.kernel_size), ctypes.c_float(cap),
            p.min_region_pixels, p.min_path_nodes,
            out.ctypes.data_as(ctypes.c_void_p), max_pts)
        # npts == 0 => native ran but found no usable region: report the
        # empty path (caller drops it) rather than None (= "no native lib")
        return [(int(y), int(x)) for y, x in out[:npts]]

    def _spine_path_fallback(self, err: np.ndarray) \
            -> Optional[List[tuple[int, int]]]:
        """Pure-Python skeleton spine (no compiler needed) — SAME
        semantics as native/robot.cpp `scribble_path`, step for step:
        largest component -> exact-EDT proportional shrink -> Zhang-Suen
        thinning -> double-BFS skeleton diameter (falling back to the
        pre-thin region's diameter for compact blobs that thin to fewer
        than min_path_nodes pixels)."""
        p = self.params
        labels, n = ndimage.label(err, structure=np.ones((3, 3)))
        if n == 0:
            return None
        sizes = ndimage.sum_labels(err, labels, index=np.arange(1, n + 1))
        comp = labels == (1 + int(np.argmax(sizes)))
        area = int(comp.sum())
        if area < p.min_region_pixels:
            return None
        # disk erosion == EDT-to-background thresholding (pad replicates
        # scipy border_value=0), ~100x faster than a structuring element
        # proportional to region size
        radius = max(1.0, p.kernel_size * np.sqrt(area))
        if p.max_kernel_radius is not None:
            radius = min(radius, p.max_kernel_radius)
        d = ndimage.distance_transform_edt(np.pad(comp, 1))[1:-1, 1:-1]
        region = comp & (d > radius)
        if region.sum() < 3:
            region = comp
        else:
            labels2, n2 = ndimage.label(region, structure=np.ones((3, 3)))
            if n2 > 1:
                sizes2 = ndimage.sum_labels(
                    region, labels2, index=np.arange(1, n2 + 1))
                region = labels2 == (1 + int(np.argmax(sizes2)))
        pre_thin = region
        # thin only the region's bounding box (native/robot.cpp restricts
        # its sweeps the same way): each Zhang-Suen subiteration is a
        # full-array vectorized pass, and sweep count scales with region
        # thickness — full-frame sweeps at 480p/1080p cost seconds where
        # the bbox costs milliseconds
        ys, xs = np.nonzero(region)
        y0, y1 = ys.min(), ys.max() + 1
        x0, x1 = xs.min(), xs.max() + 1
        skel = np.zeros_like(region)
        skel[y0:y1, x0:x1] = _zhang_suen_thin(region[y0:y1, x0:x1])
        path = _diameter_path(skel) if skel.any() else []
        if len(path) < p.min_path_nodes:
            path = _diameter_path(pre_thin)
        if len(path) < p.min_path_nodes:
            return None
        return path

    def interact(self, sequence: str, pred: np.ndarray, gt: np.ndarray,
                 num_objects: int,
                 annotated: Optional[List[int]] = None) -> Scribbles:
        """Full robot step: worst frame -> error scribbles (davisinteractive
        `InteractiveScribblesRobot.interact` capability)."""
        frame = self.worst_frame(pred, gt, num_objects, exclude=annotated)
        return self.scribble_frame(
            pred[frame], gt[frame], num_objects, frame, pred.shape[0],
            sequence)
