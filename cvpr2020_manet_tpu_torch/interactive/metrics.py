"""DAVIS segmentation metrics: region J, boundary F (SURVEY.md C20).

Semantics pinned to the `davisinteractive.metrics` / davis2017-evaluation
definitions the reference is scored by:

- J  (Jaccard): |pred ∩ gt| / |pred ∪ gt| per object per frame; empty ∪
  empty counts as 1.0.
- F  (boundary F-measure): boundaries of pred/gt masks are matched within
  a tolerance of `bound_th` (0.008) * image diagonal via binary dilation
  with a disk; F = 2PR / (P + R).

Host-side NumPy/SciPy: metrics run inside the benchmark service (our
session), not on the accelerator.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def jaccard(pred: np.ndarray, gt: np.ndarray) -> float:
    """IoU of two binary masks; both-empty -> 1.0."""
    pred = pred.astype(bool)
    gt = gt.astype(bool)
    union = np.count_nonzero(pred | gt)
    if union == 0:
        return 1.0
    return float(np.count_nonzero(pred & gt) / union)


def _mask_boundary(mask: np.ndarray) -> np.ndarray:
    """8-connected inner boundary of a binary mask."""
    mask = mask.astype(bool)
    eroded = ndimage.binary_erosion(
        mask, structure=np.ones((3, 3), bool), border_value=0)
    return mask & ~eroded


def _disk(radius: int) -> np.ndarray:
    y, x = np.ogrid[-radius:radius + 1, -radius:radius + 1]
    return (x * x + y * y) <= radius * radius


def f_measure(pred: np.ndarray, gt: np.ndarray,
              bound_th: float = 0.008) -> float:
    """Boundary F-measure with davis-style distance tolerance."""
    pred = pred.astype(bool)
    gt = gt.astype(bool)
    if not pred.any() and not gt.any():
        return 1.0
    bound_pix = max(1, int(np.ceil(bound_th * np.linalg.norm(pred.shape))))
    fg = _mask_boundary(pred)
    gtb = _mask_boundary(gt)
    disk = _disk(bound_pix)
    fg_dil = ndimage.binary_dilation(fg, structure=disk)
    gt_dil = ndimage.binary_dilation(gtb, structure=disk)
    n_fg = np.count_nonzero(fg)
    n_gt = np.count_nonzero(gtb)
    if n_fg == 0 and n_gt == 0:
        return 1.0
    if n_fg == 0 or n_gt == 0:
        return 0.0
    precision = np.count_nonzero(fg & gt_dil) / n_fg
    recall = np.count_nonzero(gtb & fg_dil) / n_gt
    if precision + recall == 0:
        return 0.0
    return float(2 * precision * recall / (precision + recall))


def batched_jaccard(pred: np.ndarray, gt: np.ndarray,
                    num_objects: int) -> np.ndarray:
    """Per-frame mean-over-objects J. pred/gt (T, H, W) int labels."""
    out = np.empty((pred.shape[0], num_objects), np.float64)
    for t in range(pred.shape[0]):
        for j in range(num_objects):
            out[t, j] = jaccard(pred[t] == j + 1, gt[t] == j + 1)
    return out.mean(axis=1)


def batched_f_measure(pred: np.ndarray, gt: np.ndarray,
                      num_objects: int,
                      bound_th: float = 0.008) -> np.ndarray:
    """Per-frame mean-over-objects boundary F. pred/gt (T, H, W).

    Uses the native EDT kernel (cvpr2020_manet_tpu_torch/native) when available
    — identical semantics to `f_measure`, ~100x faster — with the SciPy
    implementation as fallback.
    """
    from cvpr2020_manet_tpu_torch import native
    handle = native.lib()
    t, h, w = pred.shape
    out = np.empty((t, num_objects), np.float64)
    if handle is not None:
        import ctypes
        bound_pix = max(1, int(np.ceil(bound_th * np.linalg.norm((h, w)))))
        res = np.empty((t,), np.float64)
        for j in range(num_objects):
            p = np.ascontiguousarray(pred == j + 1, np.uint8)
            g = np.ascontiguousarray(gt == j + 1, np.uint8)
            handle.batched_f_measure(
                p.ctypes.data_as(ctypes.c_void_p),
                g.ctypes.data_as(ctypes.c_void_p),
                t, h, w, bound_pix,
                res.ctypes.data_as(ctypes.c_void_p))
            out[:, j] = res
        return out.mean(axis=1)
    for i in range(t):
        for j in range(num_objects):
            out[i, j] = f_measure(pred[i] == j + 1, gt[i] == j + 1, bound_th)
    return out.mean(axis=1)


def jf_per_frame(pred: np.ndarray, gt: np.ndarray,
                 num_objects: int) -> np.ndarray:
    """Per-frame (J + F) / 2 — the quantity the robot minimizes over."""
    return 0.5 * (batched_jaccard(pred, gt, num_objects)
                  + batched_f_measure(pred, gt, num_objects))
