"""`davisinteractive.metrics`: batched region J and boundary F in the
upstream calling convention.

Upstream takes `(y_true, y_pred)`, infers `nb_objects` from the ground
truth when it is None, and returns `(T,)` (the mean over objects) or,
with `average_over_objects=False`, `(T, nb_objects)`. The port's
`interactive/metrics.py` takes `(pred, gt, num_objects)` and averages;
the per-object columns here are its batched functions on one object's
binary maps, so boundary F goes through the native C++ either way.
"""

from typing import Optional

import numpy as np

from cvpr2020_manet_tpu_torch.interactive import metrics as _m

__all__ = ["batched_jaccard", "batched_f_measure"]


def _nb_objects(y_true: np.ndarray, nb_objects: Optional[int]) -> int:
    if nb_objects is not None:
        return int(nb_objects)
    n = int(np.max(y_true)) if y_true.size else 0
    return max(n, 1)


def _batched(fn, y_true, y_pred, average_over_objects, nb_objects, **kw):
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    n = _nb_objects(y_true, nb_objects)
    if average_over_objects:
        return fn(y_pred, y_true, n, **kw)
    # one object's maps as labels 0/1: the batched function's object 1
    return np.stack([fn((y_pred == j + 1).astype(np.uint8),
                        (y_true == j + 1).astype(np.uint8), 1, **kw)
                     for j in range(n)], axis=1)


def batched_jaccard(y_true: np.ndarray, y_pred: np.ndarray,
                    average_over_objects: bool = True,
                    nb_objects: Optional[int] = None) -> np.ndarray:
    """Per-frame Jaccard. `y_true`/`y_pred`: (T, H, W) int label maps
    (0 = background, objects 1..nb_objects)."""
    return _batched(_m.batched_jaccard, y_true, y_pred,
                    average_over_objects, nb_objects)


def batched_f_measure(y_true: np.ndarray, y_pred: np.ndarray,
                      average_over_objects: bool = True,
                      nb_objects: Optional[int] = None,
                      bound_th: float = 0.008) -> np.ndarray:
    """Per-frame boundary F-measure. Same conventions as
    `batched_jaccard`."""
    return _batched(_m.batched_f_measure, y_true, y_pred,
                    average_over_objects, nb_objects, bound_th=bound_th)
