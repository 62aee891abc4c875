"""Training losses, PyTorch port of the JAX package's `engine/losses.py`.

Bootstrapped (top-k / OHEM-style) pixel cross-entropy: average only the
hardest `ratio` fraction of pixels, with the ratio annealed from 1.0 at the
start of training (everything counts) down to `final_ratio`.

The kept count is computed on the host in float32 exactly as the JAX
package computes it on the device (`int32(ratio_f32 * n_valid_f32)`,
clipped to [1, n]), so both pick the same number of pixels.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def pixel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                        valid: torch.Tensor | None = None) -> torch.Tensor:
    """Per-pixel CE. logits (..., O) float; labels (...) int; -> (...)."""
    logp = F.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, labels.long()[..., None])[..., 0]
    if valid is not None:
        ce = ce * valid
    return ce


def bootstrapped_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                               ratio: float,
                               valid: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """Mean CE over the hardest `ratio` fraction of (valid) pixels. The
    fraction is sized from the valid pixel count: invalid pixels contribute
    zero loss and must not dilute it. `valid` costs one device sync (the
    count)."""
    ce = pixel_cross_entropy(logits, labels, valid).reshape(-1)
    n = ce.shape[0]
    n_valid = np.float32(n if valid is None else float(valid.sum()))
    k = int(np.clip(np.int32(np.float32(ratio) * n_valid), 1, n))
    return ce.topk(k, sorted=False).values.sum() / k


def bootstrap_ratio_schedule(step: int, warmup_steps: int,
                             final_ratio: float) -> np.float32:
    """1.0 -> final_ratio linearly over `warmup_steps` (then constant), in
    float32 as the JAX package computes it."""
    frac = np.float32(step) / np.float32(max(warmup_steps, 1))
    frac = np.minimum(np.maximum(frac, np.float32(0.0)), np.float32(1.0))
    return np.float32(1.0) + np.float32(final_ratio - 1.0) * frac
