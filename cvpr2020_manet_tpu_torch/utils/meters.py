"""Small training-loop observability helper, PyTorch port of the JAX
package's `utils/meters.py` (framework-neutral: a copy)."""

from __future__ import annotations


class AverageMeter:
    """Running average (the reference keeps the same utility in its
    utils)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)
