"""`davisinteractive.utils`: scribble, geometry and plotting helpers."""

from cvpr2020_manet_tpu_torch.davisinteractive.utils import (
    operations, scribbles, visualization)

__all__ = ["operations", "scribbles", "visualization"]
