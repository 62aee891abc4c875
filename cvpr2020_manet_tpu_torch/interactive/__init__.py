from cvpr2020_manet_tpu_torch.interactive.scribbles import (
    Scribbles, annotated_frames, scribbles2mask)
from cvpr2020_manet_tpu_torch.interactive.metrics import (
    batched_f_measure, batched_jaccard, f_measure, jaccard)
from cvpr2020_manet_tpu_torch.interactive.session import (
    DavisInteractiveSession, InteractiveSession)

__all__ = [
    "Scribbles", "annotated_frames", "scribbles2mask",
    "jaccard", "f_measure", "batched_jaccard", "batched_f_measure",
    "InteractiveSession", "DavisInteractiveSession",
]
