"""`davisinteractive.evaluation.service`: the port's evaluation server
(`interactive/service.py`). `serve(dataset, ...)` starts one;
`EvaluationService` is the scoring core of the local and remote session
modes; `RemoteSession` is the client."""

from cvpr2020_manet_tpu_torch.interactive.service import (
    EvaluationService, RemoteSession, serve)

__all__ = ["EvaluationService", "RemoteSession", "serve"]
