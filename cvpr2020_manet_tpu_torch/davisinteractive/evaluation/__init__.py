"""`davisinteractive.evaluation`: the evaluation service. The port's HTTP
server (`interactive/service.py`) plays upstream's remote service: ground
truth, robot and clock live on the server, and clients reach it through
`DavisInteractiveSession(host='http://...')`."""

from cvpr2020_manet_tpu_torch.davisinteractive.evaluation import service

__all__ = ["service"]
