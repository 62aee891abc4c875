from cvpr2020_manet_tpu_torch.models.manet import MANet

__all__ = ["MANet"]
