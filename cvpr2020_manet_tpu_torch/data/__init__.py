from cvpr2020_manet_tpu_torch.data.synthetic import SyntheticDataset

__all__ = ["SyntheticDataset"]
