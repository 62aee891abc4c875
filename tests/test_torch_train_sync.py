"""`train_step(batch, sync=False)` of both port trainers, the JAX trainers'
unsynced step (`engine/train_stage1.py:345-350`, `train_stage2.py:301-306`
of the JAX package): the metrics stay on the device as 0-d tensors, and
the step is the synchronous one, bit for bit."""

import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu_torch.config import tiny_test_config
from cvpr2020_manet_tpu_torch.engine.train_stage1 import (
    Trainer, synthetic_batch)
from cvpr2020_manet_tpu_torch.engine.train_stage2 import Stage2Trainer


@pytest.mark.parametrize("stage", [1, 2])
def test_unsynced_step_equals_the_synchronous_step(stage):
    cfg = tiny_test_config()
    cls = Trainer if stage == 1 else Stage2Trainer
    synced, unsynced = cls(cfg, device="cpu"), cls(cfg, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(2):          # the second step runs on the momentum
        batch = synthetic_batch(cfg, rng, random_entry=stage == 2)
        want = synced.train_step(batch)
        got = unsynced.train_step(batch, sync=False)
        assert set(got) == set(want) and "loss" in got
        for key, value in got.items():
            assert isinstance(want[key], float)
            assert isinstance(value, torch.Tensor) and value.dim() == 0
            assert value.device.type == "cpu" and not value.requires_grad
            assert value.item() == want[key]
    assert synced.state.step == unsynced.state.step == 2
    for (name, p), (_, q) in zip(synced.model.named_parameters(),
                                 unsynced.model.named_parameters()):
        assert torch.equal(p, q), name
