"""Data-parallel ranks, the context-parallel train step and the norms of
the PyTorch port on the card.

The argmin kernels have no CPU mode, so these tests skip without a GPU.
On a machine with one (and no JAX) run them without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_distributed_cuda.py

At the tiny config: 2 ranks on one card over Gloo on CUDA tensors
(tests/_torch_dist_worker.py) take the same steps bit for bit, equal to
one process on the card training on the whole batch to
`tests/test_torch_train.py`'s tolerances, each rank launching kernels 4
and 5 for its own samples only; the cp step on 4 members of the card
gives the one-device step's maps (to `chip_smoke.py`'s TOL_GLOBAL; the
min is exact) and loss (1e-4 relative), launching kernel 4 once per
member and sample; each norm's model on the card agrees with the same
model on the CPU to 1e-3 (cuDNN and the kernels sum in other orders;
TF32 off), the tolerance of the tiny round's card-vs-CPU check.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu_torch.config import tiny_test_config
from cvpr2020_manet_tpu_torch.engine import train_stage1 as ts1
from cvpr2020_manet_tpu_torch.kernels import build
from cvpr2020_manet_tpu_torch.models import MANet
from cvpr2020_manet_tpu_torch.parallel.mesh import create_mesh

from _torch_dist_worker import run_ranks

pytestmark = pytest.mark.cuda

LOSS_TOL = dict(rtol=1e-4, atol=0)
PARAM_TOL = dict(rtol=0, atol=1e-5)
TOL_GLOBAL = 5e-4
TOL_CARD_VS_CPU = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cfg(batch):
    cfg = tiny_test_config()
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=batch))


def test_two_gloo_ranks_on_one_card(cuda, tmp_path):
    outs = run_ranks([dict(rank=r, world=2, device="cuda", backend="gloo",
                           mode="train", tiny=True, batch=4, steps1=2,
                           steps2=1, out=str(tmp_path)) for r in range(2)])
    import json
    ranks = [[json.loads(line) for line in o.splitlines()
              if line.startswith("{")] for o in outs]
    one = ts1.Trainer(_cfg(4), device=cuda)
    losses = [one.train_step(ts1.synthetic_batch(
        _cfg(4), np.random.default_rng(1000 + i)))["loss"] for i in range(2)]
    s1 = [[r for r in rs if r.get("stage") == 1 and r["step"] >= 0]
          for rs in ranks]
    for a, b in zip(*s1):
        assert a["loss"] == b["loss"] and a["hash"] == b["hash"]
        assert a["launches"] == {"global_matching_argmin": 2,
                                 "local_matching_argmin": 4}
    np.testing.assert_allclose([r["loss"] for r in s1[0]], losses,
                               **LOSS_TOL)
    got = torch.load(tmp_path / "stage1.pt", weights_only=True)
    for k, v in one.model.state_dict().items():
        np.testing.assert_allclose(got[k].numpy(), v.cpu().numpy(),
                                   err_msg=k, **PARAM_TOL)


def test_cp_step_on_four_members_of_the_card(cuda, monkeypatch):
    cp_maps = []
    real_cp = ts1.trainable_local_then_min

    def recorded_cp(*args):
        gm = real_cp(*args)
        cp_maps.append(gm.detach())
        return gm

    monkeypatch.setattr(ts1, "trainable_local_then_min", recorded_cp)
    cfg = _cfg(2)
    one = ts1.Trainer(cfg, device=cuda)
    cp = ts1.Trainer(cfg, device=cuda)
    step = ts1.make_cp_train_step(cp.model, cfg, create_mesh(
        data=1, context=4, devices=[cuda] * 4))
    maps = []
    real = one.model._global_matching

    def recorded(*args):
        gm = real(*args)
        maps.append(gm.detach())
        return gm

    one.model._global_matching = recorded
    batch = ts1.synthetic_batch(cfg, np.random.default_rng(5))
    want = one.train_step(batch)["loss"]
    build.reset_launches()
    got = step(cp.state, batch)["loss"]
    torch.cuda.synchronize()
    assert build.LAUNCHES["global_matching_argmin"] == 2 * 4
    assert build.LAUNCHES["local_matching_argmin"] == 2 * 2
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    for a, b in zip(cp_maps, maps, strict=True):
        assert float((a - b).abs().max()) <= TOL_GLOBAL


@pytest.mark.parametrize("norm", ["bn", "ln", "frozen"])
def test_norm_model_card_vs_cpu(cuda, norm):
    cfg = dataclasses.replace(tiny_test_config().model, norm=norm,
                              head_norm=norm)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 64, 96, 3)).astype(np.float32))
    cpu = MANet(cfg, device="cpu", seed=3)
    card = MANet(cfg, device=cuda, seed=3)
    with torch.no_grad():
        for a, b in zip(cpu.extract_features(x),
                        card.extract_features(x.to(cuda))):
            np.testing.assert_allclose(b.cpu().numpy(), a.numpy(),
                                       rtol=TOL_CARD_VS_CPU,
                                       atol=TOL_CARD_VS_CPU)
    for k, v in cpu.state_dict().items():
        np.testing.assert_allclose(card.state_dict()[k].cpu().numpy(),
                                   v.numpy(), err_msg=k, rtol=1e-5,
                                   atol=1e-5)
