"""The context-parallel stage-1 step of the PyTorch port
(`engine/train_stage1.make_cp_train_step`) against the JAX package's, on
the CPU.

JAX runs its step shard_map'd over a ('data', 'context') mesh of the 8
forced CPU devices (tests/conftest.py); the port runs its single
controller over a mesh of CPU members. Same weights (bridged from the
Flax init), same batch; data 1 x context 2 and data 2 x context 2. The
loss agrees at `tests/test_torch_train.py`'s LOSS_TOL (rtol 1e-4) and the
parameters after the step at PARAM_TOL (atol 1e-5). The synthetic images
are textured at random, so the global matching's minima have no ties,
and JAX's jnp oracle and the port's argmin routing give the same
gradient. The port also equals its own one-device step, and a reference
that does not split over the context members raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu.config import tiny_test_config as jax_tiny
from cvpr2020_manet_tpu.engine import train_stage1 as js1
from cvpr2020_manet_tpu.engine.train_state import TrainState as JaxState
from cvpr2020_manet_tpu.models import MANet as JaxMANet
from cvpr2020_manet_tpu.parallel.mesh import create_mesh as jax_mesh
from cvpr2020_manet_tpu_torch.config import tiny_test_config
from cvpr2020_manet_tpu_torch.engine import train_stage1 as ts1
from cvpr2020_manet_tpu_torch.parallel.mesh import create_mesh
from cvpr2020_manet_tpu_torch.weights import (
    flax_to_state_dict, load_flax_params)

LOSS_TOL = dict(rtol=1e-4, atol=0)
PARAM_TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cp_maps(monkeypatch):
    """The (Nq, O) maps the cp step's `trainable_local_then_min` returns,
    one a sample, detached, in the order the step makes them."""
    maps = []
    real = ts1.trainable_local_then_min

    def recorded(*args):
        gm = real(*args)
        maps.append(gm.detach())
        return gm

    monkeypatch.setattr(ts1, "trainable_local_then_min", recorded)
    return maps


def _configs(batch):
    return [dataclasses.replace(c, train=dataclasses.replace(
        c.train, batch_size=batch, bootstrap_warmup_steps=2))
        for c in (jax_tiny(), tiny_test_config())]


@pytest.fixture(scope="module")
def flax_params():
    cfg = jax_tiny()
    model = JaxMANet(cfg.model, matching_backend="jnp")
    o = cfg.model.max_objects + 1
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, 8, 8, o)), jnp.zeros((1, 8, 8, o)))
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def _port_trainer(cfg, params):
    trainer = ts1.Trainer(cfg, device="cpu")
    load_flax_params(trainer.model, params)
    return trainer


@pytest.mark.parametrize("data,context,batch", [(1, 2, 2), (2, 2, 4)],
                         ids=["d1c2", "d2c2"])
def test_cp_step_vs_jax(flax_params, cp_maps, data, context, batch):
    jcfg, tcfg = _configs(batch)
    b = js1.synthetic_batch(jcfg, np.random.default_rng(21))

    jmodel = JaxMANet(jcfg.model, matching_backend="jnp",
                      trainable_matching=True)
    mesh = jax_mesh(data=data, context=context,
                    devices=jax.devices("cpu")[:data * context])
    jstep = js1.make_cp_train_step(jmodel, jcfg, mesh)
    jstate = JaxState.create(jax.tree_util.tree_map(jnp.asarray, flax_params),
                             jcfg.train)
    jstate, jmetrics = jstep(jstate, b)

    trainer = _port_trainer(tcfg, flax_params)
    step = ts1.make_cp_train_step(trainer.model, tcfg, create_mesh(
        data=data, context=context, devices=["cpu"] * (data * context)))
    metrics = step(trainer.state, b)
    np.testing.assert_allclose(metrics["loss"], float(jmetrics["loss"]),
                               **LOSS_TOL)
    assert len(cp_maps) == batch
    want = flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jstate.params), trainer.model)
    got = trainer.model.state_dict()
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), err_msg=key,
                                   **PARAM_TOL)


@pytest.mark.parametrize("context", [2, 4])
def test_cp_step_equals_one_device_step(flax_params, cp_maps, context):
    """The same weights and batch through the cp step and the one-device
    step: the maps agree exactly (each member's minima are the one-device
    minima over its rows, and the min is exact), the losses and the
    parameters to the tolerances above."""
    _, tcfg = _configs(2)
    b = ts1.synthetic_batch(tcfg, np.random.default_rng(22))
    one = _port_trainer(tcfg, flax_params)
    cp = _port_trainer(tcfg, flax_params)
    step = ts1.make_cp_train_step(cp.model, tcfg, create_mesh(
        data=1, context=context, devices=["cpu"] * context))
    maps = []
    real = one.model._global_matching

    def recorded(*args):
        gm = real(*args)
        maps.append(gm.detach())
        return gm

    one.model._global_matching = recorded
    want = one.train_step(b)
    got = step(cp.state, b)
    np.testing.assert_allclose(got["loss"], want["loss"], **LOSS_TOL)
    for m_cp, m_one in zip(cp_maps, maps, strict=True):
        np.testing.assert_array_equal(m_cp.numpy(), m_one.numpy())
    sd = cp.model.state_dict()
    for key, w in one.model.state_dict().items():
        np.testing.assert_allclose(sd[key].numpy(), w.numpy(), err_msg=key,
                                   **PARAM_TOL)


def test_cp_step_refuses_rows_that_do_not_split(flax_params):
    """JAX's step gives each member nk // ctx rows and drops the tail; the
    port raises (crop 32: 8 x 8 = 64 reference rows over 3 members)."""
    _, tcfg = _configs(2)
    trainer = _port_trainer(tcfg, flax_params)
    step = ts1.make_cp_train_step(trainer.model, tcfg, create_mesh(
        data=1, context=3, devices=["cpu"] * 3))
    with pytest.raises(ValueError, match="64 reference rows do not split "
                                         "over 3"):
        step(trainer.state, ts1.synthetic_batch(tcfg,
                                                np.random.default_rng(23)))


def test_cp_step_refuses_a_batch_that_does_not_split(flax_params):
    _, tcfg = _configs(3)
    trainer = _port_trainer(tcfg, flax_params)
    with pytest.raises(ValueError, match="batch 3 does not split over 2"):
        ts1.make_cp_train_step(trainer.model, tcfg, create_mesh(
            data=2, context=1, devices=["cpu"] * 2))
