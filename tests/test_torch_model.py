"""The PyTorch MANet vs the Flax MANet, method by method, on the CPU.

Weights come from the Flax init through the port's bridge (`weights.py`);
inputs are made with numpy and handed to both. Everything is f32, and the
methods agree to 1e-4 (convolution and GroupNorm sums are taken in another
order; nothing else differs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu.config import ModelConfig as JaxModelConfig
from cvpr2020_manet_tpu.config import tiny_test_config as jax_tiny
from cvpr2020_manet_tpu.models import MANet as JaxMANet
from cvpr2020_manet_tpu_torch.config import ModelConfig, tiny_test_config
from cvpr2020_manet_tpu_torch.models import MANet
from cvpr2020_manet_tpu_torch.weights import bridge_plan, load_flax_params

TOL = dict(rtol=1e-4, atol=1e-4)


def _jax_init(model, hw, o):
    h, w = hw
    return jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)),
        jnp.zeros((1, h // 4, w // 4, o)), jnp.zeros((1, h // 4, w // 4, o)))


@pytest.fixture(scope="module", params=[1, 2], ids=["ld1", "ld2"])
def pair(request):
    """(jax model, variables, port model) at the tiny config, with local
    matching at full (ld1) or half (ld2) feature resolution."""
    jcfg = dataclasses.replace(jax_tiny().model,
                               local_downsample=request.param)
    tcfg = dataclasses.replace(tiny_test_config().model,
                               local_downsample=request.param)
    jmodel = JaxMANet(jcfg, matching_backend="jnp")
    variables = _jax_init(jmodel, (64, 96), jcfg.max_objects + 1)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    tmodel = load_flax_params(MANet(tcfg, device="cpu", seed=1), params)
    return jmodel, variables, tmodel


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_bridge_consumes_every_leaf_tiny(pair):
    jmodel, variables, tmodel = pair
    n_leaves = len(jax.tree_util.tree_leaves(variables["params"]))
    plan = bridge_plan(variables["params"], tmodel)
    assert len(plan) == n_leaves == len(tmodel.state_dict())
    assert len({key for key, _, _ in plan}) == n_leaves


def test_bridge_consumes_every_leaf_flagship():
    """Flagship ModelConfig() shape tree (jax.eval_shape: no compute)."""
    jmodel = JaxMANet(JaxModelConfig(), matching_backend="jnp")
    o = JaxModelConfig().max_objects + 1
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1, 16, 16, o)), jnp.zeros((1, 16, 16, o)))["params"]
    tmodel = MANet(ModelConfig(), device="cpu")
    plan = bridge_plan(shapes, tmodel)
    assert len(plan) == len(jax.tree_util.tree_leaves(shapes)) \
        == len(tmodel.state_dict())


def test_bridge_rejects_unknown_and_missing_leaves(pair):
    _, variables, tmodel = pair
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    extra = dict(params, stray={"kernel": np.zeros((1, 1, 1, 1))})
    with pytest.raises(KeyError):
        bridge_plan(extra, tmodel)
    missing = {k: v for k, v in params.items() if k != "memory_aggregator"}
    with pytest.raises(KeyError, match="without a Flax leaf"):
        bridge_plan(missing, tmodel)


def test_extract_features(pair):
    jmodel, variables, tmodel = pair
    x = np.random.default_rng(0).normal(size=(2, 64, 96, 3)).astype(np.float32)
    jf, je = jmodel.apply(variables, jnp.asarray(x),
                          method=jmodel.extract_features)
    tf, te = tmodel.extract_features(torch.from_numpy(x))
    np.testing.assert_allclose(_np(tf), _np(jf), **TOL)
    np.testing.assert_allclose(_np(te), _np(je), **TOL)


def _inputs(cfg, seed, h=16, w=24):
    rng = np.random.default_rng(seed)
    o = cfg.max_objects + 1

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)

    def softmax(x):
        e = np.exp(x - x.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    ce = cfg.embedding_dim_padded
    return dict(
        feat=r(h, w, cfg.decoder_channels), emb_t=r(h, w, ce),
        prev_emb=r(h, w, ce), ref_emb=r(h * w, ce),
        ref_oh=np.eye(o, dtype=np.float32)[rng.integers(0, o, h * w)],
        gmap_prev=rng.uniform(0.5, 1.0, size=(h, w, o)).astype(np.float32),
        prev_mask=softmax(r(h, w, o)),
        pos=(rng.random((h, w, o)) > 0.9).astype(np.float32),
        neg=(rng.random((h, w, o)) > 0.9).astype(np.float32),
        int_feats=r(o, h, w, cfg.ma_channels),
        int_mem=r(o, h, w, cfg.ma_channels),
        obj_valid=np.array([1.0] * (o - 1) + [0.0], np.float32))


def test_interact(pair):
    jmodel, variables, tmodel = pair
    d = _inputs(tmodel.cfg, 1)
    jf, jl = jmodel.apply(variables, *(jnp.asarray(d[k]) for k in (
        "feat", "pos", "neg", "prev_mask")), method=jmodel.interact)
    tf, tl = tmodel.interact(*(torch.from_numpy(d[k]) for k in (
        "feat", "pos", "neg", "prev_mask")))
    np.testing.assert_allclose(_np(tf), _np(jf), **TOL)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)


@pytest.mark.parametrize("first", [True, False], ids=["first", "later"])
def test_aggregate_memory(pair, first):
    jmodel, variables, tmodel = pair
    d = _inputs(tmodel.cfg, 2)
    want = jmodel.apply(variables, jnp.asarray(d["int_feats"]),
                        jnp.asarray(d["int_mem"]), first,
                        method=jmodel.aggregate_memory)
    got = tmodel.aggregate_memory(torch.from_numpy(d["int_feats"]),
                                  torch.from_numpy(d["int_mem"]), first)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("decomposed", [False, True],
                         ids=["fused", "decomposed"])
def test_propagate(pair, decomposed):
    jmodel, variables, tmodel = pair
    d = _inputs(tmodel.cfg, 3)
    names = ("feat", "emb_t", "ref_emb", "ref_oh", None, "gmap_prev",
             "prev_emb", "prev_mask", "int_mem", "obj_valid")
    jargs = [None if k is None else jnp.asarray(d[k]) for k in names]
    targs = [None if k is None else torch.from_numpy(d[k]) for k in names]
    jkw, tkw = {}, {}
    if decomposed:
        jfp = jmodel.apply(variables, jargs[0][None],
                           method=jmodel.head_feat_contrib)
        jmp = jmodel.apply(variables, jargs[8], method=jmodel.head_mem_contrib)
        tfp = tmodel.head_feat_contrib(targs[0][None])
        tmp = tmodel.head_mem_contrib(targs[8])
        np.testing.assert_allclose(_np(tfp), _np(jfp), **TOL)
        np.testing.assert_allclose(_np(tmp), _np(jmp), **TOL)
        jkw["head_pre"] = jfp + jmp
        tkw["head_pre"] = tfp + tmp
    jl, jg = jmodel.apply(variables, *jargs, method=jmodel.propagate, **jkw)
    tl, tg = tmodel.propagate(*targs, **tkw)
    np.testing.assert_allclose(_np(tg), _np(jg), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
