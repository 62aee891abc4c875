"""The port's norms ('bn', 'ln', 'frozen') against Flax's, on the CPU.

Module by module: `make_norm`'s BatchNorm (batch statistics, and the
running statistics after one update), LayerNorm and FrozenAffine against
the JAX package's `make_norm` modules on the same NHWC input (NCHW in the
port) with the same random scale and bias. Then the whole `MANet` with
`norm` and `head_norm` set to each, weights (with `batch_stats` for 'bn')
bridged from the Flax init by `weights.py`, method by method against
JAX's `extract_features` / `interact` / `propagate`; for 'bn' JAX applies
with `mutable=["batch_stats"]` and the updated running statistics are
compared too.

Tolerances: f32 to 1e-5 for one module and 1e-4 through the model (as
`tests/test_torch_model.py`: convolutions and reductions sum in another
order). bf16 outputs to one bf16 rounding step (rtol 2^-7 = 0.0078125,
atol 1e-2 near 0): XLA may fuse FrozenAffine's product and sum into one
rounding where PyTorch rounds each, and the f32 statistics of BN and LN
round to bf16 once at the end.
"""

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from cvpr2020_manet_tpu.config import tiny_test_config as jax_tiny
from cvpr2020_manet_tpu.models import MANet as JaxMANet
from cvpr2020_manet_tpu.models.layers import make_norm as jax_make_norm
from cvpr2020_manet_tpu_torch.config import Config, tiny_test_config
from cvpr2020_manet_tpu_torch.engine import train_stage1, train_stage2
from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
from cvpr2020_manet_tpu_torch.engine.propagate_batch import BatchPropagator
from cvpr2020_manet_tpu_torch.engine.streaming import StreamingIVOS
from cvpr2020_manet_tpu_torch.models import MANet
from cvpr2020_manet_tpu_torch.models.layers import make_norm
from cvpr2020_manet_tpu_torch.parallel.mesh import create_mesh
from cvpr2020_manet_tpu_torch.utils import export
from cvpr2020_manet_tpu_torch.weights import (
    bridge_plan, flax_to_state_dict, load_flax_params)

TOL_F32 = dict(rtol=1e-5, atol=1e-5)
TOL_BF16 = dict(rtol=2 ** -7, atol=1e-2)
TOL = dict(rtol=1e-4, atol=1e-4)
NORMS = ("bn", "ln", "frozen")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


class _OneNorm(fnn.Module):
    norm: str
    dtype: Any

    @fnn.compact
    def __call__(self, x):
        return jax_make_norm(self.norm, self.dtype, 4)()(x)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("norm", NORMS)
def test_norm_module_vs_flax(norm, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(7)
    c = 8
    x = (rng.normal(size=(3, 5, 6, c)) * 2.0 + 0.5).astype(np.float32)
    jx = jnp.asarray(x, jdt)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt)
    net = _OneNorm(norm, jdt)
    variables = jax.tree_util.tree_map(
        np.asarray, net.init(jax.random.PRNGKey(0), jx))
    name = next(iter(variables["params"]))
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (rng.normal(size=c) * 0.3).astype(np.float32)
    variables["params"][name] = {"scale": scale, "bias": bias}
    module = make_norm(norm, tdt, 4)(c)
    with torch.no_grad():
        module.weight.copy_(torch.from_numpy(scale))
        module.bias.copy_(torch.from_numpy(bias))
    if norm == "bn":
        stats = {"mean": rng.normal(size=c).astype(np.float32),
                 "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
        variables["batch_stats"][name] = stats
        module.mean.copy_(torch.from_numpy(stats["mean"]))
        module.var.copy_(torch.from_numpy(stats["var"]))
        want, updated = net.apply(variables, jx, mutable=["batch_stats"])
    else:
        want = net.apply(variables, jx)
    got = module(tx)
    assert got.dtype == tdt
    tol = TOL_F32 if dtype == "f32" else TOL_BF16
    np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)), _np(want),
                               **tol)
    if norm == "bn":
        for k in ("mean", "var"):
            np.testing.assert_allclose(
                getattr(module, k).numpy(),
                np.asarray(updated["batch_stats"][name][k]), **TOL_F32)


# ------------------------------------------------------------ the model


def _configs(norm):
    return [dataclasses.replace(c().model, norm=norm, head_norm=norm)
            for c in (jax_tiny, tiny_test_config)]


def _perturbed(tree, rng):
    """Every norm scale and bias drawn at random (Flax inits them 1 and 0,
    under which 'frozen' is the identity)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturbed(v, rng)
        elif k == "scale":
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k == "bias" and v.ndim == 1:
            out[k] = (rng.normal(size=v.shape) * 0.1).astype(np.float32)
        else:
            out[k] = v
    return out


@pytest.fixture(scope="module", params=NORMS)
def norm_pair(request):
    """(norm, jax model, variables, port model) at the tiny config."""
    jcfg, tcfg = _configs(request.param)
    jmodel = JaxMANet(jcfg, matching_backend="jnp")
    o = jcfg.max_objects + 1
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3)),
        jnp.zeros((1, 16, 24, o)), jnp.zeros((1, 16, 24, o))))
    variables = dict(variables, params=_perturbed(
        variables["params"], np.random.default_rng(3)))
    tmodel = MANet(tcfg, device="cpu", seed=1)
    return request.param, jmodel, variables, tmodel


def _apply(jmodel, variables, norm, *args, **kw):
    """JAX's method call; for 'bn' as `apply(..., mutable=["batch_stats"])`
    -> (outputs, the updated variables)."""
    if norm == "bn":
        out, stats = jmodel.apply(variables, *args,
                                  mutable=["batch_stats"], **kw)
        return out, dict(variables, **stats)
    return jmodel.apply(variables, *args, **kw), variables


def _check_stats(norm, new_vars, tmodel):
    """For 'bn': the port's running statistics after the call equal the
    ones JAX's mutable apply returned."""
    if norm != "bn":
        return
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, new_vars),
                              tmodel)
    got = tmodel.state_dict()
    n = 0
    for key in want:
        if key.endswith((".mean", ".var")):
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                       err_msg=key, **TOL)
            n += 1
    assert n > 0


@pytest.fixture
def fresh(norm_pair):
    """norm_pair with the Flax variables loaded into the port model anew
    (BN's running statistics move on every call)."""
    norm, jmodel, variables, tmodel = norm_pair
    return norm, jmodel, variables, load_flax_params(tmodel, variables)


def test_extract_features_norms(fresh):
    norm, jmodel, variables, tmodel = fresh
    x = np.random.default_rng(0).normal(size=(2, 64, 96, 3)).astype(
        np.float32)
    (jf, je), new_vars = _apply(jmodel, variables, norm, jnp.asarray(x),
                                method=jmodel.extract_features)
    tf, te = tmodel.extract_features(torch.from_numpy(x))
    np.testing.assert_allclose(_np(tf), _np(jf), **TOL)
    np.testing.assert_allclose(_np(te), _np(je), **TOL)
    _check_stats(norm, new_vars, tmodel)


def _inputs(cfg, seed, h=16, w=24):
    rng = np.random.default_rng(seed)
    o = cfg.max_objects + 1

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)

    e = np.exp(r(h, w, o))
    ce = cfg.embedding_dim_padded
    return dict(
        feat=r(h, w, cfg.decoder_channels), emb_t=r(h, w, ce),
        prev_emb=r(h, w, ce), ref_emb=r(h * w, ce),
        ref_oh=np.eye(o, dtype=np.float32)[rng.integers(0, o, h * w)],
        gmap_prev=rng.uniform(0.5, 1.0, size=(h, w, o)).astype(np.float32),
        prev_mask=(e / e.sum(-1, keepdims=True)).astype(np.float32),
        pos=(rng.random((h, w, o)) > 0.9).astype(np.float32),
        neg=(rng.random((h, w, o)) > 0.9).astype(np.float32),
        int_mem=r(o, h, w, cfg.ma_channels),
        obj_valid=np.array([1.0] * (o - 1) + [0.0], np.float32))


def test_interact_norms(fresh):
    norm, jmodel, variables, tmodel = fresh
    d = _inputs(tmodel.cfg, 1)
    names = ("feat", "pos", "neg", "prev_mask")
    (jf, jl), new_vars = _apply(jmodel, variables, norm,
                                *(jnp.asarray(d[k]) for k in names),
                                method=jmodel.interact)
    tf, tl = tmodel.interact(*(torch.from_numpy(d[k]) for k in names))
    np.testing.assert_allclose(_np(tf), _np(jf), **TOL)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _check_stats(norm, new_vars, tmodel)


@pytest.mark.parametrize("decomposed", [False, True],
                         ids=["fused", "decomposed"])
def test_propagate_norms(fresh, decomposed):
    norm, jmodel, variables, tmodel = fresh
    d = _inputs(tmodel.cfg, 3)
    names = ("feat", "emb_t", "ref_emb", "ref_oh", None, "gmap_prev",
             "prev_emb", "prev_mask", "int_mem", "obj_valid")
    jargs = [None if k is None else jnp.asarray(d[k]) for k in names]
    targs = [None if k is None else torch.from_numpy(d[k]) for k in names]
    jkw, tkw = {}, {}
    if decomposed:
        jkw["head_pre"] = (
            jmodel.apply(variables, jargs[0][None],
                         method=jmodel.head_feat_contrib)
            + jmodel.apply(variables, jargs[8],
                           method=jmodel.head_mem_contrib))
        tkw["head_pre"] = (tmodel.head_feat_contrib(targs[0][None])
                           + tmodel.head_mem_contrib(targs[8]))
    (jl, jg), new_vars = _apply(jmodel, variables, norm, *jargs,
                                method=jmodel.propagate, **jkw)
    tl, tg = tmodel.propagate(*targs, **tkw)
    np.testing.assert_allclose(_np(tg), _np(jg), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _check_stats(norm, new_vars, tmodel)


# ----------------------------------------------------- the weight bridge


def test_bridge_aspp_names_by_creation_order(norm_pair):
    """Flax counts each class apart: with 'bn' the ASPP's norms are
    BatchNorm_0..3, GroupNorm_0 (the pooling branch, always GN) and
    BatchNorm_4, which go to aspp.norm.0..3, .4 and .5; the plan is one to
    one over every model tensor, BN's buffers included."""
    norm, _, variables, tmodel = norm_pair
    plan = bridge_plan(variables, tmodel)
    by_path = {"/".join(path): key for key, path, _ in plan}
    cls = {"bn": "BatchNorm", "ln": "LayerNorm",
           "frozen": "FrozenAffine"}[norm]
    aspp = "encoder/aspp/"
    for i in range(4):
        assert by_path[f"{aspp}{cls}_{i}/scale"] == \
            f"encoder.aspp.norm.{i}.weight"
    assert by_path[f"{aspp}GroupNorm_0/scale"] == "encoder.aspp.norm.4.weight"
    assert by_path[f"{aspp}{cls}_4/scale"] == "encoder.aspp.norm.5.weight"
    assert by_path[f"encoder/{cls}_1/bias"] == "encoder.decoder_norm0.bias"
    assert by_path[f"propagation_head/stack/{cls}_2/scale"] == \
        "propagation_head.stack.norm2.weight"
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    assert len(plan) == n_leaves == len(tmodel.state_dict())
    if norm == "bn":
        assert by_path[f"{aspp}{cls}_4/mean"] == "encoder.aspp.norm.5.mean"
        # the params alone leave BN's buffers without a Flax leaf
        with pytest.raises(KeyError, match="without a Flax leaf"):
            bridge_plan(variables["params"], tmodel)


@pytest.mark.parametrize("norm", NORMS)
def test_bridge_flagship_norms(norm):
    """The flagship shape tree (jax.eval_shape: no compute) of each norm
    bridges one to one."""
    from cvpr2020_manet_tpu.config import ModelConfig as JaxModelConfig
    from cvpr2020_manet_tpu_torch.config import ModelConfig
    jmodel = JaxMANet(JaxModelConfig(norm=norm, head_norm=norm),
                      matching_backend="jnp")
    o = JaxModelConfig().max_objects + 1
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1, 16, 16, o)), jnp.zeros((1, 16, 16, o)))
    tmodel = MANet(ModelConfig(norm=norm, head_norm=norm), device="cpu")
    plan = bridge_plan(shapes, tmodel)
    assert len(plan) == len(jax.tree_util.tree_leaves(shapes)) \
        == len(tmodel.state_dict())


# ------------------------------------------- refusals of bn and syncbn


def _cfg(norm, head_norm=None):
    cfg = tiny_test_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, norm=norm, head_norm=head_norm or norm))


PATHS = ("Evaluator", "StreamingIVOS", "BatchPropagator", "export",
         "Trainer", "Stage2Trainer", "make_cp_train_step")


def _paths(cfg: Config, model):
    mesh = create_mesh(data=1, context=2, devices=["cpu", "cpu"])
    return {
        "Evaluator": lambda: Evaluator(cfg, model, device="cpu"),
        "StreamingIVOS": lambda: StreamingIVOS(cfg, model, device="cpu"),
        "BatchPropagator": lambda: BatchPropagator(cfg, model, device="cpu"),
        "export": lambda: export.export_serving_bundle(model, (32, 48), 2),
        "Trainer": lambda: train_stage1.Trainer(cfg, device="cpu"),
        "Stage2Trainer": lambda: train_stage2.Stage2Trainer(cfg,
                                                            device="cpu"),
        "make_cp_train_step": lambda: train_stage1.make_cp_train_step(
            model, cfg, mesh),
    }


@pytest.mark.parametrize("norms", [("bn", "bn"), ("syncbn", "syncbn"),
                                   ("gn", "bn")], ids=["bn", "syncbn",
                                                       "head_bn"])
@pytest.mark.parametrize("path", PATHS)
def test_params_only_paths_refuse_batch_norm(path, norms):
    """Every path that JAX runs with `params` alone refuses BatchNorm with
    one error naming the reason; the model itself runs it."""
    cfg = _cfg(*norms)
    model = MANet(cfg.model, device="cpu")
    with pytest.raises(ValueError, match="batch_stats"):
        _paths(cfg, model)[path]()


@pytest.mark.parametrize("norm", ["ln", "frozen"])
def test_params_only_paths_run_ln_and_frozen(norm):
    """'ln' and 'frozen' need no batch statistics: one session round and
    one stage-1 step run with finite results."""
    from cvpr2020_manet_tpu_torch.data import SyntheticDataset
    from cvpr2020_manet_tpu_torch.interactive.session import (
        InteractiveSession)
    cfg = _cfg(norm)
    model = MANet(cfg.model, device="cpu")
    ds = SyntheticDataset(image_size=cfg.eval.image_size,
                          num_frames=cfg.eval.max_frames, num_sequences=1,
                          num_objects=2, scribble_sets=1)
    summary = Evaluator(cfg, model, device="cpu").run_session(
        InteractiveSession(ds, max_interactions=1))
    assert 0.0 <= summary["auc"] <= 1.0
    trainer = train_stage1.Trainer(cfg, device="cpu")
    batch = train_stage1.synthetic_batch(cfg, np.random.default_rng(0))
    assert np.isfinite(trainer.train_step(batch)["loss"])
