"""The port's serving artifacts against the JAX package's, on the CPU.

Both packages get the same weights (the Flax init, bridged into the port
by `weights.py`) at `tiny_test_config()`, and the same inputs, made with
numpy. The port's artifacts are saved and loaded back; the JAX side runs
its own serving functions (`build_serving_fns`) and its own exported
round (`export_forward` for the CPU, through `jax.export`), with the jnp
matching backend, whose distances the port's plain versions reproduce.
Everything is f32 and agrees to 1e-4, the tolerance of the method-by-
method model parity (`tests/test_torch_model.py`): convolution and
GroupNorm sums are taken in another order. Each package's loader refuses
the other's files as an unsupported format.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu.config import tiny_test_config as jax_tiny
from cvpr2020_manet_tpu.models import MANet as JaxMANet
from cvpr2020_manet_tpu.utils import export as jex
from cvpr2020_manet_tpu.utils.ingest import rgb_to_yuv420_host
from cvpr2020_manet_tpu_torch.config import tiny_test_config
from cvpr2020_manet_tpu_torch.models import MANet
from cvpr2020_manet_tpu_torch.utils import export as ex
from cvpr2020_manet_tpu_torch.weights import load_flax_params

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    """(cfg, jax model, variables, port model), the same weights."""
    cfg = jax_tiny()
    h, w = cfg.eval.image_size
    o = cfg.model.max_objects + 1
    jmodel = JaxMANet(cfg.model, matching_backend="jnp")
    variables = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)),
        jnp.zeros((1, h // 4, w // 4, o)), jnp.zeros((1, h // 4, w // 4, o)))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    tmodel = load_flax_params(
        MANet(tiny_test_config().model, device="cpu", seed=1), params)
    return cfg, jmodel, variables, tmodel.eval()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_bundle_loop_matches_jax(pair, tmp_path):
    """JAX's bundle loop (tests/test_export.py's 2-frame round: extract ->
    interact -> aggregate_first -> propagate, then aggregate_update),
    driven through the port's loaded bundle and through JAX's
    build_serving_fns on the same inputs: every stage's output agrees.
    The reference memory's labels come from JAX's first-frame
    probabilities, so both sides match against the same one-hot."""
    cfg, jmodel, variables, tmodel = pair
    size = cfg.eval.image_size
    o = cfg.model.max_objects + 1
    path = str(tmp_path / "bundle.ivosx")
    ex.save_bundle(ex.export_serving_bundle(
        tmodel, size, cfg.model.max_objects, pad_to=cfg.eval.pad_to), path)
    bundle = ex.load_bundle(path)
    fns = jex.build_serving_fns(jmodel, variables, size,
                                cfg.model.max_objects, pad_to=cfg.eval.pad_to)
    fns = dict(fns, extract=jex.wrap_raw_image(*fns["extract"]))
    jfn = {name: jax.jit(fn) for name, (fn, _) in fns.items()}

    rng = np.random.default_rng(3)
    h, w = size
    hh, ww = h // 4, w // 4
    img0 = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    img1 = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    pos = np.zeros((hh, ww, o), np.float32)
    pos[2:4, 2:4, 1] = 1.0
    neg = np.zeros_like(pos)
    bg = np.zeros((hh, ww, o), np.float32)
    bg[..., 0] = 1.0
    ones_map = np.ones((hh, ww, o), np.float32)
    ones_obj = np.ones((o,), np.float32)

    j_feat0, j_emb0 = jfn["extract"](img0)
    j_if, j_p0 = jfn["interact"](j_feat0, pos, neg, bg)
    j_mem = jfn["aggregate_first"](j_if)
    j_feat1, j_emb1 = jfn["extract"](img1)
    onehot = np.eye(o, dtype=np.float32)[
        np.asarray(j_p0).argmax(-1).reshape(-1)]
    j_p1, j_gmap = jfn["propagate"](
        j_feat1, j_emb1, j_emb0.reshape(-1, j_emb0.shape[-1]), onehot,
        ones_map, j_emb0, j_p0, j_mem, ones_obj)
    j_mem2 = jfn["aggregate_update"](j_if, j_mem)

    t = torch.from_numpy
    feat0, emb0 = bundle["extract"](t(img0))
    int_feats, p0 = bundle["interact"](feat0, t(pos), t(neg), t(bg))
    mem = bundle["aggregate_first"](int_feats)
    feat1, emb1 = bundle["extract"](t(img1))
    p1, gmap = bundle["propagate"](
        feat1, emb1, emb0.reshape(-1, emb0.shape[-1]), t(onehot),
        t(ones_map), emb0, p0, mem, t(ones_obj))
    mem2 = bundle["aggregate_update"](int_feats, mem)

    for got, want in [(feat0, j_feat0), (emb0, j_emb0), (feat1, j_feat1),
                      (int_feats, j_if), (p0, j_p0), (mem, j_mem),
                      (p1, j_p1), (gmap, j_gmap), (mem2, j_mem2)]:
        assert got.shape == want.shape
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert (np.asarray(j_p1) < 0.99).mean() > 0.5      # not saturated


@pytest.mark.parametrize("fmt", ["uint8", "float32", "yuv420"])
def test_fused_artifact_matches_jax(pair, tmp_path, fmt):
    """The port's fused round artifact, saved and loaded back, against
    JAX's exported round on the same frame and scribbles; both manifests
    describe the same inputs and outputs."""
    cfg, jmodel, variables, tmodel = pair
    size = cfg.eval.image_size
    h, w = size
    o = cfg.model.max_objects + 1
    path = str(tmp_path / f"{fmt}.ivosx")
    manifest = ex.save_artifact(ex.export_forward(
        tmodel, size, cfg.model.max_objects, pad_to=cfg.eval.pad_to,
        image_format=fmt), path)
    loaded = ex.load_artifact(path)
    jexported = jex.export_forward(jmodel, variables, size,
                                   cfg.model.max_objects, platforms=("cpu",),
                                   pad_to=cfg.eval.pad_to, image_format=fmt)
    jmanifest = jex.save_artifact(jexported, str(tmp_path / "jax.ivosx"))
    assert manifest["in_avals"] == jmanifest["in_avals"]
    assert manifest["out_avals"] == jmanifest["out_avals"]

    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    if fmt == "float32":
        frame = [rng.standard_normal((h, w, 3)).astype(np.float32)]
    elif fmt == "yuv420":
        frame = list(rgb_to_yuv420_host(img))
    else:
        frame = [img]
    pos = np.zeros((h // 4, w // 4, o), np.float32)
    pos[1:3, 1:3, 1] = 1.0
    neg = np.zeros_like(pos)
    neg[5:7, 6:9, 1] = 1.0
    args = [*frame, pos, neg]
    got = loaded(*[torch.from_numpy(a) for a in args]).numpy()
    want = np.asarray(jexported.call(*args))
    np.testing.assert_allclose(got, want, **TOL)
    assert (want < 0.99).mean() > 0.5                  # not saturated


def test_loaders_refuse_each_others_files(pair, tmp_path):
    """Same magic lines, other format strings: each package's loader
    reads the other's manifest and refuses it as an unsupported format,
    before it touches the blob."""
    cfg, jmodel, variables, tmodel = pair
    size = cfg.eval.image_size
    port = ex.export_serving_bundle(tmodel, size, cfg.model.max_objects,
                                    pad_to=cfg.eval.pad_to)
    jax_exports = jex.export_serving_bundle(
        jmodel, variables, size, cfg.model.max_objects, platforms=("cpu",),
        pad_to=cfg.eval.pad_to)
    files = {
        "port_artifact": ex.save_artifact,
        "port_bundle": ex.save_bundle,
        "jax_artifact": jex.save_artifact,
        "jax_bundle": jex.save_bundle,
    }
    for name, save in files.items():
        exports = port if name.startswith("port") else jax_exports
        save(exports if name.endswith("bundle") else exports["propagate"],
             str(tmp_path / f"{name}.ivosx"))
    refusals = [(jex.load_artifact, "port_artifact"),
                (jex.load_bundle, "port_bundle"),
                (ex.load_artifact, "jax_artifact"),
                (ex.load_bundle, "jax_bundle")]
    for load, name in refusals:
        with pytest.raises(ValueError, match="unsupported format"):
            load(str(tmp_path / f"{name}.ivosx"))
