"""The port's pretrained-backbone converter (`utils/pretrained.py`) against
PyTorch's BatchNorm and against the JAX package's converter, on the CPU.

A synthetic torchvision-layout resnet state_dict (depths (1, 1, 1, 1),
width 16; no weights are downloaded) is converted and loaded by both
packages into a `norm="frozen"` tiny MANet whose other weights are
bridged from the same Flax init; both encoders then run on the same
input. f32 throughout; outputs agree to 1e-4 (as `tests/test_torch_model.py`),
the BN folding to rtol 1e-5 / atol 1e-6 (as `tests/test_pretrained.py`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu.config import tiny_test_config as jax_tiny
from cvpr2020_manet_tpu.models import MANet as JaxMANet
from cvpr2020_manet_tpu.utils import pretrained as jpre
from cvpr2020_manet_tpu_torch.config import tiny_test_config
from cvpr2020_manet_tpu_torch.engine.train_state import param_labels
from cvpr2020_manet_tpu_torch.models import MANet
from cvpr2020_manet_tpu_torch.utils.pretrained import (
    convert_torch_resnet, load_backbone_into, load_torch_file)
from cvpr2020_manet_tpu_torch.weights import load_flax_params

DEPTHS, WIDTH = (1, 1, 1, 1), 16
TOL = dict(rtol=1e-4, atol=1e-4)


def make_torch_resnet_sd(depths, width, rng):
    """A torchvision-naming resnet state dict with random weights."""
    sd = {}

    def conv(name, cin, cout, k):
        sd[f"{name}.weight"] = rng.normal(
            size=(cout, cin, k, k)).astype(np.float32) * 0.1

    def bn(name, c):
        sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{name}.bias"] = rng.normal(size=c).astype(np.float32) * 0.1
        sd[f"{name}.running_mean"] = rng.normal(size=c).astype(np.float32)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 2.0, c).astype(
            np.float32)
        sd[f"{name}.num_batches_tracked"] = np.array(7, np.int64)

    conv("conv1", 3, width, 7)
    bn("bn1", width)
    cin = width
    for s, n in enumerate(depths):
        ch = width * (2 ** s)
        for b in range(n):
            t = f"layer{s + 1}.{b}"
            conv(f"{t}.conv1", cin if b == 0 else ch * 4, ch, 1)
            bn(f"{t}.bn1", ch)
            conv(f"{t}.conv2", ch, ch, 3)
            bn(f"{t}.bn2", ch)
            conv(f"{t}.conv3", ch, ch * 4, 1)
            bn(f"{t}.bn3", ch * 4)
            if b == 0:
                conv(f"{t}.downsample.0", cin, ch * 4, 1)
                bn(f"{t}.downsample.1", ch * 4)
        cin = ch * 4
    sd["fc.weight"] = rng.normal(size=(10, cin)).astype(np.float32)
    sd["fc.bias"] = np.zeros(10, np.float32)
    return sd


def _frozen(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, norm="frozen"))


def test_bn_folding_matches_torch_eval():
    """A folded FrozenAffine (the stem's) equals torch's BatchNorm2d in
    eval mode on its running statistics."""
    rng = np.random.default_rng(0)
    sd = make_torch_resnet_sd(DEPTHS, WIDTH, rng)
    converted = convert_torch_resnet(sd, DEPTHS)
    x = torch.from_numpy(rng.normal(size=(2, WIDTH, 5, 5)).astype(np.float32))
    bn = torch.nn.BatchNorm2d(WIDTH).eval()
    with torch.no_grad():
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, k).copy_(torch.from_numpy(sd[f"bn1.{k}"]))
        want = bn(x)
    w, b = converted["stem_norm.weight"], converted["stem_norm.bias"]
    got = x * w[:, None, None] + b[:, None, None]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert converted["stem_conv.weight"].shape == (WIDTH, 3, 7, 7)


def test_convert_and_load_equals_jax():
    """Both packages convert the same state dict and load it into a frozen
    tiny model; their encoders give the same features and embeddings."""
    rng = np.random.default_rng(1)
    sd = make_torch_resnet_sd(DEPTHS, WIDTH, rng)
    jcfg, tcfg = _frozen(jax_tiny()), _frozen(tiny_test_config())
    jmodel = JaxMANet(jcfg.model, matching_backend="jnp")
    o = jcfg.model.max_objects + 1
    variables = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, 8, 8, o)), jnp.zeros((1, 8, 8, o)))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    jparams = jpre.load_backbone_into(params,
                                      jpre.convert_torch_resnet(sd, DEPTHS))
    tmodel = load_flax_params(MANet(tcfg.model, device="cpu"), params)
    load_backbone_into(tmodel, convert_torch_resnet(sd, DEPTHS))
    x = rng.normal(size=(2, 64, 96, 3)).astype(np.float32)
    jf, je = jmodel.apply({"params": jparams}, jnp.asarray(x),
                          method=jmodel.extract_features)
    tf, te = tmodel.extract_features(torch.from_numpy(x))
    np.testing.assert_allclose(tf.detach().numpy(), np.asarray(jf), **TOL)
    np.testing.assert_allclose(te.detach().numpy(), np.asarray(je), **TOL)
    # the trunk really changed: the pretrained stem is not the Flax init's
    assert not np.allclose(np.asarray(jparams["encoder"]["backbone"][
        "stem_norm"]["bias"]), 0.0)


def test_load_rejects_shape_mismatch():
    """A converted backbone of another width or depth raises with the
    offending key; so does a 'gn' model, whose GroupNorms have the folded
    pairs' names and shapes but not their meaning."""
    rng = np.random.default_rng(2)
    converted = convert_torch_resnet(make_torch_resnet_sd(DEPTHS, 8, rng),
                                     DEPTHS)
    model = MANet(_frozen(tiny_test_config()).model, device="cpu")
    with pytest.raises(ValueError, match="shape mismatch at encoder."
                                         "backbone.stem_conv.weight"):
        load_backbone_into(model, converted)
    deeper = convert_torch_resnet(make_torch_resnet_sd((1, 2, 1, 1), WIDTH,
                                                       rng), (1, 2, 1, 1))
    with pytest.raises(KeyError, match="stage2_block1"):
        load_backbone_into(model, deeper)
    gn = MANet(tiny_test_config().model, device="cpu")
    ok = convert_torch_resnet(make_torch_resnet_sd(DEPTHS, WIDTH, rng),
                              DEPTHS)
    with pytest.raises(ValueError, match="norm='gn'"):
        load_backbone_into(gn, ok)


@pytest.mark.parametrize("suffix", [".pth", ".npz"])
def test_load_torch_file(tmp_path, suffix):
    """A .pth (torch.save of tensors) and an .npz load to the same arrays,
    and convert as the dict itself does."""
    sd = make_torch_resnet_sd(DEPTHS, WIDTH, np.random.default_rng(3))
    path = str(tmp_path / f"resnet{suffix}")
    if suffix == ".pth":
        torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                   path)
    else:
        np.savez(path, **sd)
    loaded = load_torch_file(path)
    assert set(loaded) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(loaded[k], v)
    a, b = (convert_torch_resnet(d, DEPTHS) for d in (loaded, sd))
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_backbone_label_covers_frozen_affine():
    """The reduced backbone LR reaches the pretrained FrozenAffine pairs
    (JAX's `_param_labels`: every leaf under `backbone`)."""
    model = MANet(_frozen(tiny_test_config()).model, device="cpu")
    labels = param_labels(model)
    assert labels["encoder.backbone.stem_norm.weight"] == "backbone"
    assert labels["encoder.backbone.stage1_block0.shortcut_norm.bias"] == \
        "backbone"
    assert labels["encoder.aspp.norm.0.weight"] == "heads"
    assert all(v == "backbone" for k, v in labels.items()
               if k.startswith("encoder.backbone."))
