"""The port's serving artifacts (`utils/export.py`, `utils/export_cli.py`)
on the CPU: round trips against the live module, the manifest, the
loaders' refusals and the export CLI.

Weights come from the Flax init through the port's bridge (`weights.py`)
at `tiny_test_config()`. A loaded program runs the same ATen operations
and the same plain matching versions (the `manet::*` custom ops' CPU
registrations) as the live module, so the two agree to 1e-6.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cvpr2020_manet_tpu.config import tiny_test_config as jax_tiny
from cvpr2020_manet_tpu.models import MANet as JaxMANet
from cvpr2020_manet_tpu_torch.config import tiny_test_config
from cvpr2020_manet_tpu_torch.models import MANet
from cvpr2020_manet_tpu_torch.utils import export as ex
from cvpr2020_manet_tpu_torch.utils import export_cli
from cvpr2020_manet_tpu_torch.utils.ingest import (
    preprocess_frames, preprocess_yuv420, rgb_to_yuv420_host)
from cvpr2020_manet_tpu_torch.weights import load_flax_params

ATOL = 1e-6
MANET_OPS = {"auto": "manet.global_matching.default",
             "int8": "manet.global_matching_int8.default"}


def _bridged(backend: str = "auto"):
    cfg = jax_tiny()
    h, w = cfg.eval.image_size
    o = cfg.model.max_objects + 1
    variables = jax.jit(JaxMANet(cfg.model, matching_backend="jnp").init)(
        jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)),
        jnp.zeros((1, h // 4, w // 4, o)), jnp.zeros((1, h // 4, w // 4, o)))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    model = MANet(tiny_test_config().model, device="cpu", seed=1,
                  matching_backend=backend)
    return load_flax_params(model, params).eval()


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config()
    return cfg, _bridged()


@pytest.fixture(scope="module")
def fused(setup, tmp_path_factory):
    """The default (uint8) fused artifact, saved and loaded back."""
    cfg, model = setup
    path = str(tmp_path_factory.mktemp("fused") / "m.ivosx")
    exported = ex.export_forward(model, cfg.eval.image_size,
                                 cfg.model.max_objects,
                                 pad_to=cfg.eval.pad_to)
    manifest = ex.save_artifact(exported, path,
                                extra={"image_size": cfg.eval.image_size})
    return path, exported, manifest


@pytest.fixture(scope="module")
def bundle(setup, tmp_path_factory):
    cfg, model = setup
    path = str(tmp_path_factory.mktemp("bundle") / "b.ivosx")
    exports = ex.export_serving_bundle(model, cfg.eval.image_size,
                                       cfg.model.max_objects,
                                       pad_to=cfg.eval.pad_to)
    manifest = ex.save_bundle(exports, path,
                              extra={"image_size": cfg.eval.image_size})
    return path, exports, manifest


def _close(got, want, atol=ATOL):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=atol)


def test_fused_roundtrip_matches_live_module(setup, fused):
    cfg, model = setup
    path, _, manifest = fused
    loaded = ex.load_artifact(path)
    assert loaded.manifest == manifest
    assert loaded.device == torch.device("cpu")
    fn, example_args = ex.wrap_raw_image(*ex.build_round_forward(
        model, cfg.eval.image_size, cfg.model.max_objects,
        pad_to=cfg.eval.pad_to))
    rng = np.random.default_rng(1)
    args = [export_cli._rand_like(rng, a) for a in example_args]
    got = loaded(*args)
    with torch.no_grad():
        _close(got, fn(*args))
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


def test_bundle_loop_matches_live_module(setup, bundle):
    """A 2-frame interactive round from the loaded bundle alone (extract
    -> interact -> aggregate_first -> propagate -> aggregate_update)
    equals the same chain through the live build_serving_fns closures."""
    cfg, model = setup
    path, _, manifest = bundle
    loaded = ex.load_bundle(path)
    assert loaded.names == ["aggregate_first", "aggregate_update",
                            "extract", "interact", "propagate"]
    assert loaded.manifest == manifest
    fns = ex.build_serving_fns(model, cfg.eval.image_size,
                               cfg.model.max_objects, pad_to=cfg.eval.pad_to)
    fns = dict(fns, extract=ex.wrap_raw_image(*fns["extract"]))
    live = {name: fn for name, (fn, _) in fns.items()}
    rng = np.random.default_rng(3)
    h, w = cfg.eval.image_size
    o = cfg.model.max_objects + 1
    imgs = [torch.from_numpy(rng.integers(0, 256, (h, w, 3), np.uint8))
            for _ in range(2)]
    pos = torch.zeros(h // 4, w // 4, o)
    pos[2:4, 2:4, 1] = 1.0

    def loop(call):
        feat0, emb0 = call["extract"](imgs[0])
        bg = F.one_hot(torch.zeros(h // 4, w // 4, dtype=torch.long),
                       o).float()
        int_feats, probs0 = call["interact"](feat0, pos, torch.zeros_like(pos),
                                             bg)
        mem = call["aggregate_first"](int_feats)
        feat1, emb1 = call["extract"](imgs[1])
        onehot = F.one_hot(probs0.argmax(-1).reshape(-1), o).float()
        probs1, gmap = call["propagate"](
            feat1, emb1, emb0.reshape(-1, emb0.shape[-1]), onehot,
            torch.ones(h // 4, w // 4, o), emb0, probs0, mem, torch.ones(o))
        return (feat0, emb0, probs0, mem, probs1, gmap,
                call["aggregate_update"](int_feats, mem))

    got = loop(loaded)
    with torch.no_grad():
        _close(got, loop(live))
    np.testing.assert_allclose(got[4].sum(-1).numpy(), 1.0, atol=1e-5)


def test_manifest_fields(setup, fused, bundle):
    cfg, _ = setup
    h, w = cfg.eval.image_size
    o = cfg.model.max_objects + 1
    _, _, manifest = fused
    assert manifest["format"] == ex.FORMAT == "ivosx-torch/1"
    assert manifest["torch_version"] == torch.__version__
    assert manifest["device"] == "cpu"
    assert manifest["image_size"] == [h, w]
    assert manifest["in_avals"] == [[[h, w, 3], "uint8"],
                                    [[h // 4, w // 4, o], "float32"],
                                    [[h // 4, w // 4, o], "float32"]]
    assert manifest["out_avals"] == [[[h // 4, w // 4, o], "float32"]]
    _, _, bmanifest = bundle
    assert bmanifest["format"] == ex.BUNDLE_FORMAT
    prop = bmanifest["entries"]["propagate"]
    assert prop["device"] == "cpu"
    assert prop["out_avals"] == [[[h // 4, w // 4, o], "float32"]] * 2
    assert bmanifest["entries"]["extract"]["in_avals"] == [[[h, w, 3],
                                                            "uint8"]]


def test_extra_cannot_clobber_reserved_keys(fused, tmp_path):
    _, exported, _ = fused
    with pytest.raises(ValueError, match="reserved"):
        ex.save_artifact(exported, str(tmp_path / "m.ivosx"),
                         extra={"format": "evil"})
    with pytest.raises(ValueError, match="reserved"):
        ex.save_bundle({"extract": exported}, str(tmp_path / "b.ivosx"),
                       extra={"entries": {}})


@pytest.mark.parametrize("load", [ex.load_artifact, ex.load_bundle],
                         ids=["artifact", "bundle"])
def test_load_rejects_bad_magic(load, tmp_path):
    path = str(tmp_path / "bad.ivosx")
    with open(path, "wb") as f:
        f.write(b"NOTANARTIFACT")
    with pytest.raises(ValueError, match="bad magic"):
        load(path)


def test_load_rejects_corrupt_manifest(tmp_path):
    path = str(tmp_path / "bad.ivosx")
    with open(path, "wb") as f:
        f.write(b"IVOSX1\n{not json\n")
    with pytest.raises(ValueError, match="corrupt manifest"):
        ex.load_artifact(path)


def test_load_rejects_corrupt_blob(fused, bundle, tmp_path):
    for src, load, what in ((fused[0], ex.load_artifact,
                             "corrupt export blob"),
                            (bundle[0], ex.load_bundle, "corrupt blob")):
        data = open(src, "rb").read()
        path = str(tmp_path / "cut.ivosx")
        with open(path, "wb") as f:
            f.write(data[: len(data) // 2])       # truncate the blobs
        with pytest.raises(ValueError, match=what):
            load(path)


def test_wrong_shape_call_raises(setup, fused):
    cfg, _ = setup
    loaded = ex.load_artifact(fused[0])
    h, w = cfg.eval.image_size
    o = cfg.model.max_objects + 1
    maps = torch.zeros(h // 4, w // 4, o)
    with pytest.raises(ValueError, match="argument 0"):
        loaded(torch.zeros(h + 4, w, 3, dtype=torch.uint8), maps, maps)
    with pytest.raises(ValueError, match="argument 0"):
        loaded(torch.zeros(h, w, 3), maps, maps)          # float, not uint8
    with pytest.raises(ValueError, match="arguments"):
        loaded(torch.zeros(h, w, 3, dtype=torch.uint8), maps)


def test_bundle_rejects_artifact_file(fused):
    with pytest.raises(ValueError, match="bad magic"):
        ex.load_bundle(fused[0])


def test_export_rejects_unknown_image_format(setup):
    cfg, model = setup
    with pytest.raises(ValueError, match="image_format"):
        ex.export_forward(model, cfg.eval.image_size, cfg.model.max_objects,
                          pad_to=cfg.eval.pad_to, image_format="jpeg")
    with pytest.raises(ValueError, match="image_format"):
        ex.export_serving_bundle(model, cfg.eval.image_size,
                                 cfg.model.max_objects, image_format="jpeg")


def test_nonaligned_size_pads_to_pad_to(setup):
    """Spatial contract: grid = (H + (-H) % pad_to) // 4 per side; the
    padded image goes through the encoder, as in the fused round."""
    cfg, model = setup
    o = cfg.model.max_objects + 1
    fn, example_args = ex.build_round_forward(
        model, (30, 50), cfg.model.max_objects, pad_to=cfg.eval.pad_to)
    assert example_args[0].shape == (30, 50, 3)
    assert example_args[1].shape == (8, 16, o)
    fns = ex.build_serving_fns(model, (30, 50), cfg.model.max_objects,
                               pad_to=cfg.eval.pad_to)
    image = torch.randn(30, 50, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert fn(image, *example_args[1:]).shape == (8, 16, o)
        feat, _ = fns["extract"][0](image)
        padded = F.pad(image, (0, 0, 0, 14, 0, 2))
        want, _ = model.extract_features(padded[None])
    assert feat.shape == (8, 16, cfg.model.decoder_channels)
    torch.testing.assert_close(feat, want[0], rtol=0, atol=0)


def test_image_formats_match_normalized_float(setup, tmp_path):
    """The uint8 and yuv420 artifacts equal the float32 artifact fed the
    same frame normalized (and decoded) on the host: the transforms live
    inside the exported graphs."""
    cfg, model = setup
    h, w = cfg.eval.image_size
    o = cfg.model.max_objects + 1
    loaded = {}
    for fmt in ("float32", "uint8", "yuv420"):
        path = str(tmp_path / f"{fmt}.ivosx")
        ex.save_artifact(ex.export_forward(
            model, (h, w), cfg.model.max_objects, pad_to=cfg.eval.pad_to,
            image_format=fmt), path)
        loaded[fmt] = ex.load_artifact(path)
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    y, uv = (torch.from_numpy(a) for a in rgb_to_yuv420_host(img))
    pos = torch.zeros(h // 4, w // 4, o)
    pos[1:3, 1:3, 1] = 1.0
    neg = torch.zeros_like(pos)
    img = torch.from_numpy(img)
    _close(loaded["uint8"](img, pos, neg),
           loaded["float32"](preprocess_frames(img), pos, neg))
    _close(loaded["yuv420"](y, uv, pos, neg),
           loaded["float32"](preprocess_yuv420(y, uv), pos, neg))
    assert loaded["yuv420"].manifest["in_avals"][:2] == [
        [[h, w], "uint8"], [[h // 2, w // 2, 2], "uint8"]]


@pytest.mark.parametrize("backend", ["auto", "int8"])
def test_exported_graph_holds_manet_ops(setup, backend):
    """The propagate entry and the fused round hold the matching kernels
    as custom-op nodes (the counterpart of JAX's tpu_custom_call check):
    manet::local_matching and the global op of the backend, not the
    other one."""
    cfg, _ = setup
    model = _bridged(backend)
    fns = ex.build_serving_fns(model, cfg.eval.image_size,
                               cfg.model.max_objects, pad_to=cfg.eval.pad_to)
    for fn, args in (fns["propagate"], ex.build_round_forward(
            model, cfg.eval.image_size, cfg.model.max_objects,
            pad_to=cfg.eval.pad_to)):
        ep = ex._export(model, fn, args)
        targets = [str(n.target) for n in ep.graph.nodes
                   if n.op == "call_function"]
        assert targets.count(MANET_OPS[backend]) == 1
        assert targets.count("manet.local_matching.default") == 1
        other = MANET_OPS["int8" if backend == "auto" else "auto"]
        assert other not in targets


@pytest.mark.parametrize("bundle_flag", [True, False],
                         ids=["bundle", "fused"])
def test_cli_export_and_check(tmp_path, capsys, bundle_flag):
    out = str(tmp_path / "cli.ivosx")
    export_cli.main(["--out", out, "--tiny", "--check", "--device", "cpu",
                     *(["--bundle"] if bundle_flag else [])])
    lines = capsys.readouterr().out.strip().splitlines()
    manifest = json.loads(lines[0])
    assert manifest["format"] == (ex.BUNDLE_FORMAT if bundle_flag
                                  else ex.FORMAT)
    assert manifest["matching_backend"] == "auto"
    assert manifest["image_input"] == "uint8_rgb"
    assert lines[-1].endswith("direct apply")


@pytest.mark.parametrize("argv,error,match", [
    (["--platforms", "cpu"], SystemExit, "--device"),
    (["--matching_backend", "jnp"], ValueError, r"\('auto', 'int8'\)"),
    (["--matching_backend", "pallas_int8"], ValueError, r"\('auto', 'int8'\)"),
])
def test_cli_refuses_jax_only_flags(tmp_path, argv, error, match):
    with pytest.raises(error, match=match):
        export_cli.main(["--out", str(tmp_path / "x.ivosx"), "--tiny",
                         "--device", "cpu", *argv])
