"""The port's FEELVOS (`models/feelvos.py`, the port's own architecture)
against the benchmark's plain reference (`manet_bench/reference/
feelvos.py`), on the CPU, on seeded random weights.

Both load the same weights (`manet_bench.weights_feelvos`: drawn from
the seed, the frozen norms calibrated on a seeded clip). Xception-65
keeps its published widths and its 16 middle units (the trunk test alone
cuts them to two, on both sides); the ASPP, decoder and head are 32
channels wide (`feelvos_config(tiny=True)`), at 64 x 96 frames. The port runs in f32 here (its plain kernel
versions), the reference in f32 with TF32 off, so the two differ by
summation order alone: in the convs, and in the YUV inverse (a matrix
product in the reference, three multiply-adds in the port), whose
rounding of the input the layers carry down. Tolerances:

- a separable layer, the trunk, the encoder's feature and embedding:
  relative L2 error under 5e-5 (up to 3e-7 seen from RGB, 1.1e-5 from
  YUV, through up to 65 layers and a residual chain);
- the head's logits: within 1e-4 absolute (logits of order 1-10 after
  four layers, the decomposed first layer summing its two parts in
  another order);
- probabilities: within 1e-4 absolute (softmax outputs in [0, 1]; 1.4e-6
  seen from RGB, 5.1e-5 from YUV);
- labels: each pixel's label within 1e-5 of the reference's best
  upsampled probability (an argmax may flip between two labels that
  close, never further; 3.3e-6 seen).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu_torch.config import feelvos_config
from cvpr2020_manet_tpu_torch.engine.propagate_batch import BatchPropagator
from cvpr2020_manet_tpu_torch.models.feelvos import FEELVOS
from cvpr2020_manet_tpu_torch.models.layers import SeparableConv
from cvpr2020_manet_tpu_torch.models.xception import Xception65

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from manet_bench import synth  # noqa: E402
from manet_bench.judge import label_gaps  # noqa: E402
from manet_bench.reference import batch as rb  # noqa: E402
from manet_bench.reference import feelvos as rf  # noqa: E402
from manet_bench.reference.engine import upsampled_probs  # noqa: E402
from manet_bench.reference.model import fp32_math  # noqa: E402
from manet_bench.weights_feelvos import draw, make_weights  # noqa: E402

SIZE = (64, 96)
FRAMES = 4
REL, LOGIT_ATOL, PROB_ATOL, GAP = 5e-5, 1e-4, 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config():
    cfg = feelvos_config(tiny=True)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, max_objects=8),
        eval=dataclasses.replace(cfg.eval, image_size=SIZE))


@pytest.fixture(scope="module")
def tiny():
    """(port Config, model dict, weights, the port's model)."""
    cfg = _config()
    m = dataclasses.asdict(cfg.model)
    weights = make_weights(m, 23, torch.device("cpu"), SIZE)
    model = FEELVOS(cfg.model, device="cpu")
    model.load_state_dict(weights, strict=True)
    return cfg, m, weights, model.eval()


def _rel(x, ref):
    return float((x.double() - ref.double()).norm() / ref.double().norm())


def _images(n=2, key=0):
    rgb, lab = synth.make_video(4, key, n, SIZE, 2, "cpu")
    return torch.from_numpy(rgb), lab


@pytest.mark.parametrize("inner_relu", [False, True])
@pytest.mark.parametrize("rate", [1, 2])
def test_separable_layer_matches_the_reference(inner_relu, rate):
    g = torch.Generator().manual_seed(rate)
    layer = SeparableConv(24, 40, 3, rate=rate, inner_relu=inner_relu,
                          dtype=torch.float32)
    sd = {k: torch.randn(v.shape, generator=g) * 0.3
          for k, v in layer.state_dict().items()}
    layer.load_state_dict(sd)
    ref = rf.FeelvosRef({f"s.{k}": v for k, v in sd.items()}, {})
    x = torch.randn((2, 24, 9, 11), generator=g)
    with fp32_math(), torch.no_grad():
        want = ref.sep(x, "s", rate=rate, inner_relu=inner_relu)
        got = layer(x)
    assert _rel(got, want) < REL
    # the placements differ: ReLU first, or after each norm
    assert bool((want < 0).any()) is not inner_relu


def test_reduced_trunk_matches_the_reference(monkeypatch):
    """Xception-65 at its published widths, the middle flow cut to two
    units on both sides: the low-level tap and the exit flow's output."""
    monkeypatch.setattr(rf, "MIDDLE_UNITS", 2)
    m = dataclasses.asdict(_config().model)
    weights = draw(m, 5, torch.device("cpu"))
    trunk = Xception65(2, 16, "frozen", torch.float32)
    prefix = "encoder.backbone."
    trunk.load_state_dict({k[len(prefix):]: v for k, v in weights.items()
                           if k.startswith(prefix)}, strict=True)
    x = rb.normalized(_images(1)[0])
    with fp32_math(), torch.no_grad():
        low_r, out_r = rf.FeelvosRef(weights, m).trunk(x)
        low, out = trunk(x)
    assert low.shape == (1, 256, SIZE[0] // 4, SIZE[1] // 4)
    assert out.shape == (1, 2048, SIZE[0] // 16, SIZE[1] // 16)
    assert _rel(low, low_r) < REL and _rel(out, out_r) < REL


def test_encoder_matches_the_reference(tiny):
    cfg, m, weights, model = tiny
    rgb, _ = _images(2)
    with fp32_math(), torch.no_grad():
        feat_r, emb_r = rf.FeelvosRef(weights, m).encoder(rb.normalized(rgb))
        feat, emb = model.extract_features(rb.normalized(rgb).permute(
            0, 2, 3, 1))
    assert feat.shape == feat_r.shape
    assert emb.shape[-1] == cfg.model.embedding_dim_padded
    assert _rel(feat, feat_r) < REL
    assert _rel(emb[..., :m["embedding_dim"]], emb_r) < REL
    assert not emb[..., m["embedding_dim"]:].any()


def test_calibrated_norms_keep_unit_scale(tiny):
    """The harness's calibration: every norm's output on its calibration
    clip has, a channel, the drawn mean b and deviation g; so the
    encoder's feature stays near unit scale through 65 layers."""
    _, m, weights, _ = tiny
    drawn = draw(m, 23, torch.device("cpu"))
    rgb, _ = _images(2)
    ref = rf.FeelvosRef(weights, m)
    with fp32_math(), torch.no_grad():
        feat, _ = ref.encoder(rb.normalized(rgb))
    assert 0.2 < float(feat.std()) < 5.0
    changed = [n for n in rf.norm_names(m)
               if not torch.equal(weights[f"{n}.weight"],
                                  drawn[f"{n}.weight"])]
    assert changed == rf.norm_names(m)


@pytest.mark.parametrize("objects", [1, 2])
def test_head_for_three_objects_matches_the_reference(tiny, objects):
    """Three object slots (background, the objects, a padded slot where
    there is one object): the port's decomposed head (`start_clip`, then
    `clip_head`: the features' share of the first layer once a frame)
    against the reference's plain head."""
    cfg, m, weights, model = tiny
    rgb, lab = _images(2)
    g = torch.Generator().manual_seed(objects)
    h, w = SIZE[0] // 4, SIZE[1] // 4
    gm, lm = (torch.rand((h, w, 3), generator=g) for _ in range(2))
    prev = torch.softmax(3 * torch.randn((h, w, 3), generator=g), -1)
    ov = rb.object_valid(objects, 3, "cpu")
    with fp32_math(), torch.no_grad():
        feat_r, _ = rf.FeelvosRef(weights, m).encoder(rb.normalized(rgb))
        want = rf.FeelvosRef(weights, m).head(feat_r[1], gm, lm, prev, ov)
        clip, state = model.start_clip(feat_r, None, ov)
        got = model.clip_head(clip, 1, feat_r[1], gm, lm, prev)
    assert state == {}
    live = ov > 0
    torch.testing.assert_close(got[..., live], want[..., live], rtol=0,
                               atol=LOGIT_ATOL)
    assert bool((got[..., ~live] < -1e8).all())


def _clips(objects):
    frames, firsts = [], []
    for i, n in enumerate(objects):
        rgb, lab = synth.make_video(9, i, FRAMES, SIZE, n, "cpu")
        frames.append(rgb)
        firsts.append(lab[0, ::4, ::4].astype(np.int32))
    return np.stack(frames), np.stack(firsts)


@pytest.mark.parametrize("objects,ingest", [([2, 5], "yuv420"),
                                            ([1], "rgb")],
                         ids=["2clips-yuv420", "1clip-rgb"])
def test_propagation_matches_the_reference(tiny, objects, ingest):
    """A 4-frame propagation through `BatchPropagator`: each frame's
    probabilities from the reference stepped from the port's own
    probabilities of the frame before, and the labels."""
    cfg, m, weights, model = tiny
    prop = BatchPropagator(cfg, model, ingest=ingest, device="cpu")
    frames, firsts = _clips(objects)
    b, t = frames.shape[:2]
    up = prop.host_frames(frames)
    ex = prop.upload(up)
    fetches, bits, state = prop.dispatch(ex, firsts, np.asarray(objects),
                                         (b, t), probs_of=range(b))
    labels = prop.drain(fetches, bits)
    assert labels.shape == (b, t, *SIZE)
    emb = torch.cat([e for _, e in ex]).reshape(b, t, *ex[0][1].shape[1:])
    ref = rf.FeelvosRef(weights, m)
    with fp32_math(), torch.no_grad():
        for i in range(b):
            assert set(state[i]) == {"probs"}
            clip = (tuple(torch.from_numpy(a[i * t:(i + 1) * t]) for a in up)
                    if ingest == "yuv420" else torch.from_numpy(frames[i]))
            first = torch.from_numpy(firsts[i])
            probs = state[i]["probs"]
            o = probs.shape[-1]
            assert o == (9 if objects[i] > 3 else 4)
            ov = rb.object_valid(objects[i], o, "cpu")
            feat_r, emb_r = rb.encode_frames(ref, clip, range(t))
            assert _rel(emb[i][..., :emb_r.shape[-1]], emb_r) < REL
            labels0 = rb.key_labels(first, ov)
            for f in range(1, t):
                rp = rf.step(ref, feat_r[f], emb_r[f], emb_r[0], labels0,
                             emb_r[f - 1], probs[f - 1], ov)
                torch.testing.assert_close(probs[f], rp, rtol=0,
                                           atol=PROB_ATOL)
                gap = label_gaps(upsampled_probs(rp, SIZE),
                                 torch.from_numpy(labels[i, f]))
                assert float(gap.max()) <= GAP, (i, f)
            if ingest == "rgb":
                # the whole clip from the reference's own state lands on
                # the port's labels where both read the same input (from
                # YUV an early flip at a near-tie of random weights
                # carries down the clip through local matching)
                own, _, _ = rf.propagate_clip(ref, clip, first, objects[i],
                                              o)
                own = upsampled_probs(own, SIZE).argmax(-1).numpy()
                assert (own == labels[i]).mean() >= 0.999


def test_models_refuse_the_other_architecture():
    from cvpr2020_manet_tpu_torch.config import ModelConfig
    from cvpr2020_manet_tpu_torch.models.manet import MANet
    with pytest.raises(ValueError):
        MANet(_config().model, device="cpu")
    with pytest.raises(ValueError):
        FEELVOS(ModelConfig(), device="cpu")
    with pytest.raises(ValueError):
        FEELVOS(dataclasses.replace(_config().model, norm="gn"),
                device="cpu")
    with pytest.raises(ValueError):
        ModelConfig(arch="resnet")


@pytest.mark.parametrize("objects", [1, 3])
def test_manet_clip_head_is_the_decomposed_propagate(objects):
    """MANet's batch step (`start_clip`, `clip_head`) equals `propagate`
    with the same maps, the seeded memory and the decomposed head, where
    the running minimum is against ones (a d never exceeds 1)."""
    from cvpr2020_manet_tpu_torch.config import tiny_test_config
    from cvpr2020_manet_tpu_torch.models.manet import MANet
    cfg = tiny_test_config().model
    model = MANet(cfg, device="cpu", seed=3).eval()
    g = torch.Generator().manual_seed(objects)
    t, h, w, o = 3, 8, 12, 4
    feat = torch.randn((t, h, w, cfg.decoder_channels), generator=g)
    first = torch.randint(0, objects + 1, (h, w), generator=g)
    ov = rb.object_valid(objects, o, "cpu")
    first_oh = torch.nn.functional.one_hot(first, o).float() * ov
    gm, lm = (torch.rand((h, w, o), generator=g) for _ in range(2))
    prev = torch.softmax(3 * torch.randn((h, w, o), generator=g), -1)
    with torch.no_grad():
        clip, state = model.start_clip(feat, first_oh, ov)
        got = model.clip_head(clip, 2, feat[2], gm, lm, prev)
        model.local_map = lambda *_: lm
        want, fused = model.propagate(
            feat[2], None, None, None, None, torch.ones_like(gm), None, prev,
            state["int_mem"], ov, gmap_override=gm,
            head_pre=clip["head_fp"][2][None] + clip["head_mp"])
    assert set(state) == {"int_mem"}
    assert torch.equal(fused, gm)
    assert torch.equal(got, want)
