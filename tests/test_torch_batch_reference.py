"""The port's `BatchPropagator` against the benchmark's plain reference of
clip propagation (`manet_bench/reference/batch.py`), on the CPU.

Both get the same seeded random weights (`manet_bench.weights`, loaded
into the port by name), the same frames (uint8 RGB, or the planar YUV
4:2:0 that the port's host converter makes of them) and the same first
masks, at `tiny_test_config()` widths with the published local matching
(`local_downsample` 2) and room for the 9-wide object bucket. The port
runs in f32 here (its plain kernel versions), the reference in f32 with
TF32 off, so the two differ by summation order alone.

The reference steps every frame from the port's own probabilities of the
frame before (`dispatch(..., probs_of=)` hands them back), so that each
frame shows its own error and not an earlier argmax flip carried down
the clip. Tolerances:

- embeddings and the seeded memory: relative L2 error under 1e-5 (f32
  convs and GroupNorm in another summation order: about 1e-6 seen);
- probabilities: within 1e-5 absolute (softmax outputs in [0, 1] after a
  3-conv head, same reason);
- labels: each pixel's label within 1e-5 of the reference's best
  upsampled probability (an argmax may flip between two labels that
  close, never further).
"""

import os
import sys

import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu_torch.engine.propagate_batch import BatchPropagator

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from manet_bench import common, synth  # noqa: E402
from manet_bench.judge import label_gaps  # noqa: E402
from manet_bench.reference import batch as rb  # noqa: E402
from manet_bench.reference.engine import upsampled_probs  # noqa: E402
from manet_bench.reference.model import Ref, fp32_math  # noqa: E402
from manet_bench.tests.conftest import tiny_config  # noqa: E402
from manet_bench.weights import make_weights  # noqa: E402

SIZE = (64, 96)
FRAMES = 4
EMB_REL, PROB_ATOL, GAP = 1e-5, 1e-5, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """(config dict, the port's Config, weights, the port's model)."""
    config = tiny_config()
    config["model"]["max_objects"] = 8
    config["eval"]["image_size"] = list(SIZE)
    cfg = common.program_config(config)
    weights = make_weights(config["model"], 11, torch.device("cpu"))
    model = common.program_model(cfg, config, weights, torch.device("cpu"))
    return config, cfg, weights, model


def _clips(objects):
    """uint8 RGB (B, T, H, W, 3) and first masks (B, h, w) of seeded
    moving-object clips."""
    frames, firsts = [], []
    for i, n in enumerate(objects):
        rgb, lab = synth.make_video(5, i, FRAMES, SIZE, n, "cpu")
        frames.append(rgb)
        firsts.append(lab[0, ::4, ::4].astype(np.int32))
    return np.stack(frames), np.stack(firsts)


def _rel(x, ref):
    return float((x.double() - ref.double()).norm() / ref.double().norm())


CASES = [([1], "rgb"), ([2], "yuv420"), ([1, 5, 2], "rgb"),
         ([5, 3], "yuv420")]


@pytest.mark.parametrize("objects,ingest", CASES,
                         ids=[f"{len(o)}clips-{'-'.join(map(str, o))}-{i}"
                              for o, i in CASES])
def test_batch_propagation_matches_the_reference(tiny, objects, ingest):
    config, cfg, weights, model = tiny
    prop = BatchPropagator(cfg, model, ingest=ingest, device="cpu")
    frames, firsts = _clips(objects)
    b, t = frames.shape[:2]
    nobj = np.asarray(objects, np.int32)
    up = prop.host_frames(frames)
    ex = prop.upload(up)
    fetches, bits, state = prop.dispatch(ex, firsts, nobj, (b, t),
                                         probs_of=range(b))
    labels = prop.drain(fetches, bits)
    assert labels.shape == (b, t, *SIZE) and labels.dtype == np.int32
    emb = torch.cat([e for _, e in ex]).reshape(b, t, *ex[0][1].shape[1:])
    ref = Ref(weights, config["model"])
    buckets = {state[i]["probs"].shape[-1] for i in range(b)}
    assert buckets == {9 if n > 3 else 4 for n in objects}
    with fp32_math(), torch.no_grad():
        for i in range(b):
            clip = (tuple(torch.from_numpy(a[i * t:(i + 1) * t]) for a in up)
                    if ingest == "yuv420" else torch.from_numpy(frames[i]))
            first = torch.from_numpy(firsts[i])
            probs = state[i]["probs"]
            o = probs.shape[-1]
            ov = rb.object_valid(objects[i], o, "cpu")
            feat_r, emb_r = rb.encode_frames(ref, clip, range(t))
            assert _rel(emb[i][..., :emb_r.shape[-1]], emb_r) < EMB_REL
            mem = rb.seed_memory(ref, feat_r[0], first, ov)
            assert _rel(state[i]["int_mem"].permute(0, 3, 1, 2), mem) \
                < EMB_REL
            torch.testing.assert_close(probs[0], rb.first_probs(first, ov),
                                       rtol=0, atol=0)
            labels0 = rb.key_labels(first, ov)
            for f in range(1, t):
                rp = rb.step(ref, feat_r[f], emb_r[f], emb_r[0], labels0,
                             emb_r[f - 1], probs[f - 1], mem, ov)
                torch.testing.assert_close(probs[f], rp, rtol=0,
                                           atol=PROB_ATOL)
                gap = label_gaps(upsampled_probs(rp, SIZE),
                                 torch.from_numpy(labels[i, f]))
                assert float(gap.max()) <= GAP, (i, f)
            # the whole clip from the reference's own state lands on the
            # port's labels (no near-tie at these seeds)
            own, _, _ = rb.propagate_clip(ref, clip, first, objects[i], o)
            own = upsampled_probs(own, SIZE).argmax(-1).numpy()
            agree = (own == labels[i]).mean()
            assert agree >= 0.999, agree


def test_hand_back_is_what_a_plain_dispatch_propagates(tiny, monkeypatch):
    """`probs_of` changes nothing of the call: the same labels, bit for
    bit, as a plain dispatch; the probabilities handed back are the ones
    the plain dispatch upsampled (read at the upsample), and their
    upsampled argmax is the labels unpacked from the packed download."""
    from cvpr2020_manet_tpu_torch.engine import propagate_batch as pb
    from cvpr2020_manet_tpu_torch.models.layers import resize_bilinear
    _, cfg, _, model = tiny
    prop = BatchPropagator(cfg, model, ingest="yuv420", device="cpu")
    objects = [2, 5, 1]
    frames, firsts = _clips(objects)
    b, t = frames.shape[:2]
    nobj = np.asarray(objects, np.int32)
    ex = prop.upload(prop.host_frames(frames))
    seen = []

    def upsample(x, size):
        seen.append(x.clone())
        return resize_bilinear(x, size)

    monkeypatch.setattr(pb, "resize_bilinear", upsample)
    plain = prop.dispatch(ex, firsts, nobj, (b, t))
    assert len(plain) == 2
    want = prop.drain(*plain)
    monkeypatch.setattr(pb, "resize_bilinear", resize_bilinear)
    fetches, bits, state = prop.dispatch(ex, firsts, nobj, (b, t),
                                         probs_of=[2, 0])
    got = prop.drain(fetches, bits)
    np.testing.assert_array_equal(got, want)
    assert sorted(state) == [0, 2]
    for i in (0, 2):
        probs = state[i]["probs"]
        assert probs.dtype == torch.float32
        assert probs.shape == (t, SIZE[0] // 4, SIZE[1] // 4, 4)
        torch.testing.assert_close(probs, seen[i], rtol=0, atol=0)
        assert state[i]["int_mem"].shape[:3] == probs.shape[-1:] + \
            probs.shape[1:3]
        lab = resize_bilinear(probs, SIZE).argmax(-1).numpy()
        np.testing.assert_array_equal(lab, got[i])
    with pytest.raises(ValueError):
        prop.dispatch(ex, firsts, nobj, (b, t), probs_of=[3])
