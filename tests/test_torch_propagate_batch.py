"""The PyTorch port's BatchPropagator vs the JAX one, on the CPU.

Both get the same Flax weights (bridged into the port), frames and first
masks. f32 (JAX's plain oracle against the port's plain kernel versions):
f32 summation order only, so the label maps are equal. int8 (JAX's
interpret-mode int8 kernel against the port's plain int8 version): the
embeddings differ by ~1e-6 between the packages, so a channel on a
rounding edge can land one quantization step apart; labels agree on at
least 0.999 of the pixels.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu.config import tiny_test_config as jax_tiny
from cvpr2020_manet_tpu.engine.propagate_batch import (
    BatchPropagator as JaxPropagator)
from cvpr2020_manet_tpu.models import MANet as JaxMANet
from cvpr2020_manet_tpu_torch.config import tiny_test_config
from cvpr2020_manet_tpu_torch.data import SyntheticDataset
from cvpr2020_manet_tpu_torch.engine import propagate_batch as tpb
from cvpr2020_manet_tpu_torch.engine.propagate_batch import BatchPropagator
from cvpr2020_manet_tpu_torch.models import MANet
from cvpr2020_manet_tpu_torch.utils.ingest import rgb_to_yuv420_host
from cvpr2020_manet_tpu_torch.weights import load_flax_params

BACKENDS = {"f32": ("jnp", "auto"), "int8": ("pallas_int8_interpret", "int8")}
MIN_AGREE_INT8 = 0.999


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(mode, ingest="rgb", max_objects=None):
    jcfg, tcfg = jax_tiny(), tiny_test_config()
    if max_objects is not None:
        jcfg, tcfg = (dataclasses.replace(c, model=dataclasses.replace(
            c.model, max_objects=max_objects)) for c in (jcfg, tcfg))
    jbackend, tbackend = BACKENDS[mode]
    jmodel = JaxMANet(jcfg.model, matching_backend=jbackend)
    h, w = jcfg.eval.image_size
    o = jcfg.model.max_objects + 1
    variables = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)),
        jnp.zeros((1, h // 4, w // 4, o)), jnp.zeros((1, h // 4, w // 4, o)))
    tmodel = load_flax_params(
        MANet(tcfg.model, device="cpu", matching_backend=tbackend),
        jax.tree_util.tree_map(np.asarray, variables["params"]))
    return (JaxPropagator(jcfg, jmodel, variables, ingest=ingest),
            BatchPropagator(tcfg, tmodel, ingest=ingest, device="cpu"), tcfg)


def _clips(cfg, b, t):
    h, w = cfg.eval.image_size
    frames = np.zeros((b, t, h, w, 3), np.uint8)
    firsts = []
    for i in range(b):
        ds = SyntheticDataset(image_size=(h, w), num_frames=t,
                              num_sequences=1, num_objects=2, seed=i)
        seq = ds.sequences()[0]
        frames[i] = (np.clip(ds.images(seq), 0, 1) * 255).astype(np.uint8)
        firsts.append(ds.gt_masks(seq)[0, ::4, ::4])
    return frames, np.stack(firsts).astype(np.int32)


def _check(mode, got, want):
    assert got.shape == want.shape and got.dtype == np.int32
    if mode == "f32":
        np.testing.assert_array_equal(got, want)
    else:
        assert (got == want).mean() >= MIN_AGREE_INT8


@pytest.mark.parametrize("mode,ingest", [("f32", "rgb"), ("f32", "yuv420"),
                                         ("int8", "rgb")])
def test_propagation_matches_jax(mode, ingest):
    jp, tp, cfg = _pair(mode, ingest)
    frames, first = _clips(cfg, b=2, t=5)        # 10 frames: chunks of 8 + 2
    nobj = np.array([2, 2])
    got = tp.propagate(frames, first, nobj)
    _check(mode, got, np.asarray(jp.propagate(frames, first, nobj)))
    assert (got > 0).mean() > 0.05               # not all background
    seed_up = np.repeat(np.repeat(first, 4, axis=1), 4, axis=2)
    assert (got[:, 0] == seed_up).mean() > 0.95   # frame 0 is the seed
    assert [f.shape[0] for f, _ in tp.upload(
        frames.reshape(-1, *frames.shape[2:]))] == [8, 2]


def test_mixed_object_buckets_match_jax():
    """One clip of 1 object (bucket 4) and one of 5 (bucket 6) in a batch."""
    jp, tp, cfg = _pair("f32", max_objects=5)
    h, w = cfg.eval.image_size
    b, t = 2, 3
    frames = np.random.default_rng(0).integers(
        0, 256, (b, t, h, w, 3)).astype(np.uint8)
    fm = np.zeros((b, h // 4, w // 4), np.int32)
    fm[0, 2:4, 2:4] = 1
    fm[1, 1:3, 1:3] = 2
    fm[1, 4:6, 4:6] = 5
    nobj = np.array([1, 5])
    got = tp.propagate(frames, fm, nobj)
    _check("f32", got, np.asarray(jp.propagate(frames, fm, nobj)))
    assert got[0].max() <= 1 and got[1].max() <= 5
    assert (got[1, 0, 18:22, 18:22] == 5).all()


def test_threaded_and_packed_uploads_equal_serial():
    _, tp, cfg = _pair("f32", "yuv420")
    h, w = cfg.eval.image_size
    frames = np.random.default_rng(3).integers(0, 255, (10, h, w, 3),
                                               dtype=np.uint8)
    serial = tp.upload(frames)
    packed = tp.upload(rgb_to_yuv420_host(frames))
    threaded = tp.upload(rgb_to_yuv420_host(frames), threads=3)
    threaded_rgb = tp.upload(frames, threads=2)
    assert [f.shape[0] for f, _ in threaded] == [8, 2]
    for other in (packed, threaded, threaded_rgb):
        for (fs, es), (fo, eo) in zip(serial, other):
            torch.testing.assert_close(fo, fs, rtol=0, atol=0)
            torch.testing.assert_close(eo, es, rtol=0, atol=0)
    with pytest.raises(ValueError):              # packed input needs yuv420
        _pair("f32")[1].upload(rgb_to_yuv420_host(frames))


def test_timed_batches_labels_equal_propagate():
    """The timing loops (planar YUV made before the clock, threaded
    pipelined uploads) give `propagate`'s labels in every serial run."""
    _, tp, cfg = _pair("int8", "yuv420")
    frames, first = _clips(cfg, b=2, t=3)
    nobj = np.array([2, 2])
    serial, pipelined, labels = tpb.timed_batches(
        tp, [(frames, first, nobj)] * 2, threads=2)
    assert len(serial) == 2 and min(serial) > 0 and pipelined > 0
    want = tp.propagate(frames, first, nobj)
    for got in labels:
        np.testing.assert_array_equal(got, want)


def test_cli_prints_metric_on_cpu(monkeypatch, capsys):
    """The CLI at the tiny config, the device resolved to the CPU (the CLI,
    like the JAX one, has no device flag)."""
    monkeypatch.setattr(tpb, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    for extra in ([], ["--matching_int8", "--ingest", "yuv420",
                       "--upload_threads", "2"]):
        tpb.main(["--tiny", "--batch", "2", "--frames", "4",
                  "--timed_batches", "1", *extra])
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rec["metric"] == "batched_propagation_fps"
        assert rec["value"] > 0 and rec["fps_serial"] > 0
        assert rec["device_busy_fraction"] > 0
        assert rec["batch"] == 2 and rec["frames"] == 4
        assert rec["device"] == "cpu"
