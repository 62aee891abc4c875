"""The PyTorch port's DAVIS clip sampler against the JAX package's, on the
`davis_root` fixture tree (tests/conftest.py): every array of every clip
and batch bit for bit, from the same seeds, and only the sampled frames
decoded."""

import dataclasses

import numpy as np
import pytest

from cvpr2020_manet_tpu.config import tiny_test_config as jax_tiny
from cvpr2020_manet_tpu.data import davis as jdavis
from cvpr2020_manet_tpu_torch.config import tiny_test_config
from cvpr2020_manet_tpu_torch.data import davis as tdavis

SEEDS = range(16)


def configs(crop=None, max_objects=None):
    """(JAX config, port config): the tiny config with the same crop and
    object bucket."""
    out = []
    for cfg in (jax_tiny(), tiny_test_config()):
        if crop is not None:
            cfg = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, crop_size=crop))
        if max_objects is not None:
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, max_objects=max_objects))
        out.append(cfg)
    return out


def assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_byte_round_trip_is_identity():
    """JAX's sampler rounds its normalized floats back to bytes,
    `(clip(x * std + mean, 0, 1) * 255).round()`, before PIL's resize: the
    identity on all 256 values of every channel in float32, so the port
    starts from the decoded bytes."""
    v = np.arange(256, dtype=np.uint8)
    rgb = np.repeat(v[:, None], 3, axis=1)[None]          # (1, 256, 3)
    x = jdavis.normalize_image(rgb.astype(np.float32) / 255.0)
    raw = np.clip(x * jdavis.IMAGENET_STD + jdavis.IMAGENET_MEAN, 0.0, 1.0)
    back = (raw * 255.0).round().astype(np.uint8)
    np.testing.assert_array_equal(back, rgb)
    # ... while the batch loader's truncation is not (`propagate_batch`)
    trunc = np.clip((x * jdavis.IMAGENET_STD + jdavis.IMAGENET_MEAN) * 255.0,
                    0, 255).astype(np.uint8)
    assert (trunc != rgb).sum() == 137


@pytest.mark.parametrize("shard", [None, (0, 2), (1, 2)],
                         ids=["all", "shard0", "shard1"])
@pytest.mark.parametrize("emit_uint8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("clip_len", [3, 6])
def test_sample_clip_equals_jax(davis_root, clip_len, emit_uint8, shard):
    """16 seeds: the sequence, the frames (the triplet rule at clip_len 3,
    padding and frame_valid at 6 on 4-frame sequences), scale, crop, flip,
    the compact remap and obj_valid all equal JAX's."""
    jcfg, tcfg = configs()
    want_ds = jdavis.DavisTrainDataset(davis_root, jcfg, clip_len=clip_len,
                                       emit_uint8=emit_uint8, shard=shard)
    got_ds = tdavis.DavisTrainDataset(davis_root, tcfg, clip_len=clip_len,
                                      emit_uint8=emit_uint8, shard=shard)
    for seed in SEEDS:
        want = want_ds.sample_clip(np.random.default_rng(seed))
        got = got_ds.sample_clip(np.random.default_rng(seed))
        assert_same(got, want)
    if clip_len == 6:
        assert got["frame_valid"].tolist() == [1, 1, 1, 1, 0, 0]


@pytest.mark.parametrize("crop,max_objects", [((60, 90), 2), ((40, 40), 1)],
                         ids=["crop_floor", "one_object"])
def test_sample_clip_equals_jax_at_the_crop_floor(davis_root, crop,
                                                  max_objects):
    """A crop of 60 x 90 on 64 x 96 frames takes the resize floor
    `max(crop, int(size * scale))` on most draws; a bucket of one object
    caps the remap."""
    jcfg, tcfg = configs(crop, max_objects)
    want_ds = jdavis.DavisTrainDataset(davis_root, jcfg)
    got_ds = tdavis.DavisTrainDataset(davis_root, tcfg)
    for seed in SEEDS:
        assert_same(got_ds.sample_clip(np.random.default_rng(seed)),
                    want_ds.sample_clip(np.random.default_rng(seed)))


@pytest.mark.parametrize("emit_uint8", [False, True], ids=["f32", "u8"])
def test_batch_equals_jax(davis_root, emit_uint8):
    """`batch()` draws from the dataset's own seeded generator: three
    batches in a row equal JAX's."""
    jcfg, tcfg = configs()
    want_ds = jdavis.DavisTrainDataset(davis_root, jcfg, seed=5,
                                       emit_uint8=emit_uint8)
    got_ds = tdavis.DavisTrainDataset(davis_root, tcfg, seed=5,
                                      emit_uint8=emit_uint8)
    for _ in range(3):
        assert_same(got_ds.batch(3), want_ds.batch(3))


def test_bad_shards_raise(davis_root):
    _, tcfg = configs()
    with pytest.raises(ValueError, match="bad shard"):
        tdavis.DavisTrainDataset(davis_root, tcfg, shard=(2, 2))
    with pytest.raises(ValueError, match="is empty"):
        tdavis.DavisTrainDataset(davis_root, tcfg, shard=(2, 3))


def test_only_sampled_frames_are_decoded(tmp_path, monkeypatch):
    """On 30-frame sequences a triplet decodes at most 3 JPEGs and 3 PNGs
    (a frame that repeats in the clip once), a padded 6-frame clip of a
    30-frame sequence 6; JAX's sampler decodes all 30 of each."""
    from _torch_davis_tree import write_davis_tree

    root = str(tmp_path / "DAVIS")
    write_davis_tree(root, (128, 160), [("long_a", 30, 2, 0),
                                        ("long_b", 30, 1, 1)], 1)
    reads = {"jpg": 0, "png": 0}

    def counting(kind, fn):
        def read(path):
            reads[kind] += 1
            return fn(path)
        return read
    monkeypatch.setattr(tdavis, "read_jpeg",
                        counting("jpg", tdavis.read_jpeg))
    monkeypatch.setattr(tdavis, "load_indexed_png",
                        counting("png", tdavis.load_indexed_png))
    _, tcfg = configs()
    for clip_len, most in ((3, 3), (6, 6)):
        ds = tdavis.DavisTrainDataset(root, tcfg, clip_len=clip_len)
        for seed in range(8):
            reads.update(jpg=0, png=0)
            clip = ds.sample_clip(np.random.default_rng(seed))
            assert clip["images"].shape[0] == clip_len
            assert 1 <= reads["jpg"] <= most and reads["png"] == reads["jpg"]
