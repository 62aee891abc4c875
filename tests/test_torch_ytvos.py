"""The PyTorch port's YouTube-VOS adapter and the clip sampler over it
against the JAX package's: the tree of tests/test_ytvos.py (PIL JPEGs and
PNGs), with and without meta.json, and a tree of the port's own writer
(`tests/_torch_davis_tree.write_ytvos_tree`, numpy JPEGs)."""

import json
import os

import numpy as np
import pytest
from PIL import Image

from cvpr2020_manet_tpu.config import tiny_test_config as jax_tiny
from cvpr2020_manet_tpu.data.davis import DavisTrainDataset as JaxTrain
from cvpr2020_manet_tpu.data.ytvos import YTVOSDataset as JaxYTVOS
from cvpr2020_manet_tpu.utils.colormap import davis_palette
from cvpr2020_manet_tpu_torch.config import tiny_test_config
from cvpr2020_manet_tpu_torch.data.davis import DavisTrainDataset
from cvpr2020_manet_tpu_torch.data.ytvos import YTVOSDataset


@pytest.fixture(params=[True, False], ids=["meta", "listing"])
def ytvos_root(tmp_path, request):
    """tests/test_ytvos.py's tree (2 videos of 3 frames named 00000,
    00005, 00010, one object), with a second object entering in vid_b's
    last frame, and its meta.json only in the "meta" case."""
    root = tmp_path / "ytvos"
    rng = np.random.default_rng(0)
    h, w, t = 64, 96, 3
    videos = {}
    for seq in ["vid_a", "vid_b"]:
        (root / "train" / "JPEGImages" / seq).mkdir(parents=True)
        (root / "train" / "Annotations" / seq).mkdir(parents=True)
        for f in range(t):
            img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
            Image.fromarray(img).save(
                root / "train" / "JPEGImages" / seq / f"{f * 5:05d}.jpg")
            mask = np.zeros((h, w), np.uint8)
            mask[10:30, 10:40] = 1
            if seq == "vid_b" and f == t - 1:
                mask[40:60, 50:90] = 2
            m = Image.fromarray(mask, mode="P")
            m.putpalette(davis_palette().reshape(-1).tolist())
            m.save(root / "train" / "Annotations" / seq / f"{f * 5:05d}.png")
        videos[seq] = {"objects": {"1": {"frames": []}}}
    if request.param:
        with open(root / "train" / "meta.json", "w") as fp:
            json.dump({"videos": videos}, fp)
    return str(root)


def assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_adapter_equals_jax(ytvos_root):
    want, got = JaxYTVOS(ytvos_root), YTVOSDataset(ytvos_root)
    assert got.sequences() == want.sequences() == ["vid_a", "vid_b"]
    for seq in want.sequences():
        assert_same(got.images(seq), want.images(seq))
        assert_same(got.gt_masks(seq), want.gt_masks(seq))
        assert got.num_objects(seq) == want.num_objects(seq)
        assert got.num_frames(seq) == len(want.gt_masks(seq))
        assert_same(got.frames_uint8(seq, [2, 0, 2]),
                    np.stack([np.asarray(Image.open(os.path.join(
                        ytvos_root, "train", "JPEGImages", seq,
                        f"{5 * i:05d}.jpg"))) for i in (2, 0, 2)]))
        assert_same(got.gt_masks_at(seq, [1, 1]), want.gt_masks(seq)[[1, 1]])


@pytest.mark.parametrize("clip_len", [3, 5])
def test_sampler_over_ytvos_equals_jax(ytvos_root, clip_len):
    """16 seeds of triplets (clip_len 3) and of padded 5-frame clips."""
    want_ds = JaxTrain(cfg=jax_tiny(), adapter=JaxYTVOS(ytvos_root),
                       clip_len=clip_len)
    got_ds = DavisTrainDataset(cfg=tiny_test_config(),
                               adapter=YTVOSDataset(ytvos_root),
                               clip_len=clip_len)
    for seed in range(16):
        want = want_ds.sample_clip(np.random.default_rng(seed))
        got = got_ds.sample_clip(np.random.default_rng(seed))
        for key in want:
            assert_same(got[key], want[key])


def test_written_tree_equals_jax(tmp_path):
    """The port's tree writer (numpy JPEGs, the port's PNGs, meta.json
    with each object's frames): adapters and sampler equal JAX's."""
    from _torch_davis_tree import write_ytvos_tree

    root = str(tmp_path / "yt")
    written = write_ytvos_tree(root, (72, 128), [("v1", 5, 2, 0),
                                                 ("v2", 4, 3, 1)])
    want, got = JaxYTVOS(root), YTVOSDataset(root)
    assert got.sequences() == ["v1", "v2"]
    for seq, (_, gt) in written.items():
        assert_same(got.images(seq), want.images(seq))
        np.testing.assert_array_equal(got.gt_masks(seq), gt)
        assert got.num_objects(seq) == want.num_objects(seq) == gt.max()
    want_ds = JaxTrain(cfg=jax_tiny(), adapter=want, emit_uint8=True)
    got_ds = DavisTrainDataset(cfg=tiny_test_config(), adapter=got,
                               emit_uint8=True)
    for _ in range(3):
        b_want, b_got = want_ds.batch(2), got_ds.batch(2)
        for key in b_want:
            assert_same(b_got[key], b_want[key])


def test_progressive_jpeg_raises_with_its_path(tmp_path):
    """The port's decoder is baseline only: a progressive frame raises,
    naming the file, instead of decoding wrongly."""
    root = tmp_path / "yt"
    for kind in ("JPEGImages", "Annotations"):
        (root / "train" / kind / "vid").mkdir(parents=True)
    img = (np.random.default_rng(0).random((32, 48, 3)) * 255).astype(
        np.uint8)
    path = root / "train" / "JPEGImages" / "vid" / "00000.jpg"
    Image.fromarray(img).save(path, progressive=True)
    with pytest.raises(ValueError, match="00000.jpg"):
        YTVOSDataset(str(root)).images("vid")
