"""The port's DAVIS adapter and JPEG decoder against the JAX package's
(PIL) on the synthetic DAVIS tree: the same float frames bit for bit, the
same uint8 frames, label maps, object counts and scribbles. The decoder
(the port's own baseline decoder, native/jpeg.cpp) equals PIL on every
baseline layout PIL writes, and raises on progressive and grayscale
files, which it does not decode."""

import io

import numpy as np
import pytest
from PIL import Image

from cvpr2020_manet_tpu.data.davis import DavisEvalDataset as JaxDavis
from cvpr2020_manet_tpu_torch.data.davis import (
    IMAGENET_MEAN, IMAGENET_STD, DavisEvalDataset, normalize_image)
from cvpr2020_manet_tpu_torch.native.image import decode_jpeg, read_jpeg


def test_adapter_equals_jax(davis_root):
    for subset in ("val", "train"):
        ours = DavisEvalDataset(davis_root, subset=subset, scribble_sets=2)
        ref = JaxDavis(davis_root, subset=subset, scribble_sets=2)
        assert ours.sequences() == ref.sequences()
        for seq in ref.sequences():
            got, want = ours.images(seq), ref.images(seq)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(ours.images_uint8(seq),
                                          ref.images_uint8(seq))
            gt = ours.gt_masks(seq)
            assert gt.dtype == np.int32
            np.testing.assert_array_equal(gt, ref.gt_masks(seq))
            assert ours.num_objects(seq) == ref.num_objects(seq) == 2
            assert ours.num_scribble_sets(seq) == ref.num_scribble_sets(seq)
            for i in range(2):
                assert (ours.initial_scribbles(seq, i).to_json()
                        == ref.initial_scribbles(seq, i).to_json())


def test_normalize_constants_equal_jax():
    from cvpr2020_manet_tpu.data import davis as jd
    np.testing.assert_array_equal(IMAGENET_MEAN, jd.IMAGENET_MEAN)
    np.testing.assert_array_equal(IMAGENET_STD, jd.IMAGENET_STD)
    x = np.random.default_rng(0).random((2, 3, 4, 3), np.float32)
    np.testing.assert_array_equal(normalize_image(x), jd.normalize_image(x))


def _frame(h, w, kind, seed):
    if kind == "noise":
        return (np.random.default_rng(seed).random((h, w, 3))
                * 255).astype(np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    return np.stack([128 + 100 * np.sin(x / 17.0 + c) * np.cos(y / 23.0 - c)
                     for c in range(3)], -1).clip(0, 255).astype(np.uint8)


def _jpeg(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("hw", [(480, 854), (37, 51), (9, 17), (1, 1)])
@pytest.mark.parametrize("quality", [75, 95])
def test_decoder_equals_pil(hw, quality):
    """4:2:0 (PIL's default), 4:2:2 and 4:4:4, smooth and noisy content,
    the standard and optimized Huffman tables, and restart markers."""
    for kind in ("smooth", "noise"):
        img = _frame(*hw, kind, seed=quality)
        for extra in ({}, {"subsampling": 0}, {"subsampling": 1},
                      {"optimize": True}, {"restart_marker_blocks": 2}):
            if hw == (480, 854) and extra.get("optimize"):
                continue      # PIL cannot write this one into a buffer
            data = _jpeg(img, quality=quality, **extra)
            want = np.asarray(Image.open(io.BytesIO(data)))
            got = decode_jpeg(data)
            assert got.dtype == np.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=str(extra))


def test_read_jpeg_equals_pil_on_fixture(davis_root):
    import glob
    for f in sorted(glob.glob(f"{davis_root}/JPEGImages/480p/*/*.jpg")):
        np.testing.assert_array_equal(read_jpeg(f), np.asarray(Image.open(f)))


def test_decoder_raises_on_unsupported_files():
    img = _frame(24, 40, "smooth", 0)
    with pytest.raises(ValueError, match="progressive JPEG is not supported"):
        decode_jpeg(_jpeg(img, progressive=True))
    with pytest.raises(ValueError, match="grayscale JPEG is not supported"):
        decode_jpeg(_jpeg(img[..., 0]))
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x89PNG\r\n\x1a\n")
    with pytest.raises(ValueError, match="truncated"):
        data = _jpeg(img)
        decode_jpeg(data[:len(data) // 2])
