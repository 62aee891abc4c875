"""The port's uint8 resize (`native/resize.cpp`) against PIL 12.1's
`Image.resize`, bit for bit: BILINEAR on RGB images, NEAREST on mode-L
label maps, on hypothesis-drawn sizes (up- and down-scaling, one axis kept,
the sampler's crop floor), and a window of the result against the same
crop of the full resize."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from cvpr2020_manet_tpu_torch.native.image import (
    resize_bilinear, resize_nearest)

SIZES = st.integers(1, 96)
SETTINGS = settings(max_examples=60, deadline=None, derandomize=True,
                    database=None)


def pil_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    return np.asarray(Image.fromarray(img).resize((out_w, out_h),
                                                  Image.BILINEAR))


def pil_nearest(lab: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    return np.asarray(Image.fromarray(lab).resize((out_w, out_h),
                                                  Image.NEAREST))


def check(h, w, out_h, out_w, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    lab = rng.integers(0, 5, (h, w), dtype=np.uint8)
    np.testing.assert_array_equal(resize_bilinear(img, (out_h, out_w)),
                                  pil_bilinear(img, out_h, out_w))
    np.testing.assert_array_equal(resize_nearest(lab, (out_h, out_w)),
                                  pil_nearest(lab, out_h, out_w))


@SETTINGS
@given(h=SIZES, w=SIZES, out_h=SIZES, out_w=SIZES, seed=st.integers(0, 99))
def test_resize_equals_pil(h, w, out_h, out_w, seed):
    check(h, w, out_h, out_w, seed)


@SETTINGS
@given(h=SIZES, w=SIZES, out=SIZES, axis=st.sampled_from([0, 1]),
       seed=st.integers(0, 99))
def test_resize_one_axis_kept_equals_pil(h, w, out, axis, seed):
    """The pass of a kept axis is skipped, as in PIL."""
    check(h, out, out, w, seed) if axis else check(h, w, h, out, seed)


@SETTINGS
@given(scale=st.floats(0.75, 1.25), crop=st.integers(8, 56),
       seed=st.integers(0, 99))
def test_sampler_shapes_equal_pil(scale, crop, seed):
    """The sampler's draw on a 48 x 85 frame (480p at a tenth): the size
    `max(crop, int(size * scale))` and a window of the crop's size at a
    random offset, which must equal that crop of PIL's full resize."""
    h, w = 48, 85
    sh, sw = max(crop, int(h * scale)), max(crop, int(w * scale))
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    lab = rng.integers(0, 5, (2, h, w), dtype=np.uint8)
    y0, x0 = rng.integers(0, sh - crop + 1), rng.integers(0, sw - crop + 1)
    window = (y0, x0, crop, crop)
    crop_of = np.s_[y0:y0 + crop, x0:x0 + crop]
    got = resize_bilinear(img, (sh, sw), window)
    got_lab = resize_nearest(lab, (sh, sw), window)
    for f in range(2):
        np.testing.assert_array_equal(got[f], pil_bilinear(img[f], sh, sw)
                                      [crop_of])
        np.testing.assert_array_equal(got_lab[f], pil_nearest(lab[f], sh, sw)
                                      [crop_of])


@pytest.mark.parametrize("out_h", [360, 416, 600])
def test_resize_at_480p_equals_pil(out_h):
    """A 480 x 854 frame to the sampler's extremes and its floor (416)."""
    out_w = max(416, int(854 * out_h / 480))
    check(480, 854, out_h, out_w, out_h)


def test_resize_rejects_bad_inputs():
    img = np.zeros((4, 6, 3), np.uint8)
    with pytest.raises(TypeError):
        resize_bilinear(img.astype(np.float32), (8, 8))
    with pytest.raises(ValueError, match="window"):
        resize_bilinear(img, (8, 8), (4, 0, 5, 8))
    with pytest.raises(ValueError, match="H, W, 3"):
        resize_bilinear(img[..., :2], (8, 8))
