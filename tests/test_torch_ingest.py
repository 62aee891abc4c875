"""Frame ingest in the PyTorch port vs the JAX package, on the CPU.

The host-side RGB -> YUV 4:2:0 transform is integer arithmetic and must be
bit-equal. The device-side inverse and the normalizations are the same f32
operations in the same order, held to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu.data.davis import normalize_image
from cvpr2020_manet_tpu.engine import propagate_batch as jpb
from cvpr2020_manet_tpu.utils import ingest as jing
from cvpr2020_manet_tpu_torch.engine.propagate_batch import preprocess_frames
from cvpr2020_manet_tpu_torch.utils.ingest import (
    preprocess_yuv420, rgb_to_yuv420_host, yuv420_to_rgb)

TOL = dict(rtol=1e-5, atol=1e-5)


def test_rgb_to_yuv420_bit_equal():
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (2, 3, 8, 12, 3), dtype=np.uint8)
    y, uv = rgb_to_yuv420_host(frames)
    jy, juv = jing.rgb_to_yuv420_host(frames)
    assert y.shape == (2, 3, 8, 12) and uv.shape == (2, 3, 4, 6, 2)
    assert y.dtype == uv.dtype == np.uint8
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(uv, juv)
    with pytest.raises(ValueError):
        rgb_to_yuv420_host(np.zeros((1, 5, 8, 3), np.uint8))


def test_yuv420_inverse_and_normalizations_match_jax():
    rng = np.random.default_rng(1)
    y = rng.integers(0, 256, (3, 8, 12), dtype=np.uint8)
    uv = rng.integers(0, 256, (3, 4, 6, 2), dtype=np.uint8)
    got = yuv420_to_rgb(torch.from_numpy(y), torch.from_numpy(uv))
    want = np.asarray(jing.yuv420_to_rgb(jnp.asarray(y), jnp.asarray(uv)))
    assert got.dtype == torch.float32 and got.shape == (3, 8, 12, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        preprocess_yuv420(torch.from_numpy(y), torch.from_numpy(uv)).numpy(),
        normalize_image(want / 255.0), **TOL)

    u8 = rng.integers(0, 256, (2, 4, 4, 3), dtype=np.uint8)
    got = preprocess_frames(torch.from_numpy(u8))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jpb.preprocess_frames(jnp.asarray(u8))), **TOL)
    np.testing.assert_allclose(
        got.numpy(), normalize_image(u8.astype(np.float32) / 255.0), **TOL)


def test_yuv420_roundtrip_bounds():
    """The bounds of the JAX package's own round-trip test: flat 2x2 blocks
    come back within the fixed-point rounding, smooth content within a few
    steps."""
    rng = np.random.default_rng(0)
    blocks = rng.integers(0, 256, (2, 4, 6, 3), dtype=np.uint8)
    flat = np.repeat(np.repeat(blocks, 2, axis=1), 2, axis=2)
    y, uv = rgb_to_yuv420_host(flat)
    back = yuv420_to_rgb(torch.from_numpy(y), torch.from_numpy(uv)).numpy()
    assert np.abs(back - flat.astype(np.float32)).max() <= 3.0

    gy, gx = np.mgrid[0:16, 0:16].astype(np.float32)
    img = (64 + np.stack([4 * gy, 2 * gx, 120 - 2 * (gx + gy)],
                         axis=-1)).astype(np.uint8)[None]
    y, uv = rgb_to_yuv420_host(img)
    back = yuv420_to_rgb(torch.from_numpy(y), torch.from_numpy(uv)).numpy()
    assert np.abs(back - img.astype(np.float32)).max() <= 6.0
    assert np.abs(back - img.astype(np.float32)).mean() <= 2.0
