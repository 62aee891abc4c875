"""Resize and GroupNorm of the PyTorch port vs the JAX package (CPU, f32).

The resize fast paths do the same f32 arithmetic in the same order as the
JAX ones, so they agree to 1e-6; GroupNorm agrees to 1e-5 (Flax computes
the variance as E[x^2] - E[x]^2, PyTorch directly).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from cvpr2020_manet_tpu.models import layers as jl
from cvpr2020_manet_tpu_torch.models import layers as tl


@pytest.mark.parametrize("src,dst", [
    ((6, 10), (24, 40)),     # x4 up (decoder ASPP upsample, masks)
    ((6, 10), (12, 20)),     # x2 up (local-matching map back to stride 4)
    ((12, 20), (6, 10)),     # /2 down, antialiased, with renormalized edges
    ((8, 10), (4, 40)),      # mixed: /2 rows, x4 columns
])
def test_resize_bilinear_matches_jax(src, dst):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, *src, 5)).astype(np.float32)
    want = np.asarray(jl.resize_bilinear(jnp.asarray(x), dst))
    got = tl.resize_bilinear(torch.from_numpy(x), dst).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # HWC input and the NCHW axis form give the same numbers
    np.testing.assert_allclose(
        tl.resize_bilinear(torch.from_numpy(x[0]), dst).numpy(), want[0],
        rtol=1e-6, atol=1e-6)
    nchw = tl.resize_bilinear_axes(
        torch.from_numpy(x).permute(0, 3, 1, 2), dst, 2, 3)
    np.testing.assert_allclose(nchw.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-6, atol=1e-6)


def test_resize_bilinear_unported_factor_raises():
    with pytest.raises(NotImplementedError):
        tl.resize_bilinear(torch.zeros(1, 6, 10, 2), (9, 10))


@pytest.mark.parametrize("src,dst", [((8, 12), (4, 6)), ((4, 6), (16, 24)),
                                     ((12, 12), (4, 12))])
def test_resize_nearest_matches_jax(src, dst):
    rng = np.random.default_rng(1)
    x = rng.integers(0, 4, size=(*src, 3)).astype(np.float32)
    want = np.asarray(jl.resize_nearest(jnp.asarray(x), dst))
    got = tl.resize_nearest(torch.from_numpy(x), dst).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("groups", [1, 4])
def test_group_norm_matches_flax(groups):
    """eps 1e-6 as Flax (PyTorch's default 1e-5 would differ visibly on a
    low-variance input)."""
    rng = np.random.default_rng(2)
    c = 8
    x = (1e-3 * rng.normal(size=(2, 5, 7, c))).astype(np.float32)
    scale = rng.normal(size=(c,)).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    gn = fnn.GroupNorm(num_groups=groups)
    want = np.asarray(gn.apply({"params": {"scale": scale, "bias": bias}},
                               jnp.asarray(x)))
    m = tl.GroupNorm(groups, c)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
    got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert m.eps == 1e-6
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
