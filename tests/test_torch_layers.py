"""Resize and GroupNorm of the PyTorch port vs the JAX package (CPU).

The resize fast paths do the same f32 arithmetic in the same order as the
JAX ones, so they agree to 1e-6; the general resize (JAX's
`jax.image.resize` fallback) builds the same weight matrices and contracts
them in the same order, so it agrees to 1e-6 in f32 and to one ulp in
bf16. GroupNorm agrees to 1e-5 (Flax computes the variance as
E[x^2] - E[x]^2, PyTorch directly).
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


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place at each value of x (8-bit mantissa)."""
    return np.spacing(np.abs(x).astype(np.float32)) * 2.0 ** 16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["nhwc", "hwc"])
@pytest.mark.parametrize("src,dst", [
    ((8, 12), (2, 3)),       # /4 (the 8x12 -> 2x3 mask readback)
    ((12, 12), (3, 3)),      # /4
    ((6, 6), (9, 9)),        # non-integer up-factor
    ((10, 10), (3, 3)),      # non-integer down-factor
    ((8, 10), (4, 15)),      # /2 rows (fast), x1.5 columns (not)
    ((6, 10), (9, 20)),      # x1.5 rows (not), x2 columns (fast)
    ((5, 5), (13, 2)),       # W contracted first in JAX's einsum path
])
def test_resize_bilinear_general_matches_jax(src, dst, layout, dtype):
    """Factors off the fast paths take the general resize, as JAX's
    `jax.image.resize` fallback: in x's own dtype over both axes. f32 to
    1e-6; bf16 to one bf16 ulp of the JAX value."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, *src, 5)).astype(np.float32)
    if layout == "hwc":
        x = x[0]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jl.resize_bilinear(jnp.asarray(x, jdt), dst)
                      .astype(jnp.float32))
    got = tl.resize_bilinear(torch.from_numpy(x).to(tdt), dst)
    assert got.dtype == tdt
    got = got.float().numpy()
    assert got.shape == want.shape
    tol = 1e-6 if dtype == "float32" else _bf16_ulp(want)
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


@pytest.mark.parametrize("src,dst", [((8, 12), (4, 6)), ((4, 6), (16, 24)),
                                     ((12, 12), (4, 12))])
def test_resize_nearest_matches_jax(src, dst):
    rng = np.random.default_rng(1)
    x = rng.integers(0, 4, size=(*src, 3)).astype(np.float32)
    want = np.asarray(jl.resize_nearest(jnp.asarray(x), dst))
    got = tl.resize_nearest(torch.from_numpy(x), dst).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", ["nhwc", "hwc"])
@pytest.mark.parametrize("src,dst", [((7, 7), (3, 3)), ((3, 3), (7, 7)),
                                     ((8, 6), (4, 9)), ((12, 5), (5, 7))])
def test_resize_nearest_general_matches_jax(src, dst, layout):
    """Non-integer factors (on one axis or both) take the general nearest
    resize of `jax.image.resize`: exactly equal."""
    rng = np.random.default_rng(4)
    x = rng.integers(0, 4, size=(2, *src, 3)).astype(np.float32)
    if layout == "hwc":
        x = x[0]
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
