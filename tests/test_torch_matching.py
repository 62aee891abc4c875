"""Matching in the PyTorch port vs the JAX package, on the CPU.

The port's bucketing (`prepare_ref`) must equal the JAX one exactly; its
plain global- and local-matching versions (what the CUDA kernels are held
against on the card) must agree with the JAX Pallas kernels run in
interpret mode and with both packages' plain oracles to 1e-5 (f32; only
the summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu.ops import matching as jm
from cvpr2020_manet_tpu.ops import matching_pallas as jmp
from cvpr2020_manet_tpu.ops.local_matching_pallas import local_matching_pallas
from cvpr2020_manet_tpu_torch.ops import matching as tm
from cvpr2020_manet_tpu_torch.ops.global_matching_cuda import (
    global_matching_cuda, global_matching_prepared, prepare_ref)
from cvpr2020_manet_tpu_torch.ops.local_matching_cuda import (
    local_matching_cuda)

TOL = dict(rtol=1e-5, atol=1e-5)


def _ref_inputs(seed, nk, c, o, with_valid, empty_obj):
    rng = np.random.default_rng(seed)
    k = (0.3 * rng.normal(size=(nk, c))).astype(np.float32)
    labels = rng.integers(0, o, size=nk)
    if empty_obj:
        labels[labels == o - 1] = 0          # object o-1 has no pixels
    onehot = np.eye(o, dtype=np.float32)[labels]
    valid = (rng.random(nk) > 0.3).astype(np.float32) if with_valid else None
    return k, onehot, valid


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("with_valid,empty_obj,block_k", [
    (False, False, 512), (True, False, 128), (True, True, 128),
    (False, True, 64)])
def test_prepare_ref_equals_jax(with_valid, empty_obj, block_k):
    """src_idx and block_obj exactly; neg2pixels and sqnorm to 1e-6."""
    k, onehot, valid = _ref_inputs(1, 700, 20, 3, with_valid, empty_obj)
    want = jmp.prepare_ref(_j(k), _j(onehot), _j(valid), block_k=block_k)
    got = prepare_ref(_t(k), _t(onehot), _t(valid), block_k=block_k)
    np.testing.assert_array_equal(got.src_idx.numpy(),
                                  np.asarray(want.src_idx))
    np.testing.assert_array_equal(got.block_obj.numpy(),
                                  np.asarray(want.block_obj))
    np.testing.assert_allclose(got.neg2pixels.numpy(),
                               np.asarray(want.neg2pixels), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sqnorm.numpy(), np.asarray(want.sqnorm),
                               rtol=1e-6, atol=1e-6)
    assert got.num_objects == want.num_objects
    assert got.src_idx.dtype == got.block_obj.dtype == torch.int32


@pytest.mark.parametrize("nq,nk,c,o,with_valid", [
    (300, 700, 20, 3, True),       # ragged everything
    (64, 64, 8, 2, False),         # tiny
    (257, 1025, 128, 9, True),     # past block boundaries, full C
])
def test_global_matching_plain_vs_jax(nq, nk, c, o, with_valid):
    rng = np.random.default_rng(2)
    q = (0.3 * rng.normal(size=(nq, c))).astype(np.float32)
    k, onehot, valid = _ref_inputs(3, nk, c, o, with_valid, False)
    jb = jmp.prepare_ref(_j(k), _j(onehot), _j(valid))
    want_kernel = np.asarray(jmp.global_matching_prepared(
        _j(q), jb, interpret=True))
    want_oracle = np.asarray(jm.global_matching(_j(q), _j(k), _j(onehot),
                                                _j(valid)))
    got = global_matching_prepared(_t(q), prepare_ref(_t(k), _t(onehot),
                                                      _t(valid))).numpy()
    assert got.shape == (nq, o) and got.dtype == np.float32
    np.testing.assert_allclose(got, want_kernel, **TOL)
    np.testing.assert_allclose(got, want_oracle, **TOL)
    # the port's own oracle agrees with the JAX oracle
    np.testing.assert_allclose(
        tm.global_matching(_t(q), _t(k), _t(onehot), _t(valid)).numpy(),
        want_oracle, **TOL)


def test_global_matching_empty_object_saturates():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(32, 8)).astype(np.float32)
    k = rng.normal(size=(64, 8)).astype(np.float32)
    onehot = np.zeros((64, 3), np.float32)
    onehot[:, 0] = 1.0
    got = global_matching_cuda(_t(q), _t(k), _t(onehot)).numpy()
    want = np.asarray(jmp.global_matching_pallas(
        _j(q), _j(k), _j(onehot), interpret=True))
    assert got[:, 1].min() == 1.0 and got[:, 2].min() == 1.0
    assert got[:, 0].max() < 1.0
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("h,w,c,o,window", [
    (9, 13, 20, 3, 2),        # width not a multiple of 8
    (10, 11, 16, 2, 3),
    (6, 7, 130, 4, 3),        # C past one 128-channel chunk
])
def test_local_matching_plain_vs_jax(h, w, c, o, window):
    rng = np.random.default_rng(5)
    q = (0.3 * rng.normal(size=(h, w, c))).astype(np.float32)
    k = (0.3 * rng.normal(size=(h, w, c))).astype(np.float32)
    oh = np.eye(o, dtype=np.float32)[rng.integers(0, o, size=(h, w))]
    want_kernel = np.asarray(local_matching_pallas(
        _j(q), _j(k), _j(oh), window=window, interpret=True))
    want_oracle = np.asarray(jm.local_matching(_j(q), _j(k), _j(oh),
                                               window=window))
    got = local_matching_cuda(_t(q), _t(k), _t(oh), window=window).numpy()
    assert got.shape == (h, w, o) and got.dtype == np.float32
    np.testing.assert_allclose(got, want_kernel, **TOL)
    np.testing.assert_allclose(got, want_oracle, **TOL)
    np.testing.assert_allclose(
        tm.local_matching(_t(q), _t(k), _t(oh), window=window).numpy(),
        want_oracle, **TOL)
