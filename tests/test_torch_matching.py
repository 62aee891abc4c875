"""Matching in the PyTorch port vs the JAX package, on the CPU.

The port's bucketing (`prepare_ref`) must equal the JAX one exactly; its
plain global- and local-matching versions (what the CUDA kernels are held
against on the card) must agree with the JAX Pallas kernels run in
interpret mode and with both packages' plain oracles to 1e-5 (f32; only
the summation order differs). The argmin versions must name the same
winners, and the argmin-routed Functions of the training path must give
JAX's forward and gradients (to rtol 1e-4 / atol 1e-5: the gradients are
sums of products taken in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu.ops import local_matching_pallas as jlmp
from cvpr2020_manet_tpu.ops import matching as jm
from cvpr2020_manet_tpu.ops import matching_pallas as jmp
from cvpr2020_manet_tpu.ops.local_matching_pallas import local_matching_pallas
from cvpr2020_manet_tpu_torch.ops import matching as tm
from cvpr2020_manet_tpu_torch.ops.global_matching_cuda import (
    global_matching_cuda, global_matching_prepared,
    global_matching_prepared_argmin, prepare_ref)
from cvpr2020_manet_tpu_torch.ops.local_matching_cuda import (
    local_matching_argmin, local_matching_cuda)
from cvpr2020_manet_tpu_torch.ops.trainable import (
    GlobalMatchingTrainable, LocalMatchingTrainable)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These shapes are tiny: one intra-op thread is faster than many, and
    it keeps the parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# --------------------------------------------------------------------------
# argmin matching and the argmin-routed trainable Functions (training path)

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def jax_interpret(monkeypatch):
    """The JAX trainable matchings call their argmin Pallas kernels, which
    run here in interpret mode."""
    for mod, name in ((jmp, "global_matching_prepared_argmin"),
                      (jlmp, "local_matching_pallas_argmin")):
        monkeypatch.setattr(mod, name, functools.partial(
            getattr(mod, name), interpret=True))


def _noisy_copies(rng, n_ref, n_query, c):
    """Reference rows and queries that are noisy copies of some of them:
    continuous values (no ties), nearest distances off saturation."""
    k = (0.3 * rng.normal(size=(n_ref, c))).astype(np.float32)
    q = (k[rng.integers(0, n_ref, size=n_query)]
         + 0.05 * rng.normal(size=(n_query, c))).astype(np.float32)
    return q, k


@pytest.mark.parametrize("nq,nk,c,o,empty", [
    (300, 700, 20, 3, True),       # ragged, an object without pixels
    (257, 1025, 128, 9, False),    # past block boundaries, training O
])
def test_global_argmin_plain_vs_jax(nq, nk, c, o, empty):
    """Distances to 1e-5 and winners (bucketed rows) exactly, -1 for the
    object without pixels."""
    rng = np.random.default_rng(6)
    q, k = _noisy_copies(rng, nk, nq, c)
    onehot = np.eye(o, dtype=np.float32)[
        rng.integers(0, o - 1 if empty else o, size=nk)]
    want, want_idx = jmp.global_matching_prepared_argmin(
        _j(q), jmp.prepare_ref(_j(k), _j(onehot)), interpret=True)
    got, got_idx = global_matching_prepared_argmin(
        _t(q), prepare_ref(_t(k), _t(onehot)))
    assert got_idx.dtype == torch.int32 and got_idx.shape == (nq, o)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    if empty:
        assert (got_idx[:, o - 1] == -1).all()
        assert (got[:, o - 1] == 1.0).all()


def _has_key_in_window(oh: np.ndarray, window: int) -> np.ndarray:
    """(H, W, O): whether the object has a pixel within the window."""
    x = torch.from_numpy(oh).permute(2, 0, 1)[None]
    return (torch.nn.functional.max_pool2d(
        x, 2 * window + 1, stride=1, padding=window)[0] > 0).permute(
            1, 2, 0).numpy()


@pytest.mark.parametrize("h,w,c,o,window", [
    (9, 13, 20, 4, 2),        # width not a multiple of 8
    (10, 11, 16, 3, 3),
])
def test_local_argmin_plain_vs_jax(h, w, c, o, window):
    """Distances to 1e-5; winners (flat index into the previous frame)
    exactly wherever the object has a pixel in the window. Elsewhere the
    output saturates at 1.0 and both versions may name any key."""
    rng = np.random.default_rng(7)
    k = (0.3 * rng.normal(size=(h, w, c))).astype(np.float32)
    q = (np.roll(k, (1, -1), axis=(0, 1))
         + 0.05 * rng.normal(size=(h, w, c))).astype(np.float32)
    labels = rng.integers(0, o - 1, size=(h, w))       # object o-1 is empty
    labels[:h // 2, :w // 2] = 0     # object 1 is out of reach of some pixels
    oh = np.eye(o, dtype=np.float32)[labels]
    want, want_idx = jlmp.local_matching_pallas_argmin(
        _j(q), _j(k), _j(oh), window=window, interpret=True)
    got, got_idx = local_matching_argmin(_t(q), _t(k), _t(oh), window)
    assert got_idx.dtype == torch.int32 and got_idx.shape == (h, w, o)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    reach = _has_key_in_window(oh, window)
    assert reach[..., 1].mean() < 1.0 and not reach[..., o - 1].any()
    np.testing.assert_array_equal(got_idx.numpy()[reach],
                                  np.asarray(want_idx)[reach])
    assert (got.numpy()[~reach] == 1.0).all()


@pytest.mark.parametrize("empty", [False, True], ids=["live", "empty"])
def test_global_trainable_vs_jax(jax_interpret, empty):
    """Forward and the query / reference gradients against JAX's
    `global_matching_trainable` and against jax.grad through the plain
    oracle's hard min (tie-free inputs: the routed and the split gradient
    agree). With the upstream gradient only on an object without pixels,
    every gradient is 0."""
    rng = np.random.default_rng(8)
    nq, nk, c, o = 40, 90, 8, 3
    q, k = _noisy_copies(rng, nk, nq, c)
    onehot = np.eye(o, dtype=np.float32)[rng.integers(0, o - 1, size=nk)]
    g = rng.normal(size=(nq, o)).astype(np.float32)
    if empty:
        g[:, :o - 1] = 0.0

    def jloss(fn):
        return lambda q, k: jnp.sum(fn(q, k, _j(onehot)) * _j(g))

    want_out = np.asarray(jmp.global_matching_trainable(
        _j(q), _j(k), _j(onehot)))
    want_routed = jax.grad(jloss(jmp.global_matching_trainable),
                           argnums=(0, 1))(_j(q), _j(k))
    want_oracle = jax.grad(jloss(jm.global_matching),
                           argnums=(0, 1))(_j(q), _j(k))
    qq, kk = _t(q).requires_grad_(), _t(k).requires_grad_()
    out = GlobalMatchingTrainable.apply(qq, kk, _t(onehot))
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL)
    for got, routed, oracle in zip((qq.grad, kk.grad), want_routed,
                                   want_oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(routed),
                                   **GRAD_TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(oracle),
                                   **GRAD_TOL)
        if empty:
            assert not got.any()
        else:
            assert got.abs().max() > 1e-3


@pytest.mark.parametrize("empty", [False, True], ids=["live", "empty"])
def test_local_trainable_vs_jax(jax_interpret, empty):
    """As the global case, for `local_matching_trainable` (window 2). In the
    empty case the embeddings are large enough that keys of other objects
    beat the 1e8 sentinel in f32 and win for the pixel-less object: its
    gradient must still be 0 (the `on_obj` gate)."""
    rng = np.random.default_rng(9)
    h, w, c, o, window = 6, 9, 8, 3, 2
    scale = 1.0 if empty else 0.3
    k = (scale * rng.normal(size=(h, w, c))).astype(np.float32)
    q = (np.roll(k, 1, axis=1)
         + 0.05 * rng.normal(size=(h, w, c))).astype(np.float32)
    oh = np.eye(o, dtype=np.float32)[rng.integers(0, o - 1, size=(h, w))]
    g = rng.normal(size=(h, w, o)).astype(np.float32)
    if empty:
        g[..., :o - 1] = 0.0
        winners = local_matching_argmin(_t(q), _t(k), _t(oh), window)[1]
        assert (winners[..., o - 1] >= 0).any()

    def jloss(fn):
        return lambda q, k: jnp.sum(fn(q, k, _j(oh)) * _j(g))

    trainable = lambda q, k, oh: jlmp.local_matching_trainable(q, k, oh,
                                                               window)
    oracle = lambda q, k, oh: jm.local_matching(q, k, oh, window=window)
    want_out = np.asarray(trainable(_j(q), _j(k), _j(oh)))
    want_routed = jax.grad(jloss(trainable), argnums=(0, 1))(_j(q), _j(k))
    want_oracle = jax.grad(jloss(oracle), argnums=(0, 1))(_j(q), _j(k))
    qq, kk = _t(q).requires_grad_(), _t(k).requires_grad_()
    out = LocalMatchingTrainable.apply(qq, kk, _t(oh), window)
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL)
    for got, routed, oracle_g in zip((qq.grad, kk.grad), want_routed,
                                     want_oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(routed),
                                   **GRAD_TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(oracle_g),
                                   **GRAD_TOL)
        if empty:
            assert not got.any()
        else:
            assert got.abs().max() > 1e-3


def test_trainable_finite_differences_f64():
    """The routed backward against central differences of the plain
    forward, everything in f64 (tie-free inputs, distances below the
    normalization's clamp)."""
    rng = np.random.default_rng(10)
    q, k = (torch.tensor(a, dtype=torch.float64)
            for a in _noisy_copies(rng, 30, 12, 4))
    gate = torch.tensor(np.eye(3)[rng.integers(0, 3, size=30)])
    assert torch.autograd.gradcheck(
        lambda q, k: GlobalMatchingTrainable.apply(q, k, gate),
        (q.requires_grad_(), k.requires_grad_()), eps=1e-6, atol=1e-6)
    kl = torch.tensor(0.3 * rng.normal(size=(5, 6, 4)))
    ql = torch.roll(kl, 1, dims=0) + 0.05 * torch.tensor(
        rng.normal(size=(5, 6, 4)))
    oh = torch.tensor(np.eye(3)[rng.integers(0, 3, size=(5, 6))])
    assert torch.autograd.gradcheck(
        lambda q, k: LocalMatchingTrainable.apply(q, k, oh, 2),
        (ql.requires_grad_(), kl.requires_grad_()), eps=1e-6, atol=1e-6)
