"""Int8 global matching in the PyTorch port vs the JAX package, on the CPU.

The quantizers and the int8 bucketed layout are plain tensor code in both
packages and must be bit-equal: int8 values, scales, norms, `src_idx` and
`block_obj`, including values that land exactly halfway between two steps
(both round half to even). The port's plain version of the int8 kernel
(what the CUDA kernel is held against on the card) must match JAX's
interpret-mode Pallas kernel to 1e-5: both form the integer cross terms
exactly and differ at most in how the f32 epilogue is fused.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu.ops import matching as jm
from cvpr2020_manet_tpu.ops import matching_pallas as jmp
from cvpr2020_manet_tpu_torch.config import tiny_test_config
from cvpr2020_manet_tpu_torch.models import MANet
from cvpr2020_manet_tpu_torch.ops import matching as tm
from cvpr2020_manet_tpu_torch.ops.global_matching_cuda import (
    global_matching_cuda, global_matching_int8_cuda,
    global_matching_prepared_int8, prepare_ref_int8, quantize_rows_int8,
    quantize_symmetric_int8)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread keeps the parallel test workers
    from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _halfway_rows(rng, n, c):
    """Rows whose largest magnitude is 127, so the scale is exactly 1 and
    x / scale = x: the halves (0.5, 1.5, 2.5, -0.5, -3.5) are exact ties."""
    x = rng.integers(-126, 127, size=(n, c)).astype(np.float32)
    x[:, 0] = 127.0
    x[:, 1:6] = [0.5, 1.5, 2.5, -0.5, -3.5]
    return x


def test_quantize_rows_bit_equal():
    rng = np.random.default_rng(0)
    x = np.concatenate([_halfway_rows(rng, 4, 20),
                        (0.3 * rng.normal(size=(50, 20))).astype(np.float32),
                        np.zeros((1, 20), np.float32)])     # the 1e-6 floor
    jq, js = jmp.quantize_rows_int8(jnp.asarray(x))
    tq, ts = quantize_rows_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert list(tq[0, 1:6]) == [0, 2, 2, 0, -4]             # half to even


@pytest.mark.parametrize("masked", [False, True])
def test_quantize_symmetric_bit_equal(masked):
    rng = np.random.default_rng(1)
    x = np.concatenate([_halfway_rows(rng, 3, 16),
                        rng.normal(size=(40, 16)).astype(np.float32)])
    x[-1] = 900.0                       # an outlier row, outside the mask
    mask = np.ones(len(x), bool)
    mask[-1] = False
    row_mask = mask if masked else None
    jq, js = jmp.quantize_symmetric_int8(
        jnp.asarray(x), None if row_mask is None else jnp.asarray(row_mask))
    tq, ts = quantize_symmetric_int8(
        torch.from_numpy(x),
        None if row_mask is None else torch.from_numpy(row_mask))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if masked:
        assert float(ts) == 127.0 / 127.0         # the outlier left out
        assert (tq[-1] == 127).all()              # and saturated


@pytest.mark.parametrize("nk,c,o,with_valid,empty", [
    (700, 20, 3, True, False),
    (1025, 128, 9, False, True),
    (300, 16, 4, True, True),
])
def test_prepare_ref_int8_bit_equal(nk, c, o, with_valid, empty):
    rng = np.random.default_rng(2)
    k = (0.3 * rng.normal(size=(nk, c))).astype(np.float32)
    labels = rng.integers(0, o - 1 if empty else o, size=nk)
    onehot = np.eye(o, dtype=np.float32)[labels]
    onehot[rng.random(nk) < 0.1] = 0.0           # unlabelled pixels
    valid = (rng.random(nk) > 0.3).astype(np.float32) if with_valid else None
    jb = jmp.prepare_ref_int8(jnp.asarray(k), jnp.asarray(onehot),
                              None if valid is None else jnp.asarray(valid))
    tb = prepare_ref_int8(torch.from_numpy(k), torch.from_numpy(onehot),
                          None if valid is None else torch.from_numpy(valid))
    for field in ("pixels", "sqnorm", "block_obj", "src_idx", "scale"):
        want = np.asarray(getattr(jb, field))
        got = getattr(tb, field).numpy()
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    assert tb.num_objects == jb.num_objects


@pytest.mark.parametrize("nq,nk,c,o", [(300, 700, 20, 3), (257, 1025, 128, 9)])
def test_plain_int8_matches_jax_kernel(nq, nk, c, o):
    rng = np.random.default_rng(3)
    q = (0.1 * rng.normal(size=(nq, c))).astype(np.float32)
    k = (0.1 * rng.normal(size=(nk, c))).astype(np.float32)
    onehot = np.eye(o, dtype=np.float32)[rng.integers(0, o, size=nk)]
    valid = (rng.random(nk) > 0.3).astype(np.float32)
    want = np.asarray(jmp.global_matching_pallas_int8(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(onehot),
        jnp.asarray(valid), interpret=True))
    got = global_matching_int8_cuda(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(onehot),
        torch.from_numpy(valid))
    assert got.shape == (nq, o) and got.dtype == torch.float32
    assert (want < 0.9).mean() > 0.05            # the check is not vacuous
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_int8_empty_object_saturates():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.normal(size=(32, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
    onehot = torch.zeros(64, 3)
    onehot[:, 0] = 1.0                           # objects 1 and 2: no pixels
    out = global_matching_int8_cuda(q, k, onehot)
    assert (out[:, 1:] == 1.0).all()
    assert (out[:, 0] < 1.0).all()


def test_int8_close_to_f32():
    """The quantization's cost in the normalized distances, against the
    port's f32 oracle (the bound of the JAX package's own test)."""
    rng = np.random.default_rng(5)
    nq, nk, c, o = 400, 900, 100, 4
    q = (0.3 * rng.normal(size=(nq, c))).astype(np.float32)
    k = (0.3 * rng.normal(size=(nk, c))).astype(np.float32)
    k[:200] = q[:200] + 0.01 * rng.normal(size=(200, c))   # near copies
    onehot = torch.from_numpy(
        np.eye(o, dtype=np.float32)[rng.integers(0, o, size=nk)])
    q, k = torch.from_numpy(q), torch.from_numpy(k)
    want = tm.global_matching(q, k, onehot)
    got = global_matching_int8_cuda(q, k, onehot)
    err = (got - want).abs()
    assert err.max() < 0.05 and err.mean() < 0.005


def test_model_int8_backend_switch():
    """`matching_backend="int8"` routes the model's global matching to the
    int8 path, training keeps full precision, other names are refused; a
    bf16 query meets an f32 memory in f32 on the default backend."""
    cfg = tiny_test_config().model
    rng = np.random.default_rng(6)
    q = torch.from_numpy((0.3 * rng.normal(size=(40, 16))).astype(np.float32))
    k = torch.from_numpy((0.3 * rng.normal(size=(90, 16))).astype(np.float32))
    onehot = torch.from_numpy(
        np.eye(3, dtype=np.float32)[rng.integers(0, 3, size=90)])
    model = MANet(cfg, device="cpu", matching_backend="int8")
    torch.testing.assert_close(model._global_matching(q, k, onehot, None),
                               global_matching_int8_cuda(q, k, onehot),
                               rtol=0, atol=0)
    model.trainable_matching = True
    torch.testing.assert_close(model._global_matching(q, k, onehot, None),
                               tm.global_matching(q, k, onehot), **TOL)
    with pytest.raises(ValueError):
        MANet(cfg, device="cpu", matching_backend="pallas_int8")
    want = np.asarray(jm.global_matching(
        jnp.asarray(q.numpy(), jnp.bfloat16), jnp.asarray(k.numpy()),
        jnp.asarray(onehot.numpy())))
    got = global_matching_cuda(q.to(torch.bfloat16), k, onehot)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the prepared wrapper takes any float query on the CPU as well
    b = prepare_ref_int8(k, onehot)
    torch.testing.assert_close(global_matching_prepared_int8(q.double(), b),
                               global_matching_prepared_int8(q, b),
                               rtol=0, atol=0)


@pytest.mark.parametrize("backend", ["auto", "int8"])
def test_model_prepared_matching_equals_drop_in(backend):
    """`MANet.prepare_ref` + `match_prepared` (what the engines call once
    per reference) equal the backend's drop-in bit for bit, and so does
    `propagate`'s own matching, a bf16 query against f32 memory too."""
    cfg = tiny_test_config().model
    rng = np.random.default_rng(7)
    q = torch.from_numpy((0.3 * rng.normal(size=(40, 16))).astype(np.float32))
    k = torch.from_numpy((0.3 * rng.normal(size=(90, 16))).astype(np.float32))
    onehot = torch.from_numpy(
        np.eye(3, dtype=np.float32)[rng.integers(0, 3, size=90)])
    drop_in = (global_matching_int8_cuda if backend == "int8"
               else global_matching_cuda)
    model = MANet(cfg, device="cpu", matching_backend=backend)
    want = drop_in(q, k, onehot)
    got = model.match_prepared(q, model.prepare_ref(k, onehot))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    qb = q.to(torch.bfloat16)
    torch.testing.assert_close(model._global_matching(qb, k, onehot, None),
                               drop_in(qb, k, onehot), rtol=0, atol=0)
