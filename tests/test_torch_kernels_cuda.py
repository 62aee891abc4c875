"""The CUDA kernels vs their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so these tests skip without a GPU. On a
machine with one (and no JAX) run them without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Both sides compute the same products exactly in f32 (bf16 inputs are
widened) and accumulate in f32 in another order, so they agree to 1e-5 on
the normalized distances at these input scales. TF32 is off for the plain
matmuls.
"""

import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu_torch.kernels import build
from cvpr2020_manet_tpu_torch.ops.global_matching_cuda import (
    global_matching_prepared, global_matching_prepared_plain, prepare_ref)
from cvpr2020_manet_tpu_torch.ops.local_matching_cuda import (
    local_matching_prepared, local_matching_prepared_plain, prepare_local)

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("nq,nk,c,o,dtype,empty", [
    (300, 700, 20, 3, torch.float32, False),     # ragged everything
    (257, 1025, 128, 9, torch.float32, False),   # past block boundaries
    (1000, 3000, 100, 4, torch.bfloat16, False),  # the model's dtype
    (257, 1025, 128, 9, torch.bfloat16, False),  # tensor cores, ragged
    (50, 200, 16, 2, torch.bfloat16, False),     # fewer queries than a block
    (64, 600, 128, 4, torch.bfloat16, True),     # an object with no pixels
])
def test_global_kernel_matches_plain(cuda, nq, nk, c, o, dtype, empty):
    rng = np.random.default_rng(0)
    # queries are noisy copies of reference rows, so nearest distances are
    # small and the normalized outputs do not all saturate at 1.0
    k_np = 0.3 * rng.normal(size=(nk, c))
    q_np = k_np[rng.integers(0, nk, size=nq)] + 0.02 * rng.normal(size=(nq, c))
    q = torch.tensor(q_np, dtype=dtype, device=cuda)
    k = torch.tensor(k_np, dtype=dtype, device=cuda)
    labels = rng.integers(0, o - 1 if empty else o, size=nk)
    onehot = torch.tensor(np.eye(o)[labels], dtype=torch.float32, device=cuda)
    valid = torch.tensor(rng.random(nk) > 0.2, device=cuda)
    b = prepare_ref(k, onehot, valid)
    before = build.LAUNCHES["global_matching"]
    got = global_matching_prepared(q, b)
    torch.cuda.synchronize()
    assert build.LAUNCHES["global_matching"] == before + 1
    want = global_matching_prepared_plain(q, b)
    assert got.shape == (nq, o) and got.dtype == torch.float32
    assert (want < 0.9).float().mean() > 0.05     # the check is not vacuous
    torch.testing.assert_close(got, want, **TOL)
    if empty:
        assert (got[:, o - 1] == 1.0).all()


@pytest.mark.parametrize("h,w,c,o,window", [
    (9, 13, 20, 3, 2),
    (60, 108, 128, 4, 15),     # the flagship's half-resolution frame
    (7, 5, 256, 9, 3),         # two channel chunks, window past the edges
])
def test_local_kernel_matches_plain(cuda, h, w, c, o, window):
    rng = np.random.default_rng(1)
    # the query frame is a noisy, shifted copy of the previous one
    k_np = 0.3 * rng.normal(size=(h, w, c))
    q_np = np.roll(k_np, (1, -1), axis=(0, 1)) \
        + 0.02 * rng.normal(size=(h, w, c))
    q = torch.tensor(q_np, dtype=torch.float32, device=cuda)
    k = torch.tensor(k_np, dtype=torch.float32, device=cuda)
    oh = torch.tensor(np.eye(o)[rng.integers(0, o, size=(h, w))],
                      dtype=torch.float32, device=cuda)
    inputs = prepare_local(q, k, oh)
    before = build.LAUNCHES["local_matching"]
    got = local_matching_prepared(*inputs, window)
    torch.cuda.synchronize()
    assert build.LAUNCHES["local_matching"] == before + 1
    want = local_matching_prepared_plain(*inputs, window)
    assert (want < 0.9).float().mean() > 0.05     # the check is not vacuous
    torch.testing.assert_close(got, want, **TOL)


def test_wrappers_reject_bad_inputs(cuda):
    q = torch.zeros(8, 8, 128, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        local_matching_prepared(q, q, torch.zeros(8, 8, 2, device=cuda), 2)
    k = torch.zeros(64, 16, device=cuda)
    b = prepare_ref(k, torch.ones(64, 2, device=cuda))
    with pytest.raises(TypeError):
        global_matching_prepared(k.to(torch.bfloat16), b)
    # a contiguous reference two bytes past an aligned address: cp.async
    # would fault on it, so the wrapper refuses it
    kb = k.to(torch.bfloat16)
    b = prepare_ref(kb, torch.ones(64, 2, device=cuda))
    buf = torch.empty(b.neg2pixels.numel() + 1, dtype=torch.bfloat16,
                      device=cuda)
    shifted = buf[1:].view_as(b.neg2pixels)
    shifted.copy_(b.neg2pixels)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        global_matching_prepared(kb, b._replace(neg2pixels=shifted))
