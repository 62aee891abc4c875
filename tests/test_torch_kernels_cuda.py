"""The CUDA kernels vs their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so these tests skip without a GPU. On a
machine with one (and no JAX) run them without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Both sides compute the same products exactly in f32 (bf16 inputs are
widened) and accumulate in f32 in another order, so they agree to 1e-5 on
the normalized distances at these input scales. TF32 is off for the plain
matmuls.

The int8 kernel (kernel 3) and its plain version form the same integer
cross terms exactly (in int32, and in f32 below 2^24) and round the same
f32 epilogue in the same order, so they differ only in the exp of the
normalization: 1e-5.

The argmin kernels' winners must equal the plain versions' wherever the
best candidate beats the second best by more than the distance tolerance
(closer pairs may swap under another summation order). The trainable
Functions' gradients are compared with an upstream gradient that is zero
where the two forwards chose different winners; elsewhere they differ only
in the order `index_add_` sums on the card, so they agree to 1e-5 in f32
and to the rounding of the bf16 result (rtol 1e-2) in bf16.
"""

import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu_torch.kernels import build
from cvpr2020_manet_tpu_torch.ops.global_matching_cuda import (
    global_matching_int8_quantized, global_matching_prepared,
    global_matching_prepared_argmin, global_matching_prepared_argmin_plain,
    global_matching_prepared_int8, global_matching_prepared_int8_plain,
    global_matching_prepared_plain, prepare_ref, prepare_ref_int8)
from cvpr2020_manet_tpu_torch.ops.local_matching_cuda import (
    local_matching_prepared, local_matching_prepared_argmin,
    local_matching_prepared_argmin_plain, local_matching_prepared_plain,
    prepare_local)
from cvpr2020_manet_tpu_torch.ops.trainable import (
    GlobalMatchingTrainable, LocalMatchingTrainable)

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-5, atol=1e-5)
GAP = 1e-4        # best-vs-second gap (raw distance) above which winners match


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


def _top2_gap(e: torch.Tensor, dim: int) -> torch.Tensor:
    """Second-smallest minus smallest along `dim` (inf with < 2 finite)."""
    two = e.topk(2, dim=dim, largest=False).values
    first, second = two.select(dim, 0), two.select(dim, 1)
    return torch.where(torch.isfinite(first), second - first,
                       torch.full_like(first, float("inf")))


def _global_gaps(q: torch.Tensor, b) -> torch.Tensor:
    """(Nq, O) gap between each object's best and second-best bucketed
    row, from the plain f32 distances."""
    qp = torch.nn.functional.pad(q.float(),
                                 (0, b.neg2pixels.shape[1] - q.shape[1]))
    e = qp @ b.neg2pixels.float().T + b.sqnorm.reshape(-1)
    row_obj = b.block_obj.long().repeat_interleave(b.sqnorm.shape[1])
    real = b.src_idx >= 0
    gaps = []
    for o in range(b.num_objects):
        keep = (row_obj == o) & real
        gaps.append(_top2_gap(torch.where(keep, e, float("inf")), 1))
    return torch.stack(gaps, 1)


def _local_gaps(q, k, kno, window) -> torch.Tensor:
    """(H, W, O) gap between the best and second-best in-image key of the
    window, from the plain f32 distances."""
    h, w, _ = q.shape
    pad = (0, 0, window, window, window, window)
    k_pad = torch.nn.functional.pad(k, pad)
    kno_pad = torch.nn.functional.pad(kno, pad, value=float("inf"))
    cands = []
    for dy in range(2 * window + 1):
        for dx in range(2 * window + 1):
            cross = (q * k_pad[dy:dy + h, dx:dx + w]).sum(-1)
            cands.append((-2.0 * cross)[..., None]
                         + kno_pad[dy:dy + h, dx:dx + w])
    return _top2_gap(torch.stack(cands), 0)


def _noisy_copies(rng, n_ref, n_query, c, cuda, dtype):
    k = 0.3 * rng.normal(size=(n_ref, c))
    q = k[rng.integers(0, n_ref, size=n_query)] \
        + 0.02 * rng.normal(size=(n_query, c))
    return (torch.tensor(q, dtype=dtype, device=cuda),
            torch.tensor(k, dtype=dtype, device=cuda))


@pytest.mark.parametrize("nq,nk,c,o,dtype,empty", [
    (300, 700, 20, 3, torch.float32, True),      # ragged, f32 FMA variant
    (257, 1025, 128, 9, torch.bfloat16, False),  # tensor cores, ragged
    (2704, 2704, 128, 9, torch.bfloat16, True),  # training O, empty object
])
def test_global_argmin_kernel_matches_plain(cuda, nq, nk, c, o, dtype, empty):
    rng = np.random.default_rng(3)
    q, k = _noisy_copies(rng, nk, nq, c, cuda, dtype)
    labels = rng.integers(0, o - 1 if empty else o, size=nk)
    onehot = torch.tensor(np.eye(o)[labels], dtype=torch.float32, device=cuda)
    b = prepare_ref(k, onehot)
    before = dict(build.LAUNCHES)
    got, got_idx = global_matching_prepared_argmin(q, b)
    torch.cuda.synchronize()
    assert build.LAUNCHES["global_matching_argmin"] == \
        before["global_matching_argmin"] + 1
    assert build.LAUNCHES["global_matching"] == before["global_matching"]
    want, want_idx = global_matching_prepared_argmin_plain(q, b)
    assert got_idx.shape == (nq, o) and got_idx.dtype == torch.int32
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(got, global_matching_prepared(q, b), **TOL)
    clear = _global_gaps(q, b) > GAP
    assert clear[:, :o - 1 if empty else o].float().mean() > 0.9
    assert torch.equal(got_idx[clear], want_idx[clear])
    if empty:
        assert (got_idx[:, o - 1] == -1).all() and (got[:, o - 1] == 1.0).all()
    # every winner is a real row of its object
    live = got_idx >= 0
    obj = b.block_obj.long()[got_idx.long().clamp(min=0)
                             // b.sqnorm.shape[1]]
    cols = torch.arange(o, device=cuda).expand(nq, o)
    assert torch.equal(obj[live], cols[live])
    assert (b.src_idx[got_idx[live].long()] >= 0).all()


@pytest.mark.parametrize("h,w,c,o,window", [
    (9, 13, 20, 3, 2),
    (52, 52, 128, 9, 15),      # the flagship's training shape
    (7, 5, 256, 9, 3),         # two channel chunks, window past the edges
])
def test_local_argmin_kernel_matches_plain(cuda, h, w, c, o, window):
    rng = np.random.default_rng(4)
    k_np = 0.3 * rng.normal(size=(h, w, c))
    q_np = np.roll(k_np, (1, -1), axis=(0, 1)) \
        + 0.02 * rng.normal(size=(h, w, c))
    q = torch.tensor(q_np, dtype=torch.float32, device=cuda)
    k = torch.tensor(k_np, dtype=torch.float32, device=cuda)
    labels = rng.integers(0, o - 1, size=(h, w))      # object o-1 is empty
    oh = torch.tensor(np.eye(o)[labels], dtype=torch.float32, device=cuda)
    inputs = prepare_local(q, k, oh)
    before = dict(build.LAUNCHES)
    got, got_idx = local_matching_prepared_argmin(*inputs, window)
    torch.cuda.synchronize()
    assert build.LAUNCHES["local_matching_argmin"] == \
        before["local_matching_argmin"] + 1
    assert build.LAUNCHES["local_matching"] == before["local_matching"]
    want, want_idx = local_matching_prepared_argmin_plain(*inputs, window)
    assert got_idx.shape == (h, w, o) and got_idx.dtype == torch.int32
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(got, local_matching_prepared_plain(
        *inputs, window), **TOL)
    clear = _local_gaps(*inputs, window) > GAP
    assert clear[..., :o - 1].float().mean() > 0.9
    assert torch.equal(got_idx[clear], want_idx[clear])
    assert (got[..., o - 1] == 1.0).all()
    # winners lie inside the image and inside the window
    live = got_idx >= 0
    yy, xx = got_idx.long() // w, got_idx.long() % w
    py = torch.arange(h, device=cuda)[:, None, None].expand(h, w, o)
    px = torch.arange(w, device=cuda)[None, :, None].expand(h, w, o)
    assert ((yy - py).abs()[live] <= window).all()
    assert ((xx - px).abs()[live] <= window).all()


def test_global_trainable_grads_kernel_vs_plain(cuda):
    rng = np.random.default_rng(5)
    nq, nk, c, o = 2704, 2704, 128, 9
    q, k = _noisy_copies(rng, nk, nq, c, cuda, torch.bfloat16)
    gate = torch.tensor(np.eye(o)[rng.integers(0, o - 1, size=nk)],
                        dtype=torch.float32, device=cuda)
    g = torch.tensor(rng.normal(size=(nq, o)), dtype=torch.float32,
                     device=cuda)
    b = prepare_ref(k, gate)
    same = global_matching_prepared_argmin(q, b)[1] \
        == global_matching_prepared_argmin_plain(q, b)[1]
    assert same.float().mean() > 0.99
    grads = []
    for match in (global_matching_prepared_argmin,
                  global_matching_prepared_argmin_plain):
        qq, kk = q.clone().requires_grad_(), k.clone().requires_grad_()
        out = GlobalMatchingTrainable.apply(qq, kk, gate, match)
        (out * g * same).sum().backward()
        assert qq.grad.dtype == kk.grad.dtype == torch.bfloat16
        grads.append((qq.grad.float(), kk.grad.float()))
    assert grads[0][0].abs().max() > 0
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-3)


def test_local_trainable_grads_kernel_vs_plain(cuda):
    rng = np.random.default_rng(6)
    h, w, c, o, window = 52, 52, 128, 9, 15
    k_np = 0.3 * rng.normal(size=(h, w, c))
    q_np = np.roll(k_np, (2, 1), axis=(0, 1)) \
        + 0.02 * rng.normal(size=(h, w, c))
    q = torch.tensor(q_np, dtype=torch.float32, device=cuda)
    k = torch.tensor(k_np, dtype=torch.float32, device=cuda)
    oh = torch.tensor(np.eye(o)[rng.integers(0, o - 1, size=(h, w))],
                      dtype=torch.float32, device=cuda)
    g = torch.tensor(rng.normal(size=(h, w, o)), dtype=torch.float32,
                     device=cuda)
    inputs = prepare_local(q, k, oh)
    same = local_matching_prepared_argmin(*inputs, window)[1] \
        == local_matching_prepared_argmin_plain(*inputs, window)[1]
    assert same.float().mean() > 0.99
    grads = []
    for match in (local_matching_prepared_argmin,
                  local_matching_prepared_argmin_plain):
        qq, kk = q.clone().requires_grad_(), k.clone().requires_grad_()
        out = LocalMatchingTrainable.apply(qq, kk, oh, window, match)
        (out * g * same).sum().backward()
        grads.append((qq.grad, kk.grad))
    assert grads[0][0].abs().max() > 0
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, **TOL)


def test_argmin_wrappers_reject_bad_inputs(cuda):
    q = torch.zeros(8, 8, 128, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        local_matching_prepared_argmin(q, q, torch.zeros(8, 8, 2, device=cuda),
                                       2)
    k = torch.zeros(64, 16, device=cuda)
    b = prepare_ref(k, torch.ones(64, 2, device=cuda))
    with pytest.raises(TypeError):
        global_matching_prepared_argmin(k.to(torch.bfloat16), b)
    kb = k.to(torch.bfloat16)
    b = prepare_ref(kb, torch.ones(64, 2, device=cuda))
    buf = torch.empty(b.neg2pixels.numel() + 1, dtype=torch.bfloat16,
                      device=cuda)
    shifted = buf[1:].view_as(b.neg2pixels)
    shifted.copy_(b.neg2pixels)
    with pytest.raises(ValueError, match="aligned"):
        global_matching_prepared_argmin(kb, b._replace(neg2pixels=shifted))


@pytest.mark.parametrize("nq,nk,c,o,empty", [
    (300, 700, 20, 3, False),         # ragged everything
    (257, 1025, 128, 9, False),       # past block boundaries
    (50, 200, 16, 2, False),          # fewer queries than a block
    (64, 600, 128, 4, True),          # an object with no pixels
    (25920, 25920, 100, 4, True),     # a 480p frame step (batch engine)
    (130560, 130560, 100, 4, True),   # one 1080p memory page (stream)
])
def test_int8_kernel_matches_plain(cuda, nq, nk, c, o, empty):
    rng = np.random.default_rng(7)
    q, k = _noisy_copies(rng, nk, nq, c, cuda, torch.bfloat16)
    labels = rng.integers(0, o - 1 if empty else o, size=nk)
    onehot = torch.tensor(np.eye(o)[labels], dtype=torch.float32, device=cuda)
    valid = torch.tensor(rng.random(nk) > 0.2, device=cuda)
    b = prepare_ref_int8(k, onehot, valid)
    assert (b.block_obj >= o).any()               # slack blocks are skipped
    before = dict(build.LAUNCHES)
    got = global_matching_prepared_int8(q, b)
    torch.cuda.synchronize()
    assert build.LAUNCHES["global_matching_int8"] == \
        before["global_matching_int8"] + 1
    assert build.LAUNCHES["global_matching"] == before["global_matching"]
    want = global_matching_prepared_int8_plain(q, b)
    assert got.shape == (nq, o) and got.dtype == torch.float32
    assert (want < 0.9).float().mean() > 0.05     # the check is not vacuous
    torch.testing.assert_close(got, want, **TOL)
    if empty:
        assert (got[:, o - 1] == 1.0).all()


def test_int8_wrapper_rejects_bad_inputs(cuda):
    k = torch.randn(640, 128, device=cuda)
    b = prepare_ref_int8(k, torch.ones(640, 2, device=cuda))
    q = torch.randn(64, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):            # wider than the reference
        global_matching_prepared_int8(torch.zeros(64, 256, device=cuda), b)
    with pytest.raises(TypeError):             # not an int8 reference
        global_matching_prepared_int8(q, b._replace(pixels=b.pixels.float()))
    with pytest.raises(TypeError):
        global_matching_prepared_int8(q.to(torch.int32), b)
    # a contiguous reference one byte past an aligned address
    buf = torch.empty(b.pixels.numel() + 1, dtype=torch.int8, device=cuda)
    shifted = buf[1:].view_as(b.pixels)
    shifted.copy_(b.pixels)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        global_matching_prepared_int8(q, b._replace(pixels=shifted))
    q_hat = torch.zeros(64, 128, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):            # one scale pair per row
        global_matching_int8_quantized(
            q_hat, torch.zeros(63, 2, device=cuda), b)
