"""The CUDA kernels vs their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so these tests skip without a GPU. On a
machine with one (and no JAX) run them without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Both sides compute the same products exactly in f32 (bf16 inputs are
widened) and accumulate in f32 in another order, so they agree to 1e-5 on
the normalized distances at these input scales. TF32 is off for the plain
matmuls. Kernel 1's f32 variant and kernel 2 run 3xTF32 on the tensor
cores: each operand is split into two TF32 halves, the three products that
matter are exact, the dropped lo x lo product is below 2^-22 of a
product, and the large products are summed per 32 channels before an f32
add, so they keep within 1e-5 as well.

The int8 kernel (kernel 3) quantizes the float query in its prologue as
the plain version's `quantize_rows_int8` does, bit for bit (IEEE division,
ties to even), and the two form the same integer cross terms exactly (in
int32, and in f32 below 2^24) and round the same f32 epilogue in the same
order, so they differ only in the exp of the normalization: 1e-5. One
quantized value off by one would move an unsaturated output by about
1e-3. Its key splits give the same bits as one walk: a min is exact.

The ring kernel (kernel 6), driven by the ring rotation on members that
share one card, agrees with the same ring on its plain version to 1e-5
(another f32 summation order), and is bit-identical to kernel 1's f32
variant over all rows: both run the same 3xTF32 arithmetic on each pair,
whatever tile holds its key, and a min is exact.

The argmin kernels' winners must equal the plain versions' wherever the
best candidate beats the second best by more than the distance tolerance
(closer pairs may swap under another summation order). On inputs whose
every product and sum is exact (small multiples of 1/4) they must equal
everywhere, ties included: the lowest bucketed row wins, across the key
splits of kernel 4 as within one. The trainable
Functions' gradients are compared with an upstream gradient that is zero
where the two forwards chose different winners; elsewhere they differ only
in the order `index_add_` sums on the card, so they agree to 1e-5 in f32
and to the rounding of the bf16 result (rtol 1e-2) in bf16.
"""

import numpy as np
import pytest
import torch

from _torch_local_ties import local_ties
from cvpr2020_manet_tpu_torch.kernels import build
from cvpr2020_manet_tpu_torch.ops.global_matching_cuda import (
    global_matching_prepared, global_matching_prepared_argmin,
    global_matching_prepared_argmin_plain, global_matching_prepared_int8,
    global_matching_prepared_int8_plain, global_matching_prepared_plain,
    _div127, _launch_int8, key_splits, prepare_ref, prepare_ref_int8,
    quantize_rows_int8, split_ranges)
from cvpr2020_manet_tpu_torch.ops.local_matching_cuda import (
    ARGMIN_PATCH_ROWS, _launch as local_launch, local_matching_prepared,
    local_matching_prepared_argmin, local_matching_prepared_argmin_plain,
    local_matching_prepared_plain, prepare_local)
from cvpr2020_manet_tpu_torch.ops.ring_matching_cuda import (
    RingShard, ring_matching_step, ring_matching_step_plain)
from cvpr2020_manet_tpu_torch.ops.trainable import (
    GlobalMatchingTrainable, LocalMatchingTrainable)
from cvpr2020_manet_tpu_torch.parallel.cp_matching import (
    context_parallel_matching, ring_kernel)
from cvpr2020_manet_tpu_torch.parallel.mesh import create_mesh, shard_context

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-5, atol=1e-5)
# Kernel 2 at C = 512, where |k|^2 is about 46 at these input scales: its
# 3xTF32 cross terms (the tensor cores' f32 sums are truncated, not
# rounded) land up to about 2e-5 from the plain version on an H100; held
# to the 1e-4 that chip_smoke.py holds kernel 2 to.
TOL_WIDE = dict(rtol=1e-4, atol=1e-4)
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
    (4096, 8192, 128, 4, torch.float32, False),  # many pipeline stages
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


def _local_case(rng, h, w, c, o, repeat, cuda):
    """A previous frame (repeated in blocks of 4 columns when `repeat`,
    so that candidates tie exactly), a noisy shifted copy as queries, and
    random labels over o objects -> the prepared inputs."""
    k_np = 0.3 * rng.normal(size=(h, w, c))
    if repeat:
        k_np = np.repeat(k_np[:, ::4], 4, axis=1)[:, :w]
    q_np = np.roll(k_np, (1, -1), axis=(0, 1)) \
        + 0.02 * rng.normal(size=(h, w, c))
    q = torch.tensor(q_np, dtype=torch.float32, device=cuda)
    k = torch.tensor(k_np, dtype=torch.float32, device=cuda)
    oh = torch.tensor(np.eye(o)[rng.integers(0, o, size=(h, w))],
                      dtype=torch.float32, device=cuda)
    return prepare_local(q, k, oh)


@pytest.mark.parametrize("h,w,c,o,window,repeat", [
    (61, 109, 128, 4, 15, False),   # h, w no multiple of the 2 x 16 patch
    (10, 40, 128, 4, 15, False),    # shorter than 2w + 1
    (40, 9, 128, 4, 15, False),     # narrower than 2w + 1 and one tile
    (23, 37, 128, 1, 15, False),    # one object
    (23, 37, 128, 9, 15, False),    # 8-object bucket + background
    (23, 37, 100, 32, 7, False),    # the widest object bound
    (17, 35, 512, 5, 15, False),    # 16 channel chunks
    (20, 50, 128, 4, 15, True),     # keys repeat: candidates tie exactly
    (12, 30, 128, 4, 40, False),    # the widest window (4 warps a row)
    (12, 30, 128, 4, 1, False),     # window 1: one warp a row
])
def test_local_kernel_tf32_cases(cuda, h, w, c, o, window, repeat):
    """Kernel 2's patches, stages and masks at edge shapes: ragged
    patches, images smaller than the window, every object bound, four
    channel chunks, exact ties, the window's extremes."""
    inputs = _local_case(np.random.default_rng(7), h, w, c, o, repeat, cuda)
    got = local_matching_prepared(*inputs, window)
    torch.cuda.synchronize()
    want = local_matching_prepared_plain(*inputs, window)
    assert got.shape == (h, w, o)
    # not vacuous: a query's own object (1 of o) is near, the others far
    assert (want < 0.9).float().mean() > 0.5 / o
    torch.testing.assert_close(got, want, **(TOL if c <= 256 else TOL_WIDE))


def test_local_kernel_rejects_wide_window(cuda):
    inputs = _local_case(np.random.default_rng(8), 8, 8, 128, 2, False, cuda)
    with pytest.raises(ValueError, match="window"):
        local_matching_prepared(*inputs, 41)


def _local_exact_ties(rng, h, w, c, o, cuda):
    """A previous frame of small multiples of 1/4 (every product and sum
    exact, in 3xTF32 as in f32) repeated in blocks of 2 rows x 4 columns,
    with labels repeated alike, and queries that copy a key plus 1/4 on
    one channel: each query's nearest keys are a block of exact ties that
    straddles key rows, n8 tiles and column tiles. -> prepared inputs."""
    hb, wb = -(-h // 2), -(-w // 4)
    base = rng.integers(-2, 3, size=(hb, wb, c)) * 0.25
    k_np = np.repeat(np.repeat(base, 2, axis=0), 4, axis=1)[:h, :w]
    lab = rng.integers(0, o, size=(hb, wb))
    labels = np.repeat(np.repeat(lab, 2, axis=0), 4, axis=1)[:h, :w]
    q_np = np.roll(k_np, (1, -1), axis=(0, 1)).copy()
    q_np[..., 0] += 0.25
    q = torch.tensor(q_np, dtype=torch.float32, device=cuda)
    k = torch.tensor(k_np, dtype=torch.float32, device=cuda)
    oh = torch.tensor(np.eye(o)[labels], dtype=torch.float32, device=cuda)
    return prepare_local(q, k, oh)


@pytest.mark.parametrize("h,w,c,o,window,exact", [
    (61, 109, 128, 4, 15, False),   # h, w no multiple of the patch
    (10, 40, 128, 4, 15, False),    # shorter than 2w + 1
    (40, 9, 128, 4, 15, False),     # narrower than 2w + 1 and one tile
    (23, 37, 128, 1, 15, False),    # one object
    (23, 37, 128, 9, 15, False),    # 8-object bucket + background
    (23, 37, 100, 32, 7, False),    # the widest object bound
    (17, 35, 512, 5, 15, False),    # 16 channel chunks
    (20, 50, 128, 4, 15, True),     # keys repeat: candidates tie exactly
    (52, 52, 128, 9, 15, True),     # the training shape, exact ties
    (12, 30, 128, 4, 40, False),    # the widest window (4 warps a row)
    (12, 30, 128, 4, 1, False),     # window 1: one warp a row
])
def test_local_argmin_tf32_cases(cuda, h, w, c, o, window, exact):
    """Kernel 5 on kernel 2's template at its edge shapes: distances as
    kernel 2's are held; winners equal to the plain version's wherever an
    object's best candidate beats the next distinct one by more than GAP;
    on exact inputs with repeated keys, equal everywhere and, at every
    tie, the lowest flat index; patches of 4, 2 and 1 query rows give the
    same bits."""
    rng = np.random.default_rng(7)
    inputs = (_local_exact_ties(rng, h, w, c, o, cuda) if exact
              else _local_case(rng, h, w, c, o, False, cuda))
    got = {rows: local_launch(*inputs, window, argmin=True, rows=rows)
           for rows in ARGMIN_PATCH_ROWS}
    torch.cuda.synchronize()
    dist, idx = got[ARGMIN_PATCH_ROWS[0]]
    for d2, i2 in got.values():
        assert torch.equal(d2, dist) and torch.equal(i2, idx)
    want, want_idx = local_matching_prepared_argmin_plain(*inputs, window)
    assert idx.shape == (h, w, o) and idx.dtype == torch.int32
    assert (want < 0.9).float().mean() > 0.5 / o
    torch.testing.assert_close(dist, want,
                               **(TOL if c <= 256 else TOL_WIDE))
    best, first, count, gap = local_ties(*inputs, window)
    assert torch.equal(want_idx, first)
    if exact:
        assert torch.equal(idx, want_idx)
        ties = count > 1
        assert int(ties.sum()) > h * w
    else:
        # an object without keys in the window: 1e8-scale candidates
        clear = (gap > GAP) & (best < 1e7)
        assert clear.float().mean() > 0.5
        assert torch.equal(idx[clear], want_idx[clear])


def test_local_argmin_rejects_wide_window(cuda):
    inputs = _local_case(np.random.default_rng(8), 8, 8, 128, 2, False, cuda)
    with pytest.raises(ValueError, match="window"):
        local_matching_prepared_argmin(*inputs, 41)


@pytest.mark.parametrize("nq,nk,c,o,empty", [
    (1001, 5000, 128, 4, False),   # Nq no multiple of the 128-query tile
    (300, 4000, 128, 9, True),     # O = 9, an object without rows
    (129, 700, 100, 9, False),     # few rows an object: slack blocks
])
def test_global_bf16_wgmma_cases(cuda, nq, nk, c, o, empty):
    """Kernel 1 in bf16 on the wgmma mainloop: ragged query tiles, an
    object without rows (1.0), slack blocks skipped, O = 9."""
    rng = np.random.default_rng(9)
    k_np = 0.3 * rng.normal(size=(nk, c))
    q_np = k_np[rng.integers(0, nk, size=nq)] + 0.02 * rng.normal(size=(nq, c))
    q = torch.tensor(q_np, dtype=torch.bfloat16, device=cuda)
    k = torch.tensor(k_np, dtype=torch.bfloat16, device=cuda)
    labels = rng.integers(0, o - 1 if empty else o, size=nk)
    onehot = torch.tensor(np.eye(o)[labels], dtype=torch.float32, device=cuda)
    b = prepare_ref(k, onehot)
    assert bool((b.block_obj >= o).any())         # slack blocks present
    got = global_matching_prepared(q, b)
    torch.cuda.synchronize()
    want = global_matching_prepared_plain(q, b)
    assert (want < 0.9).float().mean() > 0.05
    torch.testing.assert_close(got, want, **TOL)
    if empty:
        assert (got[:, o - 1] == 1.0).all()


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


def _exact_inputs(rng, nq, nk, c, o, cuda, dup_rows=64):
    """bf16 keys and queries in small multiples of 1/4, so that every
    product and sum is exact and the kernel and the plain version see the
    same candidates, ties included. Objects of unequal sizes (object j
    draws j + 1 shares of the rows), so that their k-blocks do not line up
    with the key splits; object o - 1 has no pixels. In each
    live object, the first `dup_rows` rows of its first k-block are copied
    over rows of its last one, and half the queries are those rows: exact
    ties across k-blocks and key splits."""
    k = rng.integers(-2, 3, size=(nk, c)) * 0.25
    shares = np.arange(1, o)
    sizes = np.diff(np.concatenate([[0], shares.cumsum() * nk // shares.sum()]))
    labels = rng.permutation(np.repeat(np.arange(o - 1), sizes))
    onehot = torch.tensor(np.eye(o)[labels], dtype=torch.float32, device=cuda)
    b = prepare_ref(torch.tensor(k, dtype=torch.bfloat16, device=cuda), onehot)
    block_k = b.sqnorm.shape[1]
    src = b.src_idx.cpu().numpy().reshape(-1, block_k)
    obj = b.block_obj.cpu().numpy()
    dups = []
    for ob in range(o - 1):
        blocks = np.nonzero(obj == ob)[0]
        first, last = src[blocks[0], :dup_rows], src[blocks[-1], :dup_rows]
        keep = (first >= 0) & (last >= 0)
        k[last[keep]] = k[first[keep]]
        dups.append(first[keep])
    dups = np.concatenate(dups)
    q = rng.integers(-2, 3, size=(nq, c)) * 0.25
    half = nq // 2
    q[:half] = k[dups[rng.integers(0, len(dups), size=half)]]
    q[:half, :4] += 0.25                # near, but not on, the copied rows
    return (torch.tensor(q, dtype=torch.bfloat16, device=cuda),
            torch.tensor(k, dtype=torch.bfloat16, device=cuda), onehot)


def _live_runs(block_obj: torch.Tensor, o: int):
    """Each live object's run of live k-block ordinals [first, last]."""
    live = [x for x in block_obj.tolist() if x < o]
    return {ob: (live.index(ob), len(live) - 1 - live[::-1].index(ob))
            for ob in set(live)}, len(live)


@pytest.mark.parametrize("nq,nk,o", [
    (2704, 10816, 4),          # 23 live blocks over 12 splits
    (10816, 10816, 9),         # the training shape
])
def test_global_argmin_split_ties(cuda, nq, nk, o):
    """Kernel 4 with its key range split: exact inputs with ties inside and
    across k-blocks and splits, objects whose blocks straddle two splits,
    and a pixel-less object. Winners equal the plain version's everywhere
    and distances agree to 1e-5 (only the normalization's exp differs)."""
    rng = np.random.default_rng(9)
    q, k, onehot = _exact_inputs(rng, nq, nk, 128, o, cuda)
    b = prepare_ref(k, onehot)
    splits = key_splits(nq, b, cuda)
    runs, n_live = _live_runs(b.block_obj, o)
    cuts = {lo for lo, _ in split_ranges(n_live, splits)} - {0}
    assert splits > 1
    assert any(first < cut <= last for first, last in runs.values()
               for cut in cuts)                       # an object straddles
    got, got_idx = global_matching_prepared_argmin(q, b)
    want, want_idx = global_matching_prepared_argmin_plain(q, b)
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got_idx, want_idx)
    assert (got_idx[:, o - 1] == -1).all() and (got[:, o - 1] == 1.0).all()
    # the copied rows tie: the lower bucketed row (the first block) wins
    e = q.float() @ b.neg2pixels.float().T + b.sqnorm.reshape(-1)
    row_obj = b.block_obj.long().repeat_interleave(b.sqnorm.shape[1])
    ties = 0
    for ob in range(o - 1):
        eo = torch.where((row_obj == ob) & (b.src_idx >= 0), e, float("inf"))
        best = eo.min(dim=1, keepdim=True).values
        n_best = (eo == best).sum(dim=1)
        first = (eo == best).int().argmax(dim=1)
        tie = n_best > 1
        ties += int(tie.sum())
        assert torch.equal(got_idx[tie, ob].long(), first[tie])
    assert ties > nq // 4


def test_global_argmin_unsplit(cuda):
    """With more query tiles than three per SM the planner takes S = 1 and
    the kernel writes its results without partials or merge."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    nq = 3 * sms * 128 + 1
    rng = np.random.default_rng(10)
    q, k, onehot = _exact_inputs(rng, nq, 2000, 128, 4, cuda)
    b = prepare_ref(k, onehot)
    assert key_splits(nq, b, cuda) == 1
    before = build.LAUNCHES["global_matching_argmin"]
    got, got_idx = global_matching_prepared_argmin(q, b)
    torch.cuda.synchronize()
    assert build.LAUNCHES["global_matching_argmin"] == before + 1
    want, want_idx = global_matching_prepared_argmin_plain(q, b)
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got_idx, want_idx)
    assert (got_idx[:, 3] == -1).all()


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


def test_int8_quantizers_divide_as_ieee(cuda):
    """The quantizers divide by 127 on the card as on the CPU and in JAX
    (IEEE division; PyTorch's x / 127.0 on a CUDA tensor multiplies by
    the reciprocal), so the card's plain version quantizes as kernel 3's
    prologue and the CPU do."""
    x = 3 * torch.rand(1 << 16, generator=torch.Generator().manual_seed(3))
    assert torch.equal(_div127(x.to(cuda)).cpu(), x / 127.0)
    got_q, got_s = quantize_rows_int8(x.reshape(-1, 128).to(cuda))
    want_q, want_s = quantize_rows_int8(x.reshape(-1, 128))
    assert torch.equal(got_q.cpu(), want_q) and torch.equal(got_s.cpu(), want_s)


def _int8_query(rng, nq, nk, c, case):
    """Queries (noisy copies of reference rows; for "ties", exact copies
    of rows of integers and halves times 2^-6 with 127 * 2^-6 at their
    largest, so that s_q = 2^-6 and every x / s_q of the quantizer is
    exact, the halves ties) and reference rows."""
    k = 0.3 * rng.normal(size=(nk, c))
    q = k[rng.integers(0, nk, size=nq)] + 0.02 * rng.normal(size=(nq, c))
    if case == "ties":
        rows = (rng.integers(-126, 127, size=(nk, c))
                + 0.5 * rng.integers(0, 2, size=(nk, c))) * 2.0 ** -6
        rows[:, 0] = 127 * 2.0 ** -6
        q = rows[rng.integers(0, nk, size=nq)]
        k = rows + 0.02 * rng.normal(size=(nk, c))
    return q, k


@pytest.mark.parametrize("nq,nk,c,o,dtype,case", [
    (300, 900, 16, 3, torch.float32, "plain"),      # 16 channels, padded
    (1001, 3000, 100, 4, torch.bfloat16, "plain"),  # the model's 100
    (777, 2000, 128, 9, torch.float32, "plain"),    # O = 9, ragged tiles
    (500, 1500, 128, 4, torch.bfloat16, "one_live"),  # 3 objects empty
    (256, 1000, 128, 4, torch.float32, "ties"),     # halves tie
    (333, 1200, 128, 4, torch.float32, "unaligned"),  # scalar loads
])
def test_int8_fused_quantization_cases(cuda, nq, nk, c, o, dtype, case):
    """Kernel 3 on its float query: f32 and bf16, C = 16 and 100 padded in
    the kernel, a ragged last query tile, exact halves, an unaligned query
    (the scalar load path), all objects but one without rows, O = 9;
    against `_int8_query` + the plain version, with one walk (S = 1) and
    with split key ranges giving the same bits."""
    rng = np.random.default_rng(11)
    q_np, k_np = _int8_query(rng, nq, nk, c, case)
    q = torch.tensor(q_np, dtype=dtype, device=cuda)
    if case == "unaligned":
        buf = torch.empty(q.numel() + 1, dtype=dtype, device=cuda)
        buf[1:].copy_(q.reshape(-1))
        q = buf[1:].view(nq, c)
        assert q.is_contiguous() and q.data_ptr() % 16
    k = torch.tensor(k_np, dtype=torch.bfloat16, device=cuda)
    live = 1 if case == "one_live" else o
    labels = rng.integers(0, live, size=nk)
    onehot = torch.tensor(np.eye(o)[labels], dtype=torch.float32, device=cuda)
    b = prepare_ref_int8(k, onehot)
    before = build.LAUNCHES["global_matching_int8"]
    got = _launch_int8(q, b, 1)
    split = _launch_int8(q, b, 3)
    torch.cuda.synchronize()
    assert build.LAUNCHES["global_matching_int8"] == before + 2
    want = global_matching_prepared_int8_plain(q, b)
    assert got.shape == (nq, o) and got.dtype == torch.float32
    assert (want[:, :live] < 0.9).float().mean() > 0.05
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(split, got)
    if live < o:
        assert (got[:, live:] == 1.0).all()


def test_int8_batch_shape_splits(cuda):
    """The batch engine's launch (Nq = Nk = 25,920) plans S > 1 on an H100
    and matches the plain version and the unsplit walk."""
    rng = np.random.default_rng(12)
    n = 25920
    q, k = _noisy_copies(rng, n, n, 100, cuda, torch.bfloat16)
    onehot = torch.tensor(np.eye(4)[rng.integers(0, 3, size=n)],
                          dtype=torch.float32, device=cuda)
    b = prepare_ref_int8(k, onehot)
    splits = key_splits(n, b, cuda)
    if torch.cuda.get_device_properties(0).multi_processor_count >= 132:
        assert splits > 1
    got = global_matching_prepared_int8(q, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, global_matching_prepared_int8_plain(q, b),
                               **TOL)
    assert torch.equal(got, _launch_int8(q, b, 1))


@pytest.mark.parametrize("n,dtype", [(1, torch.float32), (2, torch.float32),
                                     (3, torch.float32), (4, torch.float32),
                                     (4, torch.bfloat16)])
def test_ring_kernel_matches_plain(cuda, n, dtype):
    """Kernel 6 on a ring of n members on one card: n x n launches, within
    1e-5 of the plain ring, bit-identical to kernel 1's f32 variant over
    all rows (a bf16 query is promoted to f32)."""
    rng = np.random.default_rng(8)
    nq, nk, c, o = 300, 1536, 100, 4
    q, k = _noisy_copies(rng, nk, nq, c, cuda, torch.float32)
    q = q.to(dtype)
    labels = rng.integers(0, o - 1, size=nk)           # object o-1 is empty
    onehot = torch.tensor(np.eye(o)[labels], dtype=torch.float32, device=cuda)
    valid = torch.tensor(rng.random(nk) > 0.2, device=cuda)
    mesh = create_mesh(data=1, context=n, devices=[cuda] * n)
    before = dict(build.LAUNCHES)
    got = context_parallel_matching(q, k, onehot, valid, mesh,
                                    schedule="ring_kernel")
    torch.cuda.synchronize()
    assert build.LAUNCHES["ring_matching"] == before["ring_matching"] + n * n
    assert build.LAUNCHES["global_matching"] == before["global_matching"]
    plain = ring_kernel(q, *(shard_context(x, mesh)
                             for x in (k, onehot, valid)),
                        mesh.context_devices,
                        step_fn=ring_matching_step_plain)
    assert got.shape == (nq, o) and got.dtype == torch.float32
    assert (plain < 0.9).float().mean() > 0.05    # the check is not vacuous
    torch.testing.assert_close(got, plain, **TOL)
    assert (got[:, o - 1] == 1.0).all()
    whole = global_matching_prepared(q.float(), prepare_ref(
        k, onehot * valid.float()[:, None]))
    assert torch.equal(got, whole)


def test_ring_step_rejects_bad_inputs(cuda):
    k = torch.randn(512, 128, device=cuda)
    b = prepare_ref(k, torch.ones(512, 2, device=cuda))
    shard = RingShard(b.neg2pixels, b.sqnorm, b.block_obj)
    q = torch.randn(64, 128, device=cuda)
    acc, out = torch.empty(64, 2, device=cuda), torch.empty(64, 2, device=cuda)
    with pytest.raises(TypeError):                 # f32 only
        ring_matching_step(q.to(torch.bfloat16), shard, acc, out,
                           first=True, last=True)
    with pytest.raises(ValueError):                # one acc row per query
        ring_matching_step(q[:63], shard, acc, out, first=True, last=True)
    with pytest.raises(ValueError):                # not contiguous
        ring_matching_step(q.t().contiguous().t(), shard, acc, out,
                           first=True, last=True)
    buf = torch.empty(q.numel() + 1, device=cuda)   # 4 bytes past aligned
    shifted = buf[1:].view_as(q)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="aligned"):
        ring_matching_step(shifted, shard, acc, out, first=True, last=True)
