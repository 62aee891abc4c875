"""Kernel 4's tie rule and key-split planner, on the CPU.

The bf16 argmin kernel splits the key range across blocks and merges the
splits' partial (min, row) in ascending split order with a strict <, so
that the lowest bucketed row wins ties, as the TPU kernel's `jnp.argmin`
within a k-block and `dmin < acc` across k-blocks do. Here the port's plain
argmin version (the kernel's oracle on the card) is held against JAX's
`global_matching_prepared_argmin` in interpret mode on inputs with exact
duplicate reference rows in one object across k-blocks: the bucketed rows
must be equal and the distances within 1e-5. The values are small
multiples of 1/4, so every product and sum is exact in both and the ties
are ties in both. The planner must cover every live k-block exactly once,
in contiguous runs, with 1 <= S <= live blocks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu.ops import matching_pallas as jmp
from cvpr2020_manet_tpu_torch.ops.global_matching_cuda import (
    BLOCKS_PER_SM, global_matching_prepared_argmin, plan_splits,
    prepare_ref, split_ranges)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, as in the other port tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tie_inputs(seed, nq, nk, c, o, block_k, empty):
    """Keys in multiples of 1/4; in each live object the rows of its first
    k-block are copied over rows of each later k-block of the object, and
    most queries sit next to a copied row. -> (q, k, onehot)."""
    rng = np.random.default_rng(seed)
    k = (rng.integers(-2, 3, size=(nk, c)) * 0.25).astype(np.float32)
    live = o - 1 if empty else o
    labels = rng.integers(0, live, size=nk)
    onehot = np.eye(o, dtype=np.float32)[labels]
    b = prepare_ref(torch.from_numpy(k), torch.from_numpy(onehot),
                    block_k=block_k)
    src = b.src_idx.numpy().reshape(-1, block_k)
    obj = b.block_obj.numpy()
    copied = []
    for ob in range(live):
        blocks = np.nonzero(obj == ob)[0]
        assert len(blocks) >= 2               # the object spans k-blocks
        first = src[blocks[0]]
        for later in blocks[1:]:
            keep = (first >= 0) & (src[later] >= 0)
            k[src[later][keep]] = k[first[keep]]
        copied.append(first[first >= 0])
    copied = np.concatenate(copied)
    q = (rng.integers(-2, 3, size=(nq, c)) * 0.25).astype(np.float32)
    near = nq * 3 // 4
    q[:near] = k[copied[rng.integers(0, len(copied), size=near)]]
    q[:near, :2] += 0.25
    return q, k, onehot


@pytest.mark.parametrize("nq,nk,c,o,block_k,empty", [
    (200, 900, 16, 3, 128, True),     # an object without pixels
    (130, 1200, 20, 4, 64, False),    # ragged channels, many k-blocks
])
def test_argmin_plain_ties_vs_jax(nq, nk, c, o, block_k, empty):
    q, k, onehot = _tie_inputs(11, nq, nk, c, o, block_k, empty)
    want, want_idx = jmp.global_matching_prepared_argmin(
        jnp.asarray(q), jmp.prepare_ref(jnp.asarray(k), jnp.asarray(onehot),
                                        block_k=block_k),
        block_k=block_k, interpret=True)
    b = prepare_ref(torch.from_numpy(k), torch.from_numpy(onehot),
                    block_k=block_k)
    got, got_idx = global_matching_prepared_argmin(torch.from_numpy(q), b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    # the ties are real, and the lowest bucketed row won them
    e = torch.nn.functional.pad(torch.from_numpy(q), (
        0, b.neg2pixels.shape[1] - c)) @ b.neg2pixels.T + b.sqnorm.reshape(-1)
    row_obj = b.block_obj.long().repeat_interleave(block_k)
    ties = 0
    for ob in range(o - 1 if empty else o):
        eo = torch.where((row_obj == ob) & (b.src_idx >= 0), e, float("inf"))
        at_min = eo == eo.min(dim=1, keepdim=True).values
        tie = at_min.sum(dim=1) > 1
        ties += int(tie.sum())
        rows = torch.where(at_min, torch.arange(e.shape[1]), e.shape[1])
        first_two = rows.topk(2, dim=1, largest=False).values.sort(1).values
        assert torch.equal(got_idx[tie, ob].long(), first_two[tie, 0])
        # some ties span two k-blocks
        assert (first_two[tie] // block_k).diff(dim=1).gt(0).any()
    assert ties >= nq // 2
    if empty:
        assert (got_idx[:, o - 1] == -1).all()
        assert (got[:, o - 1] == 1.0).all()


@pytest.mark.parametrize("tiles,live,sms", [
    (85, 24, 132),         # stage-1 / stage-2 training shape: S = 3
    (85, 38, 132),         # the same, planned on all k-blocks
    (22, 23, 132),
    (3, 9, 132),           # few queries: one live block per split
    (1, 1, 132),
    (397, 24, 132),        # more tiles than resident blocks: S = 1
    (1000, 5, 132),
    (40, 100, 114),        # another SM count
])
def test_split_planner(tiles, live, sms):
    s = plan_splits(tiles, live, sms)
    assert 1 <= s <= live
    if tiles * 2 <= BLOCKS_PER_SM * sms:
        assert s > 1 or live == 1
    assert tiles * s <= max(BLOCKS_PER_SM * sms, tiles)
    ranges = split_ranges(live, s)
    assert len(ranges) == s
    assert ranges[0][0] == 0 and ranges[-1][1] == live
    covered = []
    for (lo, hi), (nlo, _) in zip(ranges, ranges[1:] + [(live, live)]):
        assert lo <= hi and hi == nlo          # contiguous, in order
        covered += range(lo, hi)
    assert covered == list(range(live))       # each live block exactly once
    assert max(hi - lo for lo, hi in ranges) <= -(-live // s)


def test_split_planner_training_shape():
    """Crop 416: 104 x 104 features, 85 query tiles of 128, on 132 SMs
    with 2 resident blocks each: 3 splits, 255 blocks."""
    assert plan_splits(-(-104 * 104 // 128), 38, 132) == 3
