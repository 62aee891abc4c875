"""'syncbn' of the PyTorch port (`models/layers.BatchNorm` over a process
group), the counterpart of `tests/test_syncbn.py`: two Gloo CPU ranks
(tests/_torch_dist_worker.py), each with half of a 16-sample batch. The
synced output equals Flax's BatchNorm over the whole batch (rtol/atol
2e-5, as the JAX test), per-rank BN without the sync differs by more than
1e-3 (so the all-reduce carries the result), the input gradient of
sum(y * w) equals the full batch's autograd gradient, and the running
statistics equal Flax's after the update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu.models.layers import make_norm as jax_make_norm
from cvpr2020_manet_tpu_torch.models.layers import make_norm
from flax import linen as fnn

from _torch_dist_worker import run_ranks

TOL = dict(rtol=2e-5, atol=2e-5)


class _BN(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return jax_make_norm("bn", jnp.float32)()(x)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The two ranks' outputs, and the batch they split."""
    out = tmp_path_factory.mktemp("syncbn")
    run_ranks([dict(rank=r, world=2, device="cpu", mode="syncbn",
                    out=str(out)) for r in range(2)])
    ranks = [dict(np.load(out / f"syncbn{r}.npz")) for r in range(2)]
    rng = np.random.default_rng(0)          # as the worker draws them
    x = rng.normal(size=(16, 8, 4, 4)).astype(np.float32) * 3.0
    w = rng.normal(size=x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.normal(size=8).astype(np.float32)
    return ranks, x, w, scale, bias


def _flax_full_batch(x, scale, bias):
    net = _BN()
    nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    variables = net.init(jax.random.PRNGKey(0), nhwc)
    variables = {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}},
                 "batch_stats": variables["batch_stats"]}
    y, stats = net.apply(variables, nhwc, mutable=["batch_stats"])
    return (np.asarray(y).transpose(0, 3, 1, 2),
            jax.tree_util.tree_map(np.asarray,
                                   stats["batch_stats"]["BatchNorm_0"]))


def test_syncbn_matches_full_batch_flax_bn(job):
    ranks, x, _, scale, bias = job
    want, stats = _flax_full_batch(x, scale, bias)
    got = np.concatenate([r["syncbn_y"] for r in ranks])
    np.testing.assert_allclose(got, want, **TOL)
    for r in ranks:
        np.testing.assert_allclose(r["syncbn_mean"], stats["mean"], **TOL)
        np.testing.assert_allclose(r["syncbn_var"], stats["var"], **TOL)
    unsynced = np.concatenate([r["bn_y"] for r in ranks])
    assert np.abs(unsynced - want).max() > 1e-3


def test_syncbn_input_gradient_is_the_full_batch_gradient(job):
    """The autograd-aware all-reduce carries the backward across the ranks:
    each rank's input gradient is its half of the full batch's."""
    ranks, x, w, scale, bias = job
    m = make_norm("bn", torch.float32)(8)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).requires_grad_(True)
    (m(xt) * torch.from_numpy(w)).sum().backward()
    got = np.concatenate([r["syncbn_gx"] for r in ranks])
    np.testing.assert_allclose(got, xt.grad.numpy(), **TOL)
    unsynced = np.concatenate([r["bn_gx"] for r in ranks])
    assert np.abs(unsynced - xt.grad.numpy()).max() > 1e-3


def test_syncbn_without_a_group_raises():
    """Like an unbound `axis_name` in Flax: no process group, no syncbn."""
    with pytest.raises(RuntimeError, match="process group"):
        make_norm("syncbn", torch.float32)(4)(torch.zeros(2, 4, 3, 3))
