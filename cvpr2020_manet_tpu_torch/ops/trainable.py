"""Matching that trains through the hard min: argmin-routed gradients.

Port of the JAX package's `global_matching_trainable`
(`ops/matching_pallas.py`, `_gm_train_fwd` / `_gm_train_bwd`) and
`local_matching_trainable` (`ops/local_matching_pallas.py`, `_lm_train_fwd`
/ `_lm_train_bwd`). The forward is the argmin variant of each matching
kernel (the CUDA kernel for CUDA tensors, its plain version for CPU
tensors); the backward is plain PyTorch, as the JAX backward is plain jnp:
each output's gradient goes to the one reference key that won its minimum,
through the derivative of the normalization recomputed in f32 from the
saved inputs,

    d/dd [1 - 2 / (1 + exp(d))] = 2 sigmoid(d) sigmoid(-d),   d = |q - k*|^2

gated to 0 where the forward saturated (no winner, the sentinel, or
d >= 30). That is the subgradient of the plain oracles' `min` wherever the
minimum is unique; where two keys tie exactly, the oracle splits the
gradient between them and the routing gives all of it to one.

The key gradients are summed with `index_add_`, which on CUDA adds in an
order that changes from run to run: sums agree to f32 rounding (about 1e-6
relative), not bit for bit.

Under `torch.utils.checkpoint` the forwards run again in the backward
(and launch their kernels again); their results are the same.
"""

from __future__ import annotations

import torch

from cvpr2020_manet_tpu_torch.ops.global_matching_cuda import (
    global_matching_prepared_argmin, prepare_ref)
from cvpr2020_manet_tpu_torch.ops.local_matching_cuda import (
    local_matching_prepared_argmin, prepare_local)
from cvpr2020_manet_tpu_torch.ops.matching import acc_dtype


def _routed_grads(g: torch.Tensor, q32: torch.Tensor, k32: torch.Tensor,
                  amin: torch.Tensor, gate: torch.Tensor | None = None):
    """Gradients of sum(g * normalize(|q - k[amin]|^2)) for queries q32
    (N, C) and keys k32 (Nk, C), both in the distances' type (`acc_dtype`);
    amin (N, O) int, -1 = no winner; gate (N, O) bool or None: further
    winners to drop. -> (gq (N, C), gk (Nk, C)) in that type."""
    nk, c = k32.shape
    a = amin.long().clamp(0, nk - 1)
    diff = q32[:, None, :] - k32[a]                         # (N, O, C)
    d = diff.square().sum(-1)                               # (N, O)
    sig = torch.sigmoid(d)
    keep = (amin >= 0) & (d < 30.0)
    if gate is not None:
        keep = keep & gate
    gd = g.to(q32.dtype) * (2.0 * sig * (1.0 - sig)) * keep
    gq = (2.0 * diff * gd[..., None]).sum(1)
    # dropped winners add exact zeros to row 0 (clamped index)
    gk = torch.zeros((nk, c), dtype=k32.dtype, device=k32.device)
    gk.index_add_(0, a.reshape(-1),
                  (-2.0 * diff * gd[..., None]).reshape(-1, c))
    return gq, gk


class GlobalMatchingTrainable(torch.autograd.Function):
    """query (Nq, C), ref (Nk, C), ref_gate (Nk, O) -> normalized distances
    (Nq, O) f32, differentiable in query and ref. `ref_gate` is the
    reference one-hot times its validity (no gradient). `match` is the
    argmin matching to run (the CUDA-or-plain wrapper by default; a test
    or a check may pass the plain version)."""

    @staticmethod
    def forward(ctx, query, ref, ref_gate,
                match=global_matching_prepared_argmin):
        bucketed = prepare_ref(ref, ref_gate)
        out, amin_b = match(query, bucketed)
        # bucketed row -> source reference row (-1: none, or a padding row)
        amin = torch.where(amin_b >= 0,
                           bucketed.src_idx[amin_b.long().clamp(min=0)],
                           torch.full_like(amin_b, -1))
        ctx.save_for_backward(query, ref, amin)
        return out

    @staticmethod
    def backward(ctx, g):
        query, ref, amin = ctx.saved_tensors
        dt = acc_dtype(query)
        gq, gk = _routed_grads(g, query.to(dt), ref.to(dt), amin)
        return gq.to(query.dtype), gk.to(ref.dtype), None, None


class LocalMatchingTrainable(torch.autograd.Function):
    """query, prev (H, W, C), prev_onehot (H, W, O), window -> normalized
    distances (H, W, O) f32, differentiable in query and prev. A winner
    counts only if the previous mask gives it to the object (`on_obj`);
    prev_onehot and window get no gradient. `match` as in
    `GlobalMatchingTrainable`, on the prepared inputs."""

    @staticmethod
    def forward(ctx, query, prev, prev_onehot, window,
                match=local_matching_prepared_argmin):
        out, amin = match(*prepare_local(query, prev, prev_onehot), window)
        ctx.save_for_backward(query, prev, prev_onehot, amin)
        return out

    @staticmethod
    def backward(ctx, g):
        query, prev, prev_onehot, amin = ctx.saved_tensors
        h, w, c = query.shape
        o = amin.shape[-1]
        n = h * w
        af = amin.reshape(n, o)
        on_obj = prev_onehot.reshape(n, o).gather(
            0, af.long().clamp(0, n - 1)) > 0                  # (N, O)
        dt = acc_dtype(query)
        gq, gk = _routed_grads(g.reshape(n, o), query.to(dt).reshape(n, c),
                               prev.to(dt).reshape(n, c), af, on_obj)
        return (gq.reshape(h, w, c).to(query.dtype),
                gk.reshape(h, w, c).to(prev.dtype), None, None, None)
