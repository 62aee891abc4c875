"""Pixel-wise semantic matching — plain PyTorch oracles.

A port of the JAX package's `ops/matching.py`: the straightforward
definitions that the CUDA kernels (`ops/global_matching_cuda.py`,
`ops/local_matching_cuda.py`) and their plain versions are held against.
The main path runs neither of these.

- Global matching: for every query pixel and object, the minimum squared
  L2 distance to the reference pixels labelled with that object; reference
  pixels of other labels (or padding) are pushed away by
  WRONG_LABEL_PADDING_DISTANCE. Chunked over reference pixels with a
  running min.
- Local matching: the same against the previous frame only, within a
  (2w+1)^2 window, gated by the previous frame's predicted labels.
- Distances are normalized to [0, 1) by d -> 1 - 2 / (1 + exp(d)).

Shapes use a trailing object axis O = max_objects + 1, background first.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Sentinel added to distances of wrong-label reference pixels; 1e8 (not
# 1e20) so it survives float32 addition without inf.
WRONG_LABEL_PADDING_DISTANCE = 1e8


def acc_dtype(t: torch.Tensor) -> torch.dtype:
    """The type distances are taken in: f32, or f64 for f64 inputs (the
    plain versions' finite-difference checks)."""
    return torch.promote_types(t.dtype, torch.float32)


def normalize_distance(d: torch.Tensor) -> torch.Tensor:
    """Map squared distances [0, inf) -> [0, 1); the sentinel saturates to
    exactly 1.0. Monotone, so min-fusion commutes with it."""
    return 1.0 - 2.0 / (1.0 + torch.exp(torch.clamp(d, max=30.0)))


def pairwise_sq_distances(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances between rows of q (Nq, C) and k (Nk, C), in f32."""
    q32, k32 = q.float(), k.float()
    qn = q32.square().sum(-1, keepdim=True)
    kn = k32.square().sum(-1, keepdim=True)
    return torch.clamp(qn + kn.T - 2.0 * (q32 @ k32.T), min=0.0)


def global_matching(query: torch.Tensor, ref: torch.Tensor,
                    ref_onehot: torch.Tensor,
                    ref_valid: torch.Tensor | None = None, *,
                    chunk: int = 1024, normalize: bool = True) -> torch.Tensor:
    """Per-object nearest-neighbour distance maps. query (Nq, C), ref
    (Nk, C), ref_onehot (Nk, O), ref_valid (Nk,) -> (Nq, O) f32. Objects
    with no reference pixels saturate at 1.0 when normalized."""
    nq = query.shape[0]
    nk, o = ref_onehot.shape
    gate = ref_onehot.float()
    if ref_valid is not None:
        gate = gate * ref_valid.float()[:, None]
    running = torch.full((nq, o), WRONG_LABEL_PADDING_DISTANCE,
                         dtype=torch.float32, device=query.device)
    for s in range(0, nk, chunk):
        d = pairwise_sq_distances(query, ref[s:s + chunk])      # (Nq, chunk)
        d_obj = d[:, :, None] + (1.0 - gate[s:s + chunk])[None] \
            * WRONG_LABEL_PADDING_DISTANCE
        running = torch.minimum(running, d_obj.amin(dim=1))
    running = torch.clamp(running, max=WRONG_LABEL_PADDING_DISTANCE)
    return normalize_distance(running) if normalize else running


def local_matching(query: torch.Tensor, prev: torch.Tensor,
                   prev_onehot: torch.Tensor, *, window: int = 15,
                   normalize: bool = True) -> torch.Tensor:
    """Windowed min-distance vs the previous frame. query, prev (H, W, C),
    prev_onehot (H, W, O) -> (H, W, O) f32:

      d(p, o) = min over |dy|,|dx| <= window of |e_t(p) - e_{t-1}(p + (dy, dx))|^2
                over previous-frame pixels predicted o.
    """
    h, w, _ = query.shape
    o = prev_onehot.shape[-1]
    q32 = query.float()
    pad = (0, 0, window, window, window, window)
    prev_pad = F.pad(prev.float(), pad)
    oh_pad = F.pad(prev_onehot.float(), pad)                # 0 on padding
    qn = q32.square().sum(-1)
    kn_pad = prev_pad.square().sum(-1)
    running = torch.full((h, w, o), WRONG_LABEL_PADDING_DISTANCE,
                         dtype=torch.float32, device=query.device)
    for dy in range(2 * window + 1):
        for dx in range(2 * window + 1):
            k = prev_pad[dy:dy + h, dx:dx + w]
            kn = kn_pad[dy:dy + h, dx:dx + w]
            m = oh_pad[dy:dy + h, dx:dx + w]
            cross = (q32 * k).sum(-1)
            d = torch.clamp(qn + kn - 2.0 * cross, min=0.0)
            d_obj = d[:, :, None] + (1.0 - m) * WRONG_LABEL_PADDING_DISTANCE
            running = torch.minimum(running, d_obj)
    running = torch.clamp(running, max=WRONG_LABEL_PADDING_DISTANCE)
    return normalize_distance(running) if normalize else running
