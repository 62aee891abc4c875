"""Ties of the local argmin, for tests/test_torch_matching.py and
tests/test_torch_kernels_cuda.py (it imports torch only, so the CUDA tests
can use it on a machine without JAX)."""

import torch


def local_ties(q, k, kno, window):
    """The plain version's candidates (-2 q.k + kno, in-image keys only)
    per (query, object) of prepared inputs, visited in ascending flat
    index from the 1e8 sentinel: -> (the best value, the lowest flat index
    that reaches it, -1 where none beats the sentinel, how many keys reach
    it, the smallest value above it minus the best)."""
    h, w, _ = q.shape
    pad = (0, 0, window, window, window, window)
    k_pad = torch.nn.functional.pad(k, pad)
    kno_pad = torch.nn.functional.pad(kno, pad, value=float("inf"))
    best = torch.full(kno.shape, 1e8, device=q.device)
    second = torch.full(kno.shape, float("inf"), device=q.device)
    first = torch.full(kno.shape, -1, dtype=torch.int32, device=q.device)
    count = torch.zeros(kno.shape, dtype=torch.int32, device=q.device)
    flat = torch.arange(h * w, dtype=torch.int32, device=q.device).reshape(
        h, w, 1)
    for dy in range(2 * window + 1):
        for dx in range(2 * window + 1):
            e = (-2.0 * (q * k_pad[dy:dy + h, dx:dx + w]).sum(-1))[..., None] \
                + kno_pad[dy:dy + h, dx:dx + w]
            lt, eq = e < best, e == best
            second = torch.where(lt, best, torch.where(
                eq, second, torch.minimum(second, e)))
            count = torch.where(lt, 1, torch.where(eq, count + 1, count))
            first = torch.where(lt, flat + (dy - window) * w + (dx - window),
                                first)
            best = torch.where(lt, e, best)
    return best, first, count, second - best
