"""Windowed local matching against the previous frame: the CUDA kernel and
its plain version.

Port of the JAX package's `ops/local_matching_pallas.py`
(`local_matching_pallas`). The inputs are prepared once per call as in the
JAX wrapper: query and previous-frame embeddings in f32 with channels
zero-padded to a multiple of 128, and the gated |k|^2 per object
(`kno`: |k|^2 on pixels the previous mask gives to the object, +1e8
elsewhere). The kernel (`csrc/local_matching.cu`, which replaces the TPU
kernel `local_matching_pallas.py::_kernel`) then returns

    normalize(clamp(|q|^2 + min over the window of (kno - 2 q.k), 0, 1e8))

`local_matching_prepared` launches it for CUDA tensors and runs the plain
version below for CPU tensors. There is no fallback between them.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from cvpr2020_manet_tpu_torch.kernels import build
from cvpr2020_manet_tpu_torch.ops.matching import (
    WRONG_LABEL_PADDING_DISTANCE, normalize_distance)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def prepare_local(query: torch.Tensor, prev: torch.Tensor,
                  prev_onehot: torch.Tensor):
    """-> (q (H, W, C_pad) f32, k (H, W, C_pad) f32, kno (H, W, O) f32)."""
    c = query.shape[-1]
    c_pad = _round_up(c, 128)
    q = F.pad(query.float(), (0, c_pad - c)).contiguous()
    k = F.pad(prev.float(), (0, c_pad - c)).contiguous()
    kn = prev.float().square().sum(-1)
    kno = kn[..., None] + (1.0 - prev_onehot.float()) \
        * WRONG_LABEL_PADDING_DISTANCE
    return q, k, kno.contiguous()


def local_matching_prepared_plain(q: torch.Tensor, k: torch.Tensor,
                                  kno: torch.Tensor, window: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: a loop over the (2w+1)^2 shifts
    of the previous frame, padded with zero embeddings and +1e8 gated norms
    outside the image. -> (H, W, O) f32."""
    h, w, _ = q.shape
    o = kno.shape[-1]
    pad = (0, 0, window, window, window, window)
    k_pad = F.pad(k, pad)
    kno_pad = F.pad(kno, pad, value=WRONG_LABEL_PADDING_DISTANCE)
    running = torch.full((h, w, o), WRONG_LABEL_PADDING_DISTANCE,
                         dtype=torch.float32, device=q.device)
    for dy in range(2 * window + 1):
        for dx in range(2 * window + 1):
            cross = (q * k_pad[dy:dy + h, dx:dx + w]).sum(-1)
            e = (-2.0 * cross)[..., None] + kno_pad[dy:dy + h, dx:dx + w]
            running = torch.minimum(running, e)
    qn = q.square().sum(-1, keepdim=True)
    d = torch.clamp(torch.clamp(running + qn, min=0.0),
                    max=WRONG_LABEL_PADDING_DISTANCE)
    return normalize_distance(d)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def local_matching_prepared(q: torch.Tensor, k: torch.Tensor,
                            kno: torch.Tensor, window: int) -> torch.Tensor:
    """Kernel on prepared inputs -> (H, W, O) f32. Launches the CUDA kernel
    for CUDA tensors; runs the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return local_matching_prepared_plain(q, k, kno, window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    h, w, c = q.shape
    o = kno.shape[-1]
    for name, t in (("q", q), ("k", k), ("kno", kno)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be f32, got {t.dtype}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if k.shape != q.shape or kno.shape != (h, w, o):
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, kno {tuple(kno.shape)}")
    if c % 128 or c > 512 or o > 32:
        raise ValueError(f"C={c} must be a multiple of 128 up to 512 and "
                         f"O={o} at most 32")
    out = torch.empty((h, w, o), dtype=torch.float32, device=q.device)
    fn = build.kernel_function("local_matching", "manet_local_matching",
                               _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), kno.data_ptr(), out.data_ptr(),
                 h, w, c, o, window,
                 torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch("local_matching", err)
    return out


def local_matching_cuda(query: torch.Tensor, prev: torch.Tensor,
                        prev_onehot: torch.Tensor, *,
                        window: int = 15) -> torch.Tensor:
    """Drop-in for ops.matching.local_matching. query, prev (H, W, C),
    prev_onehot (H, W, O) -> (H, W, O) f32."""
    return local_matching_prepared(*prepare_local(query, prev, prev_onehot),
                                   window)
