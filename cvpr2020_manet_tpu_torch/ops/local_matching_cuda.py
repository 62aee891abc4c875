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
version below for CPU tensors. There is no fallback between them. It goes
through the custom op `torch.ops.manet.local_matching` (CUDA registration
the kernel, CPU registration the plain version, a fake implementation
for `torch.export`). The
kernel tiles the frame into patches of query rows and forms the cross
terms on the TF32 tensor cores in 3xTF32 (f32 accuracy); it takes windows
up to `LOCAL_WINDOW_MAX`.

`local_matching_argmin` does the same with the kernel's argmin variant
(which replaces `local_matching_pallas.py::_kernel_argmin`; the same
template with an argmin epilogue, and the same window limit): it also
returns the flat index into the (H*W) previous frame of each minimum's key,
for the training path's argmin-routed backward (`ops/trainable.py`). Only
in-image keys compete, in both versions, the lowest flat index wins ties,
and the index is -1 where none beats the 1e8 sentinel. Where a key of the
object lies in the window the winner is that object's nearest key, as on
the TPU; elsewhere (no key of the object in the window) the TPU kernel may
name another pixel or a padding key, but the output is 1.0 and the routed
gradient 0 either way.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from cvpr2020_manet_tpu_torch.device import sm_count
from cvpr2020_manet_tpu_torch.kernels import build
from cvpr2020_manet_tpu_torch.ops.matching import (
    WRONG_LABEL_PADDING_DISTANCE, acc_dtype, normalize_distance)


# The widest window of kernels 2 and 5: a patch row's 16 + 2w keys take 4
# warps of 3 n8 tiles, whose patches fit a block at every C and O taken
# here.
LOCAL_WINDOW_MAX = 40
# Query rows of an argmin patch, the most first (csrc/local_matching.cu).
ARGMIN_PATCH_ROWS = (4, 2, 1)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def prepare_local(query: torch.Tensor, prev: torch.Tensor,
                  prev_onehot: torch.Tensor):
    """-> (q (H, W, C_pad), k (H, W, C_pad), kno (H, W, O)), in f32 (f64
    for f64 inputs, which only the plain version takes)."""
    c = query.shape[-1]
    c_pad = _round_up(c, 128)
    dt = acc_dtype(query)
    q = F.pad(query.to(dt), (0, c_pad - c)).contiguous()
    k = F.pad(prev.to(dt), (0, c_pad - c)).contiguous()
    kn = prev.to(dt).square().sum(-1)
    kno = kn[..., None] + (1.0 - prev_onehot.to(dt)) \
        * WRONG_LABEL_PADDING_DISTANCE
    return q, k, kno.contiguous()


def _plain(q: torch.Tensor, k: torch.Tensor, kno: torch.Tensor, window: int,
           argmin: bool):
    """Both plain versions: a loop over the (2w+1)^2 shifts of the previous
    frame in raster order, padded with zero embeddings outside the image
    and gated norms of +1e8 (+inf with `argmin`, so that only in-image keys
    can win; the distances are the same, since a window always holds its
    own pixel). A shift replaces the running minimum only when it is
    smaller, so the lowest flat index wins ties, as in the kernels."""
    h, w, _ = q.shape
    o = kno.shape[-1]
    pad = (0, 0, window, window, window, window)
    k_pad = F.pad(k, pad)
    kno_pad = F.pad(kno, pad, value=float("inf") if argmin
                    else WRONG_LABEL_PADDING_DISTANCE)
    running = torch.full((h, w, o), WRONG_LABEL_PADDING_DISTANCE,
                         dtype=q.dtype, device=q.device)
    idx = torch.full((h, w, o), -1, dtype=torch.int32, device=q.device)
    flat = torch.arange(h * w, dtype=torch.int32, device=q.device).reshape(
        h, w, 1)
    for dy in range(2 * window + 1):
        for dx in range(2 * window + 1):
            cross = (q * k_pad[dy:dy + h, dx:dx + w]).sum(-1)
            e = (-2.0 * cross)[..., None] + kno_pad[dy:dy + h, dx:dx + w]
            if argmin:
                better = e < running
                running = torch.where(better, e, running)
                # flat index of key (y + dy - w, x + dx - w)
                idx = torch.where(better, flat + (dy - window) * w
                                  + (dx - window), idx)
            else:
                running = torch.minimum(running, e)
    qn = q.square().sum(-1, keepdim=True)
    d = torch.clamp(torch.clamp(running + qn, min=0.0),
                    max=WRONG_LABEL_PADDING_DISTANCE)
    return normalize_distance(d), idx


def local_matching_prepared_plain(q: torch.Tensor, k: torch.Tensor,
                                  kno: torch.Tensor, window: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel. -> (H, W, O) f32."""
    return _plain(q, k, kno, window, argmin=False)[0]


def local_matching_prepared_argmin_plain(q: torch.Tensor, k: torch.Tensor,
                                         kno: torch.Tensor, window: int):
    """Plain PyTorch version of the argmin kernel. -> (distances (H, W, O)
    f32, flat key indices (H, W, O) int32)."""
    return _plain(q, k, kno, window, argmin=True)


def _check(q: torch.Tensor, k: torch.Tensor, kno: torch.Tensor,
           window: int) -> None:
    """What the kernels take: f32, contiguous and 16-byte aligned on one
    CUDA device, matching shapes, C a multiple of 128 up to 512, O <= 32,
    and a window up to LOCAL_WINDOW_MAX."""
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
    if window < 0 or window > LOCAL_WINDOW_MAX:
        raise ValueError(f"window {window}: 0 to {LOCAL_WINDOW_MAX}")


# q, k, kno, out[, idx]; h, w, c, o, window[, rows]; stream
_ARGTYPES = {argmin: [ctypes.c_void_p] * (5 if argmin else 4)
             + [ctypes.c_int] * (6 if argmin else 5) + [ctypes.c_void_p]
             for argmin in (False, True)}


def argmin_patch_rows(h: int, w: int, sms: int) -> int:
    """Query rows of kernel 5's patches: the fewest of ARGMIN_PATCH_ROWS
    whose (column tiles x row patches) grid still has at most one block
    per SM, else the most (blocks that share an SM run unevenly, and a
    patch of fewer rows reads the same key rows for fewer queries). A
    training crop's 52 x 52 takes 2 rows: 104 blocks for 132 SMs."""
    for rows in sorted(ARGMIN_PATCH_ROWS):
        if -(-w // 16) * -(-h // rows) <= sms:
            return rows
    return max(ARGMIN_PATCH_ROWS)


def _launch(q: torch.Tensor, k: torch.Tensor, kno: torch.Tensor, window: int,
            argmin: bool, rows: int | None = None):
    """Check CUDA inputs and launch the kernel (or its argmin variant, on
    patches of `rows` query rows, by default `argmin_patch_rows`'s; every
    choice gives the same bits). -> (out, idx), idx None without
    `argmin`."""
    _check(q, k, kno, window)
    if argmin and rows is None:
        rows = argmin_patch_rows(q.shape[0], q.shape[1], sm_count(q.device))
    h, w, c = q.shape
    o = kno.shape[-1]
    out = torch.empty((h, w, o), dtype=torch.float32, device=q.device)
    idx = (torch.empty((h, w, o), dtype=torch.int32, device=q.device)
           if argmin else None)
    name = "local_matching_argmin" if argmin else "local_matching"
    fn = build.kernel_function(name, f"manet_{name}", _ARGTYPES[argmin])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), kno.data_ptr(), out.data_ptr(),
                 *([idx.data_ptr()] if argmin else []), h, w, c, o, window,
                 *([rows] if argmin else []),
                 torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(name, err)
    return out, idx


# Kernel 2 as a custom op of the `manet` namespace, registered as kernels
# 1 and 3 are (ops/global_matching_cuda.py): CUDA the kernel, CPU the
# plain version, a fake implementation for torch.export.
_LIB = torch.library.Library("manet", "FRAGMENT")
_LIB.define("local_matching(Tensor q, Tensor k, Tensor kno, int window) "
            "-> Tensor")


def _local_matching_cuda(q, k, kno, window):
    return _launch(q, k, kno, window, argmin=False)[0]


@torch.library.register_fake("manet::local_matching", lib=_LIB)
def _local_matching_fake(q, k, kno, window):
    return q.new_empty((*q.shape[:2], kno.shape[-1]), dtype=acc_dtype(q))


_LIB.impl("local_matching", local_matching_prepared_plain, "CPU")
_LIB.impl("local_matching", _local_matching_cuda, "CUDA")


def local_matching_prepared(q: torch.Tensor, k: torch.Tensor,
                            kno: torch.Tensor, window: int) -> torch.Tensor:
    """Kernel on prepared inputs -> (H, W, O) f32. Launches the CUDA kernel
    for CUDA tensors; runs the plain version for CPU tensors
    (`torch.ops.manet.local_matching`)."""
    return torch.ops.manet.local_matching(q, k, kno, window)


def local_matching_prepared_argmin(q: torch.Tensor, k: torch.Tensor,
                                   kno: torch.Tensor, window: int):
    """Argmin kernel on prepared inputs -> (distances (H, W, O) f32, flat
    key indices (H, W, O) int32). Launches the CUDA kernel for CUDA
    tensors; runs the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return local_matching_prepared_argmin_plain(q, k, kno, window)
    return _launch(q, k, kno, window, argmin=True)


def local_matching_cuda(query: torch.Tensor, prev: torch.Tensor,
                        prev_onehot: torch.Tensor, *,
                        window: int = 15) -> torch.Tensor:
    """Drop-in for ops.matching.local_matching. query, prev (H, W, C),
    prev_onehot (H, W, O) -> (H, W, O) f32."""
    return local_matching_prepared(*prepare_local(query, prev, prev_onehot),
                                   window)


def local_matching_argmin(query: torch.Tensor, prev: torch.Tensor,
                          prev_onehot: torch.Tensor, window: int = 15):
    """Local matching plus winners. query, prev (H, W, C), prev_onehot
    (H, W, O) -> (normalized distances (H, W, O) f32, flat index into the
    (H*W) previous frame of each minimum's key (H, W, O) int32)."""
    return local_matching_prepared_argmin(
        *prepare_local(query, prev, prev_onehot), window)
