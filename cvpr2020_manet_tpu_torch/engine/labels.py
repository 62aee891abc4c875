"""How label maps leave the device, for the three serving engines.

- The interactive round (`engine/evaluator.py`) keeps its argmax labels
  unpacked on the device, crops them to the real frames and the image,
  repeats them by the mask stride and casts them to int32 there
  (`crop_labels`), then copies them into pinned host memory (`to_host`).
- The stream (`engine/streaming.py`) and the batch
  (`engine/propagate_batch.py`) bit-pack their labels on the device
  (`pack_labels`), hand the copy to the shared download pool
  (`FETCH_POOL`, `download`), so that it overlaps the next frames' device
  work, and unpack on the host (`unpack_labels`). The stream packs at the
  live label count, widened until a packed row is whole bytes
  (`aligned_mask_bits`); the batch packs at its object bucket
  (`bucket_mask_bits`).
"""

from __future__ import annotations

import concurrent.futures

import numpy as np
import torch

# One process-wide pool for mask downloads (threads start on first use).
FETCH_POOL = concurrent.futures.ThreadPoolExecutor(
    max_workers=4, thread_name_prefix="mask-fetch")


def pack_labels(lab, bits: int):
    """Bit-pack uint8 labels along the trailing (W) axis (torch or numpy):
    8 px/byte at 1 bit, 4 at 2 bits, 2 at 4 bits."""
    if bits == 1:
        acc = lab[..., 0::8]
        for i in range(1, 8):
            acc = acc | (lab[..., i::8] << i)
        return acc
    if bits == 2:
        return (lab[..., 0::4] | (lab[..., 1::4] << 2)
                | (lab[..., 2::4] << 4) | (lab[..., 3::4] << 6))
    if bits == 4:
        return lab[..., 0::2] | (lab[..., 1::2] << 4)
    return lab


def unpack_labels(packed: np.ndarray, bits: int) -> np.ndarray:
    """Inverse of `pack_labels`: (..., W // ppb) uint8 -> (..., W) uint8."""
    if bits == 8:
        return packed
    n = 8 // bits
    mask = (1 << bits) - 1
    out = np.empty((*packed.shape[:-1], packed.shape[-1] * n), np.uint8)
    for i in range(n):
        np.bitwise_and(packed >> (bits * i) if i else packed, mask,
                       out=out[..., i::n])
    return out


def mask_bits_for_labels(num_labels: int) -> int:
    """Bits/px for the LIVE label count of a sequence."""
    if num_labels <= 2:
        return 1
    if num_labels <= 4:
        return 2
    if num_labels <= 16:
        return 4
    return 8


def aligned_mask_bits(num_labels: int, w_pad: int) -> int:
    """mask_bits_for_labels widened until the packed W axis is whole-byte
    aligned (the strided pack slices need W % (8/bits) == 0)."""
    bits = mask_bits_for_labels(num_labels)
    while w_pad % (8 // bits):
        bits *= 2
    return bits


def bucket_mask_bits(o_bucket: int) -> int:
    """Bits per pixel of the packed masks of an object bucket (the batch
    engine packs at the bucket, not at the live label count)."""
    if o_bucket <= 4:
        return 2
    if o_bucket <= 16:
        return 4
    return 8


def download(t: torch.Tensor) -> np.ndarray:
    """`t` copied to the host as numpy (on `FETCH_POOL`'s threads)."""
    return t.cpu().numpy()


def to_host(t: torch.Tensor) -> torch.Tensor:
    """`t` on the host. A device tensor is copied into pinned memory from
    PyTorch's caching host allocator, whose blocks stay mapped and are
    reused once their holders drop them, and the copy is waited for; a
    host tensor is returned as it is."""
    if t.device.type == "cpu":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return out


def crop_labels(lab: torch.Tensor, image_hw: tuple[int, int],
                mask_stride: int) -> torch.Tensor:
    """(T, H_pad / mask_stride, W_pad / mask_stride) labels -> (T, H, W)
    int32, contiguous, on the labels' own device. The low-resolution
    labels are cropped to what covers the image and cast before the
    repeat."""
    ms = mask_stride
    h_img, w_img = image_hw
    h, w = -(-h_img // ms), -(-w_img // ms)
    lab = lab[:, :h, :w].to(torch.int32)
    if ms > 1:
        t, h, w = lab.shape
        lab = lab[:, :, None, :, None].expand(t, h, ms, w, ms).reshape(
            t, h * ms, w * ms)[:, :h_img, :w_img]
    return lab.contiguous()
