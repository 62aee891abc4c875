"""Frame ingest: raw uint8 RGB and YUV 4:2:0, normalized on the device.

Port of the JAX package's `utils/ingest.py`, plus `preprocess_frames`
(`engine/propagate_batch.py` there). Raw bytes cross the host link (a
uint8 frame is a quarter of a float32 one; planar YUV 4:2:0, the format
video decoders emit, half of uint8 RGB), and the conversion to the
encoder's ImageNet-normalized f32 input runs on the device.

Conventions: full-range (JPEG / BT.601) YCbCr, an integer fixed-point
forward transform on the host, a float inverse on the device, chroma
subsampled by a 2x2 box average and upsampled by nearest neighbour.
"""

from __future__ import annotations

import numpy as np
import torch

from cvpr2020_manet_tpu_torch.data.davis import IMAGENET_MEAN, IMAGENET_STD


def rgb_to_yuv420_host(frames_u8: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(..., H, W, 3) uint8 RGB -> ((..., H, W) Y, (..., H/2, W/2, 2) UV),
    fixed-point BT.601 full range. H and W must be even."""
    h, w = frames_u8.shape[-3:-1]
    if h % 2 or w % 2:
        raise ValueError(f"YUV420 needs even dims, got {h}x{w}")
    rgb = frames_u8.astype(np.int32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = (77 * r + 150 * g + 29 * b + 128) >> 8
    # chroma from the 2x2 box-averaged RGB (decimate, then transform)
    r2, g2, b2 = _box2(r), _box2(g), _box2(b)
    u = ((-43 * r2 - 85 * g2 + 128 * b2 + 128) >> 8) + 128
    v = ((128 * r2 - 107 * g2 - 21 * b2 + 128) >> 8) + 128
    uv = np.stack([u, v], axis=-1)
    return (np.clip(y, 0, 255).astype(np.uint8),
            np.clip(uv, 0, 255).astype(np.uint8))


def _box2(c: np.ndarray) -> np.ndarray:
    """2x2 box average over the last two axes (int32 in and out)."""
    h, w = c.shape[-2:]
    c = c.reshape(*c.shape[:-2], h // 2, 2, w // 2, 2)
    return (c.sum(axis=(-3, -1)) + 2) >> 2


def yuv420_to_rgb(y_u8: torch.Tensor, uv_u8: torch.Tensor) -> torch.Tensor:
    """Y (..., H, W) + UV (..., H/2, W/2, 2) uint8 -> f32 RGB in [0, 255]
    (..., H, W, 3), with nearest chroma upsampling."""
    yf = y_u8.float()
    uvf = uv_u8.float() - 128.0
    uvf = uvf.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)
    u, v = uvf[..., 0], uvf[..., 1]
    r = yf + 1.402 * v
    g = yf - 0.344136 * u - 0.714136 * v
    b = yf + 1.772 * u
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0)


def _normalize(rgb255: torch.Tensor) -> torch.Tensor:
    x = rgb255 / 255.0
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def preprocess_frames(frames: torch.Tensor) -> torch.Tensor:
    """uint8 RGB (..., H, W, 3) -> ImageNet-normalized f32, on the frames'
    device."""
    return _normalize(frames.float())


def preprocess_yuv420(y_u8: torch.Tensor, uv_u8: torch.Tensor) -> torch.Tensor:
    """Planar YUV 4:2:0 -> ImageNet-normalized f32 RGB (..., H, W, 3)."""
    return _normalize(yuv420_to_rgb(y_u8, uv_u8))
