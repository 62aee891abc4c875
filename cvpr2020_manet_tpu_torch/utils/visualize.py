"""Prediction / scribble visualization, PyTorch port of the JAX package's
`utils/visualize.py` (numpy only, so it works headless and without an
image library).

`overlay_masks` blends a label map over the frame with the DAVIS
palette; `draw_scribbles` rasterizes a protocol scribble payload's
polylines (the same Bresenham as the model-input rasterizer) in palette
colors. Both return uint8 images; `save_image` writes an RGB PNG
(`utils/colormap.save_rgb_png`, where JAX writes with PIL).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from cvpr2020_manet_tpu_torch.interactive.scribbles import (
    Scribbles, bresenham)
from cvpr2020_manet_tpu_torch.utils.colormap import (
    davis_palette, save_rgb_png)


def overlay_masks(image: np.ndarray, labels: np.ndarray,
                  alpha: float = 0.5) -> np.ndarray:
    """Blend a (H, W) label map over a (H, W, 3) uint8 frame.

    Background (label 0) keeps the frame; object pixels blend toward
    their DAVIS palette color with weight `alpha`.
    """
    image = np.asarray(image)
    labels = np.asarray(labels)
    if image.shape[:2] != labels.shape:
        raise ValueError(f"shape mismatch: {image.shape} vs {labels.shape}")
    colors = davis_palette()[np.clip(labels, 0, 255)]       # (H, W, 3)
    fg = (labels > 0)[..., None]
    out = np.where(fg, (1.0 - alpha) * image + alpha * colors, image)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def draw_scribbles(image: np.ndarray,
                   scribbles: Scribbles | Dict[str, Any],
                   frame: int, radius: int = 1) -> np.ndarray:
    """Draw one frame's scribble polylines onto a (H, W, 3) uint8 frame.

    Strokes use the object's DAVIS palette color; background strokes
    (object_id 0) use white. `radius` thickens strokes with a square
    dilation (same convention as scribbles2mask).
    """
    if isinstance(scribbles, dict):
        scribbles = Scribbles.from_json(scribbles)
    out = np.array(image, dtype=np.uint8, copy=True)
    h, w = out.shape[:2]
    palette = davis_palette()
    for line in scribbles.scribbles[frame]:
        path = np.asarray(line["path"], dtype=np.float64)
        if path.size == 0:
            continue
        obj = int(line["object_id"])
        color = palette[obj] if obj > 0 else np.array([255, 255, 255],
                                                      np.uint8)
        px = np.clip(np.round(path[:, 0] * (w - 1)), 0, w - 1)
        py = np.clip(np.round(path[:, 1] * (h - 1)), 0, h - 1)
        pts = [np.array([[px[0], py[0]]], np.int64)]
        for i in range(len(path) - 1):
            pts.append(bresenham((px[i], py[i]), (px[i + 1], py[i + 1])))
        pts = np.concatenate(pts, axis=0)
        if radius > 0:
            offs = np.stack(np.meshgrid(
                np.arange(-radius, radius + 1),
                np.arange(-radius, radius + 1)), -1).reshape(-1, 2)
            pts = (pts[:, None, :] + offs[None]).reshape(-1, 2)
        xs = np.clip(pts[:, 0], 0, w - 1)
        ys = np.clip(pts[:, 1], 0, h - 1)
        out[ys, xs] = color
    return out


def save_image(path: str, image: np.ndarray) -> None:
    """Write a (H, W, 3) uint8 image as PNG."""
    save_rgb_png(path, image)
