"""`davisinteractive.utils.visualization`: scribble drawing.

`plot_scribble` draws one frame's scribble polylines on the caller's
matplotlib axes, colored per object; this module imports no matplotlib.
`draw_scribble` draws them into an RGB image array (`utils/visualize.py`
of the port).
"""

from typing import Any, Dict, Optional, Tuple

import numpy as np

from cvpr2020_manet_tpu_torch.interactive.scribbles import Scribbles
from cvpr2020_manet_tpu_torch.native.image import resize_bilinear
from cvpr2020_manet_tpu_torch.utils.colormap import davis_palette
from cvpr2020_manet_tpu_torch.utils.visualize import draw_scribbles

__all__ = ["plot_scribble", "draw_scribble"]


def draw_scribble(img: np.ndarray, scribble, frame: int,
                  output_size: Optional[Tuple[int, int]] = None,
                  width: int = 3) -> np.ndarray:
    """Draw one frame's strokes onto an RGB image array (the image-space
    counterpart of `plot_scribble`).

    `output_size=(H, W)` resizes the canvas first (PIL's uint8 BILINEAR,
    bit for bit, through `native/image.resize_bilinear`); `width` is the
    stroke thickness in pixels. Returns a new uint8 array."""
    img = np.asarray(img).astype(np.uint8)
    if output_size is not None and tuple(img.shape[:2]) != tuple(output_size):
        img = resize_bilinear(img, output_size)
    return draw_scribbles(img, scribble, frame,
                          radius=max(0, (int(width) - 1) // 2))


def plot_scribble(ax, scribble, frame: int,
                  output_size: Optional[Tuple[int, int]] = None,
                  **line_kwargs):
    """Plot a scribble payload's `frame` on matplotlib axes `ax`.

    Path coordinates are normalized [0, 1]; with `output_size=(H, W)`
    they scale to pixel coordinates (as in `scribbles2mask`), which line
    up with an `ax.imshow(frame_image)` underneath. Extra kwargs pass
    through to `ax.plot`. Returns `ax`.
    """
    sc: Dict[str, Any] = (scribble.to_json()
                          if isinstance(scribble, Scribbles) else scribble)
    palette = davis_palette().astype(np.float64) / 255.0
    for line in sc["scribbles"][frame]:
        path = np.asarray(line["path"], dtype=np.float64)
        if path.size == 0:
            continue
        x, y = path[:, 0], path[:, 1]
        if output_size is not None:
            h, w = output_size
            x, y = x * (w - 1), y * (h - 1)
        obj = int(line["object_id"])
        color = palette[obj] if obj > 0 else (1.0, 1.0, 1.0)
        ax.plot(x, y, color=tuple(color), **line_kwargs)
    return ax
