"""YouTube-VOS dataset adapter, PyTorch port of the JAX package's
`data/ytvos.py` (the reference family pretrains stage 1 on YouTube-VOS).

Standard YouTube-VOS tree:
    train/
      JPEGImages/<seq>/00000.jpg ... (5-digit, every 5th frame)
      Annotations/<seq>/00000.png    (palettized label maps)
      meta.json                      {"videos": {seq: {"objects": {...}}}}

Exposes the eval-style interface of `DavisEvalDataset` and its frame-subset
accessors (`ClipFrames`), so that the clip sampler
(`data/davis.DavisTrainDataset(adapter=...)`) and the batch propagator take
it unchanged. JPEGs decode with the port's baseline decoder
(`native/image.read_jpeg`: a progressive file raises with its path), PNGs
with `utils/colormap.load_indexed_png`.
"""

from __future__ import annotations

import functools
import json
import os
from typing import List

import numpy as np

from cvpr2020_manet_tpu_torch.data.davis import ClipFrames, normalize_image
from cvpr2020_manet_tpu_torch.native.image import read_jpeg
from cvpr2020_manet_tpu_torch.utils.colormap import load_indexed_png


class YTVOSDataset(ClipFrames):
    def __init__(self, root: str, split: str = "train"):
        self.root = os.path.join(root, split)
        meta_path = os.path.join(self.root, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                self._meta = json.load(f)["videos"]
            self._names = sorted(self._meta)
        else:
            self._meta = None
            self._names = sorted(os.listdir(
                os.path.join(self.root, "JPEGImages")))

    def sequences(self) -> List[str]:
        return list(self._names)

    def _frame_files(self, seq: str, kind: str, ext: str) -> List[str]:
        d = os.path.join(self.root, kind, seq)
        return sorted(os.path.join(d, f) for f in os.listdir(d)
                      if f.endswith(ext))

    @functools.lru_cache(maxsize=2)
    def images(self, seq: str) -> np.ndarray:
        """ImageNet-normalized (T, H, W, 3) float32, in JAX's order of
        operations (bit for bit)."""
        frames = [np.asarray(read_jpeg(f), np.float32) / 255.0
                  for f in self._frame_files(seq, "JPEGImages", ".jpg")]
        return normalize_image(np.stack(frames))

    @functools.lru_cache(maxsize=2)
    def gt_masks(self, seq: str) -> np.ndarray:
        return np.stack([load_indexed_png(f) for f in
                         self._frame_files(seq, "Annotations", ".png")])

    def num_objects(self, seq: str) -> int:
        if self._meta is not None:
            return len(self._meta[seq]["objects"])
        return int(self.gt_masks(seq).max())
