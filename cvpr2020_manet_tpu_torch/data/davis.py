"""DAVIS dataset adapter (SURVEY.md C12), PyTorch port of the JAX
package's `data/davis.py`.

Standard DAVIS-2017 tree:
    DAVIS/
      JPEGImages/480p/<seq>/00000.jpg ...
      Annotations/480p/<seq>/00000.png ...      (palettized label maps)
      ImageSets/2017/{train,val}.txt
      Scribbles/<seq>/001.json ... 003.json     (interactive challenge)

`DavisEvalDataset` is the interface `InteractiveSession` consumes
(sequences / images / gt_masks / num_objects / initial_scribbles). Frames
decode with the port's own JPEG decoder (`native/image.py`) and label maps
with its PNG reader (`utils/colormap.py`), both bit-equal to PIL's; per
sequence LRU caches as in JAX. The training clip sampler is not ported
yet.
"""

from __future__ import annotations

import functools
import json
import os
from typing import List

import numpy as np

from cvpr2020_manet_tpu_torch.interactive.scribbles import Scribbles
from cvpr2020_manet_tpu_torch.native.image import read_jpeg
from cvpr2020_manet_tpu_torch.utils.colormap import load_indexed_png

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_image(img: np.ndarray) -> np.ndarray:
    """[0,1] float RGB -> ImageNet-normalized (reference transform C14)."""
    return (img - IMAGENET_MEAN) / IMAGENET_STD


class DavisEvalDataset:
    """Interactive-evaluation adapter over a DAVIS tree."""

    def __init__(self, root: str, subset: str = "val", year: str = "2017",
                 resolution: str = "480p", scribble_sets: int = 3):
        self.root = root
        self.resolution = resolution
        self.scribble_sets = scribble_sets
        split = os.path.join(root, "ImageSets", year, f"{subset}.txt")
        with open(split) as f:
            self._names = [ln.strip() for ln in f if ln.strip()]

    def sequences(self) -> List[str]:
        return list(self._names)

    def _frame_files(self, seq: str, kind: str, ext: str) -> List[str]:
        d = os.path.join(self.root, kind, self.resolution, seq)
        return sorted(os.path.join(d, f) for f in os.listdir(d)
                      if f.endswith(ext))

    @functools.lru_cache(maxsize=4)
    def images(self, seq: str) -> np.ndarray:
        """ImageNet-normalized (T, H, W, 3) float32, in JAX's order of
        operations (bit for bit)."""
        files = self._frame_files(seq, "JPEGImages", ".jpg")
        frames = [np.asarray(read_jpeg(f), np.float32) / 255.0
                  for f in files]
        return normalize_image(np.stack(frames))

    @functools.lru_cache(maxsize=2)
    def images_uint8(self, seq: str) -> np.ndarray:
        """Raw (T, H, W, 3) uint8 frames, which the evaluator normalizes on
        the device: a quarter of the bytes and of the host memory of
        `images()`."""
        files = self._frame_files(seq, "JPEGImages", ".jpg")
        return np.stack([read_jpeg(f) for f in files])

    @functools.lru_cache(maxsize=4)
    def gt_masks(self, seq: str) -> np.ndarray:
        files = self._frame_files(seq, "Annotations", ".png")
        return np.stack([load_indexed_png(f) for f in files])

    def num_objects(self, seq: str) -> int:
        # max over ALL frames (an object absent from frame 0 still counts),
        # memoized per instance: an lru_cache on the method would pin
        # `self` and its cached frames for the process's life, and a miss
        # of the 4-sequence gt_masks LRU would re-decode every PNG
        cache = self.__dict__.setdefault("_num_objects_cache", {})
        if seq not in cache:
            cache[seq] = int(self.gt_masks(seq).max())
        return cache[seq]

    def num_scribble_sets(self, seq: str) -> int:
        return self.scribble_sets

    def initial_scribbles(self, seq: str, set_idx: int) -> Scribbles:
        path = os.path.join(self.root, "Scribbles", seq,
                            f"{set_idx + 1:03d}.json")
        with open(path) as f:
            return Scribbles.from_json(json.load(f))
