"""DAVIS dataset adapter (SURVEY.md C12), PyTorch port of the JAX
package's `data/davis.py`.

Standard DAVIS-2017 tree:
    DAVIS/
      JPEGImages/480p/<seq>/00000.jpg ...
      Annotations/480p/<seq>/00000.png ...      (palettized label maps)
      ImageSets/2017/{train,val}.txt
      Scribbles/<seq>/001.json ... 003.json     (interactive challenge)

Two adapters:
- `DavisEvalDataset`: the interface `InteractiveSession` consumes
  (sequences / images / gt_masks / num_objects / initial_scribbles), plus
  the frame-subset accessors of the training sampler (`ClipFrames`).
- `DavisTrainDataset`: the stage-1/2 clip sampler with joint augmentation
  (random scale, crop, horizontal flip), emitting the {'images', 'labels',
  'obj_valid', 'frame_valid'} batches the trainers take.

Frames decode with the port's own JPEG decoder (`native/image.py`) and
label maps with its PNG reader (`utils/colormap.py`), both bit-equal to
PIL's; the sampler resizes with the port's copy of PIL's uint8 resize
(`native/resize.cpp`), bit-equal too. The eval path keeps JAX's
per-sequence LRU caches. The sampler decodes only the frames it takes:
JAX's decodes the whole sequence to take 3 of its ~70 frames, and returns
the same arrays.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, List, Sequence

import numpy as np

from cvpr2020_manet_tpu_torch.interactive.scribbles import Scribbles
from cvpr2020_manet_tpu_torch.native.image import (
    read_jpeg, resize_bilinear, resize_nearest)
from cvpr2020_manet_tpu_torch.utils.colormap import load_indexed_png

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_image(img: np.ndarray) -> np.ndarray:
    """[0,1] float RGB -> ImageNet-normalized (reference transform C14)."""
    return (img - IMAGENET_MEAN) / IMAGENET_STD


class ClipFrames:
    """The training sampler's accessors, over an adapter's sorted frame
    files (`_frame_files(seq, kind, ext)`): the frame count and a subset of
    frames, each decoded once however often `idx` repeats it."""

    def _frame_files(self, seq: str, kind: str, ext: str) -> List[str]:
        raise NotImplementedError

    def num_frames(self, seq: str) -> int:
        """Annotated frames of `seq` (the sampler's T, as JAX's
        `gt_masks(seq).shape[0]`)."""
        return len(self._frame_files(seq, "Annotations", ".png"))

    def frames_uint8(self, seq: str, idx: Sequence[int]) -> np.ndarray:
        """Raw (len(idx), H, W, 3) uint8 frames `idx` of `seq`."""
        files = self._frame_files(seq, "JPEGImages", ".jpg")
        return _decode_each(idx, lambda i: read_jpeg(files[i]))

    def gt_masks_at(self, seq: str, idx: Sequence[int]) -> np.ndarray:
        """(len(idx), H, W) label maps of the frames `idx` of `seq`."""
        files = self._frame_files(seq, "Annotations", ".png")
        return _decode_each(idx, lambda i: load_indexed_png(files[i]))


def _decode_each(idx: Sequence[int], read) -> np.ndarray:
    uniq, inverse = np.unique(np.asarray(idx, np.int64), return_inverse=True)
    return np.stack([read(int(i)) for i in uniq])[inverse.reshape(-1)]


class DavisEvalDataset(ClipFrames):
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


class DavisTrainDataset:
    """Clip sampler with joint augmentation for stage-1/2 training, the
    JAX package's `DavisTrainDataset` draw for draw and array for array.

    Works over any adapter with the eval interface's `sequences()` and the
    `ClipFrames` accessors: pass `adapter=` for non-DAVIS sources (e.g.
    `data/ytvos.YTVOSDataset`).
    """

    def __init__(self, root: str = "", cfg=None, subset: str = "train",
                 year: str = "2017", clip_len: int = 3, seed: int = 0,
                 adapter=None, emit_uint8: bool = False,
                 shard: tuple[int, int] | None = None):
        """shard=(index, count): sample only the sequences [index::count],
        a disjoint per-rank split (the loader shards by clip index
        instead)."""
        self.eval_ds = adapter if adapter is not None else DavisEvalDataset(
            root, subset=subset, year=year)
        self.cfg = cfg
        self.clip_len = clip_len
        self.emit_uint8 = emit_uint8
        self._rng = np.random.default_rng(seed)
        self._shard = shard
        if shard is not None:
            index, count = shard
            if not 0 <= index < count:
                raise ValueError(f"bad shard {shard}")
            if len(self.eval_ds.sequences()[index::count]) == 0:
                raise ValueError(
                    f"shard {shard} is empty: only "
                    f"{len(self.eval_ds.sequences())} sequences")

    def _augment(self, images: np.ndarray, labels: np.ndarray,
                 rng: np.random.Generator | None = None):
        """Joint random scale / crop / hflip over a clip.

        images (T, H, W, 3) uint8, labels (T, H, W). JAX resizes the whole
        frame with PIL and crops it; the port draws the crop first (the
        resize draws nothing) and resizes only the crop, the same bits.
        JAX starts from normalized floats and rounds them back to bytes,
        which is the identity on every byte, so the port starts from the
        bytes. Returns uint8 images when `emit_uint8` (the trainers'
        `ingest_batch` normalizes on the device), else normalized f32;
        int32 labels.
        """
        ch, cw = self.cfg.train.crop_size
        t, h, w = labels.shape
        if rng is None:
            rng = self._rng
        scale = rng.uniform(0.75, 1.25)
        sh, sw = max(ch, int(h * scale)), max(cw, int(w * scale))
        y0 = rng.integers(0, sh - ch + 1)
        x0 = rng.integers(0, sw - cw + 1)
        window = (y0, x0, ch, cw)
        imgs = resize_bilinear(images, (sh, sw), window)
        labs = resize_nearest(labels.astype(np.uint8), (sh, sw),
                              window).astype(np.int32)
        if rng.random() < 0.5:
            imgs = imgs[:, :, ::-1].copy()
            labs = labs[:, :, ::-1].copy()
        if self.emit_uint8:
            return imgs, labs
        return normalize_image(imgs.astype(np.float32) / 255.0), labs

    def sample_clip(self, rng: np.random.Generator | None = None
                    ) -> Dict[str, np.ndarray]:
        """One clip with remapped compact object ids.

        Pass `rng` for deterministic per-index sampling (the loader).
        clip_len 3 on a sequence of 2+ frames is a (reference, previous,
        current) triplet; otherwise `clip_len` distinct frames in order,
        a sequence shorter than that padded by repeating its last frame,
        with `frame_valid` marking the real ones (padded frames carry no
        loss).
        """
        if rng is None:
            rng = self._rng
        o_max = self.cfg.model.max_objects
        seqs = self.eval_ds.sequences()
        if self._shard is not None:
            seqs = seqs[self._shard[0]::self._shard[1]]
        seq = seqs[rng.integers(len(seqs))]
        t = self.eval_ds.num_frames(seq)
        frame_valid = np.ones((self.clip_len,), np.float32)
        if self.clip_len == 3 and t >= 2:
            # reference frame + a consecutive (prev, cur) pair elsewhere
            ref = int(rng.integers(t))
            cur = int(rng.integers(1, t))
            idx = [ref, cur - 1, cur]
        else:
            n_real = min(t, self.clip_len)
            idx = sorted(rng.choice(t, n_real, replace=False))
            idx = list(idx) + [idx[-1]] * (self.clip_len - n_real)
            frame_valid[n_real:] = 0.0
        gt = self.eval_ds.gt_masks_at(seq, idx)
        images, labels = self._augment(self.eval_ds.frames_uint8(seq, idx),
                                       gt, rng)
        # compact remap of the object ids present in the clip, capped at
        # O; sized from the clip's frames, which hold every id of the crop
        # (JAX sizes it from the whole sequence: the same map)
        present = np.unique(labels)
        present = present[present > 0][:o_max]
        remap = np.zeros(int(gt.max()) + 1, np.int32)
        for new, old in enumerate(present, start=1):
            remap[old] = new
        labels = remap[labels]
        obj_valid = np.zeros((o_max + 1,), np.float32)
        obj_valid[:len(present) + 1] = 1.0
        if self.emit_uint8:
            labels = labels.astype(np.uint8)
        else:
            images = images.astype(np.float32)
        return {"images": images, "labels": labels,
                "obj_valid": obj_valid, "frame_valid": frame_valid}

    def batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        samples = [self.sample_clip() for _ in range(batch_size)]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
