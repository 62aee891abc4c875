"""Synthetic tiny sequences — the CPU-runnable protocol fixture
(SURVEY.md §5c, BASELINE config 1: "2-frame, 1-object fake sequence").

Moving textured squares on a textured background: trivially matchable by
embeddings (even untrained encoders separate the textures), so protocol
and engine logic can be tested end-to-end without DAVIS data or training.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from cvpr2020_manet_tpu_torch.interactive.robot import InteractiveScribblesRobot
from cvpr2020_manet_tpu_torch.interactive.scribbles import Scribbles


class SyntheticDataset:
    """Dataset adapter with the interface the interactive session needs.

    sequences() / images(seq) / gt_masks(seq) / num_objects(seq) /
    initial_scribbles(seq, set_idx) — mirroring what the davisinteractive
    local service reads from the DAVIS tree.
    """

    def __init__(self, image_size=(32, 48), num_frames=4, num_sequences=2,
                 num_objects=2, scribble_sets=2, seed=0, entry_frames=None,
                 hidden_spans=None):
        """entry_frames: optional per-object first-visible frame index —
        objects entering mid-sequence can't be segmented from an earlier
        annotated frame, so multi-round correction (and the cross-round
        matching/MA memory retaining it) becomes structurally necessary.
        Late-appearing objects also exist in YouTube-VOS (SURVEY.md C12).

        hidden_spans: optional {object_idx: (start, end)} — the object is
        fully occluded (not drawn, label absent) for frames start <= f <
        end. Re-acquisition after the gap can't come from the previous
        frame (local matching and prev-mask see nothing): only the GLOBAL
        matching against the annotated frame / round memory (SURVEY.md
        C3/C8) recovers it — the classic VOS occlusion failure mode."""
        self.image_size = image_size
        self.num_frames = num_frames
        self.entry_frames = entry_frames or [0] * num_objects
        self.hidden_spans = dict(hidden_spans or {})
        self._names = [f"synth_{i:02d}" for i in range(num_sequences)]
        self._num_objects = num_objects
        self.scribble_sets = scribble_sets
        self._rng = np.random.default_rng(seed)
        self._robot = InteractiveScribblesRobot()
        self._cache: Dict[str, tuple] = {}
        for i, name in enumerate(self._names):
            self._cache[name] = self._make_sequence(seed + i)

    def _make_sequence(self, seed: int):
        h, w = self.image_size
        t, n_obj = self.num_frames, self._num_objects
        rng = np.random.default_rng(seed)
        # per-object texture + distinct background texture
        bg = 0.2 + 0.1 * rng.random((h, w, 3))
        images = np.empty((t, h, w, 3), np.float32)
        gt = np.zeros((t, h, w), np.int32)
        size = max(6, h // 4)
        tex = [0.5 + 0.5 * rng.random((size, size, 3)) for _ in range(n_obj)]
        starts = [(rng.integers(0, h - size - t * 2),
                   rng.integers(0, w - size - t * 2)) for _ in range(n_obj)]
        vels = [(rng.integers(0, 3), rng.integers(1, 3)) for _ in range(n_obj)]
        for f in range(t):
            img = bg.copy()
            for o in range(n_obj):
                if f < self.entry_frames[o]:
                    continue
                span = self.hidden_spans.get(o)
                if span is not None and span[0] <= f < span[1]:
                    continue
                y = int(starts[o][0] + vels[o][0] * f)
                x = int(starts[o][1] + vels[o][1] * f)
                img[y:y + size, x:x + size] = tex[o]
                gt[f, y:y + size, x:x + size] = o + 1
            images[f] = img
        return images, gt

    # ------------------------------------------------------------------ #

    def sequences(self) -> List[str]:
        return list(self._names)

    def images(self, seq: str) -> np.ndarray:
        return self._cache[seq][0]

    def gt_masks(self, seq: str) -> np.ndarray:
        return self._cache[seq][1]

    def num_objects(self, seq: str) -> int:
        return self._num_objects

    def num_scribble_sets(self, seq: str) -> int:
        return self.scribble_sets

    def initial_scribbles(self, seq: str, set_idx: int) -> Scribbles:
        """Initial human scribbles: robot vs an all-background prediction
        on a set-dependent frame (DAVIS ships 3 hand-drawn sets; here the
        robot plays the human)."""
        gt = self.gt_masks(seq)
        t = gt.shape[0]
        frame = (set_idx * (t // max(1, self.scribble_sets))) % t
        return self._robot.scribble_frame(
            np.zeros_like(gt[frame]), gt[frame], self._num_objects,
            frame, t, seq)
