"""`davisinteractive.dataset`: the `Davis` handle over a DAVIS tree.

Upstream code calls it directly (e.g. `Davis(davis_root).load_scribble(
seq, 1)`). Upstream ships a static metadata table of the official 2017
sequences; a handle over a tree cannot know sequences it has not seen, so
the subsets and each sequence's metadata are read lazily from the tree
(ImageSets/<year>/*.txt, JPEGImages, Annotations, Scribbles). Label maps
are read with the port's PNG reader (`utils/colormap.py`) and frames with
its JPEG decoder (`native/image.py`), which is bit-equal to PIL's.
"""

import json
import os
from typing import Dict, List, Optional

import numpy as np

from cvpr2020_manet_tpu_torch.native.image import read_jpeg
from cvpr2020_manet_tpu_torch.utils.colormap import load_indexed_png

__all__ = ["Davis"]


class Davis:
    ANNOTATIONS_SUBDIR = "Annotations"
    SCRIBBLES_SUBDIR = "Scribbles"
    RESOLUTION = "480p"

    def __init__(self, davis_root: Optional[str] = None,
                 year: str = "2017"):
        if davis_root is None:
            davis_root = os.environ.get("DATASET_DAVIS")
        if davis_root is None:
            raise ValueError(
                "Davis root dir not specified: pass davis_root= or set "
                "the DATASET_DAVIS environment variable")
        self.davis_root = davis_root
        self.year = year
        self._sets: Optional[Dict[str, List[str]]] = None
        self._meta: Dict[str, Dict] = {}

    # -- subsets -------------------------------------------------------- #

    @property
    def sets(self) -> Dict[str, List[str]]:
        """subset name -> sequence list, from ImageSets/<year>/*.txt."""
        if self._sets is None:
            d = os.path.join(self.davis_root, "ImageSets", self.year)
            sets = {}
            for f in sorted(os.listdir(d)):
                if f.endswith(".txt"):
                    with open(os.path.join(d, f)) as fh:
                        sets[f[:-4]] = [ln.strip() for ln in fh
                                        if ln.strip()]
            self._sets = sets
        return self._sets

    def _sequence_dir(self, kind: str, sequence: str) -> str:
        return os.path.join(self.davis_root, kind, self.RESOLUTION, sequence)

    def _files(self, kind: str, sequence: str, ext: str) -> List[str]:
        d = self._sequence_dir(kind, sequence)
        return sorted(os.path.join(d, f) for f in os.listdir(d)
                      if f.endswith(ext))

    # -- metadata ------------------------------------------------------- #

    def sequence_metadata(self, sequence: str) -> Dict:
        """{'num_frames', 'num_scribbles', 'num_objects', 'image_size'},
        read from the tree once per sequence: the frame and scribble
        counts from the directory listings, the object count from the
        annotation PNGs one at a time (objects can enter mid-video)."""
        if sequence not in self._meta:
            files = self._files(self.ANNOTATIONS_SUBDIR, sequence, ".png")
            num_objects, size = 0, None
            for f in files:
                ann = load_indexed_png(f)
                num_objects = max(num_objects, int(ann.max()))
                size = size or (int(ann.shape[1]), int(ann.shape[0]))
            scr_dir = os.path.join(self.davis_root, self.SCRIBBLES_SUBDIR,
                                   sequence)
            num_scribbles = len([f for f in os.listdir(scr_dir)
                                 if f.endswith(".json")]) \
                if os.path.isdir(scr_dir) else 0
            self._meta[sequence] = {
                "num_frames": len(files),
                "num_scribbles": num_scribbles,
                "num_objects": num_objects,
                "image_size": size,
            }
        return dict(self._meta[sequence])

    @property
    def dataset(self) -> Dict[str, Dict]:
        """sequence -> metadata for every sequence in every subset."""
        return {s: self.sequence_metadata(s)
                for seqs in self.sets.values() for s in seqs}

    # -- file checks ---------------------------------------------------- #

    def check_files(self, sequences: Optional[List[str]] = None) -> None:
        """Raise FileNotFoundError on the first missing piece."""
        if sequences is None:
            sequences = [s for seqs in self.sets.values() for s in seqs]
        for seq in sequences:
            for kind, ext in (("JPEGImages", ".jpg"),
                              (self.ANNOTATIONS_SUBDIR, ".png")):
                d = self._sequence_dir(kind, seq)
                if not os.path.isdir(d) or not any(
                        f.endswith(ext) for f in os.listdir(d)):
                    raise FileNotFoundError(
                        f"sequence {seq}: no {ext} files under {d}")
            scr = os.path.join(self.davis_root, self.SCRIBBLES_SUBDIR,
                               seq, "001.json")
            if not os.path.isfile(scr):
                raise FileNotFoundError(
                    f"sequence {seq}: missing scribble file {scr}")

    # -- loading -------------------------------------------------------- #

    def load_scribble(self, sequence: str, scribble_idx: int) -> Dict:
        """Scribble set `scribble_idx` (1-based, upstream convention) as
        the raw davisinteractive JSON dict."""
        path = os.path.join(self.davis_root, self.SCRIBBLES_SUBDIR,
                            sequence, f"{scribble_idx:03d}.json")
        with open(path) as f:
            return json.load(f)

    def load_annotations(self, sequence: str,
                         dtype=np.int32) -> np.ndarray:
        """-> (num_frames, H, W) label maps from the palette PNGs."""
        return np.stack([load_indexed_png(f) for f in self._files(
            self.ANNOTATIONS_SUBDIR, sequence, ".png")]).astype(dtype)

    def load_images(self, sequence: str, dtype=np.uint8) -> np.ndarray:
        """-> (num_frames, H, W, 3) RGB frames."""
        return np.stack([read_jpeg(f) for f in self._files(
            "JPEGImages", sequence, ".jpg")]).astype(dtype, copy=False)
