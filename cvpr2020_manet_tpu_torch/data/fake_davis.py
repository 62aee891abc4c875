"""Generate a DAVIS-2017-*shaped* synthetic tree at realistic scale,
PyTorch port of the JAX package's `scripts/make_fake_davis.py`.

The dress rehearsal for a real-data run where no DAVIS data is at hand: it
builds a tree with the exact layout `data/davis.DavisEvalDataset` and
`engine/eval_davis.py` consume —
  JPEGImages/480p/<seq>/00000.jpg ...
  Annotations/480p/<seq>/00000.png ...   (palettized labels)
  Scribbles/<seq>/001..003.json          (robot-drawn initial sets,
                                          set-dependent annotated frame)
  ImageSets/2017/{val,train}.txt
— at DAVIS-val scale: 480x854, frame counts spanning every frame bucket
including the ~100-frame one (the longest DAVIS val sequences are ~100
frames), multi-object with textured moving squares (matchable even by
untrained encoders, data/synthetic.py's trick).

The same sequences, textures, drift and scribbles as JAX's script from
the same seed. Without an image library: the frames go through the
port's numpy baseline JPEG encoder (`utils/jpeg.py`, quality 90, as JAX
saves with PIL), the annotations through `utils/colormap.save_indexed_png`.
Frames are rendered and written one at a time in uint8 (a 100-frame 480p
sequence held as float32 would be ~0.5 GB).

    python -m cvpr2020_manet_tpu_torch.data.fake_davis --root out/fake_davis
    python -m cvpr2020_manet_tpu_torch.engine.eval_davis \\
        --davis_root out/fake_davis --rounds 8 --report out/rehearsal.csv
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from cvpr2020_manet_tpu_torch.interactive.robot import InteractiveScribblesRobot
from cvpr2020_manet_tpu_torch.utils.colormap import save_indexed_png
from cvpr2020_manet_tpu_torch.utils.jpeg import encode_jpeg

# (name, frames, objects): spans the 32/64/104 frame buckets; the 52-frame
# sequence has ONE object (exercises the 1-bit mask pack path), others
# hit the default 4-wide object bucket.
SEQUENCES = [
    ("camel_like", 100, 2),
    ("judo_like", 69, 3),
    ("lone_goat", 52, 1),
    ("pigs_like", 38, 3),
    ("blackswan_like", 30, 2),
]
SCRIBBLE_SETS = 3
OBJECT_SIZE = 120


def write_sequence(root: str, name: str, t: int, n_obj: int, seed: int,
                   h: int = 480, w: int = 854) -> None:
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "JPEGImages", "480p", name)
    ann_dir = os.path.join(root, "Annotations", "480p", name)
    scr_dir = os.path.join(root, "Scribbles", name)
    for d in (img_dir, ann_dir, scr_dir):
        os.makedirs(d, exist_ok=True)

    # smooth background + per-object texture (uint8 throughout)
    yy = np.linspace(0, 1, h)[:, None, None]
    xx = np.linspace(0, 1, w)[None, :, None]
    bg = (40 + 40 * yy + 30 * xx
          + 25 * rng.random((h, w, 3))).astype(np.uint8)
    size = OBJECT_SIZE
    tex = [(128 + 127 * rng.random((size, size, 3))).astype(np.uint8)
           for _ in range(n_obj)]
    # linear drift that stays in-frame for all t frames
    starts, vels = [], []
    for _ in range(n_obj):
        vy = rng.uniform(-1.5, 1.5)
        vx = rng.uniform(-2.0, 2.0)
        y0 = rng.uniform(max(0, -vy * t), min(h - size, h - size - vy * t))
        x0 = rng.uniform(max(0, -vx * t), min(w - size, w - size - vx * t))
        starts.append((y0, x0))
        vels.append((vy, vx))

    gt_frames = {}
    for f in range(t):
        img = bg.copy()
        gt = np.zeros((h, w), np.uint8)
        for o in range(n_obj):
            y = int(round(starts[o][0] + vels[o][0] * f))
            x = int(round(starts[o][1] + vels[o][1] * f))
            y = min(max(y, 0), h - size)
            x = min(max(x, 0), w - size)
            img[y:y + size, x:x + size] = tex[o]
            gt[y:y + size, x:x + size] = o + 1
        with open(os.path.join(img_dir, f"{f:05d}.jpg"), "wb") as fp:
            fp.write(encode_jpeg(img))
        save_indexed_png(os.path.join(ann_dir, f"{f:05d}.png"), gt)
        gt_frames[f] = gt

    # 3 initial scribble sets, each annotating a different frame (the
    # robot plays the human, data/synthetic.py's convention)
    robot = InteractiveScribblesRobot()
    for s in range(SCRIBBLE_SETS):
        frame = (s * (t // 3)) % t
        scr = robot.scribble_frame(
            np.zeros((h, w), np.int32), gt_frames[frame].astype(np.int32),
            n_obj, frame, t, name)
        with open(os.path.join(scr_dir, f"{s + 1:03d}.json"), "w") as fp:
            json.dump(scr.to_json(), fp)


def write_tree(root: str, seed: int = 7) -> list[str]:
    """Every sequence of SEQUENCES (sequence i from seed + i) and the val
    and train lists. -> the sequence names."""
    names = []
    for i, (name, t, n_obj) in enumerate(SEQUENCES):
        write_sequence(root, name, t, n_obj, seed + i)
        names.append(name)
        print(f"{name}: {t} frames, {n_obj} objects", flush=True)
    sets_dir = os.path.join(root, "ImageSets", "2017")
    os.makedirs(sets_dir, exist_ok=True)
    listing = "".join(n + "\n" for n in names)
    for subset in ("val", "train"):
        with open(os.path.join(sets_dir, f"{subset}.txt"), "w") as f:
            f.write(listing)
    return names


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    names = write_tree(args.root, args.seed)
    print(f"tree at {args.root}: {len(names)} sequences, "
          f"{sum(t for _, t, _ in SEQUENCES)} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
