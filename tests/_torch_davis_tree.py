"""DAVIS-2017 and YouTube-VOS trees written without an image library, for
chip_smoke.py's davis and train phases and the port's tests: writers of
the synthetic fixture's textured moving objects in the DAVIS and
YouTube-VOS layouts, their frames through the port's numpy baseline JPEG
encoder (`utils/jpeg.encode_jpeg`). It imports numpy and the port only (no
JAX, no PIL), so that it runs on a machine that has neither."""

import json
import os

import numpy as np

from cvpr2020_manet_tpu_torch.utils.jpeg import encode_jpeg


def _synthetic_clip(image_size, n_frames, n_obj, seed, scribble_sets=1):
    from cvpr2020_manet_tpu_torch.data import SyntheticDataset
    ds = SyntheticDataset(image_size=image_size, num_frames=n_frames,
                          num_sequences=1, num_objects=n_obj,
                          scribble_sets=scribble_sets, seed=seed)
    src = ds.sequences()[0]
    frames = (np.clip(ds.images(src), 0, 1) * 255).astype(np.uint8)
    return ds, src, frames, ds.gt_masks(src)


def write_davis_tree(root: str, image_size, sequences, scribble_sets: int):
    """A DAVIS-2017 tree of the synthetic fixture's textured moving objects:
    JPEGImages (`encode_jpeg`), Annotations (the port's indexed-PNG
    writer), Scribbles/<seq>/00k.json (set k: paths through every object
    on frame 0, then on the middle frame, drawn by the scribble robot
    against an empty prediction) and ImageSets/2017/{val,train}.txt, both
    listing every sequence. -> {sequence: (uint8 frames, label maps)}."""
    from cvpr2020_manet_tpu_torch.utils.colormap import save_indexed_png
    written = {}
    for name, n_frames, n_obj, seed in sequences:
        ds, src, frames, gt = _synthetic_clip(image_size, n_frames, n_obj,
                                              seed, scribble_sets)
        dirs = [os.path.join(root, kind, "480p", name)
                for kind in ("JPEGImages", "Annotations")]
        dirs.append(os.path.join(root, "Scribbles", name))
        for d in dirs:
            os.makedirs(d, exist_ok=True)
        for t in range(n_frames):
            with open(os.path.join(dirs[0], f"{t:05d}.jpg"), "wb") as f:
                f.write(encode_jpeg(frames[t]))
            save_indexed_png(os.path.join(dirs[1], f"{t:05d}.png"), gt[t])
        for k in range(scribble_sets):
            payload = ds.initial_scribbles(src, k).to_json()
            payload["sequence"] = name
            with open(os.path.join(dirs[2], f"{k + 1:03d}.json"), "w") as f:
                json.dump(payload, f)
        written[name] = (frames, gt)
    split = os.path.join(root, "ImageSets", "2017")
    os.makedirs(split, exist_ok=True)
    for subset in ("val", "train"):
        with open(os.path.join(split, f"{subset}.txt"), "w") as f:
            f.write("".join(f"{name}\n" for name, *_ in sequences))
    return written


def write_ytvos_tree(root: str, image_size, sequences):
    """A YouTube-VOS train split of the synthetic fixture's textured moving
    objects: train/JPEGImages/<seq>/<5 t:05d>.jpg (every 5th frame named,
    as the dataset does), train/Annotations/<seq>/... (indexed PNGs) and
    train/meta.json listing each video's objects and the frames they
    appear in. `sequences`: (name, frames, objects, seed).
    -> {sequence: (uint8 frames, label maps)}."""
    from cvpr2020_manet_tpu_torch.utils.colormap import save_indexed_png
    split = os.path.join(root, "train")
    written, videos = {}, {}
    for name, n_frames, n_obj, seed in sequences:
        _, _, frames, gt = _synthetic_clip(image_size, n_frames, n_obj, seed)
        dirs = [os.path.join(split, kind, name)
                for kind in ("JPEGImages", "Annotations")]
        for d in dirs:
            os.makedirs(d, exist_ok=True)
        stems = [f"{5 * t:05d}" for t in range(n_frames)]
        for t, stem in enumerate(stems):
            with open(os.path.join(dirs[0], f"{stem}.jpg"), "wb") as f:
                f.write(encode_jpeg(frames[t]))
            save_indexed_png(os.path.join(dirs[1], f"{stem}.png"), gt[t])
        videos[name] = {"objects": {
            str(k): {"category": "object",
                     "frames": [s for t, s in enumerate(stems)
                                if (gt[t] == k).any()]}
            for k in range(1, n_obj + 1)}}
        written[name] = (frames, gt)
    with open(os.path.join(split, "meta.json"), "w") as f:
        json.dump({"videos": videos}, f)
    return written
