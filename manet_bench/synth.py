"""Seeded inputs: videos of moving textured objects and scribbles.

Every draw comes from `--seed` through `rng(seed, *keys)`, so the same
seed gives the same inputs; the sizes (frame counts, object counts,
resolutions) come from the workload file and never from the seed.

A video is made on the device in a few large calls and handed over as
host uint8 RGB, as a decoder would give it. A scribble is a path of
pixels, each a step of at most one pixel from the one before, so that
any line rasterizer draws exactly these pixels; its JSON form follows the
DAVIS interactive format (normalized [x, y] points).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def seed_of(seed: int, *keys: int) -> int:
    """A 63-bit seed derived from the run's seed and `keys`."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *keys])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng(seed_of(seed, *keys))


def generator(seed: int, device, *keys: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed_of(seed, *keys))
    return g


def _texture(g, h, w, c, device, cell=16):
    """A smooth random texture (c, h, w) in [0, 1]."""
    lo = torch.rand((1, c, -(-h // cell) + 1, -(-w // cell) + 1),
                    generator=g, device=device)
    up = F.interpolate(lo, size=(h, w), mode="bilinear", align_corners=False)
    fine = torch.rand((1, c, h, w), generator=g, device=device)
    return (0.75 * up + 0.25 * fine)[0]


def make_video(seed: int, key: int, frames: int, size, objects: int,
               device):
    """`frames` uint8 RGB frames (T, H, W, 3) and their labels (T, H, W)
    int8 (0 background, 1..objects): textured rectangles that move at a
    constant speed and bounce at the borders over a textured background;
    later objects occlude earlier ones."""
    h, w = size
    g = generator(seed, device, 1, key)
    r = rng(seed, 2, key)
    bg = 0.15 + 0.5 * _texture(g, h, w, 3, device, cell=32)
    video = bg[None].expand(frames, -1, -1, -1).clone()
    labels = torch.zeros((frames, h, w), dtype=torch.int8, device=device)
    t = np.arange(frames)
    for j in range(objects):
        oh = int(r.integers(h // 6, h // 3))
        ow = int(r.integers(w // 8, w // 4))
        tex = 0.3 + 0.7 * _texture(g, oh, ow, 3, device, cell=8)
        ys = _bounce(r.integers(0, h - oh), r.uniform(-3, 3), h - oh, t)
        xs = _bounce(r.integers(0, w - ow), r.uniform(-5, 5), w - ow, t)
        for f in range(frames):
            y, x = ys[f], xs[f]
            video[f, :, y:y + oh, x:x + ow] = tex
            labels[f, y:y + oh, x:x + ow] = j + 1
    u8 = (video.clamp(0, 1) * 255).round().to(torch.uint8)
    return (u8.permute(0, 2, 3, 1).contiguous().cpu().numpy(),
            labels.cpu().numpy())


def _bounce(start, speed, span, t):
    """Positions start + speed t folded back into [0, span]."""
    if span <= 0:
        return np.zeros_like(t)
    p = np.abs((start + speed * t) % (2 * span))
    return np.where(p > span, 2 * span - p, p).astype(np.int64)


def _walk(r, labels, obj, start, length):
    """A path of pixels from `start`, one step right (or left) at a time
    with a random step up or down, kept while it stays on label `obj`."""
    h, w = labels.shape
    y, x = start
    dx = 1 if r.random() < 0.5 else -1
    path = []
    for _ in range(length):
        if not (0 <= y < h and 0 <= x < w) or labels[y, x] != obj:
            break
        path.append((int(x), int(y)))
        x += dx
        y += int(r.integers(-1, 2))
    return path


def stroke(r, labels, obj, length):
    """A stroke on label `obj` of a label map (H, W): a walk from a
    random pixel of it, or None where it has too few pixels."""
    ys, xs = np.nonzero(labels == obj)
    if len(ys) < 16:
        return None
    i = int(r.integers(len(ys)))
    path = _walk(r, labels, obj, (ys[i], xs[i]), length)
    return path if len(path) >= 4 else None


def scribble_json(r, labels, frame, num_frames, objects, name,
                  length=160):
    """One round's scribbles on `frame` of a label video: a stroke on
    each of `objects` (object ids; 0 is the background) ->
    (the DAVIS-format JSON, [(object, path)] in drawing order)."""
    h, w = labels.shape[1:]
    lines, drawn = [], []
    for obj in objects:
        path = stroke(r, labels[frame], obj, length)
        if path is None:
            continue
        drawn.append((obj, path))
        lines.append({"path": [[x / (w - 1), y / (h - 1)] for x, y in path],
                      "object_id": int(obj), "start_time": 0.0,
                      "end_time": 1.0})
    scribbles = [[] for _ in range(num_frames)]
    scribbles[frame] = lines
    return {"sequence": name, "scribbles": scribbles}, drawn


def raster(drawn, size, pad_to: int) -> np.ndarray:
    """The label raster of drawn strokes (Hp, Wp) int64, -1 where nothing
    is drawn, padded at the bottom and right to `pad_to`."""
    h, w = size
    out = np.full((h + (-h) % pad_to, w + (-w) % pad_to), -1, np.int64)
    for obj, path in drawn:
        p = np.asarray(path)
        out[p[:, 1], p[:, 0]] = obj
    return out
