"""Semi-supervised clip propagation, written plainly over the reference
model: the first frame's mask goes through the rest of a clip.

One clip goes like this:

- the frames, uint8 RGB or planar YUV 4:2:0 (full-range BT.601, the
  JPEG / JFIF inverse, chroma repeated 2 x 2), are normalized and
  encoded, each frame on its own;
- the memory is seeded from the first mask: the interaction with the
  mask as the positive map and its complement as the negative one, then
  the memory gate's first round (which keeps the interaction features);
- the matching reference is frame 0's embedding, each pixel labelled by
  the first mask;
- each frame t >= 1 takes global matching against that reference (no
  earlier minima), local matching against frame t-1's argmax inside the
  window at `local_downsample`, then the head and a softmax;
- the probabilities are upsampled to the frame and argmaxed
  (`reference.engine.upsampled_probs`).

Everything runs in float32 with TF32 off (the caller enters
`model.fp32_math`). It imports nothing of the program.

Where it departs from the program's batch engine (all of them leave the
computation the same up to rounding): the engine runs the encoder in
bf16 in 8-frame chunks, pads the embedding from 100 to 128 channels with
zeros, matches globally in bf16 against a reference bucketed by object
and locally in 3xTF32, splits the head's first conv into a per-frame
feature part, a per-clip memory part and a per-frame map part, casts the
maps to bf16 for the head, and bit-packs the labels at the object
bucket's width.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from manet_bench.reference.engine import IMAGENET_MEAN, IMAGENET_STD
from manet_bench.reference.model import Ref

# full-range BT.601 (JFIF): R = Y + 1.402 V', G = Y - 0.344136 U' - 0.714136
# V', B = Y + 1.772 U', with U' and V' the chroma less 128
YUV_TO_RGB = ((1.0, 0.0, 1.402), (1.0, -0.344136, -0.714136),
              (1.0, 1.772, 0.0))


def yuv420_to_rgb(y: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Y (T, H, W) and UV (T, H/2, W/2, 2) uint8 -> RGB (T, H, W, 3) f32 in
    [0, 255]: each chroma sample covers its 2 x 2 block."""
    c = uv.float() - 128.0
    c = c.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    yuv = torch.cat([y.float()[..., None], c], -1)
    m = torch.tensor(YUV_TO_RGB, device=y.device)
    return (yuv @ m.T).clamp(0.0, 255.0)


def rgb_to_yuv420(rgb: torch.Tensor):
    """RGB (T, H, W, 3) uint8 -> (Y (T, H, W), UV (T, H/2, W/2, 2)) uint8,
    full-range BT.601, chroma from each 2 x 2 block's mean colour: how the
    benchmark makes a decoder's output from its frames."""
    x = rgb.float()
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    t, h, w, _ = x.shape
    box = x.reshape(t, h // 2, 2, w // 2, 2, 3).mean((2, 4))
    r2, g2, b2 = box[..., 0], box[..., 1], box[..., 2]
    u = -0.168736 * r2 - 0.331264 * g2 + 0.5 * b2 + 128.0
    v = 0.5 * r2 - 0.418688 * g2 - 0.081312 * b2 + 128.0

    def u8(z):
        return z.round().clamp(0, 255).to(torch.uint8)

    return u8(y), u8(torch.stack([u, v], -1))


def normalized(frames) -> torch.Tensor:
    """uint8 RGB (T, H, W, 3), or a (Y, UV) uint8 pair -> the encoder's
    input (T, 3, H, W), ImageNet-normalized."""
    rgb = yuv420_to_rgb(*frames) if isinstance(frames, tuple) \
        else frames.float()
    x = rgb / 255.0
    x = (x - x.new_tensor(IMAGENET_MEAN)) / x.new_tensor(IMAGENET_STD)
    return x.permute(0, 3, 1, 2)


def encode_frames(ref: Ref, frames, idx) -> tuple[torch.Tensor, torch.Tensor]:
    """Features (len(idx), h, w, Cd) and embeddings (len(idx), h, w, Ce) of
    the frames `idx` of a clip (uint8 RGB (T, H, W, 3) or a (Y, UV) pair,
    on the device), one frame a call."""
    feats, embs = [], []
    for t in idx:
        one = tuple(p[t:t + 1] for p in frames) \
            if isinstance(frames, tuple) else frames[t:t + 1]
        f, e = ref.encoder(normalized(one))
        feats.append(f)
        embs.append(e)
    return torch.cat(feats), torch.cat(embs)


def object_valid(num_objects: int, o: int, device) -> torch.Tensor:
    """(O,) 1 for the background and each of the clip's objects."""
    return (torch.arange(o, device=device) <= num_objects).float()


def seed_memory(ref: Ref, feat0, first_mask, obj_valid):
    """The memory the first mask seeds (O, Cma, h, w): feat0 (h, w, Cd),
    first_mask (h, w) labels."""
    o = obj_valid.shape[0]
    pos = F.one_hot(first_mask.long(), o).float() * obj_valid
    neg = (pos.amax(-1, keepdim=True) - pos) * obj_valid
    fe, _ = ref.interact(feat0, pos, neg, pos)
    return ref.aggregate(fe, None, True)


def first_probs(first_mask, obj_valid):
    """Frame 0's probabilities (h, w, O): the first mask's one-hot."""
    return F.one_hot(first_mask.long(), obj_valid.shape[0]).float() * obj_valid


def key_labels(first_mask, obj_valid):
    """The matching reference's labels (h w,): the first mask, -1 where it
    names an object the clip does not have."""
    lab = first_mask.long().reshape(-1)
    return torch.where(obj_valid[lab.clamp(0, obj_valid.shape[0] - 1)] > 0,
                       lab, torch.full_like(lab, -1))


def step(ref: Ref, feat_t, emb_t, emb0, labels0, emb_prev, probs_prev, mem,
         obj_valid):
    """Frame t's probabilities (h, w, O) from frame t-1's embedding and
    probabilities: global matching against frame 0's labelled pixels,
    local matching against frame t-1, the head, a softmax."""
    h, w, ce = emb_t.shape
    o = obj_valid.shape[0]
    gm = ref.global_matching(emb_t.reshape(-1, ce), emb0.reshape(-1, ce),
                             labels0, o).reshape(h, w, o)
    logits = ref.propagate(feat_t[None], emb_t[None], gm[None],
                           emb_prev[None], probs_prev[None], mem, obj_valid)
    return torch.softmax(logits[0], -1)


def propagate_clip(ref: Ref, frames, first_mask, num_objects: int, o: int,
                   last: int | None = None):
    """A clip from its first mask, each frame from the one before it, up
    to frame `last` (default: the clip's end). -> (probs (n, h, w, O),
    embeddings (n, h, w, Ce), memory (O, Cma, h, w)), n = last + 1."""
    n = (frames[0] if isinstance(frames, tuple) else frames).shape[0]
    n = n if last is None else last + 1
    feat, emb = encode_frames(ref, frames, range(n))
    ov = object_valid(num_objects, o, feat.device)
    mem = seed_memory(ref, feat[0], first_mask, ov)
    labels0 = key_labels(first_mask, ov)
    probs = [first_probs(first_mask, ov)]
    for t in range(1, n):
        probs.append(step(ref, feat[t], emb[t], emb[0], labels0, emb[t - 1],
                          probs[-1], mem, ov))
    return torch.stack(probs), emb, mem

