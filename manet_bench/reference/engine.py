"""The interactive round and the live stream, written plainly over the
reference model. Each takes the benchmark's inputs (uint8 frames,
scribble rasters) and, where a call continues from an earlier one, the
state that the earlier call left (`RoundState`, `StreamState`)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from manet_bench.reference.model import NEG_INF, Ref, resize

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_frames(u8: torch.Tensor, pad_to: int) -> torch.Tensor:
    """(T, H, W, 3) uint8 RGB -> (T, 3, Hp, Wp) normalized f32, the
    bottom and right edges padded to `pad_to` with the mean (0 once
    normalized)."""
    x = u8.float() / 255.0
    x = (x - x.new_tensor(IMAGENET_MEAN)) / x.new_tensor(IMAGENET_STD)
    h, w = x.shape[1:3]
    x = F.pad(x.permute(0, 3, 1, 2), (0, (-w) % pad_to, 0, (-h) % pad_to))
    return x


def encode(ref: Ref, u8: np.ndarray, pad_to: int, device, chunk: int = 8):
    """Features and embeddings of uint8 frames (T, H, W, 3) -> (T, h, w,
    Cd), (T, h, w, Ce), in blocks of `chunk` frames."""
    feats, embs = [], []
    for i in range(0, u8.shape[0], chunk):
        x = normalize_frames(torch.from_numpy(u8[i:i + chunk]).to(device),
                             pad_to)
        f, e = ref.encoder(x)
        feats.append(f)
        embs.append(e)
    return torch.cat(feats), torch.cat(embs)


def scribble_maps(raster: torch.Tensor, o: int, stride: int):
    """A scribble raster (Hp, Wp), -1 where unscribbled -> positive and
    negative maps (h, w, O): an object's pixel is positive where a stroke
    of it falls in the stride x stride block, negative where a stroke of
    another label does."""
    hp, wp = raster.shape
    scr = raster >= 0
    pos = torch.stack([raster == j for j in range(o)], -1)
    neg = scr[..., None] & ~pos

    def block_any(x):
        return x.reshape(hp // stride, stride, wp // stride, stride, o) \
            .any(3).any(1).float()

    return block_any(pos), block_any(neg)


def labels_to_keys(int_probs, pos, obj_valid):
    """The matching keys' labels of an annotated frame: the interaction's
    argmax, overridden by the scribbles; every pixel is labelled."""
    lab = int_probs.argmax(-1)
    lab = torch.where(pos.amax(-1) > 0, pos.argmax(-1), lab)
    return lab.reshape(-1)


def upsampled_probs(probs: torch.Tensor, size) -> torch.Tensor:
    """(..., h, w, O) probabilities -> bilinear at `size`."""
    lead = probs.shape[:-3]
    y = resize(probs.reshape(-1, *probs.shape[-3:]), size)
    return y.reshape(*lead, *size, probs.shape[-1])


# ------------------------------------------------------------- the round


@dataclasses.dataclass
class RoundState:
    """What a round continues from: the previous masks and the running
    minimum of the global maps of every frame (T, h, w, O), and the
    interaction memory (O, Cma, h, w); `first`: no round yet."""
    probs: torch.Tensor
    gmap: torch.Tensor
    mem: torch.Tensor | None
    first: bool

    @classmethod
    def initial(cls, t, h, w, o, device):
        probs = torch.zeros((t, h, w, o), device=device)
        probs[..., 0] = 1.0
        return cls(probs, torch.ones((t, h, w, o), device=device), None, True)


def run_round(ref: Ref, feat, emb, state: RoundState, raster, annot: int,
              num_objects: int, nf: int, stride: int):
    """One interaction round over the sequence's first `nf` frames:
    the interaction on the annotated frame, global matching of every
    other frame against its pixels, and a sweep forward from it to the
    end and backward from it to the start, each step from the frame
    visited before. -> (probs (nf, h, w, O), gmap (nf, h, w, O), mem)."""
    o = state.probs.shape[-1]
    dev = feat.device
    obj_valid = (torch.arange(o, device=dev) <= num_objects).float()
    pos, neg = scribble_maps(raster, o, stride)
    fe, logits = ref.interact(feat[annot], pos, neg, state.probs[annot])
    mem = ref.aggregate(fe, state.mem, state.first)
    int_probs = torch.softmax(logits + (1.0 - obj_valid) * NEG_INF, -1)
    keys = emb[annot].reshape(-1, emb.shape[-1])
    labels = labels_to_keys(int_probs, pos, obj_valid)
    probs = state.probs[:nf].clone()
    gmap = state.gmap[:nf].clone()
    probs[annot] = int_probs
    order = [(f, f - 1) for f in range(annot + 1, nf)] + \
            [(f, f + 1) for f in range(annot - 1, -1, -1)]
    h, w = feat.shape[1:3]
    for f, p in order:
        g = ref.global_matching(emb[f].reshape(-1, emb.shape[-1]), keys,
                                labels, o).reshape(h, w, o)
        g = torch.minimum(g, gmap[f])
        logits = ref.propagate(feat[f][None], emb[f][None], g[None],
                               emb[p][None], probs[p][None], mem, obj_valid)
        probs[f] = torch.softmax(logits[0], -1)
        gmap[f] = g
    return probs, gmap, mem


def round_steps(ref: Ref, feat, emb, state: RoundState, given, raster,
                annot: int, num_objects: int, nf: int, stride: int,
                block: int = 8):
    """The round stage by stage from what a candidate gave: the
    interaction from the state before the round, then each sweep step
    from the candidate's probabilities `given` (nf, h, w, O) of the frame
    visited before it, against keys labelled as the candidate's
    interaction output labels them. Each stage then shows its own error,
    not the earlier stages' flipped labels carried down the sweep, and
    the steps are independent: they run `block` frames at a time. ->
    (probs (nf, h, w, O), gmap (nf, h, w, O), mem), the state the round
    hands on: the annotated frame keeps its global-map minima."""
    o = state.probs.shape[-1]
    dev = feat.device
    obj_valid = (torch.arange(o, device=dev) <= num_objects).float()
    pos, neg = scribble_maps(raster, o, stride)
    fe, logits = ref.interact(feat[annot], pos, neg, state.probs[annot])
    mem = ref.aggregate(fe, state.mem, state.first)
    probs = torch.empty_like(given)
    gmap = state.gmap[:nf].clone()
    probs[annot] = torch.softmax(logits + (1.0 - obj_valid) * NEG_INF, -1)
    keys = emb[annot].reshape(-1, emb.shape[-1])
    labels = labels_to_keys(given[annot], pos, obj_valid)
    h, w = feat.shape[1:3]
    frames = [f for f in range(nf) if f != annot]
    for i in range(0, len(frames), block):
        f = torch.tensor(frames[i:i + block], device=dev)
        p = torch.where(f > annot, f - 1, f + 1)
        g = ref.global_matching(emb[f].reshape(-1, emb.shape[-1]), keys,
                                labels, o).reshape(len(f), h, w, o)
        g = torch.minimum(g, state.gmap[f])
        probs[f] = torch.softmax(ref.propagate(
            feat[f], emb[f], g, emb[p], given[p], mem, obj_valid), -1)
        gmap[f] = g
    return probs, gmap, mem


# ------------------------------------------------------------ the stream


@dataclasses.dataclass
class StreamState:
    """The stream's memory: the annotated pixels of each correction
    (keys (K, Ce), labels (K,)), the interaction memory, and the frame
    seen last with its features and probabilities."""
    keys: list
    labels: list
    mem: torch.Tensor | None
    feat: torch.Tensor | None = None
    emb: torch.Tensor | None = None
    probs: torch.Tensor | None = None


def stream_observe(ref: Ref, feat, emb, state: StreamState, prev_emb,
                   prev_probs, obj_valid):
    """A new frame's probabilities (h, w, O): global matching against
    every correction's pixels, local matching against the frame before;
    before any correction, all background."""
    h, w = feat.shape[:2]
    o = obj_valid.shape[0]
    if not state.keys:
        probs = torch.zeros((h, w, o), device=feat.device)
        probs[..., 0] = 1.0
        return probs
    g = ref.global_matching(emb.reshape(-1, emb.shape[-1]),
                            torch.cat(state.keys), torch.cat(state.labels),
                            o).reshape(h, w, o)
    logits = ref.propagate(feat[None], emb[None], g[None], prev_emb[None],
                           prev_probs[None], state.mem, obj_valid)
    return torch.softmax(logits[0], -1)


def stream_correct(ref: Ref, state: StreamState, raster, obj_valid,
                   stride: int, key_labels=None):
    """The user's scribbles on the frame seen last: the interaction, the
    memory update, and the frame's pixels as a new page of keys, labelled
    as the interaction labels them, or as `key_labels` (K,) give. -> the
    frame's refreshed probabilities."""
    o = obj_valid.shape[0]
    pos, neg = scribble_maps(raster, o, stride)
    fe, logits = ref.interact(state.feat, pos, neg, state.probs)
    state.mem = ref.aggregate(fe, state.mem, not state.keys)
    probs = torch.softmax(logits + (1.0 - obj_valid) * NEG_INF, -1)
    state.keys.append(state.emb.reshape(-1, state.emb.shape[-1]))
    state.labels.append(labels_to_keys(probs, pos, obj_valid)
                        if key_labels is None else key_labels)
    state.probs = probs
    return probs
