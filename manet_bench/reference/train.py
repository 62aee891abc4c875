"""Stage-1 training, written plainly over the reference model.

A sample is a (reference, previous, current) triplet of frames with their
labels: the reference frame's labels stand in for the first round's
scribbles, the current frame is propagated from the previous frame's
labels, and the loss is the bootstrapped cross-entropy of the
propagation's logits plus half of the interaction's, at the crop's
resolution, averaged over the batch. The update is SGD with momentum
(the decay added to the gradient before the momentum trace), a poly
learning rate, and the backbone at a reduced rate.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from manet_bench.reference.engine import normalize_frames
from manet_bench.reference.model import Ref


def ratio_at(step: int, warmup: int, final: float) -> float:
    """The share of hardest pixels the loss keeps: 1 down to `final` over
    `warmup` steps, in float32."""
    frac = np.float32(min(max(np.float32(step) / np.float32(max(warmup, 1)),
                              0.0), 1.0))
    return np.float32(1.0) + np.float32(final - 1.0) * frac


def hard_ce(logits, labels, ratio) -> torch.Tensor:
    """Mean cross-entropy of the int32(ratio n) hardest of n pixels."""
    ce = -F.log_softmax(logits, -1).gather(
        -1, labels.long()[..., None])[..., 0].reshape(-1)
    n = ce.shape[0]
    k = int(np.clip(np.int32(np.float32(ratio) * np.float32(n)), 1, n))
    return ce.topk(k, sorted=False).values.sum() / k


def _sub_onehot(labels, stride, o):
    return F.one_hot(labels[stride // 2::stride, stride // 2::stride].long(),
                     o).float()


def sample_loss(ref: Ref, images, labels, obj_valid, ratio, o: int):
    """One triplet: images (3, H, W, 3) uint8, labels (3, H, W) ->
    the sample's loss."""
    s = ref.m["feature_stride"]
    feat, emb = ref.encoder(normalize_frames(images, 1))
    h, w = labels.shape[1:]
    ref_oh = _sub_onehot(labels[0], s, o)
    prev_oh = _sub_onehot(labels[1], s, o)
    pos = ref_oh * obj_valid
    neg = (pos.amax(-1, keepdim=True) - pos) * obj_valid
    bg = torch.zeros_like(ref_oh)
    bg[..., 0] = 1.0
    fe, int_logits = ref.interact(feat[0], pos, neg, bg)
    mem = ref.aggregate(fe, None, True)
    keys = labels[0][s // 2::s, s // 2::s].reshape(-1)
    gm = ref.global_matching(emb[2].reshape(-1, emb.shape[-1]),
                             emb[0].reshape(-1, emb.shape[-1]), keys,
                             o).reshape(ref_oh.shape)
    logits = ref.propagate(feat[2:], emb[2:], gm[None], emb[1:2],
                           prev_oh[None], mem, obj_valid)[0]

    def up(x):
        return F.interpolate(x.permute(2, 0, 1)[None], size=(h, w),
                             mode="bilinear", align_corners=False)[0] \
            .permute(1, 2, 0)

    return (hard_ce(up(logits), labels[2], ratio)
            + 0.5 * hard_ce(up(int_logits), labels[0], ratio))


def lr_of(name: str, step: int, t: dict) -> float:
    scale = t["backbone_lr_scale"] if name.startswith("encoder.backbone.") \
        else 1.0
    frac = min(max(step / t["total_steps"], 0.0), 1.0)
    return t["base_lr"] * scale * (1.0 - frac) ** t["poly_power"]


def train(sd: dict, m: dict, t: dict, batches, *, low: bool = False,
          keep: int | None = None):
    """`len(batches)` steps from the parameters `sd`. batches: dicts of
    device tensors (`images` (B, 3, H, W, 3) uint8, `labels` (B, 3, H, W),
    `obj_valid` (B, O)); `keep`: only the first `keep` samples of each
    batch (a fault to read). -> (losses, first gradients, parameters after
    the last step), by name."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in sd.items()}
    ref = Ref(params, m, low=low)
    trace: dict = {}
    losses, first = [], None
    for step, b in enumerate(batches):
        ratio = ratio_at(step, t["bootstrap_warmup_steps"],
                         t["bootstrap_ratio"])
        n = b["images"].shape[0] if keep is None else keep
        o = b["obj_valid"].shape[1]
        total = 0.0
        for i in range(n):
            loss = sample_loss(ref, b["images"][i], b["labels"][i],
                               b["obj_valid"][i], ratio, o) / n
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        with torch.no_grad():
            grads = {k: (p.grad if p.grad is not None
                         else torch.zeros_like(p)) for k, p in params.items()}
            if first is None:
                first = {k: g.clone() for k, g in grads.items()}
            for k, p in params.items():
                g = grads[k] + t["weight_decay"] * p
                trace[k] = g.clone() if k not in trace else \
                    t["momentum"] * trace[k] + g
                p -= lr_of(k, step, t) * trace[k]
                p.grad = None
    return losses, first, {k: p.detach() for k, p in params.items()}
