"""Stage-2 training, PyTorch port of the JAX package's
`engine/train_stage2.py`: the interaction branch and memory aggregation
learn across simulated interaction rounds.

Per sample, R rounds (a Python loop, each round under
`torch.utils.checkpoint`): pick the worst frame by soft IoU, synthesize
scribbles from its errors (line strokes through the densest error blobs of
each object, background-correction strokes included), run the interaction
branch on it, fuse its features into the MA memory, propagate to every
frame of the clip, and take a loss on every round, later rounds weighted
more. Every frame's propagation runs both argmin matching kernels, and the
backward reruns each round, so per step each kernel launches
2 * B * R * F times (F frames per clip).

    python -m cvpr2020_manet_tpu_torch.engine.train_stage2 --synthetic \\
        --steps 5 [--tiny] [--sim_rounds R] [--gmap_memory]
    python -m cvpr2020_manet_tpu_torch.engine.train_stage2 \\
        --ytvos_root YTVOS --clip_len 6 --uint8 --init_from STAGE1_SNAPSHOTS

Data as in stage 1 (`train_stage1.make_feed`), plus YouTube-VOS clips
(`--ytvos_root`, `data/ytvos.py`) and `--clip_len` frames a clip (a
shorter sequence is padded, `frame_valid` marking its real frames: padded
frames are never the annotated one and carry no loss). `--init_from`
starts from a stage-1 snapshot's parameters, with a fresh optimizer and
step.

Randomness: each sample gets a seed from the trainer's `torch.Generator`,
and each round draws its strokes from a generator seeded from it, so the
recompute of a checkpointed round draws the same strokes. The draws are
not JAX's; their distribution is. In a data-parallel run every rank draws
the seeds of the whole global batch and takes its own rank's slice, so a
sample's strokes depend on its place in the global batch only: the ranks
together draw what one process draws for the global batch (the worst
frame is an argmin, no draw).

Data parallelism over processes as in stage 1 (`--distributed`).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cvpr2020_manet_tpu_torch.config import Config, check_params_only
from cvpr2020_manet_tpu_torch.device import resolve_device
from cvpr2020_manet_tpu_torch.engine.losses import (
    bootstrap_ratio_schedule, bootstrapped_cross_entropy)
from cvpr2020_manet_tpu_torch.engine.train_stage1 import (
    _downsample_onehot, add_train_override_args, base_config, encode_batch,
    ingest_batch, join_group, leave_group, make_feed, run_training, step_with,
    to_device)
from cvpr2020_manet_tpu_torch.engine.train_state import TrainState
from cvpr2020_manet_tpu_torch.models.layers import resize_bilinear
from cvpr2020_manet_tpu_torch.models.manet import NEG_INF, MANet

STROKES_PER_OBJECT = 2   # line strokes synthesized per object per round


def _soft_iou_per_frame(probs, gt_onehot, obj_valid):
    """(F, h, w, O) x (F, h, w, O) -> (F,) mean soft IoU over live objects."""
    inter = (probs * gt_onehot).sum((1, 2))
    union = (probs + gt_onehot - probs * gt_onehot).sum((1, 2))
    iou = inter / union.clamp(min=1e-6)                       # (F, O)
    w = obj_valid[None, :]
    return (iou * w).sum(1) / w.sum().clamp(min=1e-6)


def _box_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """(N, h, w) -> sums over k x k windows, zero-padded ('SAME', odd k)."""
    ones = torch.ones((1, 1, k, k), dtype=x.dtype, device=x.device)
    return F.conv2d(x[:, None], ones, padding=k // 2)[:, 0]


def _synthesize_scribbles(gen: torch.Generator, gt_oh, pred_labels,
                          obj_valid):
    """Line strokes through each object's error region, the device-side
    stand-in for the eval robot's skeleton polylines.

    Per object channel (channel 0 = background, i.e. correction strokes over
    other objects' false positives): find the densest false-negative blob
    (5x5 box-summed error, with a little jitter from `gen` to break ties),
    draw a segment through it at an angle drawn from `gen`, keep its pixels
    inside the error region; STROKES_PER_OBJECT times, each time blanking
    the density around the previous strokes so that the next lands
    elsewhere.

    gt_oh (h, w, O) one-hot GT of the annotated frame; pred_labels (h, w).
    Returns (pos (h, w, O), neg (h, w, O)).
    """
    h, w, o = gt_oh.shape
    dev = gt_oh.device
    pred_oh = F.one_hot(pred_labels.long(), o).float()
    err = (gt_oh * (1.0 - pred_oh)).permute(2, 0, 1)          # (O, h, w)
    half_len = max(h, w) / 3.0
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]

    density = _box_sum(err, 5)
    acc = torch.zeros_like(err)
    for _ in range(STROKES_PER_OBJECT):
        jit = 0.01 * torch.rand(err.shape, generator=gen, device=dev)
        theta = math.pi * torch.rand((o, 1, 1), generator=gen, device=dev)
        seed = ((density + jit) * (err > 0)).reshape(o, -1).argmax(1)
        sy = (seed // w).float()[:, None, None]
        sx = (seed % w).float()[:, None, None]
        dy, dx = yy - sy, xx - sx
        along = dy * torch.sin(theta) + dx * torch.cos(theta)
        perp = dy * torch.cos(theta) - dx * torch.sin(theta)
        line = (perp.abs() <= 0.75) & (along.abs() <= half_len)
        stroke = line.float() * err
        acc = torch.maximum(acc, stroke)
        density = torch.where(_box_sum(stroke, 7) > 0,
                              torch.zeros_like(density), density)
    pos = acc.permute(1, 2, 0) * obj_valid
    scribbled = pos.amax(-1, keepdim=True)
    neg = (scribbled - pos) * obj_valid
    return pos, neg


def forward_sample_stage2(model: MANet, feat, emb, labels, obj_valid,
                          frame_valid, cfg: Config, seed: int):
    """Multi-round simulated interaction on one clip.

    feat (F, h, w, Cf), emb (F, h, w, Ce): encoder outputs of the clip;
    labels (F, H, W) int; obj_valid (O,); frame_valid (F,) {0,1}: padded
    frames are never picked as the annotated frame (the caller drops their
    loss). Returns per-round logits (R, F, H, W, O) f32.
    """
    mcfg = cfg.model
    o = mcfg.max_objects + 1
    s = mcfg.feature_stride
    f, h, w = labels.shape
    hh, ww = h // s, w // s
    dev = labels.device
    rounds = cfg.train.stage2_rounds
    gmap_memory = cfg.train.stage2_gmap_memory
    round_seeds = torch.randint(
        1 << 62, (rounds,),
        generator=torch.Generator().manual_seed(seed)).tolist()

    gt_oh = torch.stack([_downsample_onehot(l, s, o) for l in labels]) \
        * obj_valid                                           # (F, hh, ww, O)
    frames = torch.arange(f, device=dev)
    obj_mask = (1.0 - obj_valid) * NEG_INF

    def round_step(probs, int_mem, gmap, r: int):
        # the worst frame by soft IoU is the annotated one; padded frames
        # are never picked
        iou = _soft_iou_per_frame(probs, gt_oh, obj_valid)
        a = torch.where(frame_valid > 0, iou,
                        torch.full_like(iou, math.inf)).argmin()
        pick = lambda x: x.index_select(0, a.reshape(1))[0]
        gt_a = pick(gt_oh)
        gen = torch.Generator(device=dev).manual_seed(round_seeds[r])
        pos, neg = _synthesize_scribbles(gen, gt_a, pick(probs).argmax(-1),
                                         obj_valid)
        int_feats, int_logits = model.interact(pick(feat), pos, neg,
                                               pick(probs))
        int_mem = model.aggregate_memory(int_feats, int_mem, r == 0)

        # matching reference: the annotated frame's GT labels (the
        # interaction is simulated from GT, so GT is the consistent label)
        ref_emb = pick(emb).reshape(-1, emb.shape[-1])
        ref_oh = gt_a.reshape(-1, o)
        logits, g_all = [], []
        for t in range(f):
            prev = max(t - 1, 0)
            g_prev = gmap[t] if gmap_memory else torch.ones_like(gmap[t])
            lg, g_new = model.propagate(
                feat[t], emb[t], ref_emb, ref_oh, None, g_prev, emb[prev],
                probs[prev], int_mem, obj_valid)
            logits.append(lg)
            g_all.append(g_new)
        logits = torch.stack(logits)                          # (F, hh, ww, O)
        if gmap_memory:
            gmap = torch.stack(g_all)        # min-fused inside propagate
        # the annotated frame keeps its interaction-branch refresh
        logits = torch.where((frames == a)[:, None, None, None],
                             (int_logits + obj_mask)[None], logits)
        new_probs = torch.softmax(logits + obj_mask, -1)
        return new_probs, int_mem, gmap, logits

    probs = torch.zeros((f, hh, ww, o), device=dev)
    probs[..., 0] = 1.0
    int_mem = torch.zeros((o, hh, ww, mcfg.ma_channels), device=dev)
    # per-frame global-map memory across rounds: ones = "no match yet"
    gmap = torch.ones((f, hh, ww, o), device=dev)
    rounds_logits = []
    for r in range(rounds):
        # each round is recomputed in the backward instead of holding every
        # round's activations
        probs, int_mem, gmap, logits = checkpoint(
            round_step, probs, int_mem, gmap, r, use_reentrant=False)
        rounds_logits.append(logits)
    return resize_bilinear(torch.stack(rounds_logits), (h, w))


def make_loss_fn(model: MANet, cfg: Config):
    """-> loss_fn(batch, step, seeds) -> (loss, {"loss": loss}): the forward
    of one step on a batch of device tensors; `seeds` holds one int per
    sample (its strokes' randomness)."""
    tcfg = cfg.train

    def loss_fn(batch, step: int, seeds):
        batch = ingest_batch(batch)
        ratio = bootstrap_ratio_schedule(step, tcfg.bootstrap_warmup_steps,
                                         tcfg.bootstrap_ratio)
        feat, emb = encode_batch(model, batch["images"],
                                 tcfg.remat_chunk if tcfg.remat else 0)
        per_sample = []
        for feat_s, emb_s, labels, obj_valid, frame_valid, seed in zip(
                feat, emb, batch["labels"], batch["obj_valid"],
                batch["frame_valid"], seeds):
            up = forward_sample_stage2(model, feat_s, emb_s, labels,
                                       obj_valid, frame_valid, cfg, seed)
            r = up.shape[0]
            losses = torch.stack([
                torch.stack([bootstrapped_cross_entropy(lo, la, ratio)
                             for lo, la in zip(up_r, labels)])
                for up_r in up])                              # (R, F)
            # later rounds weigh more (the MA gate must help, not hurt);
            # padded frames contribute nothing
            weights = (1.0 + torch.arange(r, dtype=torch.float32,
                                          device=up.device)[:, None]) \
                * frame_valid[None, :]
            per_sample.append((losses * weights).sum()
                              / weights.sum().clamp(min=1e-6))
        loss = torch.stack(per_sample).mean()
        return loss, {"loss": loss}

    return loss_fn


def make_train_step(model: MANet, cfg: Config):
    return step_with(make_loss_fn(model, cfg))


class Stage2Trainer:
    """Stage-2 trainer on one device (`cuda` unless `device` says
    otherwise). Start it from stage-1 weights with
    `CheckpointManager(stage1_dir).restore_params(trainer.model)`.
    Data-parallel once a group is joined, as stage 1's `Trainer`."""

    def __init__(self, cfg: Config, device=None, seed: int | None = None):
        check_params_only(cfg.model, "Stage2Trainer")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = MANet(cfg.model, device=self.device,
                           seed=cfg.train.seed if seed is None else seed,
                           trainable_matching=True)
        self.state = TrainState.create(self.model, cfg.train)
        self._gen = torch.Generator().manual_seed(cfg.train.seed + 1)
        self._step = make_train_step(self.model, cfg)

    def train_step(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """One optimizer step on a batch of numpy arrays (or of tensors
        already on the device): this rank's share of the global batch."""
        b = batch["images"].shape[0]
        rank, world = 0, 1
        if self.state.group is not None:
            rank = dist.get_rank(self.state.group)
            world = dist.get_world_size(self.state.group)
        seeds = torch.randint(1 << 62, (b * world,),
                              generator=self._gen).tolist()
        return self._step(self.state, to_device(batch, self.device),
                          seeds[rank * b:(rank + 1) * b])


def main(argv=None):
    p = argparse.ArgumentParser()
    add_train_override_args(p)
    p.add_argument("--sim_rounds", type=int, default=None,
                   help="simulated interaction rounds per sample "
                        "(TrainConfig.stage2_rounds)")
    p.add_argument("--gmap_memory", action="store_true",
                   help="thread the global-map min-fusion memory through "
                        "the simulated rounds (TrainConfig."
                        "stage2_gmap_memory)")
    p.add_argument("--no_gmap_memory", action="store_true",
                   help="the default; kept so that existing command lines "
                        "run")
    p.add_argument("--ytvos_root", default=None,
                   help="train on YouTube-VOS clips (data/ytvos.py)")
    p.add_argument("--clip_len", type=int, default=3,
                   help="frames per clip (the rounds propagate over the "
                        "clip; short sequences pad, with frame_valid)")
    p.add_argument("--init_from", default=None,
                   help="stage-1 snapshot dir to take the parameters from")
    args = p.parse_args(argv)
    joined = join_group(args)
    try:
        train(args)
    finally:
        leave_group(joined)


def train(args) -> None:
    """The stage-2 CLI's run, in the process group `main` joined."""
    cfg = base_config(args)
    tr = {}
    if args.sim_rounds is not None:
        tr["stage2_rounds"] = args.sim_rounds
    if args.gmap_memory:
        tr["stage2_gmap_memory"] = True
    if tr:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, **tr))
    trainer = Stage2Trainer(cfg)
    adapter = None
    if args.ytvos_root:
        from cvpr2020_manet_tpu_torch.data.ytvos import YTVOSDataset
        adapter = YTVOSDataset(args.ytvos_root)
    batches = make_feed(cfg, args, clip_len=args.clip_len, adapter=adapter)
    if args.init_from:
        # stage 2 starts from the stage-1 snapshot's parameters; the
        # optimizer and the step start fresh (a --snapshot_dir resume in
        # run_training still wins)
        from cvpr2020_manet_tpu_torch.utils.checkpoint import (
            CheckpointManager)
        step = CheckpointManager(args.init_from).restore_params(
            trainer.model)
        print(f"initialized from stage-1 step {step}")
    run_training(trainer, args, batches)


if __name__ == "__main__":
    main()
