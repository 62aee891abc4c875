"""Stage-1 training, PyTorch port of the JAX package's
`engine/train_stage1.py`.

Reference recipe: (reference frame, previous frame, current frame)
triplets; the reference frame's GT mask stands in for a round-0
interaction; propagate to the current frame with the teacher-forced
previous mask; bootstrapped CE on the interaction and propagation logits;
SGD with poly LR.

One step: the encoder runs over all B*3 frames as one conv batch (in
checkpointed chunks when `remat`); then, per sample (a Python loop), the
global matching runs once outside the checkpointed tail and the tail
(interaction head, MA, local matching, propagation head, losses) runs
under `torch.utils.checkpoint`. The matching goes through the
argmin-routed Functions of `ops/trainable.py`, whose forwards are the
argmin CUDA kernels on the card, so global matching (kernel
`global_matching_argmin`) launches once per sample per step and local
matching (`local_matching_argmin`) twice: in the forward and in the
tail's recompute during the backward.

    python -m cvpr2020_manet_tpu_torch.engine.train_stage1 --synthetic \\
        --steps 20 [--tiny]

Left out for now (ROADMAP): DAVIS / YouTube-VOS data, the uint8 ingest,
and multi-device training.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cvpr2020_manet_tpu_torch.config import Config, tiny_test_config
from cvpr2020_manet_tpu_torch.device import resolve_device
from cvpr2020_manet_tpu_torch.engine.losses import (
    bootstrap_ratio_schedule, bootstrapped_cross_entropy)
from cvpr2020_manet_tpu_torch.engine.train_state import TrainState
from cvpr2020_manet_tpu_torch.models.layers import resize_bilinear
from cvpr2020_manet_tpu_torch.models.manet import MANet


def _downsample_onehot(labels: torch.Tensor, stride: int, o: int
                       ) -> torch.Tensor:
    """(H, W) int -> (H/s, W/s, O) f32 one-hot via nearest subsampling."""
    sub = labels[stride // 2::stride, stride // 2::stride]
    return F.one_hot(sub.long(), o).float()


def encode_batch(model: MANet, images: torch.Tensor, remat_chunk: int = 0):
    """Encoder over ALL frames of ALL samples as one conv batch.

    images (B, T, H, W, 3) -> feat (B, T, h, w, Cf), emb (B, T, h, w, Ce).
    When `remat_chunk` > 0 the B*T frames run in checkpointed chunks of the
    largest divisor of B*T that is at most `remat_chunk`, so the backward's
    recompute holds one chunk of encoder activations at a time.
    """
    b, t = images.shape[:2]
    n = b * t
    flat = images.reshape((n,) + tuple(images.shape[2:]))
    if remat_chunk > 0:
        chunk = next(c for c in range(min(remat_chunk, n), 0, -1)
                     if n % c == 0)
        outs = [checkpoint(model.extract_features, x, use_reentrant=False)
                for x in flat.split(chunk)]
        feat = torch.cat([f for f, _ in outs])
        emb = torch.cat([e for _, e in outs])
    else:
        feat, emb = model.extract_features(flat)
    return (feat.reshape((b, t) + tuple(feat.shape[1:])),
            emb.reshape((b, t) + tuple(emb.shape[1:])))


def forward_sample(model: MANet, feat: torch.Tensor, emb: torch.Tensor,
                   gm: torch.Tensor, labels: torch.Tensor,
                   obj_valid: torch.Tensor, cfg: Config):
    """Logits of ONE triplet sample, upsampled to the crop.

    feat (3, h, w, Cf), emb (3, h, w, Ce): encoder outputs of frames
    [reference, previous, current]; gm (h*w, O): global matching of the
    current frame against the reference frame's GT pixels (computed by the
    caller, outside the checkpointed tail); labels (3, H, W) int; obj_valid
    (O,). Returns (interaction logits, propagation logits), (H, W, O) f32.
    """
    mcfg = cfg.model
    o = mcfg.max_objects + 1
    s = mcfg.feature_stride
    h, w = labels.shape[1:3]
    ref_oh = _downsample_onehot(labels[0], s, o)
    prev_oh = _downsample_onehot(labels[1], s, o)

    # round-0 interaction simulated by the reference frame's GT mask
    pos = ref_oh * obj_valid
    scribbled = pos.amax(-1, keepdim=True)
    neg = (scribbled - pos) * obj_valid
    bg_prior = torch.zeros_like(ref_oh)
    bg_prior[..., 0] = 1.0
    int_feats, int_logits = model.interact(feat[0], pos, neg, bg_prior)
    int_mem = model.aggregate_memory(int_feats, torch.zeros_like(int_feats),
                                     True)

    hh, ww = h // s, w // s
    prop_logits, _ = model.propagate(
        feat[2], emb[2], emb[0].reshape(-1, emb.shape[-1]),
        ref_oh.reshape(-1, o), None, torch.ones_like(ref_oh), emb[1],
        prev_oh, int_mem, obj_valid, gmap_override=gm.reshape(hh, ww, o))
    return (resize_bilinear(int_logits, (h, w)),
            resize_bilinear(prop_logits, (h, w)))


def make_loss_fn(model: MANet, cfg: Config):
    """-> loss_fn(batch, step) -> (loss, metrics): the forward of one step,
    on a batch of device tensors, at optimizer step `step`."""
    tcfg = cfg.train
    o = cfg.model.max_objects + 1
    s = cfg.model.feature_stride

    def loss_fn(batch, step: int):
        ratio = bootstrap_ratio_schedule(step, tcfg.bootstrap_warmup_steps,
                                         tcfg.bootstrap_ratio)
        feat, emb = encode_batch(model, batch["images"],
                                 tcfg.remat_chunk if tcfg.remat else 0)

        def tail(feat_s, emb_s, gm, labels, obj_valid):
            int_up, prop_up = forward_sample(model, feat_s, emb_s, gm, labels,
                                             obj_valid, cfg)
            l_int = bootstrapped_cross_entropy(int_up, labels[0], ratio)
            l_prop = bootstrapped_cross_entropy(prop_up, labels[2], ratio)
            return l_prop + 0.5 * l_int, l_prop, l_int

        per_sample = []
        for feat_s, emb_s, labels, obj_valid in zip(
                feat, emb, batch["labels"], batch["obj_valid"]):
            # global matching outside the checkpointed tail: its kernel runs
            # once in the forward, and the tail takes the small (h*w, O) map
            # as an input; gradients reach the kernel's inputs through the
            # Function's saved winners
            ce = emb_s.shape[-1]
            ref_oh = _downsample_onehot(labels[0], s, o)
            gm = model._global_matching(emb_s[2].reshape(-1, ce),
                                        emb_s[0].reshape(-1, ce),
                                        ref_oh.reshape(-1, o), None)
            args = (feat_s, emb_s, gm, labels, obj_valid)
            per_sample.append(checkpoint(tail, *args, use_reentrant=False)
                              if tcfg.remat else tail(*args))
        loss, l_prop, l_int = (torch.stack(v).mean() for v in zip(*per_sample))
        return loss, {"loss": loss, "loss_prop": l_prop, "loss_int": l_int}

    return loss_fn


def step_with(loss_fn):
    """-> train_step(state, batch, *args): one forward,
    `loss_fn(batch, state.step, *args)`, one backward and one optimizer
    update; returns the metrics as floats."""
    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], *args):
        loss, metrics = loss_fn(batch, state.step, *args)
        loss.backward()
        state.apply_gradients()
        return {k: float(v.detach()) for k, v in metrics.items()}

    return train_step


def make_train_step(model: MANet, cfg: Config):
    return step_with(make_loss_fn(model, cfg))


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


class Trainer:
    """Stage-1 trainer on one device (`cuda` unless `device` says
    otherwise). Weights are drawn from `seed` (default `cfg.train.seed`)."""

    def __init__(self, cfg: Config, device=None, seed: int | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = MANet(cfg.model, device=self.device,
                           seed=cfg.train.seed if seed is None else seed,
                           trainable_matching=True)
        self.state = TrainState.create(self.model, cfg.train)
        self._step = make_train_step(self.model, cfg)

    def train_step(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """One optimizer step on a host batch (numpy arrays)."""
        return self._step(self.state, to_device(batch, self.device))


def synthetic_batch(cfg: Config, rng: np.random.Generator,
                    num_objects: int | None = None,
                    random_entry: bool = False) -> Dict[str, np.ndarray]:
    """Random moving-square triplets (smoke training / tests), the same
    arrays as the JAX package's `synthetic_batch` from the same `rng`.

    num_objects: objects per clip (default 2, capped by the bucket).
    random_entry: each object's first visible frame is drawn over the clip,
    so the model also trains on objects absent from the reference frame."""
    from cvpr2020_manet_tpu_torch.data.synthetic import SyntheticDataset
    b = cfg.train.batch_size
    h, w = cfg.train.crop_size
    o = cfg.model.max_objects + 1
    n_obj = (min(2, cfg.model.max_objects) if num_objects is None
             else min(num_objects, cfg.model.max_objects))
    images = np.empty((b, 3, h, w, 3), np.float32)
    labels = np.empty((b, 3, h, w), np.int32)
    for i in range(b):
        entry = ([int(e) for e in rng.integers(0, 3, size=n_obj)]
                 if random_entry else None)
        ds = SyntheticDataset(image_size=(h, w), num_frames=3,
                              num_sequences=1, num_objects=n_obj,
                              seed=int(rng.integers(1 << 30)),
                              entry_frames=entry)
        seq = ds.sequences()[0]
        images[i] = ds.images(seq)
        labels[i] = ds.gt_masks(seq)
    obj_valid = np.zeros((b, o), np.float32)
    obj_valid[:, :n_obj + 1] = 1.0
    return {"images": images, "labels": labels, "obj_valid": obj_valid,
            "frame_valid": np.ones((b, 3), np.float32)}


def add_train_override_args(p: argparse.ArgumentParser) -> None:
    """Overrides of TrainConfig shared by both trainer CLIs, and the flags
    of the training loop (`run_training`)."""
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=None,
                   help="batch size (TrainConfig.batch_size)")
    p.add_argument("--crop", type=int, default=None,
                   help="square crop size (TrainConfig.crop_size)")
    p.add_argument("--total_steps", type=int, default=None,
                   help="poly-LR horizon (TrainConfig.total_steps)")
    p.add_argument("--checkpoint_every", type=int, default=None)
    p.add_argument("--objects", type=int, default=None,
                   help="objects per synthetic clip")
    p.add_argument("--random_entry", action="store_true",
                   help="synthetic objects enter mid-clip "
                        "(see synthetic_batch)")
    p.add_argument("--release", default=None,
                   help="dir to export an immutable release checkpoint "
                        "of the final params")
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic clips (the only data source "
                        "ported so far)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny_test_config() instead of the flagship Config()")
    p.add_argument("--log_dir", default=None,
                   help="append metrics to <log_dir>/metrics.jsonl")
    p.add_argument("--snapshot_dir", default=None,
                   help="checkpoint dir (resumes if it has snapshots)")


def apply_train_overrides(cfg: Config, args) -> Config:
    tr = {}
    if args.batch is not None:
        tr["batch_size"] = args.batch
    if args.crop is not None:
        tr["crop_size"] = (args.crop, args.crop)
    if args.total_steps is not None:
        tr["total_steps"] = args.total_steps
    if args.checkpoint_every is not None:
        tr["checkpoint_every"] = args.checkpoint_every
    if tr:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, **tr))
    return cfg


def base_config(args) -> Config:
    return apply_train_overrides(
        tiny_test_config() if args.tiny else Config(), args)


def run_training(trainer, args) -> None:
    """The loop both CLIs share: resume from `--snapshot_dir`, train
    `--steps` steps on synthetic batches, log, checkpoint, export."""
    from cvpr2020_manet_tpu_torch.utils.checkpoint import (
        CheckpointManager, export_release)
    from cvpr2020_manet_tpu_torch.utils.logging import MetricLogger
    cfg = trainer.cfg
    mgr = None
    if args.snapshot_dir:
        mgr = CheckpointManager(args.snapshot_dir)
        if mgr.latest_step() is not None:
            mgr.restore(trainer.state)
            print(f"resumed from step {trainer.state.step}")
    rng = np.random.default_rng(cfg.train.seed)
    start = trainer.state.step
    logger = MetricLogger(args.log_dir)
    try:
        for step in range(start, start + args.steps):
            metrics = trainer.train_step(synthetic_batch(
                cfg, rng, num_objects=args.objects,
                random_entry=args.random_entry))
            if step % max(1, cfg.train.log_every // 10) == 0:
                logger.write(step, metrics)
            if mgr is not None and (step + 1) % cfg.train.checkpoint_every == 0:
                mgr.save(trainer.state)
    finally:
        logger.close()
    if mgr is not None:
        mgr.save(trainer.state)
    if args.release:
        export_release(trainer.model.state_dict(), args.release)
        print(f"release exported to {args.release}", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    add_train_override_args(p)
    args = p.parse_args(argv)
    run_training(Trainer(base_config(args)), args)


if __name__ == "__main__":
    main()
