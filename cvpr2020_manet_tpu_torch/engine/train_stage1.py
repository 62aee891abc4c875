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
    python -m cvpr2020_manet_tpu_torch.engine.train_stage1 \\
        --davis_root DAVIS --uint8 --grain --grain_workers 4

Data: synthetic moving squares by default, or DAVIS clips (`--davis_root`,
`data/davis.DavisTrainDataset`), in this process or from worker processes
(`--grain`, `data/grain_pipeline.py`). With `--uint8` the host ships raw
uint8 frames and labels and `ingest_batch` normalizes them on the device
at the top of the step (4x fewer upload bytes).

Data parallelism over processes: `--distributed` (with `--coordinator`,
`--num_processes`, `--process_id` or the MANET_* environment variables,
`parallel/distributed.py`) runs one rank per card; `batch_size` is the
global batch and each rank feeds its share from its own data shard. The
trainers all-reduce the gradients (one flat buffer) and the metrics and
divide by the world size, so every rank takes the same step, the global
batch's mean; only rank 0 logs, snapshots and exports.

    python -m cvpr2020_manet_tpu_torch.engine.train_stage1 --distributed \
        --coordinator HOST:PORT --num_processes N --process_id R

`make_cp_train_step` is the context-parallel step: each sample's global
matching runs over the context members of a `parallel/mesh.py` mesh, each
against its share of the reference rows (`parallel/cp_matching.py`).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
from typing import Dict, Iterator

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cvpr2020_manet_tpu_torch.config import (
    Config, check_params_only, tiny_test_config)
from cvpr2020_manet_tpu_torch.device import resolve_device
from cvpr2020_manet_tpu_torch.engine.losses import (
    bootstrap_ratio_schedule, bootstrapped_cross_entropy)
from cvpr2020_manet_tpu_torch.engine.train_state import TrainState
from cvpr2020_manet_tpu_torch.models.layers import resize_bilinear
from cvpr2020_manet_tpu_torch.models.manet import MANet
from cvpr2020_manet_tpu_torch.parallel import distributed
from cvpr2020_manet_tpu_torch.parallel.cp_matching import (
    trainable_local_then_min)
from cvpr2020_manet_tpu_torch.parallel.mesh import Mesh
from cvpr2020_manet_tpu_torch.utils.ingest import preprocess_frames


def _downsample_onehot(labels: torch.Tensor, stride: int, o: int
                       ) -> torch.Tensor:
    """(H, W) int -> (H/s, W/s, O) f32 one-hot via nearest subsampling."""
    sub = labels[stride // 2::stride, stride // 2::stride]
    return F.one_hot(sub.long(), o).float()


def ingest_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Device-side batch ingest at the top of the step: uint8 images ->
    ImageNet-normalized f32 (`utils/ingest.preprocess_frames`), labels of
    another dtype -> int32, so that the host can ship 4x fewer image and
    label bytes. Float batches pass through unchanged. On the CPU it equals
    JAX's bit for bit; on a CUDA tensor PyTorch divides by 255 as a multiply
    by the reciprocal, which may differ in the last bit."""
    out = dict(batch)
    if batch["images"].dtype == torch.uint8:
        out["images"] = preprocess_frames(batch["images"])
    if batch["labels"].dtype != torch.int32:
        out["labels"] = batch["labels"].to(torch.int32)
    return out


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


def make_loss_fn(model: MANet, cfg: Config, gmap_fn=None):
    """-> loss_fn(batch, step) -> (loss, metrics): the forward of one step,
    on a batch of device tensors, at optimizer step `step`.

    gmap_fn(query (Nq, C), ref (Nk, C), ref_onehot (Nk, O), sample) ->
    (Nq, O): the global matching of sample `sample` of the batch (default:
    the model's, kernel 4)."""
    tcfg = cfg.train
    o = cfg.model.max_objects + 1
    s = cfg.model.feature_stride
    if gmap_fn is None:
        gmap_fn = lambda q, k, oh, i: model._global_matching(q, k, oh, None)

    def loss_fn(batch, step: int):
        batch = ingest_batch(batch)
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
        for i, (feat_s, emb_s, labels, obj_valid) in enumerate(zip(
                feat, emb, batch["labels"], batch["obj_valid"])):
            # global matching outside the checkpointed tail: its kernel runs
            # once in the forward, and the tail takes the small (h*w, O) map
            # as an input; gradients reach the kernel's inputs through the
            # Function's saved winners
            ce = emb_s.shape[-1]
            ref_oh = _downsample_onehot(labels[0], s, o)
            gm = gmap_fn(emb_s[2].reshape(-1, ce), emb_s[0].reshape(-1, ce),
                         ref_oh.reshape(-1, o), i)
            args = (feat_s, emb_s, gm, labels, obj_valid)
            per_sample.append(checkpoint(tail, *args, use_reentrant=False)
                              if tcfg.remat else tail(*args))
        loss, l_prop, l_int = (torch.stack(v).mean()
                               for v in zip(*per_sample))
        return loss, {"loss": loss, "loss_prop": l_prop, "loss_int": l_int}

    return loss_fn


def step_with(loss_fn):
    """-> train_step(state, batch, *args): one forward,
    `loss_fn(batch, state.step, *args)`, one backward, the gradients'
    all-reduce in a data-parallel run, and one optimizer update; returns
    the metrics as floats (in a data-parallel run their mean over the
    ranks, the same on every rank)."""
    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], *args):
        loss, metrics = loss_fn(batch, state.step, *args)
        loss.backward()
        state.allreduce_gradients()
        state.apply_gradients()
        values = [v.detach().float().reshape(1) for v in metrics.values()]
        if state.group is not None:
            distributed.all_reduce_mean_(values, state.group)
        return {k: float(v) for k, v in zip(metrics, values)}

    return train_step


def make_train_step(model: MANet, cfg: Config):
    return step_with(make_loss_fn(model, cfg))


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """Host batch -> tensors on `device` in their own dtypes (uint8 stays
    uint8: `ingest_batch` converts on the device); tensors already there
    pass through."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_cp_train_step(model: MANet, cfg: Config, mesh: Mesh):
    """The context-parallel stage-1 step (JAX `make_cp_train_step`) ->
    step(state, batch) -> metrics.

    The batch splits evenly over the mesh's 'data' rows, so the batch's
    mean loss is the mean of the rows' means. Each sample's global matching runs on the
    'context' members of its data row: member m matches the query against
    rows [m Nk/ctx, (m + 1) Nk/ctx) of the reference through
    `GlobalMatchingTrainable` (kernel 4 on a card) and the members'
    (Nq, O) maps meet on the query's device in a differentiable min, out
    of the checkpointed tail as in the one-device step. The rest of the
    step runs on the model's device. Unlike JAX, which gives each member
    Nk // ctx rows and drops the tail, a reference whose rows do not split
    evenly raises."""
    check_params_only(model.cfg, "make_cp_train_step")
    data = mesh.devices.shape[0]
    if cfg.train.batch_size % data:
        raise ValueError(f"batch {cfg.train.batch_size} does not split over "
                         f"{data} data rows")
    per_row = cfg.train.batch_size // data

    def gmap_fn(query, ref, ref_onehot, i):
        return trainable_local_then_min(query, ref, ref_onehot,
                                        list(mesh.devices[i // per_row]))

    train_step = step_with(make_loss_fn(model, cfg, gmap_fn))
    device = next(model.parameters()).device

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        return train_step(state, to_device(batch, device))

    return step


class Trainer:
    """Stage-1 trainer on one device (`cuda` unless `device` says
    otherwise). Weights are drawn from `seed` (default `cfg.train.seed`)
    on the CPU, so every rank of a data-parallel run starts from the same
    weights. Once `parallel/distributed.initialize` has joined a group, it
    trains data-parallel over the world."""

    def __init__(self, cfg: Config, device=None, seed: int | None = None):
        check_params_only(cfg.model, "Trainer")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = MANet(cfg.model, device=self.device,
                           seed=cfg.train.seed if seed is None else seed,
                           trainable_matching=True)
        self.state = TrainState.create(self.model, cfg.train)
        self._step = make_train_step(self.model, cfg)

    def train_step(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """One optimizer step on a batch of numpy arrays (or of tensors
        already on the device, e.g. from `engine/prefetch.py`)."""
        return self._step(self.state, to_device(batch, self.device))


def synthetic_batch(cfg: Config, rng: np.random.Generator,
                    num_objects: int | None = None,
                    random_entry: bool = False,
                    as_uint8: bool = False,
                    batch_size: int | None = None) -> Dict[str, np.ndarray]:
    """Random moving-square triplets (smoke training / tests), the same
    arrays as the JAX package's `synthetic_batch` from the same `rng`.

    num_objects: objects per clip (default 2, capped by the bucket).
    random_entry: each object's first visible frame is drawn over the clip,
    so the model also trains on objects absent from the reference frame.
    as_uint8: raw uint8 images and labels for the device-side ingest
    (`ingest_batch`). batch_size: overrides cfg.train.batch_size."""
    from cvpr2020_manet_tpu_torch.data.synthetic import SyntheticDataset
    b = cfg.train.batch_size if batch_size is None else batch_size
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
    if as_uint8:
        from cvpr2020_manet_tpu_torch.data.davis import (
            IMAGENET_MEAN, IMAGENET_STD)
        images = np.clip((images * IMAGENET_STD + IMAGENET_MEAN) * 255.0,
                         0, 255).astype(np.uint8)
        labels = labels.astype(np.uint8)
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
                   help="train on synthetic clips (the default without "
                        "--davis_root)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny_test_config() instead of the flagship Config()")
    p.add_argument("--log_dir", default=None,
                   help="append metrics to <log_dir>/metrics.jsonl")
    p.add_argument("--snapshot_dir", default=None,
                   help="checkpoint dir (resumes if it has snapshots)")
    p.add_argument("--davis_root", default=None,
                   help="train on DAVIS clips (data/davis.py) instead of "
                        "synthetic")
    p.add_argument("--grain", action="store_true",
                   help="sample in worker processes "
                        "(data/grain_pipeline.py; needs a dataset root)")
    p.add_argument("--grain_workers", type=int, default=4)
    p.add_argument("--shard_index", type=int, default=0,
                   help="this process's data shard")
    p.add_argument("--shard_count", type=int, default=1)
    p.add_argument("--uint8", action="store_true",
                   help="ship raw uint8 batches; normalize on the device "
                        "(ingest_batch): 4x fewer upload bytes")
    p.add_argument("--distributed", action="store_true",
                   help="data parallelism over processes, one rank a card: "
                        "join the torch.distributed group "
                        "(parallel/distributed.py); batch_size is the "
                        "GLOBAL batch and this rank feeds its share")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0 (or MANET_COORDINATOR)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="world size (or MANET_NUM_PROCESSES)")
    p.add_argument("--process_id", type=int, default=None,
                   help="this rank (or MANET_PROCESS_ID)")


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


def join_group(args) -> bool:
    """With `--distributed`, join the process group (on the card, the
    default backend); -> whether this call joined one (the CLI leaves it
    at its end)."""
    if not args.distributed or dist.is_initialized():
        return False
    distributed.initialize(args.coordinator, args.num_processes,
                           args.process_id)
    return dist.is_initialized()


def leave_group(joined: bool) -> None:
    if joined:
        dist.destroy_process_group()


def make_feed(cfg: Config, args, clip_len: int = 3,
              adapter=None) -> Iterator[Dict[str, np.ndarray]]:
    """The CLIs' host batches, as the JAX trainers' `main` picks them:
    `--grain` workers over the dataset (shards by clip index), else the
    sampler in this process (seed + shard_index, and `shard=` only when
    `--shard_count` > 1), else synthetic clips. `adapter` is a dataset in
    place of the DAVIS tree at `--davis_root` (stage 2's YouTube-VOS).
    In a data-parallel run each rank feeds its `local_batch_size`, and its
    rank is its shard when `--shard_count` is 1."""
    b = distributed.local_batch_size(cfg.train.batch_size)
    shard_index, shard_count = args.shard_index, args.shard_count
    if distributed.world_size() > 1 and shard_count == 1:
        shard_index, shard_count = distributed.rank(), \
            distributed.world_size()
    seed = cfg.train.seed + shard_index
    has_data = args.davis_root is not None or adapter is not None
    if args.grain:
        if not has_data:
            raise ValueError("--grain needs a dataset root (--davis_root, "
                             "or stage 2's --ytvos_root)")
        from cvpr2020_manet_tpu_torch.data.grain_pipeline import (
            make_train_iterator)
        return make_train_iterator(
            args.davis_root or "", cfg, clip_len=clip_len,
            num_workers=args.grain_workers, seed=cfg.train.seed,
            shard_index=shard_index, shard_count=shard_count,
            emit_uint8=args.uint8, batch_size=b, adapter=adapter)
    if has_data:
        from cvpr2020_manet_tpu_torch.data.davis import DavisTrainDataset
        ds = DavisTrainDataset(
            args.davis_root or "", cfg, clip_len=clip_len, adapter=adapter,
            seed=seed, emit_uint8=args.uint8,
            shard=((shard_index, shard_count) if shard_count > 1 else None))
        return (ds.batch(b) for _ in itertools.count())
    rng = np.random.default_rng(seed)
    return (synthetic_batch(cfg, rng, num_objects=args.objects,
                            random_entry=args.random_entry,
                            as_uint8=args.uint8, batch_size=b)
            for _ in itertools.count())


def run_training(trainer, args, batches: Iterator[Dict[str, np.ndarray]]
                 ) -> None:
    """The loop both CLIs share: resume from `--snapshot_dir`, train
    `--steps` steps on the next batches of `batches` (fed synchronously, as
    in JAX), log, checkpoint, export; closes `batches` at the end (a
    worker feed stops its workers). In a data-parallel run every rank
    restores from the shared directory and only rank 0 logs, saves (the
    others wait for it at a barrier) and exports."""
    from cvpr2020_manet_tpu_torch.utils.checkpoint import (
        CheckpointManager, export_release)
    from cvpr2020_manet_tpu_torch.utils.logging import MetricLogger
    cfg = trainer.cfg
    main_rank = distributed.rank() == 0

    def save():
        if main_rank:
            mgr.save(trainer.state)
        distributed.barrier()

    mgr = None
    if args.snapshot_dir:
        mgr = CheckpointManager(args.snapshot_dir)
        if mgr.latest_step() is not None:
            mgr.restore(trainer.state)
            if main_rank:
                print(f"resumed from step {trainer.state.step}")
    start = trainer.state.step
    logger = MetricLogger(args.log_dir) if main_rank else None
    try:
        for step in range(start, start + args.steps):
            metrics = trainer.train_step(next(batches))
            if logger is not None and step % max(1, cfg.train.log_every // 10) == 0:
                logger.write(step, metrics)
            if mgr is not None and (step + 1) % cfg.train.checkpoint_every == 0:
                save()
    finally:
        if logger is not None:
            logger.close()
        close = getattr(batches, "close", None)
        if close is not None:
            close()
    if mgr is not None:
        save()
    if args.release and main_rank:
        export_release(trainer.model.state_dict(), args.release)
        print(f"release exported to {args.release}", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    add_train_override_args(p)
    args = p.parse_args(argv)
    joined = join_group(args)
    try:
        cfg = base_config(args)
        trainer = Trainer(cfg)
        run_training(trainer, args, make_feed(cfg, args))
    finally:
        leave_group(joined)


if __name__ == "__main__":
    main()
