"""Multi-worker training input, PyTorch port of the JAX package's
`data/grain_pipeline.py`. It keeps the JAX module's name and function so
that the counterpart is easy to find, and is built on `torch.utils.data`
(the card's machine has no `grain`).

`make_train_iterator` yields the batches of JAX's grain pipeline
`MapDataset.range(virtual_epoch)[shard_index::shard_count].map(sample)
.repeat(None).batch(B)`, array for array: clip `i` is sampled with its own
`default_rng(SeedSequence([seed, i]))`, batches follow in order and span
the epoch boundary, and the result does not depend on `num_workers`.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterator

import numpy as np
import torch.utils.data

from cvpr2020_manet_tpu_torch.config import Config
from cvpr2020_manet_tpu_torch.data.davis import DavisTrainDataset
from cvpr2020_manet_tpu_torch.native import image as native_image


class ClipBatches(torch.utils.data.Dataset):
    """Batch `j` of the repeated, sharded virtual epoch: the clips
    `inner[(j * B + m) % len(inner)]` for m < B, where
    `inner = range(virtual_epoch)[shard_index::shard_count]`, stacked into
    numpy arrays."""

    def __init__(self, ds: DavisTrainDataset, batch_size: int, seed: int,
                 virtual_epoch: int, shard_index: int, shard_count: int):
        self.ds = ds
        self.batch_size = batch_size
        self.seed = seed
        self.indices = range(virtual_epoch)[shard_index::shard_count]
        if len(self.indices) == 0:
            raise ValueError(f"shard {shard_index} of {shard_count} of a "
                             f"virtual epoch of {virtual_epoch} is empty")

    def sample(self, i: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, i]))
        return self.ds.sample_clip(rng)

    def __getitem__(self, j: int) -> Dict[str, np.ndarray]:
        n = len(self.indices)
        samples = [self.sample(self.indices[(j * self.batch_size + m) % n])
                   for m in range(self.batch_size)]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class _Forever(torch.utils.data.Sampler):
    def __iter__(self):
        return itertools.count()


def _as_is(batch):
    # the trainers take numpy batches: no conversion to tensors
    return batch


def iterate(dataset, num_workers: int) -> Iterator:
    """dataset[0], dataset[1], ... in order: in this process when
    `num_workers` is 0, else from that many worker processes.

    The workers are spawned, not forked: the trainer's process holds a CUDA
    context and threads, and a forked child of it inherits their state
    half-copied; a spawned worker starts from a fresh interpreter, imports
    only what the dataset's unpickling needs, and never touches CUDA. The
    generator shuts the workers down when it is closed or collected."""
    if num_workers < 0:
        raise ValueError(f"num_workers must be >= 0, got {num_workers}")
    if num_workers == 0:
        return (dataset[j] for j in itertools.count())
    return _from_workers(dataset, num_workers)


def _from_workers(dataset, num_workers: int) -> Iterator:
    loader = torch.utils.data.DataLoader(
        dataset, batch_size=None, sampler=_Forever(),
        num_workers=num_workers, collate_fn=_as_is,
        multiprocessing_context="spawn")
    it = iter(loader)
    try:
        yield from it
    finally:
        it._shutdown_workers()


def make_train_iterator(
    root: str,
    cfg: Config,
    *,
    clip_len: int = 3,
    num_workers: int = 4,
    virtual_epoch: int = 100_000,
    seed: int = 0,
    shard_index: int = 0,
    shard_count: int = 1,
    emit_uint8: bool = False,
    batch_size: int | None = None,
    adapter=None,
) -> Iterator[dict]:
    """Infinite iterator of {'images', 'labels', 'obj_valid',
    'frame_valid'} numpy batches. `clip_len` > 3 samples stage-2 clips;
    `emit_uint8` ships raw uint8 images and labels for the trainers'
    device-side `ingest_batch` (4x fewer upload bytes); `batch_size`
    overrides cfg.train.batch_size; `adapter` samples another source than
    the DAVIS tree at `root` (e.g. `data/ytvos.YTVOSDataset`)."""
    ds = DavisTrainDataset(root, cfg, clip_len=clip_len, seed=seed,
                           adapter=adapter, emit_uint8=emit_uint8)
    batch = cfg.train.batch_size if batch_size is None else batch_size
    # build the decoder and resize here, before N workers race to
    native_image.load()
    return iterate(ClipBatches(ds, batch, seed, virtual_epoch, shard_index,
                               shard_count), num_workers)
