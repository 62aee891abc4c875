"""The port's training loader (`data/grain_pipeline.py`, on
`torch.utils.data`) against the JAX package's grain pipeline, on the
`davis_root` fixture tree: the same batches in the same order, across the
virtual epoch's end, sharded, and the same at any worker count."""

import itertools

import numpy as np
import pytest

from cvpr2020_manet_tpu.config import tiny_test_config as jax_tiny
from cvpr2020_manet_tpu.data.grain_pipeline import (
    make_train_iterator as jax_iterator)
from cvpr2020_manet_tpu_torch.config import tiny_test_config
from cvpr2020_manet_tpu_torch.data import grain_pipeline as tgp


def take(it, n):
    return list(itertools.islice(it, n))


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize("kw", [
    dict(seed=1),
    dict(seed=7, shard_index=1, shard_count=2),
    dict(seed=3, virtual_epoch=5, batch_size=2),
    dict(seed=3, virtual_epoch=7, shard_index=1, shard_count=2,
         batch_size=2, emit_uint8=True, clip_len=6),
], ids=["default", "shard1of2", "epoch_end", "epoch_end_shard_u8_clip6"])
def test_batches_equal_jax(davis_root, kw):
    """The first 3 batches; with virtual epochs of 5 and 7 (sharded: 3
    clips) batches 2 and 3 wrap around to the epoch's first clips."""
    want = take(jax_iterator(davis_root, jax_tiny(), num_workers=0, **kw), 3)
    got = take(tgp.make_train_iterator(davis_root, tiny_test_config(),
                                       num_workers=0, **kw), 3)
    assert_batches_equal(got, want)


def test_epoch_repeats_exactly(davis_root):
    """A virtual epoch of 4 clips at batch 2: batch 2 repeats batch 0."""
    b = take(tgp.make_train_iterator(davis_root, tiny_test_config(),
                                     num_workers=0, virtual_epoch=4,
                                     batch_size=2), 3)
    assert_batches_equal([b[2]], [b[0]])
    assert not np.array_equal(b[0]["images"], b[1]["images"])


def test_workers_equal_in_process(davis_root):
    """Two spawned workers give the in-process batches, in order, as numpy
    arrays; closing the iterator stops the workers."""
    kw = dict(seed=2, virtual_epoch=9, batch_size=2, emit_uint8=True)
    want = take(tgp.make_train_iterator(davis_root, tiny_test_config(),
                                        num_workers=0, **kw), 5)
    it = tgp.make_train_iterator(davis_root, tiny_test_config(),
                                 num_workers=2, **kw)
    got = take(it, 5)
    it.close()
    assert all(isinstance(v, np.ndarray) for b in got for v in b.values())
    assert_batches_equal(got, want)


def test_bad_arguments_raise(davis_root):
    with pytest.raises(ValueError, match="num_workers"):
        tgp.make_train_iterator(davis_root, tiny_test_config(),
                                num_workers=-1)
    with pytest.raises(ValueError, match="is empty"):
        tgp.make_train_iterator(davis_root, tiny_test_config(),
                                virtual_epoch=1, shard_index=1,
                                shard_count=2)
