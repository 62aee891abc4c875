"""The monolithic round's label maps on the card: cropped and cast there,
downloaded into pinned host memory.

On the card `Evaluator.collect_round` copies the round's (T_actual, H, W)
int32 labels into a block of PyTorch's caching host allocator and hands
back its numpy view. These tests hold that the view's storage is pinned;
that the card's labels equal the CPU evaluator's for the same labels on
the device, and the replaced path's (bit-packed on the card, unpacked on
the host) for the card's own probabilities; and that the allocator's
pinned bytes stay flat over rounds whose results are dropped: blocks are
reused, not added. The pinned download exists only on the card, so
these tests skip without a GPU. On a machine with one (and no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_round_labels_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu_torch.config import tiny_test_config
from cvpr2020_manet_tpu_torch.data import SyntheticDataset
from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator, RoundHandle
from cvpr2020_manet_tpu_torch.engine.labels import (
    aligned_mask_bits, pack_labels, unpack_labels)
from cvpr2020_manet_tpu_torch.models import MANet
from cvpr2020_manet_tpu_torch.models.layers import resize_bilinear

pytestmark = pytest.mark.cuda

SIZE = (30, 44)         # pads to 32 x 48: the crop drops padding
FRAMES = 3              # the frame bucket is 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the pinned download is the card's")


def _cfg(mask_stride=1):
    cfg = tiny_test_config()
    return dataclasses.replace(cfg, eval=dataclasses.replace(
        cfg.eval, image_size=SIZE, mask_stride=mask_stride,
        round_segments=1))


def _pinned(a: np.ndarray) -> bool:
    return torch.from_numpy(a).is_pinned()


@pytest.mark.parametrize("mask_stride", [1, 2, 4])
def test_collected_labels_are_pinned_and_equal_the_cpus(cuda, mask_stride):
    """The same labels in a round's handle, collected on the card and on
    the CPU: the same array, the card's in pinned memory."""
    cfg = _cfg(mask_stride)
    g = torch.Generator().manual_seed(mask_stride)
    lab = torch.randint(0, 17, (4, 32 // mask_stride, 48 // mask_stride),
                        generator=g)
    out = {}
    for dev in ("cpu", "cuda"):
        ev = Evaluator(cfg, MANet(cfg.model, device=dev, seed=0), device=dev)
        handle = RoundHandle(nf=FRAMES, t_bucket=4, masks=lab.to(dev))
        out[dev] = ev.collect_round(handle, SIZE)
    assert _pinned(out["cuda"]) and not _pinned(out["cpu"])
    assert out["cuda"].dtype == np.int32 and out["cuda"].flags.c_contiguous
    assert out["cuda"].shape == (FRAMES, *SIZE)
    np.testing.assert_array_equal(out["cuda"], out["cpu"])


def _rounds(ev, n, keep):
    """`n` rounds of a tiny 2-object sequence; -> the kept rounds'
    (labels, probabilities, mask size)."""
    ds = SyntheticDataset(image_size=SIZE, num_frames=FRAMES,
                          num_sequences=1, num_objects=2)
    seq = ds.sequences()[0]
    seen = []
    real = Evaluator._labels_impl

    def labels_impl(probs, *, hw):
        seen.append((probs, hw))
        return real(probs, hw=hw)

    ev._labels_impl = labels_impl
    st = ev.start_sequence(ds.images(seq), 2)
    scr = ds.initial_scribbles(seq, 0).to_json()
    kept = []
    for i in range(n):
        seen.clear()
        masks = ev.run_round(st, scr, SIZE, 2)
        if i in keep:
            kept.append((masks, *seen[0]))
    return kept


def test_round_on_card_equals_the_unpacked_path(cuda):
    """A round on the card returns pinned int32 labels, bit for bit those
    the replaced path gives from the card's probabilities."""
    cfg = _cfg()
    ev = Evaluator(cfg, MANet(cfg.model, device="cuda", seed=0),
                   device="cuda")
    for masks, probs, hw in _rounds(ev, 2, keep=(0, 1)):
        bits = aligned_mask_bits(3, hw[1])
        lab = resize_bilinear(probs, hw).argmax(dim=-1).to(torch.uint8)
        want = unpack_labels(pack_labels(lab, bits)[:FRAMES].cpu().numpy(),
                             bits)[:, :SIZE[0], :SIZE[1]].astype(np.int32)
        assert _pinned(masks)
        assert masks.dtype == np.int32 and masks.flags.c_contiguous
        np.testing.assert_array_equal(masks, want)


def test_pinned_bytes_stay_flat_over_dropped_rounds(cuda):
    """After a few rounds have sized the pinned pool, 20 more whose labels
    are dropped add no pinned block and no pinned byte."""
    cfg = _cfg()
    ev = Evaluator(cfg, MANet(cfg.model, device="cuda", seed=0),
                   device="cuda")
    _rounds(ev, 3, keep=())
    before = torch.cuda.host_memory_stats()
    _rounds(ev, 20, keep=())
    after = torch.cuda.host_memory_stats()
    for key in ("allocated_bytes.current", "num_host_alloc"):
        assert after[key] == before[key], (key, before[key], after[key])
    assert before["allocated_bytes.current"] > 0
