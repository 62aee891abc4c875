"""The monolithic round's label maps against the path they replaced, on the
CPU, at the tiny configuration.

The round argmaxes its upsampled probabilities on the device and hands
back (T_actual, H, W) int32 labels: repeated by `mask_stride`, cropped to
the real frames and the image, cast, all before the download. The path it
replaced bit-packed the labels on the device (`pack_labels`), unpacked
them on the host (`unpack_labels`), then repeated, cropped and cast them
in numpy. That path is kept here as the oracle: on the same
probabilities the two must give the same labels, bit for bit, at every
bit width the packing takes (1, 2, 4, 8), with and without a crop of the
padding, and at mask strides 1, 2 and 4."""

import dataclasses

import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu_torch.config import tiny_test_config
from cvpr2020_manet_tpu_torch.data import SyntheticDataset
from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
from cvpr2020_manet_tpu_torch.engine.labels import (
    aligned_mask_bits, pack_labels, unpack_labels)
from cvpr2020_manet_tpu_torch.models import MANet
from cvpr2020_manet_tpu_torch.models.layers import resize_bilinear

MAX_OBJECTS = 16
OBJECTS = (1, 2, 5, 16)
STRIDES = (1, 2, 4)
SIZES = ((32, 48), (30, 44))     # the second pads to 32 x 48: cropped
FRAMES = 3                       # the frame bucket is 4: a frame cropped


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg = tiny_test_config()
    return MANet(dataclasses.replace(cfg.model, max_objects=MAX_OBJECTS),
                 device="cpu", seed=0)


def _old_path(probs, mask_hw, nf, bits, stride, image_hw):
    """The replaced path: argmax, pack on the device; download the real
    frames, unpack, repeat, crop and cast on the host."""
    lab = resize_bilinear(probs, mask_hw).argmax(dim=-1).to(torch.uint8)
    masks = unpack_labels(pack_labels(lab, bits)[:nf].numpy(), bits)
    if stride > 1:
        masks = np.repeat(np.repeat(masks, stride, axis=1), stride, axis=2)
    return masks[:, :image_hw[0], :image_hw[1]].astype(np.int32)


def _bits(objects, stride, size):
    h, w = (n + (-n) % 16 for n in size)
    return aligned_mask_bits(objects + 1, w // stride)


def test_the_cases_cover_every_packing_width():
    assert {_bits(o, s, z) for o in OBJECTS for s in STRIDES
            for z in SIZES} == {1, 2, 4, 8}


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("stride", STRIDES)
@pytest.mark.parametrize("objects", OBJECTS)
def test_round_labels_equal_the_unpacked_path(model, monkeypatch, objects,
                                              stride, size):
    cfg = tiny_test_config()
    cfg = dataclasses.replace(
        cfg, model=model.cfg,
        eval=dataclasses.replace(cfg.eval, image_size=size, mask_stride=stride,
                                 round_segments=1))
    ev = Evaluator(cfg, model, device="cpu")
    ds = SyntheticDataset(image_size=size, num_frames=FRAMES,
                          num_sequences=1, num_objects=min(objects, 2))
    seq = ds.sequences()[0]
    seen = []
    real = Evaluator._labels_impl

    def labels_impl(probs, *, hw):
        seen.append((probs, hw))
        return real(probs, hw=hw)

    monkeypatch.setattr(Evaluator, "_labels_impl", staticmethod(labels_impl))
    st = ev.start_sequence(ds.images(seq), objects)
    scr = ds.initial_scribbles(seq, 0).to_json()
    for _ in range(2):          # a first round and a later one
        seen.clear()
        got = ev.run_round(st, scr, size, objects)
        (probs, mask_hw), = seen
        bits = aligned_mask_bits(objects + 1, mask_hw[1])
        assert bits == _bits(objects, stride, size)
        want = _old_path(probs, mask_hw, FRAMES, bits, stride, size)
        assert got.dtype == np.int32
        assert got.flags.c_contiguous
        assert got.shape == (FRAMES, *size)
        np.testing.assert_array_equal(got, want)
