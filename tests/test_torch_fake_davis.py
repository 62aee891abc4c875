"""The port's fake DAVIS tree writer (`data/fake_davis.py`) against the JAX
package's `scripts/make_fake_davis.py`, and the numpy JPEG encoder it
shares with `tests/_torch_davis_tree.py` (`utils/jpeg.py`), on the CPU.

Annotations and scribble JSON are bit-equal to JAX's. The frames are the
same uint8 renders through another baseline JPEG encoder at quality 90
(JAX saves with PIL): decoded, they differ from JAX's decoded frames by at
most 21 levels and 1.95 on average (measured at 150x180, 160x200 and
480x854); the bounds below are 24 and 2.5.
"""

import functools
import glob
import hashlib
import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest
from PIL import Image

from cvpr2020_manet_tpu_torch.data import fake_davis
from cvpr2020_manet_tpu_torch.data.davis import DavisEvalDataset
from cvpr2020_manet_tpu_torch.native.image import read_jpeg
from cvpr2020_manet_tpu_torch.utils.jpeg import encode_jpeg

ROOT = pathlib.Path(__file__).resolve().parents[1]
JPEG_MAX_DIFF = 24
JPEG_MEAN_DIFF = 2.5


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "make_fake_davis", ROOT / "scripts" / "make_fake_davis.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _files(root, kind, name, ext):
    return sorted(glob.glob(os.path.join(root, kind, "480p", name,
                                         f"*.{ext}")))


@pytest.mark.parametrize("t,n_obj,seed,h,w", [(5, 2, 7, 150, 180),
                                              (4, 3, 8, 160, 200),
                                              (6, 1, 9, 128, 136)])
def test_sequence_equals_jax(tmp_path, t, n_obj, seed, h, w):
    ours, theirs = str(tmp_path / "torch"), str(tmp_path / "jax")
    fake_davis.write_sequence(ours, "s", t, n_obj, seed, h, w)
    _jax_script().write_sequence(theirs, "s", t, n_obj, seed, h, w)
    for kind, ext in (("Annotations", "png"), ("JPEGImages", "jpg")):
        assert [os.path.basename(f) for f in _files(ours, kind, "s", ext)] \
            == [os.path.basename(f) for f in _files(theirs, kind, "s", ext)]
    for a, b in zip(_files(ours, "Annotations", "s", "png"),
                    _files(theirs, "Annotations", "s", "png")):
        with Image.open(a) as x, Image.open(b) as y:
            assert x.mode == y.mode == "P"
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
            assert x.getpalette() == y.getpalette()
    for k in range(1, 4):
        payloads = []
        for root in (ours, theirs):
            with open(os.path.join(root, "Scribbles", "s",
                                   f"{k:03d}.json")) as f:
                payloads.append(json.load(f))
        assert payloads[0] == payloads[1]
    for a, b in zip(_files(ours, "JPEGImages", "s", "jpg"),
                    _files(theirs, "JPEGImages", "s", "jpg")):
        with Image.open(b) as y:
            want = np.asarray(y).astype(np.int64)
        got = read_jpeg(a).astype(np.int64)
        diff = np.abs(got - want)
        assert got.shape == (h, w, 3)
        assert diff.max() <= JPEG_MAX_DIFF and diff.mean() <= JPEG_MEAN_DIFF, \
            (diff.max(), diff.mean())


def test_tree_loads_through_davis_eval_dataset(tmp_path, monkeypatch,
                                               capsys):
    """The CLI writes every sequence and both split lists; the eval
    adapter reads them back (frames, labels, objects, scribble sets). The
    sequences are shortened and the frames shrunk here: their shapes are
    the only change."""
    monkeypatch.setattr(fake_davis, "SEQUENCES",
                        [("two_obj", 4, 2), ("one_obj", 3, 1)])
    monkeypatch.setattr(fake_davis, "write_sequence", functools.partial(
        fake_davis.write_sequence, h=144, w=176))
    root = str(tmp_path / "fake")
    assert fake_davis.main(["--root", root, "--seed", "3"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == \
        f"tree at {root}: 2 sequences, 7 frames"
    ds = DavisEvalDataset(root)
    assert ds.sequences() == ["two_obj", "one_obj"]
    with open(os.path.join(root, "ImageSets", "2017", "train.txt")) as f:
        assert f.read().split() == ds.sequences()
    for seq, t, n_obj in fake_davis.SEQUENCES:
        assert ds.images_uint8(seq).shape == (t, 144, 176, 3)
        assert ds.images(seq).dtype == np.float32
        gt = ds.gt_masks(seq)
        assert gt.shape == (t, 144, 176)
        assert ds.num_objects(seq) == n_obj
        assert set(np.unique(gt)) == set(range(n_obj + 1))
        for k in range(ds.num_scribble_sets(seq)):
            scr = ds.initial_scribbles(seq, k)
            frame = (k * (t // 3)) % t
            assert scr.num_frames == t
            assert len(scr.scribbles[frame]) > 0


# sha256 of `encode_jpeg` on seeded frames and of every JPEG that
# `tests/_torch_davis_tree.py` writes for a small tree, taken before the
# encoder moved into the package
ENCODED = {(0, 64, 96): "97dd2008117bd4ce4b5a212797785536"
                        "e37f45ab9d0c788615923357fb5dbc11",
           (1, 37, 53): "abe8eca7a1f3b912aaa6e823319eb296"
                        "21956da8a1be15532b8b162c7435e7cf",
           (2, 480, 854): "d9aa9924e3e9b563f5116b2828df8ee6"
                          "6804181f2a8019f939ffad23cdfc3ca5"}
TREE_JPEGS = "ae9eb9a10219514f8fff27226e00e969bdb924f4eb58f7d5e03da26e0ea85acc"


@pytest.mark.parametrize("seed,h,w", sorted(ENCODED))
def test_encoder_bytes_unchanged(seed, h, w):
    x = np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                             dtype=np.uint8)
    assert hashlib.sha256(encode_jpeg(x)).hexdigest() == ENCODED[seed, h, w]


def test_tree_writer_jpegs_unchanged(tmp_path):
    from _torch_davis_tree import write_davis_tree, write_ytvos_tree
    d = str(tmp_path)
    write_davis_tree(d, (64, 96), [("seq_a", 3, 2, 0), ("seq_b", 2, 1, 1)], 1)
    write_ytvos_tree(d + "/yt", (48, 64), [("v1", 2, 2, 3)])
    h = hashlib.sha256()
    for f in (sorted(glob.glob(d + "/JPEGImages/480p/*/*.jpg"))
              + sorted(glob.glob(d + "/yt/train/JPEGImages/*/*.jpg"))):
        with open(f, "rb") as fp:
            h.update(fp.read())
    assert h.hexdigest() == TREE_JPEGS
