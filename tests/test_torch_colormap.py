"""The port's indexed-PNG reader and writer (zlib and numpy) against the
JAX package's PIL-based ones: same palette, same label maps bit for bit,
on PNGs PIL writes (depths 1/2/4/8, which use row filters other than 0 at
the low depths), on hand-built files with each of the five row filters,
and on an 8-bit grayscale file."""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from cvpr2020_manet_tpu.utils.colormap import davis_palette as jax_palette
from cvpr2020_manet_tpu.utils.colormap import load_indexed_png as jax_load
from cvpr2020_manet_tpu_torch.utils.colormap import (
    davis_palette, load_indexed_png, save_indexed_png)


def test_palette_equals_jax():
    assert davis_palette().dtype == np.uint8
    np.testing.assert_array_equal(davis_palette(), jax_palette())


def _ihdr(path):
    with open(path, "rb") as f:
        data = f.read()
    return struct.unpack(">IIBB", data[16:26])       # w, h, depth, ctype


@pytest.mark.parametrize("width", [37, 64, 101])
@pytest.mark.parametrize("colors,depth", [(2, 1), (4, 2), (16, 4), (256, 8)])
def test_pil_written_palette_png_equals_jax(tmp_path, colors, depth, width):
    rng = np.random.default_rng(colors + width)
    mask = rng.integers(0, colors, (23, width)).astype(np.uint8)
    img = Image.fromarray(mask, mode="P")
    img.putpalette(davis_palette()[:colors].reshape(-1).tolist())
    path = str(tmp_path / "m.png")
    img.save(path)
    assert _ihdr(path)[2:] == (depth, 3)
    got = load_indexed_png(path)
    assert got.dtype == np.int32 and got.shape == mask.shape
    np.testing.assert_array_equal(got, jax_load(path))
    np.testing.assert_array_equal(got, mask)


def _png(rows: np.ndarray, filters, depth=8, ctype=3, interlace=0,
         palette=True) -> bytes:
    """A PNG of (h, stride) raw scanline bytes, each row encoded with its
    filter type (filters[y]), bpp 1."""
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    h, stride = rows.shape
    width = stride * 8 // depth
    out, prev = [], np.zeros(stride, np.int64)
    for y in range(h):
        cur = rows[y].astype(np.int64)
        left = np.concatenate([[0], cur[:-1]])
        upleft = np.concatenate([[0], prev[:-1]])
        f = filters[y]
        if f == 0:
            enc = cur
        elif f == 1:
            enc = cur - left
        elif f == 2:
            enc = cur - prev
        elif f == 3:
            enc = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
            enc = cur - pred
        out.append(bytes([f]) + (enc % 256).astype(np.uint8).tobytes())
        prev = cur
    body = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, h, depth, ctype,
                                         0, 0, interlace)))
    if palette:
        body += chunk(b"PLTE", davis_palette().tobytes())
    raw = zlib.compress(b"".join(out))
    # the image data split over two IDAT chunks
    return (body + chunk(b"IDAT", raw[:len(raw) // 2])
            + chunk(b"IDAT", raw[len(raw) // 2:]) + chunk(b"IEND", b""))


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
def test_each_row_filter_equals_jax(tmp_path, filt):
    rng = np.random.default_rng(filt)
    rows = rng.integers(0, 256, (9, 31)).astype(np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_png(rows, [filt] * 9))
    got = load_indexed_png(str(path))
    np.testing.assert_array_equal(got, rows)
    np.testing.assert_array_equal(got, jax_load(str(path)))


def test_mixed_filters_at_low_depth_equal_jax(tmp_path):
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 256, (10, 7)).astype(np.uint8)   # depth 2: w 28
    path = tmp_path / "m.png"
    path.write_bytes(_png(rows, [0, 1, 2, 3, 4] * 2, depth=2))
    got = load_indexed_png(str(path))
    assert got.shape == (10, 28) and got.max() <= 3
    np.testing.assert_array_equal(got, jax_load(str(path)))


def test_grayscale_png_equals_jax(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (17, 33)).astype(np.uint8)
    path = str(tmp_path / "l.png")
    Image.fromarray(img, mode="L").save(path)
    np.testing.assert_array_equal(load_indexed_png(path), jax_load(path))
    for depth in (1, 2, 4):                    # PIL's scaled gray levels
        low = tmp_path / f"l{depth}.png"
        low.write_bytes(_png(img[:5, :6], [0, 1, 2, 3, 4], depth=depth,
                             ctype=0, palette=False))
        np.testing.assert_array_equal(load_indexed_png(str(low)),
                                      jax_load(str(low)))


def test_unsupported_pngs_raise(tmp_path):
    rows = np.zeros((4, 8), np.uint8)
    interlaced = tmp_path / "i.png"
    interlaced.write_bytes(_png(rows, [0] * 4, interlace=1))
    with pytest.raises(ValueError, match="interlaced"):
        load_indexed_png(str(interlaced))
    rgb = str(tmp_path / "rgb.png")
    Image.fromarray(np.zeros((4, 5, 3), np.uint8)).save(rgb)
    with pytest.raises(ValueError, match="colour type 2"):
        load_indexed_png(rgb)
    wide = tmp_path / "16.png"
    wide.write_bytes(_png(np.zeros((4, 16), np.uint8), [0] * 4, depth=16,
                          ctype=0, palette=False))
    with pytest.raises(ValueError, match="bit depth 16"):
        load_indexed_png(str(wide))


def test_saved_png_reads_back_in_pil(tmp_path):
    rng = np.random.default_rng(2)
    mask = rng.integers(0, 11, (31, 45)).astype(np.uint8)
    path = str(tmp_path / "s.png")
    save_indexed_png(path, mask)
    img = Image.open(path)
    assert img.mode == "P"
    np.testing.assert_array_equal(np.asarray(img), mask)
    np.testing.assert_array_equal(
        np.asarray(img.getpalette(), np.uint8).reshape(-1, 3),
        davis_palette())
    np.testing.assert_array_equal(load_indexed_png(path), mask)
