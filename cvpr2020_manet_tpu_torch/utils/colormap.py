"""DAVIS label palette + indexed-PNG mask IO (SURVEY.md C19), PyTorch port
of the JAX package's `utils/colormap.py`.

The DAVIS benchmark stores multi-object masks as palettized PNGs whose
palette is the PASCAL-VOC colormap. The JAX package reads and writes them
with PIL; this module does the same with the standard library's `zlib`
and numpy:

- `load_indexed_png` reads colour types 3 (palette) and 0 (grayscale) at
  bit depths 1, 2, 4 and 8, through all five row filters, and returns
  what `np.asarray(Image.open(path), np.int32)` returns: palette indices,
  or gray levels scaled as PIL scales them (depth 2 by 85, depth 4 by 17;
  depth 1 stays 0/1). Interlaced (Adam7), 16-bit and colour types 2, 4
  and 6 raise.
- `save_indexed_png` writes 8-bit colour type 3 with the DAVIS palette in
  PLTE and filter 0 on every row.
- `save_rgb_png` writes an (H, W, 3) uint8 image as 8-bit colour type 2
  (RGB), filter 0 on every row (`utils/visualize.save_image`).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PIL's scale of low-depth gray levels to 8 bits ("L;2", "L;4"); depth 1
# opens as mode "1", whose array is boolean
_GRAY_SCALE = {1: 1, 2: 85, 4: 17, 8: 1}


def davis_palette() -> np.ndarray:
    """PASCAL-VOC / DAVIS 256-entry RGB palette, shape (256, 3) uint8."""
    palette = np.zeros((256, 3), np.uint8)
    for i in range(256):
        lab = i
        r = g = b = 0
        for j in range(8):
            r |= ((lab >> 0) & 1) << (7 - j)
            g |= ((lab >> 1) & 1) << (7 - j)
            b |= ((lab >> 2) & 1) << (7 - j)
            lab >>= 3
        palette[i] = [r, g, b]
    return palette


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def save_indexed_png(path: str, mask: np.ndarray) -> None:
    """Save (H, W) uint8 label map as a palettized PNG (DAVIS format)."""
    mask = np.ascontiguousarray(np.asarray(mask).astype(np.uint8))
    if mask.ndim != 2:
        raise ValueError(f"expected an (H, W) label map, got {mask.shape}")
    h, w = mask.shape
    rows = np.zeros((h, w + 1), np.uint8)        # filter byte 0 per row
    rows[:, 1:] = mask
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0)))
        f.write(_chunk(b"PLTE", davis_palette().tobytes()))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def save_rgb_png(path: str, image: np.ndarray) -> None:
    """Save an (H, W, 3) uint8 image as an 8-bit RGB PNG."""
    image = np.ascontiguousarray(np.asarray(image, np.uint8))
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {image.shape}")
    h, w = image.shape[:2]
    rows = np.zeros((h, 3 * w + 1), np.uint8)    # filter byte 0 per row
    rows[:, 1:] = image.reshape(h, 3 * w)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _read_chunks(data: bytes, path: str):
    """-> (IHDR fields, concatenated IDAT bytes)."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, ihdr, idat = 8, None, []
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated PNG (no IEND chunk)")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"{path}: CRC mismatch in {kind!r} chunk")
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: PNG has no IHDR chunk")
    return ihdr, b"".join(idat)


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of (h, 1 + stride) scanlines -> (h, stride)
    uint8. None, Sub and Up are numpy expressions; Average and Paeth depend
    on the left neighbour through a nonlinear step and run byte by byte."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = raw[y, 0], raw[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:                          # Sub: running sum mod 256
            pad = (-stride) % bpp
            lanes = np.concatenate([line, np.zeros(pad, np.uint8)])
            cur = (np.cumsum(lanes.reshape(-1, bpp).astype(np.uint32), axis=0)
                   .astype(np.uint8).reshape(-1)[:stride])
        elif ftype == 2:                          # Up
            cur = line + prev
        elif ftype in (3, 4):                     # Average, Paeth
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                    cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {ftype} in row {y}")
        out[y] = cur
        prev = out[y]
    return out


def load_indexed_png(path: str) -> np.ndarray:
    """Load a palettized (or 8-bit-or-less grayscale) PNG label map ->
    (H, W) int32."""
    with open(path, "rb") as f:
        data = f.read()
    (w, h, depth, ctype, comp, filt, interlace), idat = _read_chunks(
        data, path)
    if ctype not in (0, 3):
        raise ValueError(
            f"{path}: PNG colour type {ctype} is not a label map (only "
            "palette (3) and grayscale (0) are read)")
    if depth not in (1, 2, 4, 8):
        raise ValueError(f"{path}: PNG bit depth {depth} is not supported "
                         "(1, 2, 4 or 8)")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced (Adam7) PNGs are not supported")
    if comp != 0 or filt != 0:
        raise ValueError(f"{path}: unknown PNG compression/filter method "
                         f"{comp}/{filt}")
    stride = (w * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError(f"{path}: PNG image data is truncated")
    rows = _unfilter(raw[:h * (stride + 1)].reshape(h, stride + 1), h,
                     stride, bpp=1)
    if depth == 8:
        px = rows
    else:
        per_byte = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        px = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(
            h, stride * per_byte)[:, :w]
    out = px.astype(np.int32)
    if ctype == 0:
        out *= _GRAY_SCALE[depth]
    return out
