"""A baseline JPEG encoder in numpy, for the DAVIS-shaped trees the port
writes (`data/fake_davis.py`; the tests' and chip_smoke.py's trees in
`tests/_torch_davis_tree.py`) on machines without an image library.

`encode_jpeg` writes baseline JFIF: YCbCr 4:2:0, IJG's quality scaling of
the standard quantization tables, and fixed-length Huffman codes that need
no statistics. The port's own decoder (`native/image.read_jpeg`) and PIL
read it.
"""

import numpy as np

JPEG_QUALITY = 90
# IJG's standard quantization tables (JPEG Annex K), natural order
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.full(64, 99)
_Q_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25, 26, 32, 33, 40,
           48]] = [17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 99, 47, 66,
                   99, 99, 99, 99]
# zigzag position -> natural index
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# Fixed-length Huffman codes, valid baseline tables that need no
# statistics: the 12 DC categories at 4 bits, and the 162 AC symbols (EOB,
# ZRL and run/size pairs of sizes 1-10) at 8 bits, each code its index
_DC_SYMBOLS = np.arange(12)
_AC_SYMBOLS = np.array(sorted([0x00, 0xF0] + [(r << 4) | s for r in range(16)
                                              for s in range(1, 11)]))
_AC_CODE = np.zeros(256, np.int64)
_AC_CODE[_AC_SYMBOLS] = np.arange(len(_AC_SYMBOLS))


def _dct_matrix() -> np.ndarray:
    u, x = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    c = np.cos((2 * x + 1) * u * np.pi / 16) * np.sqrt(2 / 8)
    c[0] /= np.sqrt(2)
    return c


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def _size_category(v: np.ndarray) -> np.ndarray:
    """Bits of |v| (0 for 0), the JPEG magnitude category."""
    a = np.abs(v)
    s = np.zeros(v.shape, np.int64)
    nz = a > 0
    s[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return s


def _pack_bits(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Concatenate MSB-first codes; pad the last byte with 1s; stuff a zero
    after every 0xFF."""
    ends = np.cumsum(lengths)
    starts = ends - lengths
    total = int(ends[-1]) if len(ends) else 0
    bits = np.ones(total + (-total) % 8, np.uint8)
    for b in range(int(lengths.max(initial=0))):
        live = lengths > b
        bits[starts[live] + b] = (values[live] >> (lengths[live] - 1 - b)) & 1
    data = np.packbits(bits)
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0).tobytes()


def encode_jpeg(rgb: np.ndarray, quality: int = JPEG_QUALITY) -> bytes:
    """(H, W, 3) uint8 -> baseline JFIF JPEG bytes, YCbCr 4:2:0, IJG's
    quality scaling of the standard tables, fixed-length Huffman codes.
    numpy only: it needs no image library."""
    h, w = rgb.shape[:2]
    scale = 5000 / quality if quality < 50 else 200 - 2 * quality
    qtabs = [np.clip((q * scale + 50) // 100, 1, 255).astype(np.int64)
             for q in (_Q_LUMA, _Q_CHROMA)]
    x = rgb.astype(np.float64)
    ycc = np.stack([
        0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2],
        -0.168736 * x[..., 0] - 0.331264 * x[..., 1] + 0.5 * x[..., 2] + 128,
        0.5 * x[..., 0] - 0.418688 * x[..., 1] - 0.081312 * x[..., 2] + 128])
    ycc = np.pad(ycc, ((0, 0), (0, (-h) % 16), (0, (-w) % 16)), mode="edge")
    hp, wp = ycc.shape[1:]
    my, mx = hp // 16, wp // 16
    c = _dct_matrix()

    def blocks(plane, q):
        b = (plane - 128).reshape(plane.shape[0] // 8, 8, -1, 8)
        coef = c @ (b @ c.T).transpose(0, 2, 1, 3)       # (by, bx, u, v)
        qz = np.round(coef / q.reshape(8, 8)).astype(np.int64)
        return qz.reshape(*qz.shape[:2], 64)[..., _ZIGZAG]    # (by, bx, 64)

    yb = blocks(ycc[0], qtabs[0])
    cb = blocks(ycc[1].reshape(hp // 2, 2, wp // 2, 2).mean((1, 3)), qtabs[1])
    cr = blocks(ycc[2].reshape(hp // 2, 2, wp // 2, 2).mean((1, 3)), qtabs[1])
    # MCU order: 4 luma blocks (2 x 2), then Cb, then Cr
    yb = yb.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(
        my * mx, 4, 64)
    stream = np.concatenate([yb, cb.reshape(-1, 1, 64), cr.reshape(-1, 1, 64)],
                            axis=1).reshape(-1, 64)
    comp = np.tile([0, 0, 0, 0, 1, 2], my * mx)
    stream[:, 1:] = np.clip(stream[:, 1:], -1023, 1023)
    dc = stream[:, 0].copy()
    diff = np.empty_like(dc)
    for k in range(3):                     # DC predicted per component
        sel = np.flatnonzero(comp == k)
        diff[sel] = np.diff(dc[sel], prepend=0)
    n_blocks = len(stream)

    def extra(v, s):
        return np.where(v < 0, v + (1 << s) - 1, v)
    s_dc = _size_category(diff)
    keys = [np.arange(n_blocks) * 130]
    vals = [(s_dc << s_dc) | extra(diff, s_dc)]
    lens = [4 + s_dc]
    b_idx, k_idx = np.nonzero(stream[:, 1:])
    k_idx = k_idx + 1
    v = stream[b_idx, k_idx]
    first = np.r_[True, b_idx[1:] != b_idx[:-1]]
    prev_k = np.where(first, 0, np.r_[0, k_idx[:-1]])
    run = k_idx - prev_k - 1
    s = _size_category(v)
    keys.append(b_idx * 130 + 2 * k_idx)
    vals.append((_AC_CODE[((run % 16) << 4) | s] << s) | extra(v, s))
    lens.append(8 + s)
    n_zrl = run // 16
    zb = np.repeat(b_idx, n_zrl)
    keys.append(zb * 130 + 2 * np.repeat(k_idx, n_zrl) - 1)
    vals.append(np.full(len(zb), _AC_CODE[0xF0]))
    lens.append(np.full(len(zb), 8))
    last = np.zeros(n_blocks, np.int64)
    last[b_idx] = k_idx                    # k ascending within a block
    eob = np.flatnonzero(last < 63)
    keys.append(eob * 130 + 129)
    vals.append(np.full(len(eob), _AC_CODE[0x00]))
    lens.append(np.full(len(eob), 8))
    order = np.argsort(np.concatenate(keys), kind="stable")
    scan = _pack_bits(np.concatenate(vals)[order],
                      np.concatenate(lens)[order])

    def dht(tc_th, counts, symbols):
        return bytes([tc_th]) + bytes(counts) + bytes(symbols.tolist())
    dc_counts = [0] * 16
    dc_counts[3] = len(_DC_SYMBOLS)
    ac_counts = [0] * 16
    ac_counts[7] = len(_AC_SYMBOLS)
    return b"".join([
        b"\xff\xd8",
        _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
        _segment(0xDB, b"".join(bytes([i]) + bytes(t[_ZIGZAG].tolist())
                                for i, t in enumerate(qtabs))),
        _segment(0xC0, bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
                 + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])),
        _segment(0xC4, dht(0x00, dc_counts, _DC_SYMBOLS)
                 + dht(0x10, ac_counts, _AC_SYMBOLS)),
        _segment(0xDA, bytes([3, 1, 0x00, 2, 0x00, 3, 0x00, 0, 63, 0])),
        scan, b"\xff\xd9"])
