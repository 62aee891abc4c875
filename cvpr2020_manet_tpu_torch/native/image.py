"""Image decoding and resizing for the dataset adapters and the training
sampler: the port's own baseline JPEG decoder (`jpeg.cpp`), bit-exact with
libjpeg's default RGB output (ISLOW IDCT, fancy upsampling), which is what
PIL returns, and PIL's uint8 `Image.resize` (`resize.cpp`: BILINEAR on RGB
images, NEAREST on label maps), bit for bit.

Both need g++ and nothing else: no libjpeg, no PIL. They are built at
first use into one library, `libivosimage-<cpu tag>.so`, apart from the
metrics' `libivosnative` (a host that cannot build it keeps the native
metrics and robot). Unlike the metrics they have no Python fallback:
without g++, or on a file the decoder does not support (progressive,
lossless, arithmetic-coded, grayscale, CMYK), they raise.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from cvpr2020_manet_tpu_torch.native import (
    _DIR, _cpu_tag, compile_library, needs_build)

_SOURCES = [os.path.join(_DIR, "jpeg.cpp"), os.path.join(_DIR, "resize.cpp")]
# no fused multiply-adds: the resize's coefficients must round as Pillow's
_FLAGS = ("-ffp-contract=off",)
_SO = os.path.join(_DIR, f"libivosimage-{_cpu_tag()}.so")
_ERR_LEN = 256

_lock = threading.Lock()
_lib = None


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if needs_build(_SOURCES, _SO):
            try:
                compile_library(_SOURCES, _SO, _FLAGS)
            except FileNotFoundError as e:
                raise RuntimeError(
                    "the JPEG decoder and the resize (native/jpeg.cpp, "
                    "native/resize.cpp) are built at first use with g++, "
                    "and g++ was not found") from e
            except subprocess.SubprocessError as e:
                detail = (getattr(e, "stderr", None) or b"").decode(
                    errors="replace")
                raise RuntimeError(
                    "g++ failed to build the JPEG decoder and the resize "
                    f"(native/jpeg.cpp, native/resize.cpp): {e}\n{detail}"
                ) from e
        handle = ctypes.CDLL(_SO)
        handle.ivos_jpeg_size.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
        handle.ivos_jpeg_size.restype = ctypes.c_int
        handle.ivos_jpeg_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        handle.ivos_jpeg_decode.restype = ctypes.c_int
        for fn in (handle.ivos_resize_bilinear_rgb,
                   handle.ivos_resize_nearest_u8):
            fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 9 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = handle
        return _lib


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG file bytes -> (H, W, 3) uint8 RGB."""
    lib = _load()
    err = ctypes.create_string_buffer(_ERR_LEN)
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.ivos_jpeg_size(data, len(data), ctypes.byref(h), ctypes.byref(w),
                          err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.ivos_jpeg_decode(data, len(data), out.ctypes.data, h.value,
                            w.value, err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def read_jpeg(path: str) -> np.ndarray:
    """Decode a JPEG file -> (H, W, 3) uint8 RGB."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)


def load() -> None:
    """Build (if needed) and load the library now: a process that starts
    loader workers calls this first, so that they do not all build it."""
    _load()


def _resize(entry: str, src: np.ndarray, channels: int, size, window
            ) -> np.ndarray:
    lead = src.shape[:src.ndim - (3 if channels == 3 else 2)]
    h, w = src.shape[len(lead):len(lead) + 2]
    out_h, out_w = (int(v) for v in size)
    y0, x0, oh, ow = ((0, 0, out_h, out_w) if window is None
                      else (int(v) for v in window))
    if src.dtype != np.uint8:
        raise TypeError(f"resize takes uint8, got {src.dtype}")
    if channels == 3 and src.shape[-1] != 3:
        raise ValueError(f"BILINEAR resize takes (..., H, W, 3), got "
                         f"{src.shape}")
    if not (0 <= y0 and 0 <= x0 and 0 < oh and 0 < ow
            and y0 + oh <= out_h and x0 + ow <= out_w):
        raise ValueError(f"window {(y0, x0, oh, ow)} is not inside "
                         f"{(out_h, out_w)}")
    src = np.ascontiguousarray(src)
    n = int(np.prod(lead, dtype=np.int64))
    tail = (oh, ow, 3) if channels == 3 else (oh, ow)
    out = np.empty(lead + tail, np.uint8)
    if n and getattr(_load(), entry)(src.ctypes.data, n, h, w, out_h, out_w,
                                     y0, x0, oh, ow, out.ctypes.data):
        raise ValueError(f"resize of {src.shape} to {(out_h, out_w)} "
                         f"refused")
    return out


def resize_bilinear(images: np.ndarray, size, window=None) -> np.ndarray:
    """PIL's `Image.fromarray(im).resize((out_w, out_h), Image.BILINEAR)`
    of each uint8 RGB image of (..., H, W, 3), bit for bit; `size` is
    (out_h, out_w). `window` (y0, x0, h, w) returns only that crop of the
    result, computed alone (the same bits as cropping the full resize)."""
    return _resize("ivos_resize_bilinear_rgb", images, 3, size, window)


def resize_nearest(labels: np.ndarray, size, window=None) -> np.ndarray:
    """PIL's `Image.fromarray(lb).resize((out_w, out_h), Image.NEAREST)` of
    each uint8 map of (..., H, W) (mode L), bit for bit; `size` and
    `window` as in `resize_bilinear`."""
    return _resize("ivos_resize_nearest_u8", labels, 1, size, window)
