"""JPEG decoding for the DAVIS adapter: the port's own baseline decoder
(`jpeg.cpp`), bit-exact with libjpeg's default RGB output (ISLOW IDCT,
fancy upsampling), which is what PIL returns.

The decoder needs g++ and nothing else: no libjpeg, no PIL. It is built
at first use into its own library, `libivosimage-<cpu tag>.so`, apart
from the metrics' `libivosnative` (a host that cannot build it keeps the
native metrics and robot). Unlike the metrics it has no Python fallback:
without g++, or on a file it does not support (progressive, lossless,
arithmetic-coded, grayscale, CMYK), it raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from cvpr2020_manet_tpu_torch.native import (
    _DIR, _cpu_tag, compile_library, needs_build)

_SOURCES = [os.path.join(_DIR, "jpeg.cpp")]
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
                compile_library(_SOURCES, _SO)
            except FileNotFoundError as e:
                raise RuntimeError(
                    "the JPEG decoder (native/jpeg.cpp) is built at first "
                    "use with g++, and g++ was not found") from e
            except subprocess.SubprocessError as e:
                detail = (getattr(e, "stderr", None) or b"").decode(
                    errors="replace")
                raise RuntimeError(
                    "g++ failed to build the JPEG decoder (native/jpeg.cpp):"
                    f" {e}\n{detail}") from e
        handle = ctypes.CDLL(_SO)
        handle.ivos_jpeg_size.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
        handle.ivos_jpeg_size.restype = ctypes.c_int
        handle.ivos_jpeg_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        handle.ivos_jpeg_decode.restype = ctypes.c_int
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
