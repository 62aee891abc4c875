"""Native (C++) host-side kernels, loaded via ctypes.

Lazy build-on-first-import with g++; the metrics and the robot degrade
gracefully to the pure-Python implementations when no compiler is
available (`lib()` returns None and callers fall back). The JPEG decoder
and the training sampler's resize (`image.py`: `jpeg.cpp`, `resize.cpp`)
are built the same way into their own library and have no fallback.

The .so is built with -march=native, so a cached binary is only valid on
the CPU that built it: the cache file name carries a tag derived from the
host's CPU flags (a binary copied to a different machine — shared volume,
container image — misses the tag and is rebuilt instead of SIGILLing the
process). Rebuilds also trigger when any .cpp source is newer.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = [os.path.join(_DIR, "metrics.cpp"),
            os.path.join(_DIR, "robot.cpp")]


def _cpu_tag() -> str:
    """Short stable identifier of this host's CPU feature set."""
    text = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    text += line
                    break
    except OSError:
        pass
    return hashlib.sha1(text.encode()).hexdigest()[:10]


_SO = os.path.join(_DIR, f"libivosnative-{_cpu_tag()}.so")

_lock = threading.Lock()
_lib = None
_tried = False


def compile_library(sources: list[str], so: str,
                    flags: tuple[str, ...] = ()) -> None:
    """g++ `sources` (with the extra `flags`) into the shared library
    `so`; raises OSError (no g++) or subprocess.SubprocessError (the build
    failed)."""
    # each process builds into its own temporary file: processes that
    # build at the same time (parallel test workers) must not rename one
    # another's output away, which would leave one of them without the
    # library for its whole life
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", *flags,
           *sources, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    os.replace(tmp, so)


def needs_build(sources: list[str], so: str) -> bool:
    return not os.path.exists(so) or os.path.getmtime(so) < max(
        os.path.getmtime(s) for s in sources)


def _build() -> bool:
    try:
        compile_library(_SOURCES, _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def lib():
    """ctypes handle to the native library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if needs_build(_SOURCES, _SO) and not _build():
            return None
        try:
            handle = ctypes.CDLL(_SO)
        except OSError:
            return None
        handle.batched_f_measure.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        handle.batched_jaccard_obj.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        handle.scribble_path.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int]
        handle.scribble_path.restype = ctypes.c_int
        _lib = handle
        return _lib
