"""Native (C++) host-side kernels, loaded via ctypes.

Lazy build-on-first-import with g++; everything degrades gracefully to the
pure-Python implementations when no compiler is available (`lib()` returns
None and callers fall back).

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


def _build() -> bool:
    # each process builds into its own temporary file: processes that
    # build at the same time (parallel test workers) must not rename one
    # another's output away, which would leave one of them without the
    # library for its whole life
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           *_SOURCES, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
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
        needs_build = (not os.path.exists(_SO)
                       or os.path.getmtime(_SO) < max(
                           os.path.getmtime(s) for s in _SOURCES))
        if needs_build and not _build():
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
