"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under `csrc/` compiles on its own into a shared library with a
plain C interface (a source may hold several kernels, each with its own C
entry, as the argmin variants sit beside the kernels they extend):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/torch_kernels/lib<name>-<hash>.so <name>.cu

The file name carries a hash of the source, the headers and the flags, so
an edited source rebuilds and a current one is reused. The build runs at
first use (or all at once, in parallel, through `build_all`). A missing
nvcc or a failed build raises: the CUDA path has no fallback.

`LAUNCHES` counts successful kernel launches per kernel (the keys of
`KERNELS`); each wrapper adds one right after its launch, so a run can
show which kernels its main path went through. A replay of a captured
CUDA graph runs no wrapper: `engine/round_graph.py` adds, at each replay,
the launches its capture counted.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")

# kernel (launch counter) -> the source stem under csrc/ that holds it
KERNELS = {"global_matching": "global_matching",
           "global_matching_argmin": "global_matching",
           "global_matching_int8": "global_matching",
           "local_matching": "local_matching",
           "local_matching_argmin": "local_matching",
           "ring_matching": "ring_matching",
           "group_norm": "group_norm"}
SOURCES = tuple(dict.fromkeys(KERNELS.values()))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}
# ptxas report (registers, shared memory, spills) of each fresh build, by
# source
BUILD_LOGS: dict[str, str] = {}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_functions: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def _library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _build(name: str) -> str:
    path = _library_path(name)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)
    BUILD_LOGS[name] = proc.stderr
    return path


def build_all() -> float:
    """Build every source that is not built yet, one nvcc per source, all
    started together. Returns the wall seconds it took."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        for fut in [pool.submit(_build, name) for name in SOURCES]:
            fut.result()
    return time.perf_counter() - t0


def kernel_function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry `symbol` of kernel `name`'s library, built and loaded on
    first use. Every entry returns the cudaError_t of its launch."""
    key = (name, symbol)
    with _lock:
        fn = _functions.get(key)
        if fn is None:
            source = KERNELS[name]
            lib = _libs.get(source)
            if lib is None:
                lib = _libs[source] = ctypes.CDLL(_build(source))
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _functions[key] = fn
        return fn


def check_launch(name: str, err: int) -> None:
    """Raise on a failed launch; count a successful one."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    LAUNCHES[name] += 1
