"""Build the package's CUDA kernels at first use and load them.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one shared
library with a plain C interface, which ``ctypes`` loads.  The library is
written to ``opengpc_tpu_torch/_build/`` under a name keyed by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads the library already there.  A missing ``nvcc`` or a failed build
raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
build_info = {}  # nvcc path, seconds, compiler output of this process's build


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels cannot be built")


def _library_path(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libopengpc_kernels_{h.hexdigest()[:16]}.so")


def _compile(sources, target: str) -> None:
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *sources]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_info.update(nvcc=nvcc, seconds=time.perf_counter() - t0,
                      log=proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)  # atomic: a concurrent loader never sees half


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
        if not sources:
            raise RuntimeError(f"no CUDA sources under {CSRC}")
        target = _library_path(sources)
        if not os.path.exists(target):
            _compile(sources, target)
        lib = ctypes.CDLL(target)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ogpc_fused_keys.argtypes = [p, p, i, i, i, i, i, i, p, i, i, i,
                                        i, i, p]
        lib.ogpc_fused_keys.restype = i
        lib.ogpc_cuda_error_string.argtypes = [i]
        lib.ogpc_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def cuda_error_string(code: int) -> str:
    return load_library().ogpc_cuda_error_string(code).decode()
