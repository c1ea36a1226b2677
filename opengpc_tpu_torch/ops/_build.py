"""Build the package's CUDA kernels at first use and load them.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a``, one process per
source, all started together, and links the objects into one shared
library with a plain C interface, which ``ctypes`` loads.  The library is
written to ``opengpc_tpu_torch/_build/`` under a name keyed by a hash of
the flags and of every file under ``csrc/`` (sources and the headers they
include), so an edited source or header rebuilds and an unchanged tree
loads the library already there.  The build runs under a ``flock`` on
``<library>.lock``, so processes that start together (the ranks of a
``torchrun`` launch) compile once: the first builds, the others wait and
load its library.  A missing ``nvcc`` or a failed build raises: there is
no fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
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
CSRC_SUFFIXES = (".cu", ".cuh", ".h")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
PTXAS_FLAGS = ("-Xptxas", "-v")

# C entry points: (argument types, result type); "p" a pointer or the
# stream, "i" an int
_ENTRY_POINTS = {
    "ogpc_fused_keys": ("pppiiiiiiiiiiiipiiiip", "i"),
    "ogpc_fused_codes": ("ppppppiiipiip", "i"),
    "ogpc_fused_census": ("ppiip", "i"),
    "ogpc_bitonic_sort_rows": ("ppppiip", "i"),
    "ogpc_row_sort": ("pppiip", "i"),
    "ogpc_fused_sparsematch_rows": ("pppppiiipiiip", "i"),
    "ogpc_cuda_error_string": ("i", "s"),
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "s": ctypes.c_char_p}

_lock = threading.Lock()
_lib = None
build_info = {}  # nvcc path, seconds, compiler output of this process's build


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels cannot be built")


def csrc_files(csrc: str = CSRC):
    """Every file the build reads: sources and headers, sorted."""
    return sorted(f for f in glob.glob(os.path.join(csrc, "*"))
                  if f.endswith(CSRC_SUFFIXES))


def _library_path(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + PTXAS_FLAGS).encode())
    for path in files:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libopengpc_kernels_{h.hexdigest()[:16]}.so")


def _compile(sources, target: str) -> None:
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}"
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in sources]
    t0 = time.perf_counter()
    procs = [(subprocess.Popen([nvcc, *NVCC_FLAGS, *PTXAS_FLAGS, "-c", "-o",
                                obj, src], stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True), src)
             for src, obj in zip(sources, objs)]
    logs, failed = [], []
    for proc, src in procs:
        out = proc.communicate()[0]
        logs.append(f"== {os.path.basename(src)}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src} ({proc.returncode})")
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", f"{tmp}.so", *objs]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append(f"== link\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode})")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    log = "".join(logs)
    build_info.update(nvcc=nvcc, seconds=time.perf_counter() - t0, log=log)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{log}")
    os.replace(f"{tmp}.so", target)  # atomic: a concurrent loader never sees half


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        files = csrc_files()
        sources = [f for f in files if f.endswith(".cu")]
        if not sources:
            raise RuntimeError(f"no CUDA sources under {CSRC}")
        target = _library_path(files)
        if not os.path.exists(target):
            os.makedirs(BUILD_DIR, exist_ok=True)
            with open(target + ".lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)  # released on close
                if not os.path.exists(target):  # no other process built it
                    _compile(sources, target)
        lib = ctypes.CDLL(target)
        for name, (args, res) in _ENTRY_POINTS.items():
            fn = getattr(lib, name)
            fn.argtypes = [_CTYPES[a] for a in args]
            fn.restype = _CTYPES[res]
        _lib = lib
        return lib


def cuda_error_string(code: int) -> str:
    return load_library().ogpc_cuda_error_string(code).decode()


def check_launch(name: str, rc: int) -> None:
    """Raise if a C launcher returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({cuda_error_string(rc)})")
