"""Build the package's host library at first use.

``g++`` compiles ``cpp/decode.cc`` (the masked-buffer decode and the
supports writer; C++17 and threads only) together with ``cpp/io.cc`` (the
libpng codec) where ``-lpng -lz`` link and the result loads, else
``cpp/decode.cc`` alone, into one shared library with a plain C
interface, which ``io.png`` loads with ``ctypes``.  Whether the library
has the codec shows in its symbols (``ogpc_png_read``).  The library is
written to ``opengpc_tpu_torch/_build/`` under a name keyed by a hash of
the flags and of both sources, so an edited source rebuilds.  Concurrent first builds (threads, or processes such as
pytest's workers) take an exclusive ``flock`` on the target's lock file;
the one that builds writes a temporary name and renames it, and the others
load what it wrote.  Without a C++ compiler ``build`` returns None and the
callers take their numpy versions.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPP = os.path.join(os.path.dirname(_PKG), "cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("decode.cc", "io.cc")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread")
PNG_LIBS = ("-lpng", "-lz")

_lock = threading.Lock()
# this process's build: compiler, seconds, whether the codec linked, log
build_info = {}


def _cxx() -> Optional[str]:
    return shutil.which("g++") or shutil.which("c++")


def library_path(cpp: str = CPP, build_dir: str = BUILD_DIR) -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + PNG_LIBS).encode())
    for name in SOURCES:
        h.update(name.encode())
        with open(os.path.join(cpp, name), "rb") as f:
            h.update(f.read())
    return os.path.join(build_dir, f"libopengpc_host_{h.hexdigest()[:16]}.so")


def _loads(path: str) -> str:
    """'' when the library at ``path`` loads, else the loader's error (a
    libpng that links but is not on the loader's path)."""
    try:
        ctypes.CDLL(path)
    except OSError as e:
        return str(e)
    return ""


def _compile(cxx: str, cpp: str, target: str) -> bool:
    """Build ``target`` with the codec, or without it where libpng does not
    link or load; records the attempts in ``build_info``."""
    tmp = f"{target}.{os.getpid()}"
    decode, io = (os.path.join(cpp, n) for n in SOURCES)
    attempts = (("libpng", [decode, io, *PNG_LIBS]), ("none", [decode]))
    logs = []
    t0 = time.perf_counter()
    for codec, args in attempts:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *args],
                              capture_output=True, text=True)
        error = f"rc {proc.returncode}" if proc.returncode else _loads(tmp)
        logs.append(f"== {codec}: {error or 'ok'}\n{proc.stdout}"
                    f"{proc.stderr}")
        if not error:
            os.replace(tmp, target)  # atomic: a loader never sees half
            build_info.update(cxx=cxx, seconds=time.perf_counter() - t0,
                              codec=codec, compiled=True, log="".join(logs))
            return True
    if os.path.exists(tmp):
        os.remove(tmp)
    build_info.update(cxx=cxx, compiled=False, log="".join(logs))
    return False


def build(cpp: str = CPP, build_dir: str = BUILD_DIR) -> Optional[str]:
    """The host library's path, built first if needed; None where there is
    no C++ compiler or the build failed (``build_info['log']`` says why)."""
    target = library_path(cpp, build_dir)
    with _lock:
        if os.path.exists(target):
            return target
        cxx = _cxx()
        if cxx is None:
            build_info.update(compiled=False, log="no g++ or c++ on PATH")
            return None
        os.makedirs(build_dir, exist_ok=True)
        with open(target + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
            if os.path.exists(target):  # another process built it
                return target
            return target if _compile(cxx, cpp, target) else None
