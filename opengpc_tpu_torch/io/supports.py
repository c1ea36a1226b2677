"""Supports text files: the "x y d" line format shared by the CLI, the
native oracle (``cpp/oracle.cc``) and the refmatch program (the port's copy
of ``opengpc_tpu.io.supports``).

Writing is the per-frame bottleneck of sequence mode at Sintel scale
(~345k supports a frame): ``np.savetxt(fmt="%d")`` formats slowly, the host
library's writer (``cpp/decode.cc`` ``ogpc_write_supports``, a hand-rolled
itoa, on threads from 50,000 rows) writes the same bytes.  Falls back to
savetxt where the host library cannot be built.
"""

from __future__ import annotations

import ctypes

import numpy as np


def write_supports(path: str, supports: np.ndarray) -> None:
    """Write an (n, 3) int array as 'x y d' lines (byte-identical to
    ``np.savetxt(path, a, fmt="%d")``)."""
    from opengpc_tpu_torch.io.png import _DECODE_THREADS, _native_lib

    a = np.ascontiguousarray(np.asarray(supports).reshape(-1, 3),
                             dtype=np.int32)
    lib = _native_lib()
    ptr = a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    if lib is not None and _DECODE_THREADS > 1 and a.shape[0] >= 50_000:
        # each thread formats an equal slice, the buffers are written in
        # order: the same bytes
        if lib.ogpc_write_supports_par(str(path).encode(), ptr, a.shape[0],
                                       _DECODE_THREADS) == 0:
            return
    if lib is not None and lib.ogpc_write_supports(str(path).encode(), ptr,
                                                   a.shape[0]) == 0:
        return
    np.savetxt(path, a, fmt="%d")


def read_supports(path: str) -> np.ndarray:
    """Read an 'x y d' lines file back into an (n, 3) int64 array."""
    return np.loadtxt(path, dtype=np.int64).reshape(-1, 3)
