"""Raw array container shared with the native oracle (``cpp/oracle.cc``).

Layout: 8-byte magic ``OGPCRAW1``, then three little-endian int32s
(dtype code, height, width), then tightly packed row-major data.
dtype codes: 0=uint8, 1=uint32, 2=int32, 3=float32.
"""

from __future__ import annotations

import numpy as np

_MAGIC = b"OGPCRAW1"
_DTYPES = {0: np.uint8, 1: np.uint32, 2: np.int32, 3: np.float32}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def write_raw(path: str, arr: np.ndarray) -> None:
    arr = np.ascontiguousarray(arr)
    if arr.ndim != 2:
        raise ValueError("raw container stores 2-D arrays")
    code = _CODES.get(arr.dtype)
    if code is None:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(np.array([code, arr.shape[0], arr.shape[1]], dtype="<i4").tobytes())
        f.write(arr.tobytes())


def read_raw(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _MAGIC:
        raise IOError(f"{path}: bad magic")
    code, h, w = np.frombuffer(data, dtype="<i4", count=3, offset=8)
    dtype = _DTYPES[int(code)]
    arr = np.frombuffer(data, dtype=dtype, count=h * w, offset=20)
    return arr.reshape(h, w).copy()
