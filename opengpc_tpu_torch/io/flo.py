"""Middlebury ``.flo`` optical-flow file format.

Layout (reference reader: SintelOpticalFlow.hpp:384-425):
little-endian ``float32 tag`` (202021.25), ``int32 width``, ``int32 height``,
then ``height * width * 2`` float32 values interleaved (u, v) row-major.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

TAG = 202021.25


def read_flo(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (u, v) as float32 arrays of shape (H, W)."""
    with open(path, "rb") as f:
        data = f.read()
    tag = np.frombuffer(data, dtype="<f4", count=1)[0]
    if tag != np.float32(TAG):
        raise IOError(f"{path}: bad .flo tag {tag!r}")
    width, height = np.frombuffer(data, dtype="<i4", count=2, offset=4)
    uv = np.frombuffer(data, dtype="<f4", count=width * height * 2, offset=12)
    uv = uv.reshape(height, width, 2)
    return uv[:, :, 0].copy(), uv[:, :, 1].copy()


def write_flo(path: str, u: np.ndarray, v: np.ndarray) -> None:
    u = np.asarray(u, dtype=np.float32)
    v = np.asarray(v, dtype=np.float32)
    if u.shape != v.shape or u.ndim != 2:
        raise ValueError("u and v must be equal-shape 2-D arrays")
    height, width = u.shape
    uv = np.stack([u, v], axis=2)
    with open(path, "wb") as f:
        f.write(np.float32(TAG).tobytes())
        f.write(np.array([width, height], dtype="<i4").tobytes())
        f.write(uv.astype("<f4").tobytes())
