"""Binary training-triplet dataset format.

A record is three raw 27x27 uint8 patches (ref, pos, neg), 2187 bytes,
concatenated with no header — bit-compatible with the reference
(writer Feature.hpp:254-263, reader
Feature.hpp:272-296, which validates ``filesize % 2187 == 0``).

Patch byte layout: the reference extracts patches *transposed* relative
to image axes (buffer.hpp:534-544: patch(row=a, col=b) =
image(col = x+a-13, row = y+b-13)), so byte ``27*a + b`` of a stored
patch holds image pixel (y + b - 13, x + a - 13).  We keep that layout;
see :func:`opengpc_tpu_torch.forest.patch_linear_index` for how tests address it.

In-memory representation: ``(N, 3, 729)`` uint8, axis 1 = (ref, pos, neg).
"""

from __future__ import annotations

import os

import numpy as np

PATCH = 27
PATCH_BYTES = PATCH * PATCH  # 729
RECORD_BYTES = 3 * PATCH_BYTES  # 2187


def save_triplets(triplets: np.ndarray, path: str) -> None:
    triplets = np.ascontiguousarray(triplets, dtype=np.uint8)
    if triplets.ndim != 3 or triplets.shape[1] != 3 or triplets.shape[2] != PATCH_BYTES:
        raise ValueError(f"expected (N, 3, {PATCH_BYTES}) uint8, got {triplets.shape}")
    with open(path, "wb") as f:
        f.write(triplets.tobytes())


def load_triplets(path: str) -> np.ndarray:
    size = os.path.getsize(path)
    if size % RECORD_BYTES:
        raise IOError(
            f"{path}: not a triplet dataset (size {size} not a multiple of {RECORD_BYTES})"
        )
    data = np.fromfile(path, dtype=np.uint8)
    return data.reshape(-1, 3, PATCH_BYTES)
