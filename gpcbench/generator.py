"""The benchmark's input pool: synthetic rectified stereo pairs made on the
device from ``--seed``.

The semantics of a sparse Sintel-like pair: a smooth background whose
Sobel response stays under the gradient threshold, 24 x 24 textured
patches covering ``density`` of the scene, and one constant disparity per
pair drawn from the traffic's range, so that ``left(x) == right(x - d)``.
A traffic with a ``vertical`` range also gives each pair a constant
vertical offset, a rectified camera's residual error of a row or so:
``left(y, x) == right(y - dy, x - d)``.

Every random number comes from a counter-based hash of (seed, stream,
element index) computed with int64 tensor operations, so the same seed
gives the same pool on any device, in a few large calls and without a
host round trip.  The smoothing is integer arithmetic (floor division),
which every device computes alike.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
PATCH = 24
_MUL1, _MUL2 = 0x7FEB352D, 0x5BD1E995  # both < 2**31: products stay < 2**63

# stream ids of the draws
_DISP, _BG, _TEX, _CELL, _DY = 1, 2, 3, 4, 5


def _mix(x: int) -> int:
    """The 32-bit hash of a python int, the same as :func:`_hash`."""
    x &= M32
    x ^= x >> 16
    x = (x * _MUL1) & M32
    x ^= x >> 15
    x = (x * _MUL2) & M32
    return x ^ (x >> 16)


def _hash(x: torch.Tensor) -> torch.Tensor:
    """32-bit hash of int64 values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = (x * _MUL1) & M32
    x = x ^ (x >> 15)
    x = (x * _MUL2) & M32
    return x ^ (x >> 16)


def _keys(seed: int, stream: int):
    """Two 32-bit keys of (seed, stream); seeds of any size are reduced to
    64 bits first."""
    seed &= (1 << 64) - 1
    k1 = _mix(_mix(seed & M32) ^ _mix(stream * 0x9E3779B9))
    k2 = _mix(_mix(seed >> 32) + k1 + stream)
    return k1, k2


def uniform_u32(seed: int, stream: int, shape, device, offset: int = 0):
    """(shape) int64 tensor of uniform 32-bit values, element i the hash of
    (seed, stream, offset + i)."""
    k1, k2 = _keys(seed, stream)
    n = math.prod(shape)
    idx = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    return _hash((_hash(idx ^ k1) + k2) & M32).reshape(shape)


def _smooth(x: torch.Tensor, passes: int) -> torch.Tensor:
    """``passes`` rounds of the 5-point average with wrap-around, floored."""
    for _ in range(passes):
        x = (torch.roll(x, 1, -2) + torch.roll(x, -1, -2) + torch.roll(x, 1, -1)
             + torch.roll(x, -1, -1) + x).div(5, rounding_mode="floor")
    return x


def disparities(seed: int, pairs: int, lo: int, hi: int, device="cpu"):
    """The (pairs,) int64 constant disparities in [lo, hi]."""
    u = uniform_u32(seed, _DISP, (pairs,), device)
    return lo + u % (hi - lo + 1)


def vertical_offsets(seed: int, pairs: int, lo: int, hi: int,
                     device="cpu"):
    """The (pairs,) int64 constant vertical offsets in [lo, hi], from a
    stream of their own."""
    u = uniform_u32(seed, _DY, (pairs,), device)
    return lo + u % (hi - lo + 1)


def _scenes(seed, first, n, h, ws, density, device):
    """(n, h, ws) uint8 scenes of pool pairs [first, first + n)."""
    off = first * h * ws
    bg = 118 + uniform_u32(seed, _BG, (n, h, ws), device, off) % 20
    bg = _smooth(bg, 6)
    tex = _smooth(uniform_u32(seed, _TEX, (n, h, ws), device, off) % 256, 2)
    ny, nx = -(-h // PATCH), -(-ws // PATCH)
    k = round(density * ny * nx)
    score = uniform_u32(seed, _CELL, (n, ny * nx), device, first * ny * nx)
    # the k cells of least score, ties broken by cell index
    order = torch.argsort(score * (ny * nx) + torch.arange(
        ny * nx, device=device), dim=1)
    cells = torch.zeros((n, ny * nx), dtype=torch.bool, device=device)
    cells.scatter_(1, order[:, :k], True)
    cells = cells.reshape(n, ny, nx)
    mask = cells.repeat_interleave(PATCH, 1).repeat_interleave(PATCH, 2)
    mask = mask[:, :h, :ws]
    return torch.where(mask, tex, bg).to(torch.uint8)


def make_pool(seed: int, pairs: int, h: int, w: int, density: float,
              disparity, device="cpu", chunk: int = 4, vertical=None):
    """(lefts, rights, ds): two (pairs, h, w) uint8 tensors on ``device``
    and the (pairs,) int64 disparities, ``disparity = (lo, hi)``.  Pair p
    is the window [0, w) of its scene on the left and [d_p, d_p + w) on
    the right.  With ``vertical = (lo, hi)`` the right window is also
    shifted by dy_p rows (:func:`vertical_offsets`), in a scene tall
    enough for every offset; without it the pool is the same as with
    ``(0, 0)``.  ``chunk`` pairs are made at a time, which bounds the
    temporaries without changing a value."""
    lo, hi = (int(v) for v in disparity)
    if not 0 <= lo <= hi:
        raise ValueError(f"disparity range must satisfy 0 <= lo <= hi, got "
                         f"{disparity}")
    vlo, vhi = (int(v) for v in (vertical or (0, 0)))
    if vlo > vhi:
        raise ValueError(f"vertical range must satisfy lo <= hi, got "
                         f"{vertical}")
    ds = disparities(seed, pairs, lo, hi, device)
    ws = w + hi
    y0 = max(0, -vlo)  # the left window's first row in the scene
    hs = y0 + h + max(0, vhi)
    if hs != h:
        dys = vertical_offsets(seed, pairs, vlo, vhi, device)
    lefts = torch.empty((pairs, h, w), dtype=torch.uint8, device=device)
    rights = torch.empty_like(lefts)
    cols = torch.arange(w, device=device)
    rows = torch.arange(h, device=device)
    for first in range(0, pairs, chunk):
        n = min(chunk, pairs - first)
        scene = _scenes(seed, first, n, hs, ws, density, device)
        lefts[first:first + n] = scene[:, y0:y0 + h, :w]
        idx = (cols[None, :] + ds[first:first + n, None])[:, None, :]
        if hs != h:
            ridx = (rows[None, :] + y0 + dys[first:first + n, None])
            scene = torch.gather(scene, 1, ridx[:, :, None].expand(n, h, ws))
        rights[first:first + n] = torch.gather(scene, 2,
                                               idx.expand(n, h, w))
    return lefts, rights, ds
