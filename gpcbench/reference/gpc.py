"""The plain NumPy reference of openGPC's sparse matching, both modes.

Written from the method's description (Wang et al., "The Global Patch
Collider", CVPR 2016) and openGPC's ``lib/gpc/inference.hpp`` and
``filter.hpp`` as the benchmark's configurations run it:

* box: the 3 x 3 mean of the uint8 image, floored, defined on rows
  1 .. h-3 and columns 2 .. w-2 and zero elsewhere (openGPC's filter
  border);
* gradient: Sobel x and y numerators each divided by 9 with truncation
  toward zero, a pixel is textured when sx^2 + sy^2 > threshold^2, on rows
  and columns 1 .. dim-2;
* candidates: textured pixels at least 13 px from every border, so that
  every 27 x 27 test patch lies inside the image;
* leaf code: the forest's first 32 tests in file order, each the bit
  ``box[p + (iy, ix)] > box[p + (jy, jx)] - tau``, test 0 the most
  significant bit;
* epipolar matching: in each row, a code that occurs exactly twice among
  the candidates of both images, once in the left image at x_l and once
  in the right at x_r, is a support (x_l, y, d = x_l - x_r), kept when
  |d| <= disp_high;
* global matching (``epipolar_mode`` false, openGPC's default): within
  one pair, a code that occurs exactly twice among the candidates of both
  whole images, once in the left at (x_l, y_l) and once in the right at
  (x_r, y_r), is a support (x_l, y_l, d = x_l - x_r), kept when |d| <=
  disp_high and |y_l - y_r| <= vertical_tolerance.

Both modes keep |d| <= disp_high where openGPC's ``rectifiedMatch``
(``inference.hpp:384-391``) keeps 0 <= d <= disp_high: the benchmark holds
the port to its own documented contract, which keeps negative
disparities too.

Imports NumPy only.  ``drop_tests``, ``first_of_runs`` and a vertical
tolerance of 0 break one guarantee each; they exist for the benchmark's
controls (``gpcbench.check``).
"""

from __future__ import annotations

import numpy as np

MAX_TESTS = 32
MARGIN = 13
PATCH_HALF = 13


def parse_forest(text: str):
    """The flat (T, 5) int64 tests (ix, iy, jx, jy, tau) of a forest in
    openGPC's text format, the first 32 in file order."""
    toks = text.split()
    pos = 0
    n_ferns = int(toks[pos])
    pos += 1
    tests = []
    for _ in range(n_ferns):
        if toks[pos + 1] not in ("s", "m", "l"):
            raise ValueError(f"bad fern scale {toks[pos + 1]!r}")
        n_tests = int(toks[pos + 2])
        pos += 3
        for _ in range(n_tests):
            tests.append([int(t) for t in toks[pos + 1:pos + 6]])
            pos += 6
    out = np.array(tests[:MAX_TESTS], dtype=np.int64).reshape(-1, 5)
    if len(out) == 0 or np.abs(out[:, :4]).max() > PATCH_HALF:
        raise ValueError("a forest needs 1.. tests inside the 27 x 27 patch")
    return out


def box3(imgs: np.ndarray) -> np.ndarray:
    """(..., h, w) uint8 -> int32 box means, zero outside rows 1..h-3 and
    columns 2..w-2."""
    x = imgs.astype(np.int32)
    h, w = x.shape[-2:]
    out = np.zeros_like(x)
    s = np.zeros(x.shape[:-2] + (h - 3, w - 3), np.int32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s += x[..., 1 + dy:h - 2 + dy, 2 + dx:w - 1 + dx]
    out[..., 1:h - 2, 2:w - 1] = s // 9
    return out


def _trunc9(v: np.ndarray) -> np.ndarray:
    return np.sign(v) * (np.abs(v) // 9)


def textured(imgs: np.ndarray, threshold: int) -> np.ndarray:
    """(..., h, w) bool: the Sobel test on rows and columns 1..dim-2."""
    x = imgs.astype(np.int32)
    h, w = x.shape[-2:]

    def at(dy, dx):
        return x[..., 1 + dy:h - 1 + dy, 1 + dx:w - 1 + dx]

    sx = _trunc9(at(-1, -1) + at(1, -1) + 2 * at(0, -1)
                 - at(-1, 1) - 2 * at(0, 1) - at(1, 1))
    sy = _trunc9(at(-1, -1) + at(-1, 1) + 2 * at(-1, 0)
                 - at(1, -1) - 2 * at(1, 0) - at(1, 1))
    out = np.zeros(x.shape, bool)
    out[..., 1:h - 1, 1:w - 1] = sx * sx + sy * sy > threshold * threshold
    return out


def candidates(imgs: np.ndarray, threshold: int) -> np.ndarray:
    """(..., h, w) bool candidate pixels."""
    c = textured(imgs, threshold)
    c[..., :MARGIN, :] = False
    c[..., c.shape[-2] - MARGIN:, :] = False
    c[..., :MARGIN] = False
    c[..., c.shape[-1] - MARGIN:] = False
    return c


def codes_at(imgs: np.ndarray, tests: np.ndarray, idx):
    """int64 leaf codes of the pixels ``idx`` (a tuple of (b, y, x) index
    arrays) of a (B, h, w) uint8 batch."""
    smooth = box3(imgs).astype(np.int16).ravel()  # box means fit 8 bits
    h, w = imgs.shape[-2:]
    b, y, x = idx
    base = (b * h + y) * w + x
    code = np.zeros(len(base), np.int64)
    for ix, iy, jx, jy, tau in tests:
        a = smooth[base + int(iy * w + ix)]
        c = smooth[base + int(jy * w + jx)]
        code <<= 1
        code |= a > c - np.int16(tau)
    return code


def _candidate_codes(lefts, rights, tests, threshold: int):
    """Every candidate of both images of a (B, h, w) batch of uint8 pairs:
    (b, y, x, code, side) int64 arrays, side 0 the left image, each side
    in raster order."""
    lefts, rights = np.asarray(lefts), np.asarray(rights)
    if lefts.ndim == 2:
        lefts, rights = lefts[None], rights[None]
    parts = []
    for side, imgs in enumerate((lefts, rights)):
        idx = np.nonzero(candidates(imgs, threshold))
        code = codes_at(imgs, tests, idx)
        parts.append(idx + (code, np.full(len(code), side, np.int64)))
    return tuple(np.concatenate(p).astype(np.int64) for p in zip(*parts))


def _unique_pairs(group, code, side, first_of_runs: bool):
    """(i, j): the left and the right candidate of each code that occurs
    exactly twice within its ``group``, once on each side; indices into
    the arrays as given.

    ``first_of_runs`` breaks the uniqueness guarantee: a code that occurs
    more than once in its group then pairs its first left and first right
    occurrence (first in the order given)."""
    key = (group << 32) | code
    order = np.lexsort((side, key))  # by key, left before right, stable
    key, s = key[order], side[order]
    n = len(key)
    if n < 2:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    start = np.ones(n, bool)
    start[1:] = key[1:] != key[:-1]
    run_id = np.cumsum(start) - 1
    run_len = np.bincount(run_id)[run_id]
    if first_of_runs:
        # a run's lefts come first: its first left and its first right
        i = np.nonzero(start & (s == 0) & (run_len >= 2))[0]
        n_left = np.bincount(run_id, weights=(s == 0))[run_id[i]].astype(
            np.int64)
        has_right = n_left < run_len[i]
        i, j = i[has_right], (i + n_left)[has_right]
    else:
        i = np.nonzero(start & (run_len == 2))[0]
        i = i[(s[i] == 0) & (s[i + 1] == 1)]
        j = i + 1
    return order[i], order[j]


def epipolar_supports(lefts, rights, tests, threshold: int, disp_high: int,
                      first_of_runs: bool = False):
    """The supports of a (B, h, w) batch of uint8 pairs: four int64 arrays
    (b, y, x, d), ordered by (b, y, code).

    ``first_of_runs`` breaks the uniqueness guarantee: a code that occurs
    more than once in a row then pairs its first left and first right
    occurrence."""
    b, y, x, code, side = _candidate_codes(lefts, rights, tests, threshold)
    h = np.asarray(lefts).shape[-2]
    i, j = _unique_pairs(b * h + y, code, side, first_of_runs)
    d = x[i] - x[j]
    keep = np.abs(d) <= disp_high
    i, d = i[keep], d[keep]
    return b[i], y[i], x[i], d


def global_supports(lefts, rights, tests, threshold: int, disp_high: int,
                    vertical_tolerance: int, first_of_runs: bool = False):
    """The global-mode supports of a (B, h, w) batch of uint8 pairs: four
    int64 arrays (b, y, x, d), y and x the left image's, ordered by (b,
    code).  A code pairs within its pair's two whole images;
    ``first_of_runs`` as in :func:`epipolar_supports`, over the pair."""
    b, y, x, code, side = _candidate_codes(lefts, rights, tests, threshold)
    i, j = _unique_pairs(b, code, side, first_of_runs)
    d = x[i] - x[j]
    keep = (np.abs(d) <= disp_high) & (np.abs(y[i] - y[j])
                                       <= vertical_tolerance)
    i, d = i[keep], d[keep]
    return b[i], y[i], x[i], d


def drop_tests(tests: np.ndarray, n: int = 1) -> np.ndarray:
    """The forest's tests less its last ``n``: codes of lower precision."""
    return tests[:len(tests) - n]
