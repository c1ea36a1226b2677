"""The comparison that decides ``correct``.

The window's outputs of a sample of its calls, drawn from the seed, are
decoded here and held to the plain reference (``gpcbench.reference``) run
on the same input pairs, in the configuration's matching mode
(``epipolar_mode``).  Each layout is decoded from its documented contract,
not with the program's own decoders:

* epipolar, the masked layout: (B, H, 2W) ``(x << bd) | (d + disp_high)``
  at a support, 0x7FFFFFFF elsewhere, bd the bit length of 2 * disp_high,
  and (B, H) row counts;
* global, the global-rows layout: ``(xs, ys, ds)`` (B, R, C) and counts
  (B, R); segment r of a pair holds its supports (x, y, d) in its first
  ``counts[r]`` slots.  The segments are pieces of the route's sorted
  order, not image rows.

Two numbers are compared, each over every checked pair, and each has the
limit 0, since the method is exact integer arithmetic:

* ``support_mismatches``: supports in one set and not the other, counted
  with multiplicity (a support emitted twice counts once more);
* ``row_count_mismatches``: in epipolar mode the rows whose reported count
  differs from the reference's; in global mode, whose counts are per
  segment of the sorted order and not per row, the pairs whose reported
  total (the sum of their segment counts) differs from the reference's
  number of supports.

A buffer that disagrees with its own counts fails one of the two.

``checked_pairs`` has to reach ``min_pairs``: a run that checks nothing
is not correct.  The controls put a reference that breaks one guarantee
in the program's place (``control_outputs``, ``CONTROLS``) and must fail.
"""

from __future__ import annotations

import numpy as np

from gpcbench.reference import gpc

SENTINEL = 0x7FFFFFFF
LIMITS = {"support_mismatches": 0, "row_count_mismatches": 0}


def _bd(disp_high: int) -> int:
    return max(1, int(2 * disp_high).bit_length())


def decode(buf: np.ndarray, disp_high: int):
    """(b, y, x, d) int64 arrays of a (B, H, 2W) masked buffer."""
    b, y, p = np.nonzero(buf != SENTINEL)
    v = buf[b, y, p].astype(np.int64)
    bd = _bd(disp_high)
    return b, y, v >> bd, (v & ((1 << bd) - 1)) - disp_high


def encode(b, y, x, d, h: int, w: int, disp_high: int) -> np.ndarray:
    """int64 keys of supports, one per (b, y, x, d)."""
    return ((b * h + y) * w + x) * (4 * disp_high + 2) + (d + 2 * disp_high)


def decode_global(xs, ys, ds, counts):
    """(b, y, x, d) int64 arrays of (B, R, C) global-rows buffers: the
    first ``counts[b, r]`` slots of each segment."""
    sel = np.arange(xs.shape[-1]) < counts[..., None]
    b = np.nonzero(sel)[0]
    return (b, ys[sel].astype(np.int64), xs[sel].astype(np.int64),
            ds[sel].astype(np.int64))


def take(out, sl):
    """Pairs ``sl`` of a gathered output: an array, or a tuple of them."""
    if isinstance(out, tuple):
        return tuple(take(t, sl) for t in out)
    return out[sl]


def _reference(lefts, rights, tests, cfg, **broken):
    """The reference's supports in the configuration's mode; ``broken``
    holds the keyword arguments of a control."""
    args = (lefts, rights, tests, cfg["gradient_threshold"], cfg["disp_high"])
    if cfg["epipolar_mode"]:
        return gpc.epipolar_supports(*args, **broken)
    tol = broken.pop("vertical_tolerance", cfg["vertical_tolerance"])
    return gpc.global_supports(*args, tol, **broken)


def compare(buf, counts, lefts, rights, tests, cfg) -> dict:
    """The readings of checked pairs: ``buf`` and ``counts`` as the program
    left them in the mode's layout (epipolar: buf (B, H, 2W), counts (B,
    H); global: buf the (xs, ys, ds) triple of (B, R, C), counts (B, R)),
    ``lefts``/``rights`` their input pairs (B, H, W) uint8."""
    bsz, h, w = lefts.shape
    dh = cfg["disp_high"]
    ref = _reference(lefts, rights, tests, cfg)
    if cfg["epipolar_mode"]:
        got = decode(buf, dh)
        ref_counts = np.bincount(ref[0] * h + ref[1],
                                 minlength=bsz * h).reshape(bsz, h)
        count_bad = counts != ref_counts
    else:
        got = decode_global(*buf, counts)
        totals = counts.reshape(bsz, -1).sum(1, dtype=np.int64)
        count_bad = totals != np.bincount(ref[0], minlength=bsz)
    # a support outside the image or past disp_high is in no reference
    # set, and would not encode to a key of its own
    b, y, x, d = got
    ok = (y >= 0) & (y < h) & (x >= 0) & (x < w) & (np.abs(d) <= dh)
    stray = int((~ok).sum())
    a = encode(b[ok], y[ok], x[ok], d[ok], h, w, dh)
    r = encode(*ref, h, w, dh)
    a_u = np.unique(a)
    common = len(np.intersect1d(a_u, r, assume_unique=True))
    per_pair_bad = np.zeros(bsz, bool)
    per_pair_bad[b[~ok]] = True
    mism = np.setxor1d(a_u, r, assume_unique=True)
    per_pair_bad[(mism // (4 * dh + 2) // w // h).astype(np.int64)] = True
    dup = len(a) - len(a_u)
    if dup:
        _, cnt = np.unique(a, return_counts=True)
        per_pair_bad[np.unique(a)[cnt > 1] // (4 * dh + 2) // w // h] = True
    per_pair_bad |= count_bad.reshape(bsz, -1).any(1)
    return {
        "support_mismatches": int(len(a_u) - common + len(r) - common + dup
                                  + stray),
        "row_count_mismatches": int(count_bad.sum()),
        "checked_pairs": int(bsz),
        "failed_pairs": int(per_pair_bad.sum()),
        "supports": int(len(r)),
    }


def add(total: dict, part: dict) -> dict:
    for k, v in part.items():
        total[k] = total.get(k, 0) + v
    return total


def verdict(readings: dict, min_pairs: int = 1) -> bool:
    return (readings.get("checked_pairs", 0) >= min_pairs
            and all(readings.get(k, 1) <= lim for k, lim in LIMITS.items()))


def checks(readings: dict, min_pairs: int = 1) -> dict:
    """The compared numbers beside their limits, for the result line."""
    out = {k: {"value": readings.get(k), "limit": lim}
           for k, lim in LIMITS.items()}
    out["checked_pairs"] = {"value": readings.get("checked_pairs", 0),
                            "limit": min_pairs, "at_least": True}
    return out


# the controls of each mode (``epipolar_mode``), each the reference with
# one guarantee broken
CONTROLS = {True: ("drop_test", "first_of_runs"),
            False: ("drop_test", "first_of_runs", "no_tolerance")}


def control_outputs(lefts, rights, tests, cfg, kind: str):
    """(buf, counts) in the mode's layout from the reference with one
    guarantee broken, to stand in the program's place: ``drop_test``
    computes the codes one bit short (the forest's last test left out),
    ``first_of_runs`` pairs codes that are not unique in their row (in
    global mode: their pair), ``no_tolerance`` (global mode) keeps only
    supports on the same row in both images."""
    if kind not in CONTROLS[cfg["epipolar_mode"]]:
        raise ValueError(f"no control named {kind!r} in this mode")
    bsz, h, w = lefts.shape
    dh = cfg["disp_high"]
    if kind == "drop_test":
        sup = _reference(lefts, rights, gpc.drop_tests(tests), cfg)
    elif kind == "first_of_runs":
        sup = _reference(lefts, rights, tests, cfg, first_of_runs=True)
    else:
        sup = _reference(lefts, rights, tests, cfg, vertical_tolerance=0)
    if not cfg["epipolar_mode"]:
        return global_layout(sup, bsz, h, 2 * w)
    b, y, x, d = sup
    buf = np.full((bsz, h, 2 * w), SENTINEL, np.int32)
    # one support a column slot; the layout's positions are not compared
    col = np.zeros(len(b), np.int64)
    if len(b):
        row = b * h + y
        first = np.searchsorted(row, row)
        col = np.arange(len(b)) - first
    buf[b, y, col] = (x << _bd(dh)) | (d + dh)
    counts = np.bincount(b * h + y, minlength=bsz * h).reshape(bsz, h)
    return buf, counts.astype(np.int32)


def global_layout(sup, bsz: int, r: int, c: int):
    """((xs, ys, ds), counts) of (b, y, x, d) supports in the global-rows
    layout with ``r`` segments of ``c`` slots a pair: each pair's supports
    in order, segment k // c, slot k % c."""
    b, y, x, d = sup
    if len(b) and np.bincount(b).max() > r * c:
        raise ValueError("more supports than the layout holds")
    k = np.arange(len(b)) - np.searchsorted(b, b)
    out = [np.zeros((bsz, r, c), np.int32) for _ in range(3)]
    for o, v in zip(out, (x, y, d)):
        o[b, k // c, k % c] = v
    counts = np.bincount(b * r + k // c, minlength=bsz * r).reshape(bsz, r)
    return tuple(out), counts.astype(np.int32)
