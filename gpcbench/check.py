"""The comparison that decides ``correct``.

The window's outputs of a sample of its calls, drawn from the seed, are
decoded here from the masked contract's layout (``(x << bd) | (d +
disp_high)`` at a support, 0x7FFFFFFF elsewhere, bd the bit length of
2 * disp_high) and held to the plain reference (``gpcbench.reference``)
run on the same input pairs.  Two numbers are compared, each over every
checked pair, and each has the limit 0, since the method is exact integer
arithmetic:

* ``support_mismatches``: supports in one set and not the other, counted
  with multiplicity (a support emitted twice counts once more);
* ``row_count_mismatches``: rows whose reported count differs from the
  reference's.

A buffer that disagrees with its own counts fails one of the two.

``checked_pairs`` has to reach ``min_pairs``: a run that checks nothing
is not correct.  The control puts a reference that breaks one guarantee
in the program's place (``control_outputs``) and must fail.
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


def compare(buf, counts, lefts, rights, tests, cfg) -> dict:
    """The readings of checked pairs: ``buf`` (B, H, 2W) and ``counts``
    (B, H) as the program left them, ``lefts``/``rights`` their input
    pairs (B, H, W) uint8."""
    bsz, h, w = lefts.shape
    dh = cfg["disp_high"]
    ref = gpc.epipolar_supports(lefts, rights, tests,
                                cfg["gradient_threshold"], dh)
    got = decode(buf, dh)
    a = encode(*got, h, w, dh)
    r = encode(*ref, h, w, dh)
    a_u = np.unique(a)
    common = len(np.intersect1d(a_u, r, assume_unique=True))
    per_pair_bad = np.zeros(bsz, bool)
    mism = np.setxor1d(a_u, r, assume_unique=True)
    per_pair_bad[(mism // (4 * dh + 2) // w // h).astype(np.int64)] = True
    ref_counts = np.bincount(ref[0] * h + ref[1],
                             minlength=bsz * h).reshape(bsz, h)
    row_bad = counts != ref_counts
    dup = len(a) - len(a_u)
    if dup:
        _, cnt = np.unique(a, return_counts=True)
        per_pair_bad[np.unique(a)[cnt > 1] // (4 * dh + 2) // w // h] = True
    per_pair_bad |= row_bad.any(1)
    return {
        "support_mismatches": int(len(a_u) - common + len(r) - common + dup),
        "row_count_mismatches": int(row_bad.sum()),
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


def control_outputs(lefts, rights, tests, cfg, kind: str):
    """(buf, counts) in the masked layout from the reference with one
    guarantee broken, to stand in the program's place: ``drop_test``
    computes the codes one bit short (the forest's last test left out),
    ``first_of_runs`` pairs codes that are not unique in their row."""
    bsz, h, w = lefts.shape
    dh = cfg["disp_high"]
    if kind == "drop_test":
        sup = gpc.epipolar_supports(lefts, rights, gpc.drop_tests(tests),
                                    cfg["gradient_threshold"], dh)
    elif kind == "first_of_runs":
        sup = gpc.epipolar_supports(lefts, rights, tests,
                                    cfg["gradient_threshold"], dh,
                                    first_of_runs=True)
    else:
        raise ValueError(f"no control named {kind!r}")
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
