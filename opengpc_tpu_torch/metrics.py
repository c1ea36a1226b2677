"""Match-quality metrics (numpy only; the same functions as
``opengpc_tpu.metrics``):

* :func:`support_precision` — fraction of supports whose disparity agrees
  with a dense ground-truth map within a tolerance.
* :func:`support_pr_vs_reference` — precision/recall of one support set
  against another (e.g. ours vs the CPU oracle's), where recall counts
  reference supports we reproduced.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def support_precision(
    supports: np.ndarray,
    gt_disparity: np.ndarray,
    valid: np.ndarray = None,
    tol: float = 1.0,
) -> Tuple[float, int]:
    """(precision, n_evaluated) of (x, y, d) supports vs a dense GT map.

    Supports at pixels where ``valid`` is False (occluded/unknown) are
    excluded from the evaluation."""
    supports = np.asarray(supports)
    if supports.size == 0:
        return 0.0, 0
    x, y, d = supports[:, 0], supports[:, 1], supports[:, 2]
    gt = np.asarray(gt_disparity)[y, x]
    keep = np.ones(len(supports), bool) if valid is None else np.asarray(valid)[y, x]
    n = int(keep.sum())
    if n == 0:
        return 0.0, 0
    good = np.abs(d[keep] - gt[keep]) <= tol
    return float(good.mean()), n


def support_pr_vs_reference(
    supports: np.ndarray, reference: np.ndarray
) -> Tuple[float, float]:
    """(precision, recall) of a support set against a reference set.

    A support counts as correct iff its exact (x, y, d) row appears in the
    reference set; recall is the fraction of reference rows reproduced."""
    got = set(map(tuple, np.asarray(supports).reshape(-1, 3).tolist()))
    want = set(map(tuple, np.asarray(reference).reshape(-1, 3).tolist()))
    if not got:
        return 0.0, 0.0 if want else 1.0
    inter = len(got & want)
    prec = inter / len(got)
    rec = 1.0 if not want else inter / len(want)
    return prec, rec
