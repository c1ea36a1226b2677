"""Greedy fern-forest training on the card.

The port of ``opengpc_tpu.train``.  One device pass scores a whole level's
candidate set at once instead of re-walking all N triplets once per
candidate test:

* the triplet tensor is (N, 3, 729) uint8 (ref/pos/neg patches);
* per-triplet *code-prefix equality* flags (eq_pos, eq_neg) are carried
  across levels: code equality over levels [0, L] is
  ``prefix_eq & (bit_ref == bit_other)``, so no codes are materialized;
* a level evaluates all (resample, tau) candidates, a loop over the
  resamples and each vectorized over tau, emitting integer TP/FP/FN
  counts;
* the split is selected on the host in float64 with the reference's
  "strictly greater, first wins" rule, iterated resample-major then tau.

The device work is plain PyTorch (gathers, compares and integer sums: no
kernel of ``csrc/`` runs here); all randomness is the numpy ``Generator``
made from ``seed``, drawn in the JAX package's order, so the same seed and
the same triplets give the same forest text byte for byte, on the card or
on the CPU.

Decision convention (training side): bit = (patch[i] - patch[j] < tau).
Inference uses the different test ``img[i] > img[j] - tau``; each stays
on its own side, as in the reference.

Deliberate deviations from the reference, as in the JAX package:
* RNG: explicit seeds via numpy Generator (the reference is unseeded);
  candidate *distributions* match its sampleHyperplane.
* Bootstrap: samples with replacement from the WHOLE training set (the
  reference draws only from its first ``sampleFraction*N`` elements).
* The per-level stats table prints the stats of the chosen best candidate
  (the reference prints whichever candidate was evaluated last).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from opengpc_tpu_torch.config import ForestSettings, OptimizerSettings
from opengpc_tpu_torch.forest import (Fern, Forest, PATCH, PATCH_HALF,
                                      SCALE_HALF, Test, save_forest)

# batched-fern training materializes the whole (F, sub_n, 3, 729) bootstrap
# stack on the device at once; above this many bytes train_forest's default
# falls back to the fern-at-a-time loop rather than risk running out of
# device memory (explicit batch_ferns=True overrides)
BATCH_FERNS_BYTES_CAP = 1 << 30


@dataclasses.dataclass
class LevelStats:
    """Stats of the chosen split at one level.

    ``tp/fp/fn/tot`` are the exclusion-masked counts the greedy selection
    actually scored; with ``only_score_non_split_samples=False`` they
    equal the unmasked counts.  ``tp_all/fp_all/fn_all`` classify ALL
    samples by the ≤level code prefix regardless of markers — the
    diagnostic the oracle's trainfern line also carries."""

    level: int
    i: int
    j: int
    tau: int
    tp: int
    fp: int
    fn: int
    tot: int
    prec: float
    rec: float
    hmean: float
    tp_all: int = 0
    fp_all: int = 0
    fn_all: int = 0


def sample_candidates(
    rng: np.random.Generator, scale: int, num: int
) -> np.ndarray:
    """Draw ``num`` distinct (i, j) patch-linear-index pairs inside the
    scale's centered sub-window (the reference's sampleHyperplane).

    Returns (num, 2) int32.  All scales map to the same linear layout
    ``(x+13) + 27*(y+13)``.
    """
    half = SCALE_HALF[scale]
    side = 2 * half + 1
    out = np.empty((num, 2), np.int32)
    for k in range(num):
        i = j = 0
        while True:
            i, j = rng.integers(0, side * side, size=2)
            if i != j:
                break
        ix, iy = i % side - half, i // side - half
        jx, jy = j % side - half, j // side - half
        out[k, 0] = (ix + PATCH_HALF) + PATCH * (iy + PATCH_HALF)
        out[k, 1] = (jx + PATCH_HALF) + PATCH * (jy + PATCH_HALF)
    return out


def _columns(patches: torch.Tensor, idx) -> torch.Tensor:
    """Patch column ``idx[f]`` of fern f's (N, 3, 729) uint8 triplets,
    widened to int16: (F, N, 3).  Only the gathered columns are widened,
    never the whole dataset (twice its memory at full size)."""
    f = patches.shape[0]
    idx = torch.as_tensor(idx, dtype=torch.int64, device=patches.device)
    rows = torch.arange(f, device=patches.device)
    return patches[rows, :, :, idx].to(torch.int16)


def _score_level_ferns(patches, cand, tau_lo: int, num_taus: int, eq_pos,
                       eq_neg, include) -> torch.Tensor:
    """TP/FP/FN counts for every (resample, tau) candidate of the same
    level of F independent ferns: (F, R, num_taus, 3) int32.

    ``patches`` (F, N, 3, 729) uint8 bootstrap stacks, ``cand`` (F, R, 2)
    patch linear indices, ``eq_pos``/``eq_neg`` (F, N) prefix code
    equality, ``include`` (F, N) not-yet-excluded samples.  One step a
    resample gathers the two candidate pixels of every triplet ((F, N, 3)
    int16 differences), broadcasts over the tau axis and reduces.  Ferns
    are independent (own bootstrap, own greedy prefix), so scoring them
    together is exact."""
    dev = patches.device
    cand = torch.as_tensor(np.asarray(cand, np.int64), device=dev)
    taus = tau_lo + torch.arange(num_taus, dtype=torch.int32, device=dev)
    ep0 = eq_pos[:, :, None]
    en0 = eq_neg[:, :, None]
    inc = include[:, :, None]
    out = []
    for r in range(cand.shape[1]):
        diff = _columns(patches, cand[:, r, 0]) - _columns(patches,
                                                           cand[:, r, 1])
        bits = diff[..., None] < taus                      # (F, N, 3, T)
        ep = ep0 & (bits[:, :, 0] == bits[:, :, 1])        # (F, N, T)
        en = en0 & (bits[:, :, 0] == bits[:, :, 2])
        tp = (ep & ~en & inc).sum(dim=1, dtype=torch.int32)  # (F, T)
        fp = (~ep & en & inc).sum(dim=1, dtype=torch.int32)
        fn = ((ep == en) & inc).sum(dim=1, dtype=torch.int32)
        out.append(torch.stack([tp, fp, fn], dim=-1))      # (F, T, 3)
    return torch.stack(out, dim=1)                         # (F, R, T, 3)


def _score_level(patches, cand, tau_lo: int, num_taus: int, eq_pos, eq_neg,
                 include) -> torch.Tensor:
    """One fern's level: (N, 3, 729) triplets, (R, 2) candidates, (N,)
    flags -> (R, num_taus, 3) int32 counts."""
    return _score_level_ferns(patches[None], np.asarray(cand)[None], tau_lo,
                              num_taus, eq_pos[None], eq_neg[None],
                              include[None])[0]


def _apply_level_ferns(patches, i, j, tau, eq_pos, eq_neg):
    """Fold each fern's chosen (i[f], j[f], tau[f]) into its (F, N) prefix
    equality flags."""
    tau = torch.as_tensor(np.asarray(tau).astype(np.int16),
                          device=patches.device)
    bits = (_columns(patches, i) - _columns(patches, j)) < tau[:, None, None]
    return (eq_pos & (bits[:, :, 0] == bits[:, :, 1]),
            eq_neg & (bits[:, :, 0] == bits[:, :, 2]))


def _apply_level(patches, i: int, j: int, tau: int, eq_pos, eq_neg):
    """Fold the chosen (i, j, tau) into one fern's (N,) flags."""
    ep, en = _apply_level_ferns(patches[None], [i], [j], [tau], eq_pos[None],
                                eq_neg[None])
    return ep[0], en[0]


def _include_and_tot(split_pos, split_neg):
    """The include mask (not excluded by markSplitSamples) and its count
    over the last axis, on the device."""
    inc = ~(split_pos & split_neg)
    return inc, inc.sum(dim=-1, dtype=torch.int32)


def _mark_splits(split_pos, split_neg, eq_pos, eq_neg):
    """markSplitSamples: marks use the eq flags of the prefix EXCLUDING the
    just-chosen test, so this runs before the level's fold."""
    return split_pos | eq_pos, split_neg | ~eq_neg


def _diag_counts(eq_pos, eq_neg, valid):
    """Unmasked diagnostic (TP, FP) over the last axis, stacked: TP =
    eqPos & !eqNeg, FP = !eqPos & eqNeg, pads (``valid`` False) left
    out."""
    tp = (eq_pos & ~eq_neg & valid).sum(dim=-1, dtype=torch.int32)
    fp = (~eq_pos & eq_neg & valid).sum(dim=-1, dtype=torch.int32)
    return torch.stack([tp, fp])


def _share(n: int, group):
    """(lo, hi, size) of this rank's contiguous share of n triplets: the
    axis padded to a multiple of the group's size, [lo, hi) real, size -
    (hi - lo) pads."""
    if group is None:
        return 0, n, n
    rank, ranks = dist.get_rank(group), dist.get_world_size(group)
    size = -(-n // ranks)
    lo = min(rank * size, n)
    return lo, min(lo + size, n), size


def _padded(patches, size: int):
    """This rank's (..., n_local, 3, 729) triplets padded with zero
    triplets to ``size`` on the triplet axis, and the (size,) mask of the
    real ones.  Pads start with both split flags set, so they never enter
    a level's counts, and the mask keeps them out of the diagnostics."""
    real = patches.shape[-3]
    valid = torch.arange(size, device=patches.device) < real
    if real < size:
        pad = patches.new_zeros(patches.shape[:-3] + (size - real,)
                                + patches.shape[-2:])
        patches = torch.cat([patches, pad], dim=-3)
    return patches, valid


def _all_sum(group, *counts):
    """The int32 count tensors summed over the group's ranks, in one
    ``all_reduce``."""
    if group is None:
        return counts
    flat = torch.cat([c.reshape(-1) for c in counts])
    dist.all_reduce(flat, group=group)
    return tuple(t.reshape(c.shape) for t, c in
                 zip(torch.split(flat, [c.numel() for c in counts]), counts))


def _set_diag(stats: "LevelStats", tp_all: int, fp_all: int, n: int):
    stats.tp_all, stats.fp_all = tp_all, fp_all
    stats.fn_all = n - tp_all - fp_all


def _set_fern_diags(stats_out, diag, n: int):
    """Each fern's last level's diagnostics from the summed (2, F)."""
    for stats, (tp_all, fp_all) in zip(stats_out, diag.T.tolist()):
        _set_diag(stats[-1], tp_all, fp_all, n)


def _hmean(tp: int, fp: int, fn: int, w1: float) -> Tuple[float, float, float]:
    """precision, recall, weighted harmonic mean."""
    w2 = 1.0 - w1
    prec = 0.0 if tp + fp == 0 else tp / (tp + fp)
    rec = 0.0 if tp + fn == 0 else tp / (tp + fn)
    hmean = 0.0 if prec + rec == 0.0 else prec * rec / ((1.0 - w2) * prec + w2 * rec)
    return prec, rec, hmean


def _lin_to_xy(lin: int) -> Tuple[int, int]:
    return lin % PATCH - PATCH_HALF, lin // PATCH - PATCH_HALF


def _select_best(counts, cand, tau_lo: int, num_taus: int, w1: float):
    """Host-side greedy split selection over one level's (R, T, 3) counts:
    float64, strictly-greater-first-wins; if nothing scores > 0 the
    degenerate (0, 0, 0) split is kept (the reference would silently reuse
    the previous level's params via an uninitialized local — not
    copied)."""
    best_score, best = 0.0, (0, 0, 0)
    best_counts = (0, 0, 0)
    for r in range(counts.shape[0]):
        for t in range(num_taus):
            tp, fp, fn = (int(v) for v in counts[r, t])
            _, _, hm = _hmean(tp, fp, fn, w1)
            if hm > best_score:
                best_score = hm
                best = (int(cand[r, 0]), int(cand[r, 1]), tau_lo + t)
                best_counts = (tp, fp, fn)
    return best, best_counts


def _header() -> str:
    return (f"{'Level':>7}{'Prec':>10}{'Rec':>10}{'Har':>10}{'Tot':>8}"
            f"{'TP':>8}{'FP':>8}{'FN':>8}{'scale':>6}{'tau':>5}{'i':>5}"
            f"{'j':>5}")


def _row(s: LevelStats, scale: int) -> str:
    return (f"{s.level:>7}{s.prec:>10.4f}{s.rec:>10.4f}{s.hmean:>10.4f}"
            f"{s.tot:>8}{s.tp:>8}{s.fp:>8}{s.fn:>8}{scale:>6}{s.tau:>5}"
            f"{s.i:>5}{s.j:>5}")


def train_fern(
    triplets,
    scale: int,
    optimizer: OptimizerSettings,
    max_depth: int,
    rng: Optional[np.random.Generator] = None,
    candidates: Optional[Sequence[np.ndarray]] = None,
    verbose: bool = True,
    device="cuda",
    group=None,
) -> Tuple[Fern, List[LevelStats]]:
    """Greedily train one fern.

    ``triplets``: (N, 3, 729) uint8, an array or a tensor (moved to
    ``device``).  Either ``rng`` (candidates drawn per level like
    sampleHyperplane) or ``candidates`` (a list of (R, 2) arrays of patch
    linear indices per level — the injection hook used for differential
    testing against the C++ oracle) must be given.

    ``group``: a ``torch.distributed`` process group whose ranks split
    the triplet axis (every rank passes the whole set and the same
    ``rng``): each holds its contiguous share, padded with excluded
    triplets, and each level's counts are summed over the ranks; the
    selected splits are the one-device trainer's.
    """
    lo, hi, size = _share(len(triplets), group)
    patches, valid = _padded(torch.as_tensor(triplets[lo:hi]).to(device),
                             size)
    return _train_fern(patches, valid, len(triplets), scale, optimizer,
                       max_depth, rng, candidates, verbose, group)


def _train_fern(patches, valid, n: int, scale, optimizer, max_depth, rng,
                candidates, verbose, group):
    """train_fern on this rank's padded share ``patches`` of n triplets."""
    if candidates is None:
        if rng is None:
            raise ValueError("pass rng or explicit candidates")
        candidates = [
            sample_candidates(rng, scale, optimizer.num_resamples)
            for _ in range(max_depth)
        ]

    eq_pos = torch.ones_like(valid)
    eq_neg = torch.ones_like(valid)
    split_pos = ~valid
    split_neg = ~valid

    tau_lo, tau_hi = optimizer.tau_lo, optimizer.tau_hi
    num_taus = tau_hi - tau_lo
    chosen: List[Test] = []
    stats_out: List[LevelStats] = []
    diag = ()  # the last level's diagnostics, summed with the next counts

    if verbose:
        print(_header())

    for level in range(max_depth):
        cand = np.asarray(candidates[level], np.int32)
        include, tot_dev = _include_and_tot(split_pos, split_neg)
        counts, tot_dev, *diag = _all_sum(
            group, _score_level(patches, cand, tau_lo, num_taus, eq_pos,
                                eq_neg, include), tot_dev, *diag)
        if diag:
            _set_diag(stats_out[-1], *diag[0].tolist(), n)
        counts = counts.cpu().numpy()  # (R, T, 3)

        best, best_counts = _select_best(counts, cand, tau_lo, num_taus,
                                         optimizer.w1)
        bi, bj, btau = best
        if optimizer.only_score_non_split_samples:
            # marks use the prefix EXCLUDING the just-chosen test: the eq
            # flags before this level's fold (the level-0 call marks
            # pos.split on the empty prefix, vacuously true everywhere)
            split_pos, split_neg = _mark_splits(split_pos, split_neg,
                                                eq_pos, eq_neg)
        eq_pos, eq_neg = _apply_level(patches, bi, bj, btau, eq_pos, eq_neg)

        tp, fp, fn = best_counts
        tot = int(tot_dev)
        prec, rec, hm = _hmean(tp, fp, fn, optimizer.w1)
        # unmasked diagnostic counts from the post-fold eq flags (the
        # ≤level code-equality prefix)
        diag = [_diag_counts(eq_pos, eq_neg, valid)]
        ix, iy = _lin_to_xy(bi)
        jx, jy = _lin_to_xy(bj)
        chosen.append(Test(ix, iy, jx, jy, btau))
        stats_out.append(
            LevelStats(level, bi, bj, btau, tp, fp, fn, tot, prec, rec, hm))
        if verbose:
            print(_row(stats_out[-1], scale))
    if diag:
        _set_diag(stats_out[-1], *_all_sum(group, *diag)[0].tolist(), n)

    return Fern(scale, tuple(chosen)), stats_out


def _train_forest_batched(
    triplets: torch.Tensor,
    settings: ForestSettings,
    optimizer: OptimizerSettings,
    rng: np.random.Generator,
    sub_n: int,
    verbose: bool,
    group=None,
) -> Forest:
    """Train ALL ferns level-synchronously: one scorer pass per level
    covers every fern's candidate set over the stacked fern axis.

    Ferns are independent by construction — each has its own bootstrap
    subsample and its own greedy prefix, and they share nothing but the
    RNG stream — so batching them is exact.  RNG draws happen host-side
    in the sequential path's exact order (bootstrap_k, then candidates_k
    per level), so the exported forest is BYTE-IDENTICAL to
    ``train_forest``'s fern-at-a-time loop.  ``triplets`` is the whole
    dataset on the device; the (F, sub_n, 3, 729) stack is gathered there,
    with a ``group`` only this rank's share of its triplet axis.
    """
    n = triplets.shape[0]
    f = len(settings.ferns)
    max_depth = settings.max_depth
    tau_lo, tau_hi = optimizer.tau_lo, optimizer.tau_hi
    num_taus = tau_hi - tau_lo

    # pre-draw every RNG value in the sequential path's order
    idxs = np.empty((f, sub_n), np.int64)
    cands: List[List[np.ndarray]] = []
    for k, scale in enumerate(settings.ferns):
        idxs[k] = rng.integers(0, n, size=sub_n)
        cands.append([
            sample_candidates(rng, scale, optimizer.num_resamples)
            for _ in range(max_depth)
        ])

    dev = triplets.device
    lo, hi, size = _share(sub_n, group)
    patches, valid = _padded(
        triplets[torch.as_tensor(idxs[:, lo:hi], device=dev)], size)
    eq_pos = torch.ones((f, size), dtype=torch.bool, device=dev)
    eq_neg = torch.ones_like(eq_pos)
    split_pos = (~valid).repeat(f, 1)
    split_neg = split_pos.clone()

    chosen: List[List[Test]] = [[] for _ in range(f)]
    stats_out: List[List[LevelStats]] = [[] for _ in range(f)]
    diag = ()  # the last level's diagnostics, summed with the next counts
    t0 = time.perf_counter()
    for level in range(max_depth):
        cand_l = np.stack([cands[k][level] for k in range(f)]).astype(
            np.int32)  # (F, R, 2)
        include, tot_dev = _include_and_tot(split_pos, split_neg)
        counts, tots, *diag = _all_sum(
            group, _score_level_ferns(patches, cand_l, tau_lo, num_taus,
                                      eq_pos, eq_neg, include),
            tot_dev, *diag)
        if diag:
            _set_fern_diags(stats_out, diag[0], sub_n)
        counts = counts.cpu().numpy()  # (F, R, T, 3)
        tots = tots.cpu().numpy()
        bi = np.empty((f,), np.int32)
        bj = np.empty((f,), np.int32)
        bt = np.empty((f,), np.int32)
        best_counts_all = []
        for k in range(f):
            (bi[k], bj[k], bt[k]), bc = _select_best(
                counts[k], cand_l[k], tau_lo, num_taus, optimizer.w1)
            best_counts_all.append(bc)
        if optimizer.only_score_non_split_samples:
            split_pos, split_neg = _mark_splits(split_pos, split_neg,
                                                eq_pos, eq_neg)
        eq_pos, eq_neg = _apply_level_ferns(patches, bi, bj, bt, eq_pos,
                                            eq_neg)
        diag = [_diag_counts(eq_pos, eq_neg, valid)]
        for k in range(f):
            tp, fp, fn = best_counts_all[k]
            prec, rec, hm = _hmean(tp, fp, fn, optimizer.w1)
            ix, iy = _lin_to_xy(int(bi[k]))
            jx, jy = _lin_to_xy(int(bj[k]))
            chosen[k].append(Test(ix, iy, jx, jy, int(bt[k])))
            stats_out[k].append(
                LevelStats(level, int(bi[k]), int(bj[k]), int(bt[k]),
                           tp, fp, fn, int(tots[k]), prec, rec, hm))
        if verbose:
            # liveness line per level: the fern-major tables only print at
            # the end
            print(f"level {level + 1}/{max_depth}: all {f} ferns scored "
                  f"(t=+{time.perf_counter() - t0:.2f} s)", flush=True)
    if diag:
        _set_fern_diags(stats_out, _all_sum(group, *diag)[0], sub_n)
    elapsed = time.perf_counter() - t0

    if verbose:
        for k, scale in enumerate(settings.ferns):
            print(f"Fern({k + 1}/{f}) num samples: {sub_n}")
            print("*" * 90)
            print(_header())
            for s in stats_out[k]:
                print(_row(s, scale))
            print()
        print(f"batched {f} ferns x {max_depth} levels in {elapsed:.2f} s\n")

    return Forest(tuple(
        Fern(scale, tuple(chosen[k]))
        for k, scale in enumerate(settings.ferns)
    ))


def train_forest(
    triplets,
    settings: ForestSettings,
    optimizer: OptimizerSettings,
    seed: int = 0,
    verbose: bool = True,
    checkpoint_path: Optional[str] = None,
    batch_ferns: Optional[bool] = None,
    device="cuda",
    group=None,
) -> Forest:
    """Train a forest on ``device``: per fern, bootstrap-subsample (with
    replacement, from the whole set — see module docstring) and train.

    ``triplets``: (N, 3, 729) uint8, an array or a tensor; it is moved to
    ``device`` once and every bootstrap gather happens there.

    ``checkpoint_path``: incremental export — after each fern finishes the
    partial forest is written there (valid text format), so an interrupted
    run keeps its completed ferns.

    ``batch_ferns``: train all ferns level-synchronously in ONE scorer
    pass per level (see ``_train_forest_batched`` — byte-identical
    forest).  Default (None): batched whenever there is more than one
    fern, no incremental checkpointing is requested, AND the stacked
    (F, sub_n, 3, 729) bootstrap fits ``BATCH_FERNS_BYTES_CAP`` on each
    device; explicit ``batch_ferns=True`` bypasses the cap.

    ``group``: a ``torch.distributed`` process group whose ranks split
    each bootstrap's triplet axis (``train_fern``'s ``group``); every rank
    passes the same triplets and seed and gets the same forest, the
    one-device trainer's byte for byte.
    """
    rng = np.random.default_rng(seed)
    data = torch.as_tensor(triplets)
    n = data.shape[0]
    if n == 0:
        raise ValueError("training set is empty")
    sub_n = int(settings.sample_fraction * n)
    if batch_ferns is None:
        stack_bytes = (len(settings.ferns) * sub_n * 3 * 729
                       * data.element_size())
        # with a group the stack's triplet axis is split over the ranks,
        # so the budget is per device
        ranks = dist.get_world_size(group) if group is not None else 1
        batch_ferns = (checkpoint_path is None and len(settings.ferns) > 1
                       and stack_bytes // ranks <= BATCH_FERNS_BYTES_CAP)
    if batch_ferns and checkpoint_path is not None:
        raise ValueError(
            "batch_ferns trains all ferns concurrently; per-fern "
            "incremental checkpointing needs batch_ferns=False")
    # upload the dataset once; the bootstrap gathers happen on the device
    data = data.to(device)
    if batch_ferns:
        return _train_forest_batched(data, settings, optimizer, rng, sub_n,
                                     verbose, group)
    lo, hi, size = _share(sub_n, group)
    ferns = []
    for k, scale in enumerate(settings.ferns):
        idx = rng.integers(0, n, size=sub_n)
        patches, valid = _padded(
            data[torch.as_tensor(idx[lo:hi], device=data.device)], size)
        if verbose:
            print(f"Fern({k + 1}/{len(settings.ferns)}) num samples: {sub_n}")
            print("*" * 90)
        t0 = time.perf_counter()
        fern, _ = _train_fern(patches, valid, sub_n, scale, optimizer,
                              settings.max_depth, rng, None, verbose, group)
        if verbose:
            print(f"done in {time.perf_counter() - t0:.2f} s\n")
        ferns.append(fern)
        if checkpoint_path is not None:
            save_forest(Forest(tuple(ferns)), checkpoint_path)
    return Forest(tuple(ferns))
