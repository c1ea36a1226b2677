"""Dry run of every multi-device builder at tiny shapes on the current
process group (``opengpc_tpu.parallel.sharded_sparsematch_step``'s
counterpart): each whole result is held to the single-device module of its
contract, bit for bit (the global contract as a support set), and the
sharded trainer's fern to the one-device trainer's.  Every rank of the
group calls it; it raises ``RuntimeError`` on the first mismatch."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from opengpc_tpu_torch.config import InferenceSettings, zero_optimizer
from opengpc_tpu_torch.forest import SCALE_L, load_forest
from opengpc_tpu_torch.infer import (build_sparsematch,
                                     build_sparsematch_global_compact,
                                     build_sparsematch_global_rows,
                                     build_sparsematch_masked,
                                     build_sparsematch_masked_compact,
                                     build_sparsematch_rows,
                                     global_row_supports_to_numpy)
from opengpc_tpu_torch.parallel import batched, frame, pyramid
from opengpc_tpu_torch.parallel.groups import _leaves, make_mesh_2d
from opengpc_tpu_torch.pyramid import (build_pyramid_sparsematch,
                                       pyramid_supports_to_numpy)

FOREST = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "forests", "defaultZeroForest.txt")
SINGLE = {"flat": build_sparsematch, "rows": build_sparsematch_rows,
          "masked": build_sparsematch_masked,
          "masked-compact": build_sparsematch_masked_compact,
          "global-rows": build_sparsematch_global_rows,
          "global-compact": build_sparsematch_global_compact}


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"sharded_sparsematch_step: {what}")


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in
               zip(_leaves(a), _leaves(b), strict=True))


def _pair(rng, b, h, w, device):
    lefts = rng.integers(0, 256, (b, h, w)).astype(np.uint8)
    rights = np.roll(lefts, -2, axis=-1)
    return (torch.from_numpy(lefts).to(device),
            torch.from_numpy(rights).to(device))


def _global_set(out):
    return set(map(tuple, global_row_supports_to_numpy(
        *out[0], out[1]).tolist()))


def sharded_sparsematch_step(group=None, device="cuda") -> None:
    """Every builder of ``opengpc_tpu_torch.parallel`` once on ``group``
    (``None``: this process alone) at tiny shapes on ``device``, each
    against its single-device module."""
    n = dist.get_world_size(group) if group is not None else 1
    forest = load_forest(FOREST)
    settings = InferenceSettings(gradient_threshold=5, vertical_tolerance=0,
                                 disp_high=32, epipolar_mode=True,
                                 capacity=1024)
    gsettings = dataclasses.replace(settings, epipolar_mode=False)
    rng = np.random.default_rng(0)

    # the six batched contracts and the batched pyramid, 2 pairs a rank
    lefts, rights = _pair(rng, 2 * n, 64, 128, device)
    for contract, build in (
            ("flat", batched.build_batched_sparsematch),
            ("rows", batched.build_batched_sparsematch_rows),
            ("masked", batched.build_batched_sparsematch_masked),
            ("masked-compact",
             batched.build_batched_sparsematch_masked_compact),
            ("global-rows", batched.build_batched_sparsematch_global_rows),
            ("global-compact",
             batched.build_batched_sparsematch_global_compact)):
        s = gsettings if contract.startswith("global") else settings
        got = build(forest, s, group, device=device).run_whole(lefts, rights)
        want = SINGLE[contract](forest, s, device=device)(lefts, rights)
        if contract == "masked-compact":
            _check(got[2].shape == (n,), "masked-compact flags a rank")
            if not bool(got[2].any()):
                _check(_same(got[:2], want[:2]), "batched masked-compact")
        else:
            _check(_same(got, want), f"batched {contract}")
    got = batched.build_batched_pyramid(forest, settings, group, 2,
                                        device=device).run_whole(lefts,
                                                                 rights)
    want = build_pyramid_sparsematch(forest, settings, 2,
                                     device=device)(lefts, rights)
    _check(_same(got, want), "batched pyramid")

    # one frame's rows over the group: every contract, and the pyramid
    (fl,), (fr,) = _pair(rng, 1, 64 * n, 128, device)
    for contract in frame.CONTRACTS:
        s = gsettings if contract == "global-compact" else settings
        kw = {"chunk": 64, "k": 64} if contract == "global-compact" else {}
        got = frame.build_sharded_frame_sparsematch(
            forest, s, group, contract, device=device, **kw).run_whole(fl,
                                                                        fr)
        if contract == "global-compact":
            want = build_sparsematch_global_rows(forest, s,
                                                 device=device)(fl, fr)
            _check(not bool(got[2]) and _global_set(got) == _global_set(want)
                   and _global_set(want), "sharded global (lossless)")
            continue
        want = SINGLE[contract](forest, s, device=device)(fl, fr)
        if contract == "masked-compact":
            _check(bool(got[2]) == bool(want[2]), "sharded compact flag")
        if contract != "masked-compact" or not bool(got[2]):
            _check(_same(got, want), f"sharded frame {contract}")
    (pl,), (pr,) = _pair(rng, 1, 64 * n, 128, device)
    got = pyramid.build_sharded_frame_pyramid(
        forest, settings, group, 2, device=device).run_whole(pl, pr)
    want = build_pyramid_sparsematch(forest, settings, 2,
                                     device=device)(pl, pr)
    _check(torch.equal(got[4], want[4]), "sharded pyramid counts")
    _check(set(map(tuple, pyramid_supports_to_numpy(*got).tolist()))
           == set(map(tuple, pyramid_supports_to_numpy(*want).tolist())),
           "sharded pyramid support set")

    # the 2-D grid: frames over frame groups, rows over their ranks
    n_data, n_rows = (2, n // 2) if n >= 4 and n % 2 == 0 else (1, n)
    grid = make_mesh_2d(n_data, n_rows) if group is not None else None
    lefts, rights = _pair(rng, 2 * n_data, 64 * n_rows, 128, device)
    got = frame.build_batched_sharded_frame_sparsematch(
        forest, settings, grid, device=device).run_whole(lefts, rights)
    want = build_sparsematch_masked(forest, settings, device=device)(lefts,
                                                                      rights)
    _check(_same(got, want), "2-D masked")
    lefts, rights = _pair(rng, 2 * n_data, 56 * n_rows, 128, device)
    got = pyramid.build_batched_sharded_frame_pyramid(
        forest, settings, grid, 2, device=device).run_whole(lefts, rights)
    single = build_pyramid_sparsematch(forest, settings, 2, device=device)
    for i in range(lefts.shape[0]):
        want = single(lefts[i], rights[i])
        _check(torch.equal(got[4][i], want[4]), "2-D pyramid counts")
        _check(set(map(tuple, pyramid_supports_to_numpy(
            *(t[i] for t in got)).tolist()))
            == set(map(tuple, pyramid_supports_to_numpy(*want).tolist())),
            "2-D pyramid support set")

    # the trainer, the triplet axis split with pads
    from opengpc_tpu_torch.parallel import sharded_train_fern
    from opengpc_tpu_torch.train import train_fern

    trip_rng = np.random.default_rng(1)
    ref = trip_rng.integers(0, 256, (8 * n + 3, 729)).astype(np.int16)
    pos = np.clip(ref + trip_rng.integers(-6, 7, ref.shape), 0, 255)
    neg = trip_rng.integers(0, 256, ref.shape)
    triplets = np.stack([ref, pos, neg], axis=1).astype(np.uint8)
    opt = zero_optimizer(num_resamples=2)
    fern, stats = sharded_train_fern(triplets, SCALE_L, opt, 2, group,
                                     device=device)
    one, one_stats = train_fern(triplets, SCALE_L, opt, 2,
                                rng=np.random.default_rng(0), verbose=False,
                                device=device)
    _check(fern == one and stats == one_stats, "sharded trainer")
