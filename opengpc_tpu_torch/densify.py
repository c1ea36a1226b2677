"""Sparse-to-dense disparity densification in PyTorch (the port of
``opengpc_tpu.densify``, bit for bit the same float32 maps).

The GPC method emits sparse supports; downstream consumers often want a
dense map.  This densifier seeds a dense grid with the supports and runs
masked Jacobi diffusion sweeps: unknown pixels take the mean of their
already-filled 4-neighbours, known support pixels stay pinned.  The
multigrid default restricts the seeds down a 2x2 pyramid, solves the
coarsest grid and relaxes each finer level from the upsampled solution.

Every step is an elementwise tensor op in the JAX package's operand order
(``((down + up) + right) + left`` over ``val * f``, divided by
``max(nsum, 1)``; the 2x2 restriction adds its window row-major), so the
card, the CPU and JAX's CPU give the same bits.  Each sweep is about 20
elementwise launches.

Not a reference component (the reference leaves refinement hooks unused,
buffer.hpp:104-119); provided as an extra, separate from the parity
surface.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from opengpc_tpu_torch.match import MASKED_SENTINEL

# the masked buffer's seeding: "scatter" (one indexed write each of the
# values and the known mask) or "sortmerge" (two row sorts); both give the
# same bits.  On an H100 at 436x1024 the scatter takes less device time
# (chip_smoke.py's densify phase; PERF.md); by CUDA events the two trade
# places from run to run, as the densify is bound by its host launches.
# The scatter is the simpler code.
DEFAULT_SEEDING = "scatter"


def _neighbour_sum(a: torch.Tensor) -> torch.Tensor:
    """``((down + up) + right) + left`` of an (H, W) map: each term the map
    shifted by one pixel with zeros shifted in, added in JAX's order.  A
    zero border term adds exactly, so the border rows and columns take
    only the terms that reach them."""
    s = torch.zeros_like(a)
    s[:-1] = a[1:]            # down: row y takes row y + 1
    s[1:] += a[:-1]           # up
    s[:, :-1] += a[:, 1:]     # right
    s[:, 1:] += a[:, :-1]     # left
    return s


def _diffuse(value, known, num_iters: int, filled0=None):
    """The masked-Jacobi sweep loop shared by the supports and the
    masked-buffer densifiers.  ``filled0`` optionally marks extra
    already-filled (but not pinned) pixels: the multigrid path seeds fine
    levels with the upsampled coarse solution this way."""
    val = value
    filled = known if filled0 is None else filled0
    zero = torch.zeros((), dtype=torch.float32, device=value.device)
    for _ in range(num_iters):
        f = filled.to(torch.float32)
        vsum = _neighbour_sum(val * f)
        nsum = _neighbour_sum(f)
        grown = nsum > 0
        upd = vsum / torch.clamp_min(nsum, 1.0)
        # seeds stay pinned; every other filled-or-grown pixel relaxes each
        # sweep (the filled set grows by one ring a sweep and keeps
        # diffusing behind the front)
        val = torch.where(known, val, torch.where(grown, upd, zero))
        filled = filled | grown
    return val, filled


def _restrict(a: torch.Tensor) -> torch.Tensor:
    """2x2 window sums of an (H, W) map padded with zeros to even sides,
    added row-major within the window as XLA's reduce_window adds them."""
    h, w = a.shape
    a = F.pad(a, (0, w % 2, 0, h % 2))
    return ((a[0::2, 0::2] + a[0::2, 1::2]) + a[1::2, 0::2]) + a[1::2, 1::2]


def _upsample(a: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest 2x upsampling cropped to (h, w)."""
    return a.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)[:h, :w]


def _diffuse_multigrid(value, known, sweeps_per_level: int):
    """Coarse-to-fine masked diffusion: restrict the seeds down a 2x2-box
    pyramid (weighted sums, so coarse seeds are the exact means of their
    fine seeds), solve the coarsest grid (both sides <= 8) with
    ``sweeps_per_level`` Jacobi sweeps, then repeatedly upsample (nearest)
    and relax ``sweeps_per_level`` sweeps with the level's seeds pinned.
    Any hole fills (the coarsest grid is a few cells wide) and the work is
    about 4/3 of the finest level's."""
    f = known.to(torch.float32)
    pyr = [(value * f, f)]
    while max(pyr[-1][0].shape) > 8:
        wsum, cnt = pyr[-1]
        pyr.append((_restrict(wsum), _restrict(cnt)))
    zero = torch.zeros((), dtype=torch.float32, device=value.device)
    wsum, cnt = pyr[-1]
    k = cnt > 0
    sol, filled = _diffuse(torch.where(k, wsum / torch.clamp_min(cnt, 1.0),
                                       zero), k, sweeps_per_level)
    for wsum, cnt in reversed(pyr[:-1]):
        h, w = wsum.shape
        up = _upsample(sol, h, w)
        upf = _upsample(filled, h, w)
        k = cnt > 0
        seed = torch.where(k, wsum / torch.clamp_min(cnt, 1.0), zero)
        v0 = torch.where(k, seed, torch.where(upf, up, zero))
        sol, filled = _diffuse(v0, k, sweeps_per_level, filled0=k | upf)
    return sol, filled


def _solve(value, known, num_iters: int, method: str):
    if method == "multigrid":
        return _diffuse_multigrid(value, known, num_iters)
    if method == "jacobi":
        return _diffuse(value, known, num_iters)
    raise ValueError(f"unknown densify method {method!r}")


def _densify(xs, ys, ds, shape: Tuple[int, int], num_iters: int,
             method: str = "multigrid"):
    """Seed by scatter-adding each support's disparity and a count into
    its pixel (the mean of a pixel's supports), then diffuse.  The sums
    are of integers, exact in any order."""
    h, w = shape
    dev = xs.device
    flat = ys.to(torch.int64) * w + xs.to(torch.int64)
    seed_sum = torch.zeros(h * w, dtype=torch.float32, device=dev)
    seed_cnt = torch.zeros(h * w, dtype=torch.float32, device=dev)
    seed_sum.index_add_(0, flat, ds.to(torch.float32))
    seed_cnt.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    known = (seed_cnt > 0).reshape(h, w)
    value = torch.where(
        known, (seed_sum / torch.clamp_min(seed_cnt, 1.0)).reshape(h, w),
        torch.zeros((), dtype=torch.float32, device=dev))
    return _solve(value, known, num_iters, method)


def _masked_fields(buf, disp_high: int):
    """(valid, x, d + disp_high, bd) of a masked buffer's entries."""
    bd = max(1, int(2 * disp_high).bit_length())
    valid = buf != MASKED_SENTINEL
    return valid, buf >> bd, buf & ((1 << bd) - 1), bd


def _masked_seed_scatter(buf, disp_high: int, w: int):
    """Scatter seeding of the dense grid from a masked buffer: one indexed
    write of the disparities and one of the known mask.  A source pixel
    pairs at most once, so the (y, x) seeds are unique and a write needs
    no sum; invalid entries all write 0 / False into one spare slot."""
    h = buf.shape[0]
    dev = buf.device
    valid, x, dpk, _ = _masked_fields(buf, disp_high)
    y = torch.arange(h, dtype=torch.int64, device=dev)[:, None]
    flat = torch.where(valid, y * w + x.to(torch.int64), h * w).reshape(-1)
    d = torch.where(valid, dpk - disp_high, 0).to(torch.float32).reshape(-1)
    seed = torch.zeros(h * w + 1, dtype=torch.float32, device=dev)
    seed[flat] = d
    kn = torch.zeros(h * w + 1, dtype=torch.bool, device=dev)
    kn[flat] = valid.reshape(-1)
    known = kn[:h * w].reshape(h, w)
    value = torch.where(known, seed[:h * w].reshape(h, w),
                        torch.zeros((), dtype=torch.float32, device=dev))
    return value, known


def _sort_payload(key, pay):
    """Row sort of ``key`` (unstable) with ``pay`` carried along.  Equal
    keys here always carry equal payloads, so the result is the stable
    sort's."""
    key_s, idx = torch.sort(key, dim=1, stable=False)
    return key_s, torch.gather(pay, 1, idx)


def _masked_seed_sortmerge(buf, disp_high: int, w: int):
    """Sort-merge seeding: place masked-buffer entries into the dense grid
    with two row sorts instead of a scatter.

    Merge trick: per row, sort candidate keys ``2x`` (unique: a source
    pixel pairs at most once) together with one placeholder key ``2x+1``
    per output column; after the sort each placeholder's left neighbour is
    its column's candidate iff one exists (equal x, even key).  A second
    sort by placeholder x left-packs the W per-column results into the
    dense row.  Invalid entries share the key 0x7FFFFFFE with payload 0
    and non-placeholders 0x7FFFFFFF with payload 0, so the unstable sorts
    are exact."""
    h = buf.shape[0]
    dev = buf.device
    valid, x, dpk, bd = _masked_fields(buf, disp_high)
    big = 0x7FFFFFFE  # even: never mistaken for a placeholder
    ckey = torch.where(valid, x << 1, big).to(torch.int32)
    cpay = torch.where(valid, dpk, 0).to(torch.int32)
    pkey = (torch.arange(w, dtype=torch.int32, device=dev) * 2
            + 1)[None, :].expand(h, w)
    key = torch.cat([ckey, pkey], dim=1)                   # (H, C + W)
    pay = torch.cat([cpay, torch.zeros((h, w), dtype=torch.int32,
                                       device=dev)], dim=1)
    key_s, pay_s = _sort_payload(key, pay)
    prev_key = F.pad(key_s[:, :-1], (1, 0), value=-2)
    prev_pay = F.pad(pay_s[:, :-1], (1, 0))
    is_ph = (key_s & 1) == 1
    found = is_ph & (prev_key == key_s - 1)
    # second sort: placeholders keyed by their column, everything else
    # big; the payload packs (found, d) so one operand carries both
    key2 = torch.where(is_ph, key_s >> 1, 0x7FFFFFFF).to(torch.int32)
    pay2 = torch.where(found, (1 << bd) | prev_pay, 0).to(torch.int32)
    _, pay2_s = _sort_payload(key2, pay2)
    row = pay2_s[:, :w]
    known = (row >> bd) == 1
    value = torch.where(
        known, (row & ((1 << bd) - 1)).to(torch.float32) - disp_high,
        torch.zeros((), dtype=torch.float32, device=dev))
    return value, known


_SEEDINGS = {"sortmerge": _masked_seed_sortmerge,
             "scatter": _masked_seed_scatter}


def _densify_from_masked(buf, disp_high: int, num_iters: int,
                         seed_impl: str = DEFAULT_SEEDING, width: int = 0,
                         method: str = "multigrid"):
    if seed_impl not in _SEEDINGS:
        raise ValueError(f"unknown seeding {seed_impl!r}")
    value, known = _SEEDINGS[seed_impl](buf, disp_high,
                                        width or buf.shape[1] // 2)
    return _solve(value, known, num_iters, method)


def _default_iters(num_iters: Optional[int], method: str) -> int:
    if num_iters is None:
        return 10 if method == "multigrid" else 64
    return int(num_iters)


def densify_from_masked(buf, row_counts, disp_high: int,
                        num_iters: Optional[int] = None, width: int = 0,
                        method: str = "multigrid", device="cuda"):
    """Dense float32 disparity straight from the masked contract's (buf,
    row_counts), with no host decode or re-upload: the masked buffer is
    decoded, seeded and diffused on ``device``.

    Bit-identical to ``densify_supports(masked_supports_to_numpy(buf,
    row_counts, disp_high), (H, W))``.  Returns device tensors (disparity
    (H, W) float32, filled (H, W) bool); ``row_counts`` is accepted for
    symmetry with the decoders (the buffer alone determines the result).
    ``width``: the image width W, required for the chunk-compacted
    contract's narrower buffers (defaults to buf.shape[1] // 2, right only
    for the full-width masked contract).

    ``method``: "multigrid" (default) runs the coarse-to-fine solver,
    ``num_iters`` sweeps per level (default 10); "jacobi" runs
    ``num_iters`` sweeps (default 64) at full resolution, which bound the
    fill radius.  The seeding is ``DEFAULT_SEEDING``."""
    del row_counts
    buf = torch.as_tensor(buf).to(torch.device(device))
    return _densify_from_masked(buf, int(disp_high),
                                _default_iters(num_iters, method),
                                width=int(width), method=method)


def densify_supports(supports: np.ndarray, shape: Tuple[int, int],
                     num_iters: Optional[int] = None,
                     method: str = "multigrid", device="cuda"):
    """Dense float32 disparity map from (n, 3) supports (x, y, d), computed
    on ``device``.

    Returns numpy (disparity (H, W) float32, filled (H, W) bool).

    ``method="multigrid"`` (default): coarse-to-fine masked diffusion, any
    hole fills at O(log) total sweeps; ``num_iters`` is the sweeps per
    level (default 10).  ``method="jacobi"``: the single-level sweep loop;
    pixels farther than ``num_iters`` (default 64) steps from a support
    stay unfilled (each sweep grows the filled region by one
    4-neighbourhood ring).
    """
    dev = torch.device(device)
    sup = torch.as_tensor(np.asarray(supports).reshape(-1, 3)
                          .astype(np.int32)).to(dev)
    value, filled = _densify(sup[:, 0], sup[:, 1], sup[:, 2],
                             tuple(int(s) for s in shape),
                             _default_iters(num_iters, method), method)
    return value.cpu().numpy(), filled.cpu().numpy()
