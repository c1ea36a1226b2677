"""Multi-scale pyramid sparse matching: the port of ``opengpc_tpu.pyramid``,
the same contracts and the same arrays.

The same forest runs at every level of a mean-pooled image pyramid, and
the supports merge into level-0 coordinates and disparities.  Coarse
levels see disparities beyond ``disp_high`` and add coverage where the
finest level has too little texture.  The merge is finest-level-wins: at
most one support a level-0 pixel, a finer level's kept over a coarser
one's, by one sort of packed keys ``((pix * mult + level) << nbd) | (d +
disp_high)`` (``_dedup_unpack``).

Three routes, each running the port's level-1 matchers at every level:

* rows (epipolar, <= 30-test forests, packable dedup keys): the row-form
  matcher, one key-kernel launch a level; a (B, H, W) batch folds into
  one key-kernel launch and one row sort a level;
* compact (the same eligibility): the chunk-compacted masked matcher,
  with an overflow flag that tells the caller to re-run the rows pyramid;
* flat (global mode or unpackable keys): the flat matcher with each
  level's buffer sized at its pixel count, so ``settings.capacity`` never
  trims it, and the dedup as a 1-operand sort of packed keys or, where
  they do not fit 31 bits, a sort of the (pixel, level) key with the four
  payloads gathered by its indices.

Downscale: the exact 2x2 mean ``(a + b + c + d) // 4`` on uint8, in plain
torch on the device (``downscale2``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opengpc_tpu_torch.config import InferenceSettings
from opengpc_tpu_torch.forest import FilterMask
from opengpc_tpu_torch.infer import (_Matcher, _as_mask, _batched_key_images,
                                     _interior_rows, _key_image, _numpy,
                                     _rows_ok, _sparsematch_impl,
                                     _sparsematch_rows_impl)
from opengpc_tpu_torch.match import (MASKED_SENTINEL,
                                     match_epipolar_masked_compact,
                                     match_epipolar_rows)

_SENT = 0x7FFFFFFF  # an empty dedup slot; sorts after every real key


def downscale2(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) uint8 -> (..., H//2, W//2) uint8 by the 2x2 mean
    (floor); leading axes (a batch) pass through, an odd last row or
    column is dropped."""
    h2, w2 = img.shape[-2] // 2, img.shape[-1] // 2
    x = img[..., :2 * h2, :2 * w2].to(torch.int32)
    s = x.reshape(x.shape[:-2] + (h2, 2, w2, 2)).sum(dim=(-3, -1),
                                                     dtype=torch.int32)
    return (s // 4).to(torch.uint8)


def _dedup_unpack(key_c, mult, nbd, w0, disp_high, num_levels):
    """Finest-level-wins dedup and unpack of concatenated packed keys
    (``((pix * mult + level) << nbd) | (d + disp_high)``, empty slots
    ``_SENT``): one 1-operand sort over the last axis, so a (B, K) batch of
    key rows sorts as rows.  Real keys are unique (one support a source
    pixel and level), so the unstable sort's values are the stable sort's.
    Returns (xs, ys, ds, lv, counts) in the pyramid contract, counts (...,
    num_levels)."""
    key_s = torch.sort(key_c, dim=-1, stable=False).values
    grp = key_s >> nbd  # pix * mult + level
    pixg = grp // mult
    first = torch.cat([torch.ones(key_s.shape[:-1] + (1,), dtype=torch.bool,
                                  device=key_s.device),
                       pixg[..., 1:] != pixg[..., :-1]], dim=-1)
    keep = first & (key_s != _SENT)
    lv = torch.where(keep, grp % mult, -1)
    xs = torch.where(keep, pixg % w0, 0)
    ys = torch.where(keep, pixg // w0, 0)
    ds = torch.where(keep, (key_s & ((1 << nbd) - 1)) - disp_high, 0)
    return _scale_and_count(xs, ys, ds, lv, num_levels)


def _scale_and_count(xs, ys, ds, lv, num_levels):
    """The contract's last step: per-level disparities scaled to level-0
    units (``d << level``) and the per-level counts of emitted supports
    over the last axis."""
    ds = torch.where(lv >= 0, ds << lv.clamp(min=0), 0)
    counts = torch.stack([(lv == level).sum(dim=-1, dtype=torch.int32)
                          for level in range(num_levels)], dim=-1)
    return xs, ys, ds, lv, counts


def _level_keys(valid, pix, level, dfield, mult, nbd):
    """One level's packed dedup keys; ``dfield`` holds d + disp_high."""
    return torch.where(valid, ((pix * mult + level) << nbd) | dfield, _SENT)


def _arange(n, device):
    return torch.arange(n, dtype=torch.int32, device=device)


def _pyramid_rows_impl(left, right, mask: FilterMask,
                       settings: InferenceSettings, num_levels: int,
                       mult: int, nbd: int):
    """The rows pyramid of one pair: every level on the row-form matcher,
    whose per-row buffers turn straight into the packed dedup keys."""
    w0 = left.shape[1]
    dev = left.device
    keys = []
    l_img, r_img = left, right
    for level in range(num_levels):
        (xs, ds), counts = _sparsematch_rows_impl(l_img, r_img, mask,
                                                  settings)
        hl, wl = l_img.shape
        scale = 1 << level
        valid = _arange(wl, dev)[None, :] < counts[:, None]
        pix = (_arange(hl, dev)[:, None] * scale) * w0 + xs * scale
        keys.append(_level_keys(valid, pix, level, ds + settings.disp_high,
                                mult, nbd).reshape(-1))
        if level + 1 < num_levels:
            l_img, r_img = downscale2(l_img), downscale2(r_img)
    return _dedup_unpack(torch.cat(keys), mult, nbd, w0, settings.disp_high,
                         num_levels)


def _pyramid_batched_keys(lefts, rights, mask: FilterMask,
                          settings: InferenceSettings, num_levels: int,
                          mult: int, nbd: int):
    """(B, K) packed dedup keys of a batch of pairs, every level's matcher
    work folded into one key-kernel launch and one (B * hs, 2W_l) row
    sort.  Margin rows are skipped, not padded back (they hold only
    sentinels), so K = sum_l (H_l - 2 m_l) W_l, m_l the level's margin
    (0 where H_l is inside it); consumers index by the lv / counts
    contract, not by position."""
    b, _, w0 = lefts.shape
    dev = lefts.device
    keys = []
    l_imgs, r_imgs = lefts, rights
    for level in range(num_levels):
        wl = l_imgs.shape[-1]
        kimg, m = _interior_rows(_batched_key_images(l_imgs, r_imgs, mask,
                                                     settings))
        hs = kimg.shape[-2]
        (xs, ds), counts = match_epipolar_rows(
            None, None, None, None, settings.disp_high,
            key=kimg.reshape(b * hs, 2 * wl), num_tests=mask.num_tests)
        xs, ds = xs.reshape(b, hs, wl), ds.reshape(b, hs, wl)
        counts = counts.reshape(b, hs)
        scale = 1 << level
        yy = ((_arange(hs, dev) + m) * scale)[None, :, None]
        valid = _arange(wl, dev)[None, None, :] < counts[:, :, None]
        pix = yy * w0 + xs * scale
        keys.append(_level_keys(valid, pix, level, ds + settings.disp_high,
                                mult, nbd).reshape(b, hs * wl))
        if level + 1 < num_levels:
            l_imgs, r_imgs = downscale2(l_imgs), downscale2(r_imgs)
    return torch.cat(keys, dim=1)


def _pyramid_rows_batched_impl(lefts, rights, mask: FilterMask,
                               settings: InferenceSettings, num_levels: int,
                               mult: int, nbd: int):
    """The rows pyramid of a (B, H, W) batch, folded: at each level the B
    pairs' key images run as one key-kernel launch and one row sort.
    Epipolar rows are independent, so each pair's arrays equal its single
    run's.  The dedup runs as one (B, K) row sort, which gives the arrays
    of B sorts pair by pair (JAX's ``lax.map``); on the H100 the one sort
    took 0.36 ms of device time where the four took 0.64 at B = 4
    (PERF.md, ``chip_smoke.py``'s ``pyramid_times``)."""
    keys = _pyramid_batched_keys(lefts, rights, mask, settings, num_levels,
                                 mult, nbd)
    return _dedup_unpack(keys, mult, nbd, lefts.shape[-1], settings.disp_high,
                         num_levels)


def _masked_bd(settings: InferenceSettings, nbd: int) -> int:
    """The masked buffer's disparity bits, which OR straight into the dedup
    key's disparity field: for disp_high >= 1, 2d and 2d + 1 have one
    bit length, so they are the dedup key's ``nbd``."""
    bd = max(1, int(2 * settings.disp_high).bit_length())
    assert bd == nbd, (bd, nbd)
    return bd


def _compact_level_keys(buf, m, level, w0, bd, mult, nbd):
    """A level's packed dedup keys from its chunk-compacted masked buffer
    (..., hs, C): ``(x << bd) | (d + disp_high)`` at supports."""
    scale = 1 << level
    yy = ((_arange(buf.shape[-2], buf.device) + m) * scale)[:, None]
    pix = yy * w0 + (buf >> bd) * scale
    return _level_keys(buf != MASKED_SENTINEL, pix, level,
                       buf & ((1 << bd) - 1), mult, nbd)


def _pyramid_compact_impl(left, right, mask: FilterMask,
                          settings: InferenceSettings, num_levels: int,
                          mult: int, nbd: int, chunk, k):
    """The compact pyramid of one pair: every level on the chunk-compacted
    masked matcher.  The same arrays as the rows pyramid while the
    returned ``overflow`` is False; when some level's chunk held more than
    ``k`` candidates it is True and the caller must re-run the rows
    pyramid."""
    w0 = left.shape[1]
    bd = _masked_bd(settings, nbd)
    keys = []
    ovf = torch.zeros((), dtype=torch.bool, device=left.device)
    l_img, r_img = left, right
    for level in range(num_levels):
        key, m = _interior_rows(_key_image(l_img, r_img, mask, settings))
        buf, _, o = match_epipolar_masked_compact(
            key, settings.disp_high, chunk, k, num_tests=mask.num_tests)
        ovf = ovf | o
        keys.append(_compact_level_keys(buf, m, level, w0, bd, mult,
                                        nbd).reshape(-1))
        if level + 1 < num_levels:
            l_img, r_img = downscale2(l_img), downscale2(r_img)
    return _dedup_unpack(torch.cat(keys), mult, nbd, w0, settings.disp_high,
                         num_levels) + (ovf,)


def _pyramid_compact_batched_impl(lefts, rights, mask: FilterMask,
                                  settings: InferenceSettings,
                                  num_levels: int, mult: int, nbd: int,
                                  chunk, k):
    """The compact pyramid of a (B, H, W) batch: every level's compacted
    matcher runs on the folded (B * hs, 2W_l) rows, the dedup as one (B,
    K) row sort, as the rows pyramid's fold.  Returns the single-pair
    contract stacked, with (B,) overflow flags: each folded row's flag
    goes back to its pair, ORed across levels, so a caller can re-run only
    the flagged pairs."""
    b, _, w0 = lefts.shape
    bd = _masked_bd(settings, nbd)
    keys = []
    ovf = torch.zeros((b,), dtype=torch.bool, device=lefts.device)
    l_imgs, r_imgs = lefts, rights
    for level in range(num_levels):
        wl = l_imgs.shape[-1]
        kimg, m = _interior_rows(_batched_key_images(l_imgs, r_imgs, mask,
                                                     settings))
        hs = kimg.shape[-2]
        buf, _, o = match_epipolar_masked_compact(
            kimg.reshape(b * hs, 2 * wl), settings.disp_high, chunk, k,
            num_tests=mask.num_tests, row_overflow=True)
        ovf = ovf | o.reshape(b, hs).any(dim=1)
        keys.append(_compact_level_keys(buf.reshape(b, hs, -1), m, level, w0,
                                        bd, mult, nbd).reshape(b, -1))
        if level + 1 < num_levels:
            l_imgs, r_imgs = downscale2(l_imgs), downscale2(r_imgs)
    return _dedup_unpack(torch.cat(keys, dim=1), mult, nbd, w0,
                         settings.disp_high, num_levels) + (ovf,)


def _pack_params(settings: InferenceSettings, num_levels: int):
    """(mult, nbd) of the packed dedup key: the level field's size (a power
    of two >= num_levels) and the disparity field's bits."""
    mult = 1
    while mult < num_levels:
        mult <<= 1
    return mult, int(2 * settings.disp_high + 1).bit_length()


def _rows_eligible(mask: FilterMask, settings: InferenceSettings, h0: int,
                   w0: int, num_levels: int):
    """(mult, nbd) where the rows pyramid applies to an h0 x w0 frame
    (epipolar, a <= 30-test packable forest, dedup keys below 2^31, in
    Python integers), else None.  Level 0 decides for every level: the
    coarser shapes only shrink the bit budgets."""
    mult, nbd = _pack_params(settings, num_levels)
    if (settings.epipolar_mode and (h0 * w0 * mult) << nbd < _SENT
            and _rows_ok(mask, (h0, w0), settings)):
        return mult, nbd
    return None


def _pyramid_impl(left, right, mask: FilterMask, settings: InferenceSettings,
                  num_levels: int, dedup: bool):
    """One pair's pyramid: the rows pyramid where it applies (with dedup),
    else the flat fallback."""
    h0, w0 = left.shape
    if dedup:
        el = _rows_eligible(mask, settings, h0, w0, num_levels)
        if el is not None:
            return _pyramid_rows_impl(left, right, mask, settings,
                                      num_levels, *el)
    xs_all, ys_all, ds_all, lv_all = [], [], [], []
    l_img, r_img = left, right
    for level in range(num_levels):
        # a level emits at most one support a source pixel, so its pixel
        # count bounds it: with dedup each level's buffer is sized at that
        # bound and capacity never trims it (the per-level count is
        # dropped and the counts recomputed after the dedup, so a trim
        # would be silent); without dedup the capacity-trimmed buffers
        pix = l_img.shape[0] * l_img.shape[1]
        lvl_settings = dataclasses.replace(
            settings, capacity=pix if dedup else min(settings.capacity, pix))
        xs, ys, ds, count = _sparsematch_impl(l_img, r_img, mask,
                                              lvl_settings)
        scale = 1 << level
        # slots past the count carry no stale coordinates
        valid = torch.arange(xs.shape[0], device=xs.device) < count
        xs_all.append(torch.where(valid, xs * scale, 0))
        ys_all.append(torch.where(valid, ys * scale, 0))
        ds_all.append(torch.where(valid, ds, 0))  # unscaled until the end
        lv_all.append(torch.where(valid, torch.full_like(xs, level), -1))
        if level + 1 < num_levels:
            l_img, r_img = downscale2(l_img), downscale2(r_img)
    xs_c, ys_c, ds_c, lv_c = (torch.cat(t) for t in (xs_all, ys_all, ds_all,
                                                      lv_all))
    if dedup:
        mult, nbd = _pack_params(settings, num_levels)
        valid = lv_c >= 0
        pix = ys_c * w0 + xs_c
        if (h0 * w0 * mult) << nbd < _SENT:
            key = _level_keys(valid, pix, lv_c, ds_c + settings.disp_high,
                              mult, nbd)
            return _dedup_unpack(key, mult, nbd, w0, settings.disp_high,
                                 num_levels)
        # too large for the 31-bit packing: sort the (pixel, level) key and
        # gather the payloads by its indices; that key must fit int31
        # itself, or the finest-wins grouping would wrap
        if h0 * w0 * mult >= _SENT:
            raise ValueError(
                f"pyramid dedup key overflow: {h0}x{w0} image with "
                f"{num_levels} levels exceeds int32 packing; disable dedup "
                "or reduce levels")
        key_s, idx = torch.sort(torch.where(valid, pix * mult + lv_c, _SENT),
                                stable=False)
        pixg = key_s // mult
        first = torch.cat([torch.ones(1, dtype=torch.bool,
                                      device=key_s.device),
                           pixg[1:] != pixg[:-1]])
        keep = first & (key_s != _SENT)
        xs_c, ys_c, ds_c = (torch.where(keep, t[idx], 0)
                            for t in (xs_c, ys_c, ds_c))
        lv_c = torch.where(keep, lv_c[idx], -1)
    return _scale_and_count(xs_c, ys_c, ds_c, lv_c, num_levels)


class PyramidSparsematch(_Matcher):
    """The pyramid matcher: ``(xs, ys, ds, levels, counts)``; decode one
    pair with :func:`pyramid_supports_to_numpy`.  A batch folds into one
    key-kernel launch and one row sort a level where the rows pyramid
    applies, and runs pair by pair otherwise."""

    def __init__(self, mask, settings, device, num_levels, dedup):
        super().__init__(mask, settings, device)
        self.num_levels, self.dedup = num_levels, dedup

    def _pair(self, left, right, mask, settings):
        return _pyramid_impl(left, right, mask, settings, self.num_levels,
                             self.dedup)

    def _run(self, left, right):
        if left.dim() == 3 and self.dedup:
            el = _rows_eligible(self.mask, self.settings, left.shape[1],
                                left.shape[2], self.num_levels)
            if el is not None:
                return _pyramid_rows_batched_impl(
                    left, right, self.mask, self.settings, self.num_levels,
                    *el)
        return super()._run(left, right)


class PyramidSparsematchCompact(_Matcher):
    """The compact pyramid matcher: ``(xs, ys, ds, levels, counts,
    overflow)``, (B,) flags for a batch, which folds a level's matcher
    work into one call."""

    def __init__(self, mask, settings, device, num_levels, chunk, k):
        super().__init__(mask, settings, device)
        self.num_levels, self.chunk, self.k = num_levels, chunk, k

    def _eligible(self, h0, w0):
        el = _rows_eligible(self.mask, self.settings, h0, w0,
                            self.num_levels)
        if el is None:
            raise ValueError(
                "compact pyramid needs epipolar mode, a <=30-test packable "
                f"forest, and 31-bit packable dedup keys for {h0}x{w0} x "
                f"{self.num_levels} levels; use build_pyramid_sparsematch "
                "instead")
        return el

    def _pair(self, left, right, mask, settings):
        return _pyramid_compact_impl(left, right, mask, settings,
                                     self.num_levels,
                                     *self._eligible(*left.shape),
                                     self.chunk, self.k)

    def _run(self, left, right):
        if left.dim() == 3:
            return _pyramid_compact_batched_impl(
                left, right, self.mask, self.settings, self.num_levels,
                *self._eligible(*left.shape[1:]), self.chunk, self.k)
        return super()._run(left, right)


def build_pyramid_sparsematch(forest_or_mask, settings: InferenceSettings,
                              num_levels: int = 3, dedup: bool = True,
                              device="cuda") -> PyramidSparsematch:
    """The pyramid matcher as an ``nn.Module`` on ``device``: ``(left,
    right) -> (x, y, d, level, counts)`` in level-0 coordinates and
    disparities; ``level[i]`` is the level of support i (-1 marks an empty
    slot), ``counts`` the per-level count of emitted supports.  With
    ``dedup`` the merge is finest-level-wins (at most one support a
    level-0 pixel).  (H, W) pairs and (B, H, W) batches.

    With dedup on eligible settings (epipolar, <= 30-test forest, packable
    keys) every level rides the row-form matcher, lossless whatever
    ``settings.capacity``; the fallback (global mode, unpackable keys)
    sizes each level's flat buffer at its pixel count, lossless too.  Only
    ``dedup=False`` keeps the capacity-trimmed flat buffers."""
    return PyramidSparsematch(_as_mask(forest_or_mask), settings,
                              torch.device(device), num_levels, dedup)


def build_pyramid_sparsematch_compact(forest_or_mask,
                                      settings: InferenceSettings,
                                      num_levels: int = 3, chunk=None,
                                      k=None, device="cuda"
                                      ) -> PyramidSparsematchCompact:
    """The low-density pyramid matcher as an ``nn.Module`` on ``device``:
    ``(x, y, d, level, counts, overflow)``, every level on the
    chunk-compacted masked matcher.  The contract and the dedup of
    :func:`build_pyramid_sparsematch` plus the flag: the same arrays while
    it is False; when it is True (a chunk at some level held more than
    ``k`` candidates) the caller must re-run the rows pyramid.  A batch's
    flags are per pair.  Needs epipolar mode, a <= 30-test packable forest,
    31-bit packable dedup keys (``ValueError`` at the call otherwise) and
    disp_high >= 1."""
    if settings.disp_high < 1:
        raise ValueError("compact pyramid needs disp_high >= 1")
    return PyramidSparsematchCompact(_as_mask(forest_or_mask), settings,
                                     torch.device(device), num_levels, chunk,
                                     k)


def pyramid_supports_to_numpy(xs, ys, ds, levels, counts) -> np.ndarray:
    """Trim one pair's merged pyramid buffers to an (n, 4) int32 array of
    (x, y, d, level) rows, empty slots dropped.  With the default dedup
    the rows hold at most one support a (x, y)."""
    xs, ys, ds, lv = _numpy((xs, ys, ds, levels))
    keep = lv >= 0
    return np.stack([xs[keep], ys[keep], ds[keep], lv[keep]],
                    axis=1).astype(np.int32)
