"""Sparse-matching inference: every level-1 route of the one-call
``sparsematch``.

Three output contracts, each an ``nn.Module`` built per forest and
settings, as in ``opengpc_tpu.infer``:

* masked (epipolar, <= 30 tests, 30-bit (x, d) pack):
  key image (fused key kernel) -> interior rows [13, H-13) -> row sort,
  pair detection, masked emit -> host decode (``masked_supports_to_numpy``);
* global rows (global mode, <= 30 tests, (y, x) in 30 bits, 4K frames
  included):
  key image -> interior rows -> one flat sort for global uniqueness ->
  segmented pack (``match.match_global_rows``) -> host assembly
  (``global_row_supports_to_numpy``);
* flat (everything else): the key image and the packed row sort when the
  keys are packable in epipolar mode, else codes and candidates (fused code
  kernel) into ``match.match_epipolar`` or ``match.match_global``; a
  fixed-capacity (x, y, d) buffer and the true count
  (``supports_to_numpy``).

``sparsematch`` picks the route as the JAX package does, and runs the
pyramid (``opengpc_tpu_torch.pyramid``) for ``levels > 1``.  It takes
arrays, tensors, PNG paths or lists of them; PNGs decode on the host
(``io.read_gray``).  A (B, H, W) batch folds into one row sort on the
masked route and the rows pyramid and runs pair by pair (the JAX
package's ``lax.map``) on the others.  The masked buffer decodes on the
host with ``cpp/decode.cc``'s scan (``io.png.masked_decode_native``), the
numpy scan where the host library cannot be built.

Beside the routes, the builders of the other contracts: the row form
(``build_sparsematch_rows``, per-row left-packed (xs, ds)), and the
chunk-compacted low-density masked and global contracts
(``build_sparsematch_masked_compact``,
``build_sparsematch_global_compact``), whose ``overflow`` flag tells the
caller to re-run the full-width contract.  ``_key_image_slab`` is the key
image of one row slab of a larger frame, the sharded frame's
(``opengpc_tpu_torch.parallel``).  ``build_stereomatch`` is the
reference's stereoMatch surface: unfiltered global correspondences.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Optional

import numpy as np
import torch
from torch import nn

from opengpc_tpu_torch.config import InferenceSettings
from opengpc_tpu_torch.forest import FilterMask, Forest, load_forest, make_filter_mask
from opengpc_tpu_torch.io.png import (masked_decode_native, read_gray,
                                      read_gray_batch)
from opengpc_tpu_torch.match import (MASKED_SENTINEL, SENTINEL_BASE, _bits,
                                     _match_epipolar_packed, _rows_of, compact,
                                     match_correspondences,
                                     match_epipolar, match_epipolar_masked,
                                     match_epipolar_masked_compact,
                                     match_epipolar_rows, match_global,
                                     match_global_rows,
                                     match_global_rows_compact,
                                     resolve_masked_compact_chunks)
from opengpc_tpu_torch.ops.fused import (fused_codes, fused_codes_pair,
                                         fused_key_image,
                                         fused_key_image_slab, mask_tests)
from opengpc_tpu_torch.ops.fused_match import fused_sparsematch_rows
from opengpc_tpu_torch.ops.preprocess import (CANDIDATE_MARGIN, box3,
                                              candidate_mask, require_u8,
                                              sobel3)
from opengpc_tpu_torch.utils.timing import span

_MARGIN = CANDIDATE_MARGIN


def _as_mask(forest_or_mask) -> FilterMask:
    if isinstance(forest_or_mask, Forest):
        return make_filter_mask(forest_or_mask)
    if isinstance(forest_or_mask, FilterMask):
        return forest_or_mask
    raise TypeError(f"expected a Forest or FilterMask, got "
                    f"{type(forest_or_mask).__name__}")


def _packed_ok(mask: FilterMask, shape) -> bool:
    """Sentinel-packed sorting needs codes < 2^30 (<= 30 tests) and all
    positions below the sentinel base."""
    h, w = shape
    return mask.num_tests <= 30 and 2 * h * w < (1 << 30)


def _rows_ok(mask: FilterMask, shape, settings: InferenceSettings) -> bool:
    """Masked-contract eligibility: epipolar mode, sentinel-packable codes
    and the (x, d) pack fitting 30 bits."""
    h, w = shape
    return (settings.epipolar_mode and _packed_ok(mask, shape)
            and _bits(w - 1) + _bits(2 * settings.disp_high) <= 30)


def _global_rows_ok(mask: FilterMask, shape, settings: InferenceSettings) -> bool:
    """Eligibility of the segmented global contracts (global rows, global
    compact, their sharded frame, the CLI and AOT): sentinel-packable codes
    and (y, x) fitting 30 bits, the key their segments sort.  The JAX
    package also asks the (y, x, d) pack to fit 30 bits."""
    h, w = shape
    return (_packed_ok(mask, shape)
            and _bits(h - 1) + _bits(w - 1) <= 30)


def _interior_rows(key):
    """Slice a (..., H, 2W) key image to its candidate rows [13, H-13):
    rows inside the margin hold only unique sentinels and never match.
    Returns (sliced, margin); margin is 0 when H is too small to slice."""
    h = key.shape[-2]
    if h > 2 * _MARGIN + 1:
        return key[..., _MARGIN:h - _MARGIN, :], _MARGIN
    return key, 0


def _pad_rows(t, m, dim, value=0):
    """Undo an interior-row slice: ``m`` rows of ``value`` back on both
    sides of ``dim`` (negative), a no-op for m=0."""
    if not m:
        return t
    pad = [0, 0] * (-dim - 1) + [m, m]
    return nn.functional.pad(t, pad, value=value)


def _batched_key_images(lefts, rights, mask: FilterMask,
                        settings: InferenceSettings):
    """(B, H, 2W) sentinel-packed key images of a (B, H, W) batch of pairs:
    the left keys in columns [0, W), the right keys in [W, 2W).  One launch
    of the key kernel on CUDA tensors, its plain twin on CPU tensors."""
    return fused_key_image(lefts, rights, mask, settings.gradient_threshold,
                           SENTINEL_BASE)


def _key_image(left, right, mask: FilterMask, settings: InferenceSettings):
    """(H, 2W) sentinel-packed key image of one pair."""
    return _batched_key_images(left[None], right[None], mask, settings)[0]


def _key_image_slab(slab_l, slab_r, mask: FilterMask,
                    settings: InferenceSettings, y0: int, h_total: int):
    """(sh, 2W) sentinel-packed key image of one row slab of a larger
    frame: ``slab_*`` are (sh + 28, W) uint8 slabs holding frame rows
    [y0 - 14, y0 + sh + 14) (zeros outside the frame), ``h_total`` the
    frame's height; (B, sh + 28, W) batches of such slabs give (B, sh,
    2W).  Equal to rows [y0, y0 + sh) of :func:`_key_image` on the whole
    frame.  One slab-mode launch of the key kernel for both on CUDA
    tensors, its plain twin on CPU tensors."""
    return fused_key_image_slab(slab_l, slab_r, mask,
                                settings.gradient_threshold, SENTINEL_BASE,
                                y0, h_total)


def _folded_key_rows(left, right, mask: FilterMask,
                     settings: InferenceSettings):
    """The interior rows of the key image of one (H, W) pair, or of a
    (B, H, W) batch's key images folded into one row axis: (rows (R, 2W),
    the (..., H') shape they unfold to, the margin m).  Epipolar rows are
    independent, so a folded batch matches as its pairs do one by one."""
    keys = (_batched_key_images(left, right, mask, settings)
            if left.dim() == 3 else _key_image(left, right, mask, settings))
    with span("ogpc.fold"):
        keys, m = _interior_rows(keys)
        return keys.reshape(-1, keys.shape[-1]), keys.shape[:-1], m


def _unfold(t, lead, m, value=0):
    """Per-row results (R, ...) back to (..., H, ...): the (..., H') shape
    ``lead`` and ``m`` margin rows of ``value`` on both sides."""
    t = t.reshape(lead + t.shape[1:])
    return _pad_rows(t, m, len(lead) - 1 - t.dim(), value=value)


def _codes_and_candidates(img, mask: FilterMask,
                          settings: InferenceSettings):
    """(codes int32, candidates bool) of an (H, W) image: the fused code
    kernel on a CUDA tensor, its plain twin on a CPU one."""
    return fused_codes(img, mask, settings.gradient_threshold)


def _check_masked(mask: FilterMask, shape, settings: InferenceSettings):
    if not _rows_ok(mask, shape, settings):
        raise ValueError(
            "masked output needs epipolar mode, <=30-test forests and a "
            "30-bit (x, d) pack")


def _sparsematch_masked_impl(left, right, mask: FilterMask,
                             settings: InferenceSettings):
    """(buf (H, 2W) int32, row_counts (H,) int32) for one pair, or
    (B, H, 2W) and (B, H) for a batch folded into one row sort."""
    _check_masked(mask, tuple(left.shape[-2:]), settings)
    rows, lead, m = _folded_key_rows(left, right, mask, settings)
    buf, counts = match_epipolar_masked(None, None, None, None,
                                        settings.disp_high, key=rows,
                                        num_tests=mask.num_tests)
    with span("ogpc.unfold"):
        return (_unfold(buf, lead, m, MASKED_SENTINEL),
                _unfold(counts, lead, m))


def _sparsematch_impl(left, right, mask: FilterMask,
                      settings: InferenceSettings, fused_match: bool = False):
    """The flat contract for one (H, W) pair: (xs, ys, ds) (capacity,)
    int32 buffers and the true support count.

    ``fused_match=True`` runs the fused match kernel
    (``ops.fused_match.fused_sparsematch_rows``) where it applies (epipolar
    mode, packable keys) and compacts its windows in flat window order."""
    if fused_match and settings.epipolar_mode and _packed_ok(mask, left.shape):
        keep, src_x, d = fused_sparsematch_rows(
            left, right, mask, settings.gradient_threshold, settings.disp_high)
        (xs, ys, ds), count = compact(keep, (src_x, _rows_of(keep), d),
                                      settings.capacity)
        return xs, ys, ds, count
    if settings.epipolar_mode and _packed_ok(mask, left.shape):
        (xs, ys, ds), count = _match_epipolar_packed(
            None, None, None, None, settings.disp_high, settings.capacity,
            key=_key_image(left, right, mask, settings),
            num_tests=mask.num_tests)
        return xs, ys, ds, count
    (codes_l, cand_l), (codes_r, cand_r) = fused_codes_pair(
        left, right, mask, settings.gradient_threshold)
    if settings.epipolar_mode:
        (xs, ys, ds), count = match_epipolar(
            codes_l, codes_r, cand_l, cand_r, settings.disp_high,
            settings.capacity)
    else:
        (xs, ys, ds), count = match_global(
            codes_l, codes_r, cand_l, cand_r, settings.disp_high,
            settings.vertical_tolerance, settings.capacity,
            packed=_packed_ok(mask, left.shape))
    return xs, ys, ds, count


def _sparsematch_global_rows_impl(left, right, mask: FilterMask,
                                  settings: InferenceSettings):
    """The global-rows contract for one (H, W) pair:
    ((xs, ys, ds) (R, C) int32, counts (R,))."""
    if settings.epipolar_mode:
        raise ValueError("global row-form output is for global mode")
    if not _global_rows_ok(mask, tuple(left.shape), settings):
        raise ValueError(
            "global row-form output needs <=30-test forests and (y, x) in "
            "30 bits; use build_sparsematch")
    key = _key_image(left, right, mask, settings)
    with span("ogpc.fold"):
        key, m = _interior_rows(key)
    return match_global_rows(key, left.shape[1], settings.disp_high,
                             settings.vertical_tolerance, y_offset=m)


def _check_rows(mask: FilterMask, shape, settings: InferenceSettings):
    if not settings.epipolar_mode:
        raise ValueError("row-form output is epipolar-only")
    if not _packed_ok(mask, shape):
        raise ValueError("row-form output needs <=30-test forests")
    if not _rows_ok(mask, shape, settings):
        raise ValueError(
            f"row-form output needs the (x, d) pack key to fit 30 bits "
            f"(width {shape[1]} with disp_high {settings.disp_high} does "
            "not); use build_sparsematch")


def _sparsematch_rows_impl(left, right, mask: FilterMask,
                           settings: InferenceSettings):
    """The row form: ((xs, ds) (H, W) int32 each, row_counts (H,)) for one
    pair, or (B, H, W) and (B, H) for a batch folded into one row sort."""
    _check_rows(mask, tuple(left.shape[-2:]), settings)
    rows, lead, m = _folded_key_rows(left, right, mask, settings)
    (xs, ds), counts = match_epipolar_rows(
        None, None, None, None, settings.disp_high, key=rows,
        num_tests=mask.num_tests)
    return ((_unfold(xs, lead, m), _unfold(ds, lead, m)),
            _unfold(counts, lead, m))


def _sparsematch_masked_compact_impl(left, right, mask: FilterMask,
                                     settings: InferenceSettings, chunk, k):
    """The chunk-compacted masked contract: (buf (H, C) int32, row_counts
    (H,), overflow bool) for one pair, or (B, H, C), (B, H) and one flag
    for a batch folded into one compacted row sort."""
    _check_masked(mask, tuple(left.shape[-2:]), settings)
    rows, lead, m = _folded_key_rows(left, right, mask, settings)
    buf, counts, ovf = match_epipolar_masked_compact(
        rows, settings.disp_high, chunk, k, num_tests=mask.num_tests)
    return (_unfold(buf, lead, m, MASKED_SENTINEL), _unfold(counts, lead, m),
            ovf)


def _sparsematch_global_compact_impl(left, right, mask: FilterMask,
                                     settings: InferenceSettings, chunk, k):
    """The chunk-compacted global contract for one (H, W) pair:
    ((xs, ys, ds) (R, C) int32, counts (R,), overflow bool)."""
    if settings.epipolar_mode:
        raise ValueError("global compact output is for global mode; use "
                         "build_sparsematch_masked_compact for epipolar")
    if not _global_rows_ok(mask, tuple(left.shape), settings):
        raise ValueError(
            "global compact needs <=30-test forests and (y, x) in 30 bits; "
            "use build_sparsematch")
    key, m = _interior_rows(_key_image(left, right, mask, settings))
    return match_global_rows_compact(
        key, left.shape[1], settings.disp_high, settings.vertical_tolerance,
        chunk=chunk, k=k, y_offset=m)


def _stereomatch_impl(left, right, mask: FilterMask,
                      settings: InferenceSettings):
    """Unfiltered global correspondences of one (H, W) pair: (sx, sy, tx,
    ty) (capacity,) int32 buffers and the true count.  One code-kernel
    launch for both images on CUDA tensors."""
    (codes_l, cand_l), (codes_r, cand_r) = fused_codes_pair(
        left, right, mask, settings.gradient_threshold)
    (sx, sy, tx, ty), count = match_correspondences(
        codes_l, codes_r, cand_l, cand_r, settings.capacity,
        packed=_packed_ok(mask, left.shape))
    return sx, sy, tx, ty, count


def _stack(outs):
    """Stack a list of equally nested tuples of tensors along a new axis."""
    if isinstance(outs[0], tuple):
        return tuple(_stack(list(o)) for o in zip(*outs))
    return torch.stack(outs)


class _Matcher(nn.Module):
    """A matcher for one forest and one settings object.

    ``forward(left, right)`` takes (H, W) or (B, H, W) uint8 tensors on the
    module's device and returns the contract's device tensors, with a
    leading batch axis for a batch."""

    def __init__(self, mask: FilterMask, settings: InferenceSettings,
                 device="cuda"):
        super().__init__()
        self.mask = mask
        self.settings = settings
        self.register_buffer(
            "tests", torch.tensor(mask_tests(mask), dtype=torch.int32,
                                  device=device).reshape(-1, 5))

    def forward(self, left: torch.Tensor, right: torch.Tensor):
        with span("ogpc.forward"):
            require_u8(left)
            require_u8(right)
            if left.shape != right.shape or left.dim() not in (2, 3):
                raise ValueError(
                    f"expected matching (H, W) or (B, H, W) images, got "
                    f"{tuple(left.shape)} and {tuple(right.shape)}")
            dev = self.tests.device
            if left.device != dev or right.device != dev:
                raise ValueError(f"images on {left.device}/{right.device}, "
                                 f"matcher on {dev}")
            return self._run(left, right)

    def _run(self, left, right):
        """Pair by pair, stacked for a batch: the JAX builders' lax.map."""
        if left.dim() == 2:
            return self._pair(left, right, self.mask, self.settings)
        return _stack([self._pair(l, r, self.mask, self.settings)
                       for l, r in zip(left, right)])


class SparsematchMasked(_Matcher):
    """The masked epipolar matcher: ``(buf, row_counts)``; decode one pair
    with :func:`masked_supports_to_numpy`.  A batch folds into one row
    sort."""

    def _run(self, left, right):
        return _sparsematch_masked_impl(left, right, self.mask, self.settings)


class Sparsematch(_Matcher):
    """The flat matcher: ``(xs, ys, ds, count)``; trim one pair with
    :func:`supports_to_numpy`."""

    _pair = staticmethod(_sparsematch_impl)


class SparsematchGlobalRows(_Matcher):
    """The global-mode segmented matcher: ``((xs, ys, ds), counts)``;
    assemble one pair with :func:`global_row_supports_to_numpy`.  A batch
    runs pair by pair; a batch of one returns its pair's tensors as views
    with a leading axis, with no stack copy."""

    _pair = staticmethod(_sparsematch_global_rows_impl)

    def _run(self, left, right):
        if left.dim() == 3 and left.shape[0] == 1:
            (xs, ys, ds), counts = self._pair(left[0], right[0], self.mask,
                                              self.settings)
            return (xs[None], ys[None], ds[None]), counts[None]
        return super()._run(left, right)


class SparsematchRows(_Matcher):
    """The row-form epipolar matcher: ``((xs, ds), row_counts)``; assemble
    one pair with :func:`row_supports_to_numpy`.  A batch folds into one
    row sort."""

    def _run(self, left, right):
        return _sparsematch_rows_impl(left, right, self.mask, self.settings)


class SparsematchMaskedCompact(_Matcher):
    """The chunk-compacted masked matcher: ``(buf, row_counts,
    overflow)``.  A batch folds into one compacted row sort with one
    flag."""

    def __init__(self, mask, settings, device, chunk, k):
        super().__init__(mask, settings, device)
        self.chunk, self.k = resolve_masked_compact_chunks(chunk, k)

    def _run(self, left, right):
        return _sparsematch_masked_compact_impl(left, right, self.mask,
                                                self.settings, self.chunk,
                                                self.k)


class SparsematchGlobalCompact(_Matcher):
    """The chunk-compacted global matcher: ``((xs, ys, ds), counts,
    overflow)``.  A batch runs pair by pair, with a flag for each pair."""

    def __init__(self, mask, settings, device, chunk, k):
        super().__init__(mask, settings, device)
        self.chunk, self.k = chunk, k

    def _pair(self, left, right, mask, settings):
        return _sparsematch_global_compact_impl(left, right, mask, settings,
                                                self.chunk, self.k)


class Stereomatch(_Matcher):
    """The correspondence matcher: ``(sx, sy, tx, ty, count)``.  A batch
    runs pair by pair."""

    _pair = staticmethod(_stereomatch_impl)


def build_sparsematch_masked(forest_or_mask, settings: InferenceSettings,
                             device="cuda") -> SparsematchMasked:
    """The masked epipolar matcher as an ``nn.Module`` on ``device``.

    ``buf`` is (H, 2W) int32 with ``(x << bd) | (d + disp_high)`` at
    detected supports and ``MASKED_SENTINEL`` elsewhere.  Batches fold into
    the row axis."""
    return SparsematchMasked(_as_mask(forest_or_mask), settings,
                             torch.device(device))


def build_sparsematch(forest_or_mask, settings: InferenceSettings,
                      device="cuda") -> Sparsematch:
    """The flat matcher as an ``nn.Module`` on ``device``: (xs, ys, ds)
    (capacity,) int32 buffers and the true support count, which may exceed
    ``settings.capacity`` (the buffers then hold the first ``capacity``).
    Any forest of <= 32 tests, either mode."""
    return Sparsematch(_as_mask(forest_or_mask), settings,
                       torch.device(device))


def build_sparsematch_global_rows(forest_or_mask, settings: InferenceSettings,
                                  device="cuda") -> SparsematchGlobalRows:
    """The global-mode matcher with segmented row-form output as an
    ``nn.Module`` on ``device``: the same support set as the flat matcher
    in global mode, with no capacity and without its compaction sort.
    Needs <= 30 tests and (y, x) in 30 bits (4K frames included): each
    segment sorts the (y, x) key on the row-sort kernel."""
    return SparsematchGlobalRows(_as_mask(forest_or_mask), settings,
                                 torch.device(device))


def build_sparsematch_rows(forest_or_mask, settings: InferenceSettings,
                           device="cuda") -> SparsematchRows:
    """The row-form epipolar matcher as an ``nn.Module`` on ``device``:
    ((xs, ds) (H, W) each, row_counts (H,)), row y holding the supports
    (xs[y, :c], y, ds[y, :c]), c = row_counts[y], ordered by x.  The same
    support set as the flat matcher, without its compaction sort.  Needs
    epipolar mode, <= 30 tests and a 30-bit (x, d) pack."""
    return SparsematchRows(_as_mask(forest_or_mask), settings,
                           torch.device(device))


def build_sparsematch_masked_compact(forest_or_mask,
                                     settings: InferenceSettings,
                                     device="cuda", chunk=None,
                                     k=None) -> SparsematchMaskedCompact:
    """The low-density masked matcher as an ``nn.Module`` on ``device``:
    (buf (H, 2W/chunk*k), row_counts (H,), overflow bool).  The same
    support set as :func:`build_sparsematch_masked` while ``overflow`` is
    False; when it is True (a chunk held more than ``k`` candidates) the
    result is incomplete and the caller must re-run the full-width masked
    matcher.  ``buf`` decodes with :func:`masked_supports_to_numpy`."""
    return SparsematchMaskedCompact(_as_mask(forest_or_mask), settings,
                                    torch.device(device), chunk, k)


def build_sparsematch_global_compact(forest_or_mask,
                                     settings: InferenceSettings,
                                     device="cuda", chunk=None,
                                     k=None) -> SparsematchGlobalCompact:
    """The low-density global matcher as an ``nn.Module`` on ``device``:
    ((xs, ys, ds) (R, C) each, counts (R,), overflow bool).  The same
    support set as :func:`build_sparsematch_global_rows` while
    ``overflow`` is False; when it is True the caller must re-run the
    full-width global matcher.  ``chunk``/``k`` default by row width
    (``match.global_compact_chunks``).  A batch runs pair by pair and
    gives a flag for each pair."""
    return SparsematchGlobalCompact(_as_mask(forest_or_mask), settings,
                                    torch.device(device), chunk, k)


def build_stereomatch(forest_or_mask, settings: InferenceSettings,
                      device="cuda") -> Stereomatch:
    """The correspondence matcher as an ``nn.Module`` on ``device``, the
    reference's stereoMatch surface: global unique-collision
    correspondences (sx, sy, tx, ty) (capacity,) int32 buffers and their
    true count, with no epipolar, disparity or vertical filter.  A (B, H,
    W) batch runs pair by pair."""
    return Stereomatch(_as_mask(forest_or_mask), settings,
                       torch.device(device))


def _numpy(t):
    """Host copies of a tensor, an array or a nested tuple of them."""
    if isinstance(t, tuple):
        return tuple(_numpy(o) for o in t)
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def masked_supports_to_numpy(buf, row_counts, disp_high: int) -> np.ndarray:
    """Decode one pair's masked buffer into the (n, 3) int32 (x, y, d)
    support array: row-major, code-sorted within each row.  The scan is
    the host library's (``io.png.masked_decode_native``, on threads for a
    large buffer), or :func:`_masked_decode_numpy` where the library cannot
    be built."""
    buf, row_counts = _numpy(buf), _numpy(row_counts)
    if buf.ndim != 2:
        raise ValueError(
            "masked_supports_to_numpy takes one pair's (H, 2W) buffer; "
            "index the batch axis first")
    n = int(row_counts.sum())
    out = masked_decode_native(buf, n, disp_high, MASKED_SENTINEL,
                               row_counts=row_counts)
    return out if out is not None else _masked_decode_numpy(buf, n,
                                                            disp_high)


def _masked_decode_numpy(buf: np.ndarray, n: int, disp_high: int):
    """The plain masked decode: one flat nonzero pass over the (H, 2W)
    buffer; raises when it holds other than ``n`` supports."""
    bd = max(1, int(2 * disp_high).bit_length())
    flat = buf.ravel()
    pos = np.flatnonzero(flat != MASKED_SENTINEL)
    v = flat[pos]
    out = np.empty((len(pos), 3), np.int32)
    out[:, 0] = v >> bd
    out[:, 1] = (pos // buf.shape[1]).astype(np.int32)
    out[:, 2] = (v & ((1 << bd) - 1)) - disp_high
    if out.shape[0] != n:
        raise ValueError(
            f"masked buffer holds {out.shape[0]} supports, row counts say {n}")
    return out


def supports_to_numpy(xs, ys, ds, count) -> np.ndarray:
    """Trim one pair's flat buffers to the (n, 3) int32 (x, y, d) array;
    supports beyond the capacity are dropped (``count`` tells)."""
    xs, ys, ds = _numpy(xs), _numpy(ys), _numpy(ds)
    if xs.ndim != 1:
        raise ValueError(
            "supports_to_numpy takes one pair's buffers; index the batch "
            "axis first")
    n = min(int(count), xs.shape[0])
    return np.stack([xs[:n], ys[:n], ds[:n]], axis=1).astype(np.int32)


def global_row_supports_to_numpy(xs, ys, ds, counts) -> np.ndarray:
    """Assemble one pair's global segmented buffers into the (n, 3) int32
    (x, y, d) array, in (y, x, d)-ascending order."""
    xs, ys, ds, c = _numpy(xs), _numpy(ys), _numpy(ds), _numpy(counts)
    if xs.ndim != 2:
        raise ValueError(
            "global_row_supports_to_numpy takes one pair's (R, C) buffers; "
            "index the batch axis first")
    sel = np.arange(xs.shape[1])[None, :] < c[:, None]
    out = np.stack([xs[sel], ys[sel], ds[sel]], axis=1).astype(np.int32)
    return out[np.lexsort((out[:, 2], out[:, 0], out[:, 1]))]


def row_supports_to_numpy(xs_rows, ds_rows, row_counts) -> np.ndarray:
    """Assemble one pair's row-form buffers into the (n, 3) int32 (x, y, d)
    array, row-major and x-ascending within a row."""
    xs, ds, c = _numpy(xs_rows), _numpy(ds_rows), _numpy(row_counts)
    if xs.ndim != 2:
        raise ValueError(
            "row_supports_to_numpy takes one pair's (H, W) buffers; index "
            "the batch axis first")
    sel = np.arange(xs.shape[1])[None, :] < c[:, None]
    ys = np.broadcast_to(np.arange(xs.shape[0], dtype=np.int32)[:, None],
                         xs.shape)
    return np.stack([xs[sel], ys[sel], ds[sel]], axis=1).astype(np.int32)


def preprocess(img, gradient_threshold: int, device="cuda"):
    """(smooth, candidate_mask) of one uint8 image, an array or tensor, on
    ``device``: the 3x3 box and the Sobel candidates with their 13-px
    margin.  Both run on the *raw* image, as in the reference; the codes
    are taken on the smoothed one."""
    img = _image_arg(img, torch.device(device))
    return box3(img), candidate_mask(sobel3(img, gradient_threshold))


def extract_descriptors(img, forest_or_mask, settings: InferenceSettings,
                        device="cuda") -> np.ndarray:
    """Per-image descriptor list: an (n, 3) int64 array of (x, y, state)
    rows, one for every candidate pixel in row-major order, with the leaf
    code as an unsigned 32-bit state.  ``img`` is one (H, W) uint8 array or
    tensor; the fused code kernel runs on ``device``."""
    img = _image_arg(img, torch.device(device))
    if img.dim() != 2:
        raise ValueError(f"extract_descriptors takes one (H, W) image, got "
                         f"shape {tuple(img.shape)}")
    codes, cand = _codes_and_candidates(img, _as_mask(forest_or_mask),
                                        settings)
    ys, xs = np.nonzero(cand.cpu().numpy())
    states = codes.cpu().numpy().astype(np.uint32)[ys, xs]
    return np.stack([xs, ys, states.astype(np.int64)], axis=1)


class _LruCache:
    """Thread-safe bounded LRU.  ``make`` runs outside the lock; a lost race
    discards the duplicate and returns the first-written value."""

    def __init__(self, max_entries: int):
        self._d = collections.OrderedDict()
        self._max = max_entries
        self._lock = threading.Lock()

    def get_or_add(self, key, make):
        with self._lock:
            val = self._d.get(key)
            if val is not None:
                self._d.move_to_end(key)
                return val
        val = make()
        with self._lock:
            cur = self._d.get(key)
            if cur is not None:
                self._d.move_to_end(key)
                return cur
            self._d[key] = val
            if len(self._d) > self._max:
                self._d.popitem(last=False)
            return val

    def discard(self, key):
        with self._lock:
            self._d.pop(key, None)


_MATCH_FN_CACHE = _LruCache(16)
_FOREST_CACHE = _LruCache(8)


def _file_key(real: str):
    st = os.stat(real)
    return (real, st.st_ino, st.st_mtime_ns, st.st_size)


def _load_forest_cached(path: str) -> Forest:
    """load_forest keyed by (realpath, inode, mtime, size).  The key is
    taken again after the parse and the call retried if it changed, so a
    file swapped during the parse is never cached under the old key; a
    file that keeps changing raises instead of serving an unverified
    parse."""
    real = os.path.realpath(path)
    for _ in range(8):
        key = _file_key(real)
        forest = _FOREST_CACHE.get_or_add(key, lambda: load_forest(real))
        if _file_key(real) == key:
            return forest
        _FOREST_CACHE.discard(key)
    raise RuntimeError(f"forest file {real} kept changing while it was read")


def _mask_cache_key(mask: FilterMask):
    return (mask_tests(mask), mask.type)


def _is_path(x) -> bool:
    return isinstance(x, (str, os.PathLike))


def _host_frame(x):
    """A PNG path decoded on the host (``io.read_gray``); arrays and
    tensors pass."""
    return read_gray(os.fspath(x)) if _is_path(x) else x


def _image_arg(x, device) -> torch.Tensor:
    """One sparsematch image argument as a uint8 tensor on ``device``: an
    array or tensor, a PNG path, or a list of same-shape frames or paths
    stacked to (B, H, W).  Four or more paths decode through
    ``io.read_gray_batch``.  Frames decode and stack on the host and
    upload once."""
    if isinstance(x, (list, tuple)):
        if not x:
            raise ValueError("sparsematch got an empty batch list")
        if len(x) >= 4 and all(map(_is_path, x)):
            frames = read_gray_batch([os.fspath(f) for f in x])
        else:
            frames = [_host_frame(f) for f in x]
        shapes = {tuple(f.shape) for f in frames}
        if len(shapes) != 1:
            raise ValueError(
                f"batch frames have differing shapes: {sorted(shapes)}; "
                "sparsematch batches one resolution per call")
        if any(isinstance(f, torch.Tensor) for f in frames):
            return torch.stack([_image_arg(f, device) for f in frames])
        for f in frames:
            require_u8(f)
        x = np.stack(frames)
    x = _host_frame(x)
    require_u8(x)
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def _pair_of(out, i):
    """Pair i of a batched, nested tuple of arrays."""
    if isinstance(out, tuple):
        return tuple(_pair_of(o, i) for o in out)
    return out[i]


def route(mask: FilterMask, shape, settings: InferenceSettings,
          levels: int = 1) -> str:
    """The one-call route of an (H, W) frame: "masked", "global-rows" or
    "flat" at one level; with ``levels > 1`` "pyramid-rows" (every level
    on the row-form matcher) or "pyramid-flat" (the flat fallback: global
    mode or unpackable dedup keys).

    The choice is the JAX package's except in global mode where the (y,
    x, d) pack is past 30 bits (1080 x 1920 and 4K frames at dispHigh
    128, or a wide dispHigh): the JAX package takes the flat route there,
    with its capacity, and the port the global-rows route, whose segments
    sort the (y, x) key alone.  The flat route stays the fallback for 31-
    and 32-test forests."""
    if levels > 1:
        from opengpc_tpu_torch.pyramid import _rows_eligible

        el = _rows_eligible(mask, settings, shape[0], shape[1], levels)
        return "pyramid-rows" if el is not None else "pyramid-flat"
    if settings.epipolar_mode and _rows_ok(mask, shape, settings):
        return "masked"
    if not settings.epipolar_mode and _global_rows_ok(mask, shape, settings):
        return "global-rows"
    return "flat"


_BUILDERS = {"masked": build_sparsematch_masked,
             "global-rows": build_sparsematch_global_rows,
             "flat": build_sparsematch}
_DECODERS = {
    "masked": lambda out, s: masked_supports_to_numpy(*out, s.disp_high),
    "global-rows": lambda out, s: global_row_supports_to_numpy(*out[0],
                                                               out[1]),
    "flat": lambda out, s: supports_to_numpy(*out),
}


def _build(contract, mask, settings, device, levels):
    """The module of a one-call contract."""
    if levels > 1:
        from opengpc_tpu_torch.pyramid import build_pyramid_sparsematch

        return build_pyramid_sparsematch(mask, settings, num_levels=levels,
                                         device=device)
    return _BUILDERS[contract](mask, settings, device)


def _decode_pyramid(out, settings):
    from opengpc_tpu_torch.pyramid import pyramid_supports_to_numpy

    return pyramid_supports_to_numpy(*out)


def sparsematch(left, right, forest_or_mask,
                settings: Optional[InferenceSettings] = None,
                device="cuda", levels: int = 1):
    """One-call sparse match: a rectified (H, W) uint8 pair -> the (n, 3)
    int32 (x, y, d) support array, d = x_src - x_tar.

    ``left``/``right`` are arrays, tensors or PNG paths (8/16-bit,
    palette and RGB files read as the reference's grayscale), or (B, H, W)
    stacks or lists of frames or paths for a batch, which returns a
    length-B list.  ``forest_or_mask`` is a ``Forest``, a ``FilterMask`` or
    a forest file path (parsed once and cached).  The device stages run
    on ``device``; the PNG and support decodes run on the host.

    >>> supports = sparsematch("left.png", "right.png", "forest.txt")

    The route (:func:`route`): the masked contract in epipolar mode when
    it applies, the global-rows contract in global mode when it applies
    (<= 30 tests; at any frame the key kernel takes, 4K included), and the
    flat contract otherwise (more than 30 tests, or an epipolar (x, d)
    pack wider than 30 bits).  The flat route raises ``ValueError`` when a
    pair has more supports than ``settings.capacity``.

    ``levels > 1`` runs the coarse-to-fine pyramid instead (the CLI's
    ``--pyramid N``): supports of every scale, finest-level-wins, as an
    (n, 4) int32 (x, y, d, level) array in level-0 coordinates.  Lossless
    on either route (``pyramid.build_pyramid_sparsematch``).
    """
    settings = settings if settings is not None else InferenceSettings()
    if levels < 1:
        raise ValueError(f"levels must be >= 1, got {levels}")
    if isinstance(forest_or_mask, (str, os.PathLike)):
        forest_or_mask = _load_forest_cached(os.fspath(forest_or_mask))
    mask = _as_mask(forest_or_mask)
    device = torch.device(device)
    left = _image_arg(left, device)
    right = _image_arg(right, device)
    if left.shape != right.shape:
        raise ValueError(
            f"image shapes differ: {tuple(left.shape)} vs {tuple(right.shape)}")
    if left.dim() not in (2, 3):
        raise ValueError(
            f"sparsematch takes one (H, W) pair or a (B, H, W) batch, got "
            f"shape {tuple(left.shape)}")
    batched = left.dim() == 3
    contract = (f"pyramid-{levels}" if levels > 1
                else route(mask, tuple(left.shape[-2:]), settings))
    key = (_mask_cache_key(mask), settings, device, contract)
    fn = _MATCH_FN_CACHE.get_or_add(
        key, lambda: _build(contract, mask, settings, device, levels))
    out = _numpy(fn(left, right))
    if contract == "flat":
        count = out[3]
        over = np.flatnonzero(np.atleast_1d(count) > settings.capacity)
        if over.size:
            which = (f"pair(s) {over.tolist()} of the batch" if batched
                     else f"{int(count)} supports")
            raise ValueError(
                f"{which} exceed settings.capacity={settings.capacity} on the "
                "flat contract; raise capacity (these settings are outside "
                "the packed-key contracts: width/disp_high beyond the 30-bit "
                "budget, or a >30-test forest)")
    decode = _DECODERS[contract] if levels == 1 else _decode_pyramid
    if batched:
        return [decode(_pair_of(out, i), settings)
                for i in range(left.shape[0])]
    return decode(out, settings)
