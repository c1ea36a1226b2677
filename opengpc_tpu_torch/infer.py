"""Sparse-matching inference: the masked epipolar contract.

    key image (fused key kernel, both images)   ops.fused.fused_keys
      -> interior rows [13, H-13)               _interior_rows
      -> row sort, pair detection, masked emit  match.match_epipolar_masked
      -> host decode to (x, y, d) supports      masked_supports_to_numpy

``build_sparsematch_masked`` returns an ``nn.Module`` whose forward runs
the device stages; ``sparsematch`` is the one-call entry point.  A
(B, H, W) batch folds into one (B*H', 2W) row sort.  Other output
contracts, the pyramid and global mode are not ported yet and raise
``NotImplementedError``.
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
from opengpc_tpu_torch.match import (MASKED_SENTINEL, SENTINEL_BASE,
                                     match_epipolar_masked)
from opengpc_tpu_torch.ops.fused import fused_keys_into, mask_tests
from opengpc_tpu_torch.ops.preprocess import CANDIDATE_MARGIN, require_u8

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
    bx = max(1, int(w - 1).bit_length())
    bd = max(1, int(2 * settings.disp_high).bit_length())
    return (settings.epipolar_mode and _packed_ok(mask, shape)
            and bx + bd <= 30)


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
    the left keys in columns [0, W), the right keys in [W, 2W).  The key
    kernel on CUDA tensors, its plain twin on CPU tensors."""
    b, h, w = lefts.shape
    out = torch.empty((b, h, 2 * w), dtype=torch.int32, device=lefts.device)
    thr = settings.gradient_threshold
    fused_keys_into(lefts, out, 0, mask, thr, 0, SENTINEL_BASE)
    fused_keys_into(rights, out, w, mask, thr, w, SENTINEL_BASE)
    return out


def _key_image(left, right, mask: FilterMask, settings: InferenceSettings):
    """(H, 2W) sentinel-packed key image of one pair."""
    return _batched_key_images(left[None], right[None], mask, settings)[0]


def _sparsematch_masked_impl(left, right, mask: FilterMask,
                             settings: InferenceSettings):
    """(buf (H, 2W) int32, row_counts (H,) int32) for one pair, or
    (B, H, 2W) and (B, H) for a batch folded into one row sort."""
    shape = tuple(left.shape[-2:])
    if not _rows_ok(mask, shape, settings):
        raise ValueError(
            "masked output needs epipolar mode, <=30-test forests and a "
            "30-bit (x, d) pack")
    batched = left.dim() == 3
    keys = (_batched_key_images(left, right, mask, settings) if batched
            else _key_image(left, right, mask, settings))
    keys, m = _interior_rows(keys)
    hs, w2 = keys.shape[-2:]
    buf, counts = match_epipolar_masked(keys.reshape(-1, w2),
                                        settings.disp_high, mask.num_tests)
    buf = buf.reshape(keys.shape)
    counts = counts.reshape(keys.shape[:-1])
    return (_pad_rows(buf, m, -2, value=MASKED_SENTINEL),
            _pad_rows(counts, m, -1))


class SparsematchMasked(nn.Module):
    """The masked epipolar matcher for one forest and one settings object.

    ``forward(left, right)`` takes (H, W) or (B, H, W) uint8 tensors on the
    module's device and returns device tensors ``(buf, row_counts)``;
    decode one pair with :func:`masked_supports_to_numpy`.
    """

    def __init__(self, mask: FilterMask, settings: InferenceSettings,
                 device="cpu"):
        super().__init__()
        self.mask = mask
        self.settings = settings
        self.register_buffer(
            "tests", torch.tensor(mask_tests(mask), dtype=torch.int32,
                                  device=device).reshape(-1, 5))

    def forward(self, left: torch.Tensor, right: torch.Tensor):
        require_u8(left)
        require_u8(right)
        if left.shape != right.shape or left.dim() not in (2, 3):
            raise ValueError(f"expected matching (H, W) or (B, H, W) images, "
                             f"got {tuple(left.shape)} and "
                             f"{tuple(right.shape)}")
        dev = self.tests.device
        if left.device != dev or right.device != dev:
            raise ValueError(f"images on {left.device}/{right.device}, "
                             f"matcher on {dev}")
        return _sparsematch_masked_impl(left, right, self.mask, self.settings)


def build_sparsematch_masked(forest_or_mask, settings: InferenceSettings,
                             device="cpu") -> SparsematchMasked:
    """The masked epipolar matcher as an ``nn.Module`` on ``device``.

    ``buf`` is (H, 2W) int32 with ``(x << bd) | (d + disp_high)`` at
    detected supports and ``MASKED_SENTINEL`` elsewhere.  Batches fold into
    the row axis."""
    return SparsematchMasked(_as_mask(forest_or_mask), settings,
                             torch.device(device))


def masked_supports_to_numpy(buf, row_counts, disp_high: int) -> np.ndarray:
    """Decode one pair's masked buffer into the (n, 3) int32 (x, y, d)
    support array: row-major, code-sorted within each row."""
    if isinstance(buf, torch.Tensor):
        buf = buf.cpu().numpy()
    if isinstance(row_counts, torch.Tensor):
        row_counts = row_counts.cpu().numpy()
    if np.ndim(buf) != 2:
        raise ValueError(
            "masked_supports_to_numpy takes one pair's (H, 2W) buffer; "
            "index the batch axis first")
    n = int(np.asarray(row_counts).sum())
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


def _image_arg(x, device) -> torch.Tensor:
    """One sparsematch image argument as a uint8 tensor on ``device``: an
    array or tensor, or a list of same-shape frames stacked to (B, H, W)."""
    if isinstance(x, (str, os.PathLike)):
        raise NotImplementedError(
            "PNG inputs wait for the port of opengpc_tpu.io.png (ROADMAP "
            "queue 1, item 11); pass uint8 arrays")
    if isinstance(x, (list, tuple)):
        if not x:
            raise ValueError("sparsematch got an empty batch list")
        frames = [_image_arg(f, device) for f in x]
        shapes = {tuple(f.shape) for f in frames}
        if len(shapes) != 1:
            raise ValueError(
                f"batch frames have differing shapes: {sorted(shapes)}; "
                "sparsematch batches one resolution per call")
        return torch.stack(frames)
    require_u8(x)
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def sparsematch(left, right, forest_or_mask,
                settings: Optional[InferenceSettings] = None,
                device="cuda", levels: int = 1):
    """One-call sparse match: a rectified (H, W) uint8 pair -> the (n, 3)
    int32 (x, y, d) support array, d = x_src - x_tar.

    ``left``/``right`` are arrays or tensors, or (B, H, W) stacks (or
    lists of frames) for a batch, which returns a length-B list.
    ``forest_or_mask`` is a ``Forest``, a ``FilterMask`` or a forest file
    path (parsed once and cached).  The device stages run on ``device``;
    the decode runs on the host.  Only the masked epipolar contract is
    ported: settings that would take another route raise
    ``NotImplementedError``.
    """
    settings = settings if settings is not None else InferenceSettings()
    if levels < 1:
        raise ValueError(f"levels must be >= 1, got {levels}")
    if levels > 1:
        raise NotImplementedError(
            "the pyramid is not ported yet (ROADMAP queue 1, item 5)")
    if not settings.epipolar_mode:
        raise NotImplementedError(
            "global (non-epipolar) mode is not ported yet (ROADMAP queue 1, "
            "item 3)")
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
    frame_shape = tuple(left.shape[-2:])
    if not _rows_ok(mask, frame_shape, settings):
        raise NotImplementedError(
            f"{mask.num_tests} tests at {frame_shape} with disp_high "
            f"{settings.disp_high} fall outside the masked contract (more "
            "than 30 tests or an (x, d) pack wider than 30 bits); the flat "
            "contract they need is not ported yet (ROADMAP queue 1, item 2)")
    key = (_mask_cache_key(mask), settings, device)
    fn = _MATCH_FN_CACHE.get_or_add(
        key, lambda: build_sparsematch_masked(mask, settings, device))
    buf, rc = fn(left, right)
    buf, rc = buf.cpu().numpy(), rc.cpu().numpy()
    if left.dim() == 3:
        return [masked_supports_to_numpy(buf[i], rc[i], settings.disp_high)
                for i in range(left.shape[0])]
    return masked_supports_to_numpy(buf, rc, settings.disp_high)
