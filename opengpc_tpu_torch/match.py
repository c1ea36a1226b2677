"""On-device unique-collision matching, epipolar masked contract.

Each row of the (R, 2W) key image (source image in columns [0, W), target
in [W, 2W)) is sorted; a run of exactly two equal keys, one from each
image, is a support.  Non-candidate pixels carry unique per-position
sentinel keys >= SENTINEL_BASE, so they never pair and the sort needs no
validity operand.  Same semantics as ``opengpc_tpu.match``'s masked path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SENTINEL_BASE = 0x40000000  # above any <=30-bit leaf code
MASKED_SENTINEL = 0x7FFFFFFF


def _pos_bits(w2: int) -> int:
    return int(w2 - 1).bit_length()


def _pack_ok(num_tests, w2) -> bool:
    """True when code and position can share ONE int32 sort key: packed
    keys (code << pos_bits | pos) stay below SENTINEL_BASE, and the
    per-position sentinels pass through unchanged."""
    return num_tests is not None and num_tests + _pos_bits(w2) <= 30


def _pack_keypos(key, pos, pb):
    """Pack pos into the low ``pb`` bits of a code key; sentinels pass
    through unchanged (they already encode their position)."""
    return torch.where(key < SENTINEL_BASE, (key << pb) | pos, key)


def _unpack_keypos(packed, pb):
    """Inverse of _pack_keypos: (key, pos) from packed keys."""
    sent = packed >= SENTINEL_BASE
    key = torch.where(sent, packed, packed >> pb)
    pos = torch.where(sent, packed - SENTINEL_BASE, packed & ((1 << pb) - 1))
    return key, pos


def _sort_key_pos(key, num_tests):
    """The matcher's row sort of an (R, 2W) key image whose positions are
    the column indices: one operand with pos packed into the key when
    ``_pack_ok`` holds, otherwise (key, pos) by an unstable sort whose
    returned indices are the positions.  Returns int32 (key_s, pos_s).

    Tie order does not matter: detection only emits runs of exactly two,
    normalized by lo/hi position."""
    w2 = key.shape[1]
    if _pack_ok(num_tests, w2):
        pb = _pos_bits(w2)
        pos = torch.arange(w2, dtype=torch.int32, device=key.device)
        packed_s = torch.sort(_pack_keypos(key, pos, pb), dim=1,
                              stable=False).values
        return _unpack_keypos(packed_s, pb)
    key_s, idx = torch.sort(key, dim=1, stable=False)
    return key_s, idx.to(torch.int32)


def _detect_pairs_packed(key_s, pos_s, w, disp_high):
    """Pair detection over row-sorted keys: (keep, src_x, d) windows of
    shape (R, 2W-1)."""
    eq = key_s[:, :-1] == key_s[:, 1:]
    prev = F.pad(eq[:, :-1], (1, 0))
    nxt = F.pad(eq[:, 1:], (0, 1))
    pair = eq & ~prev & ~nxt
    left_pos, right_pos = pos_s[:, :-1], pos_s[:, 1:]
    # an equal (src, tar) pair may come out in either order: normalize
    lo = torch.minimum(left_pos, right_pos)
    hi = torch.maximum(left_pos, right_pos)
    cross = (lo < w) & (hi >= w) & (hi < 2 * w)
    src_x = lo
    d = src_x - (hi - w)
    keep = pair & cross & (d.abs() <= disp_high)
    return keep, src_x, d


def _masked_emit(keep, src_x, d, w, disp_high):
    """Pack detected supports as ``(src_x << bd) | (d + disp_high)`` in
    place, MASKED_SENTINEL elsewhere, one sentinel pad column, and the
    per-row counts."""
    bd = max(1, int(2 * disp_high).bit_length())
    bx = max(1, int(w - 1).bit_length())
    if bx + bd > 30:
        raise ValueError(
            f"masked pack needs x+d bits <= 30, got {bx}+{bd}")
    out = torch.where(keep, (src_x << bd) | (d + disp_high),
                      torch.full_like(src_x, MASKED_SENTINEL))
    out = F.pad(out, (0, 1), value=MASKED_SENTINEL)
    counts = keep.sum(dim=1, dtype=torch.int32)
    return out, counts


def match_epipolar_masked(key, disp_high, num_tests):
    """Masked sorted-order epipolar matcher over an (R, 2W) int32 key image.

    Returns (buf (R, 2W) int32, row_counts (R,) int32): window position i
    of row y holds ``(src_x << bd) | (d + disp_high)`` where a support was
    found (bd = bit_length(2*disp_high)) and MASKED_SENTINEL elsewhere.
    Decode with ``infer.masked_supports_to_numpy``.
    """
    if key.dtype != torch.int32 or key.dim() != 2:
        raise ValueError(f"expected an (R, 2W) int32 key image, got "
                         f"{key.dtype} {tuple(key.shape)}")
    w = key.shape[1] // 2
    key_s, pos_s = _sort_key_pos(key, num_tests)
    keep, src_x, d = _detect_pairs_packed(key_s, pos_s, w, disp_high)
    return _masked_emit(keep, src_x, d, w, disp_high)
