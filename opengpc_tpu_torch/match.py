"""On-device unique-collision matching: the masked and flat epipolar
contracts and global mode.  Same semantics as ``opengpc_tpu.match``.

Epipolar mode sorts each row of the (R, 2W) key image (source image in
columns [0, W), target in [W, 2W)); a run of exactly two equal keys, one
from each image, is a support.  Global mode sorts all keys of the pair in
one flat sort, so uniqueness spans the whole image pair.  Non-candidate
pixels carry unique per-position sentinel keys >= SENTINEL_BASE, so they
never pair and the sort needs no validity operand; forests of 31 or 32
tests fill all 32 code bits and sort on (invalid, code) instead.

Output contracts: the masked buffer (``match_epipolar_masked``), the row
form (``match_epipolar_rows``), the flat fixed-capacity buffer
(``match_epipolar``, ``match_global``: compaction is a sort by position or
by the packed support, as in the JAX package), the segmented global rows
(``match_global_rows``), the unfiltered correspondences
(``match_correspondences``), and the chunk-compacted low-density variants of
the masked and global contracts (``match_epipolar_masked_compact``,
``match_global_rows_compact``) with their overflow flag.  The sorts are
``torch.sort``, the counterpart of XLA's ``lax.sort``, except the
epipolar row sort of the masked, row and sentinel-packed flat matchers
(``_sort_key_pos``), which is ``ops.sort.row_sort`` up to 16,384 columns;
the bitonic row sort of ``ops.sort`` is the ``sort_impl="bitonic"``
alternative.

The host matchers ``match_reference_quirk`` and ``match_hashmatch`` are
numpy copies of the JAX package's: the reference's exact sweep and its
hash-table matcher, bug for bug, on descriptor lists.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from opengpc_tpu_torch.ops.sort import MAX_N, row_sort
from opengpc_tpu_torch.utils.timing import span

SENTINEL_BASE = 0x40000000  # above any <=30-bit leaf code
MASKED_SENTINEL = 0x7FFFFFFF
PAD_KEY_BASE = 0x7F000000   # bitonic row padding: above every sentinel
_INT32_MAX = 0x7FFFFFFF


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
    the column indices.  Returns int32 (key_s, pos_s).

    Rows of at most ``ops.sort.MAX_N`` keys take ``ops.sort.row_sort``
    (the kernel of ``csrc/row_sort.cu`` on the card, a stable sort on the
    CPU): (key, pos) order, which is also the packed sort's.  Wider rows
    take ``torch.sort``: one operand with pos packed into the key when
    ``_pack_ok`` holds, otherwise (key, pos) by an unstable sort whose
    returned indices are the positions; ``row_sort.wide_calls`` counts
    such calls on the card.

    Tie order does not matter: detection only emits runs of exactly two,
    normalized by lo/hi position."""
    w2 = key.shape[1]
    with span("ogpc.sort"):
        if w2 <= MAX_N:
            return row_sort(key)
        if key.is_cuda:
            row_sort.wide_calls += 1
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
    with span("ogpc.detect"):
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
    with span("ogpc.emit"):
        out = torch.where(keep, (src_x << bd) | (d + disp_high),
                          torch.full_like(src_x, MASKED_SENTINEL))
        out = F.pad(out, (0, 1), value=MASKED_SENTINEL)
        counts = keep.sum(dim=1, dtype=torch.int32)
        return out, counts


def _key_from_codes(code_src, code_tar, valid_src, valid_tar):
    """The (H, 2W) sentinel-packed key image of two (H, W) code images:
    the code where valid, ``SENTINEL_BASE + pos`` elsewhere."""
    w2 = 2 * code_src.shape[1]
    pos = torch.arange(w2, dtype=torch.int32, device=code_src.device)
    return torch.where(torch.cat([valid_src, valid_tar], dim=1),
                       torch.cat([code_src, code_tar], dim=1),
                       SENTINEL_BASE + pos)


def match_epipolar_masked(code_src, code_tar, valid_src, valid_tar,
                          disp_high, key=None, num_tests=None):
    """Masked sorted-order epipolar matcher, from two (H, W) code images
    and their validity masks or from a prebuilt (R, 2W) int32 key image
    (``key=``, as ``ops.fused.fused_keys`` emits; the code arguments are
    then ignored).

    Returns (buf (R, 2W) int32, row_counts (R,) int32): window position i
    of row y holds ``(src_x << bd) | (d + disp_high)`` where a support was
    found (bd = bit_length(2*disp_high)) and MASKED_SENTINEL elsewhere.
    Decode with ``infer.masked_supports_to_numpy``.
    """
    if key is None:
        key = _key_from_codes(code_src, code_tar, valid_src, valid_tar)
    elif key.dtype != torch.int32 or key.dim() != 2:
        raise ValueError(f"expected an (R, 2W) int32 key image, got "
                         f"{key.dtype} {tuple(key.shape)}")
    w = key.shape[1] // 2
    key_s, pos_s = _sort_key_pos(key, num_tests)
    keep, src_x, d = _detect_pairs_packed(key_s, pos_s, w, disp_high)
    return _masked_emit(keep, src_x, d, w, disp_high)


def _bits(v: int) -> int:
    return max(1, int(v).bit_length())


def _two_key_sort(invalid, code):
    """Unstable sort along the last axis on (invalid, code) with signed
    int32 codes, through one order-preserving int64 key.  Returns
    (invalid_s, code_s, index): code_s is the code offset by 2**31, which
    orders and compares as the code."""
    comp = (invalid.to(torch.int64) << 32) + (code.to(torch.int64) + (1 << 31))
    comp_s, idx = torch.sort(comp, stable=False)
    return comp_s >> 32, comp_s & 0xFFFFFFFF, idx


def _pair_starts(invalid, code, flag):
    """Over sorted (..., N) keys, the (..., N-1) windows that start a run
    of exactly two equal valid codes with differing flags."""
    both_valid = (invalid[..., :-1] == 0) & (invalid[..., 1:] == 0)
    eq = (code[..., :-1] == code[..., 1:]) & both_valid
    prev = F.pad(eq[..., :-1], (1, 0))
    nxt = F.pad(eq[..., 1:], (0, 1))
    cross = flag[..., :-1] != flag[..., 1:]
    return eq & ~prev & ~nxt & cross


def compact(mask, values, capacity: int):
    """Gather ``values[mask]`` into fixed-size buffers in flat mask order:
    one sort by a position key (matched entries keep their flat index,
    the rest get INT32_MAX).  Returns (compacted values, count); slots from
    ``count`` on are 0 and entries beyond ``capacity`` are dropped, while
    ``count`` is the true number of matches."""
    mask_f = mask.reshape(-1)
    n = mask_f.shape[0]
    dev = mask.device
    count = mask_f.sum(dtype=torch.int32)
    key = torch.where(mask_f, torch.arange(n, dtype=torch.int32, device=dev),
                      _INT32_MAX)
    order = torch.sort(key, stable=False).indices
    k = min(n, capacity)
    slot_ok = torch.arange(capacity, device=dev) < count
    outs = []
    for v in values:
        buf = F.pad(v.reshape(-1)[order[:k]], (0, capacity - k))
        outs.append(torch.where(slot_ok, buf, 0))
    return tuple(outs), count


def compact_packed(mask, fields, capacity: int):
    """Single-operand sort compaction: every ``(array, n_bits)`` field is
    bit-packed into the int32 sort key (values offset to [0, 2**n_bits),
    at most 30 bits in all), so the output is ordered by the packed tuple:
    row-major (y, x, ...) for the matchers' (y, x, d) layout.  Returns
    (unpacked fields, count), with the same slot rules as :func:`compact`."""
    total = sum(b for _, b in fields)
    if total > 30:
        raise ValueError(f"packed compaction needs <= 30 bits, got {total}")
    dev = mask.device
    key = torch.zeros(mask.shape, dtype=torch.int32, device=dev)
    for arr, b in fields:
        key = (key << b) | torch.where(mask, arr.to(torch.int32), 0)
    key = torch.where(mask, key, _INT32_MAX).reshape(-1)
    n = key.shape[0]
    count = mask.sum(dtype=torch.int32)
    k = min(n, capacity)
    buf = F.pad(torch.sort(key, stable=False).values[:k], (0, capacity - k),
                value=_INT32_MAX)
    slot_ok = torch.arange(capacity, device=dev) < count
    outs = []
    shift = total
    for _, b in fields:
        shift -= b
        outs.append(torch.where(slot_ok, (buf >> shift) & ((1 << b) - 1), 0))
    return tuple(outs), count


def _compact_supports(keep, src_x, ycoord, d, capacity, w, h, disp_high):
    """(x, y, d) support compaction: the packed single-operand sort when
    y, x and d fit 30 bits, the position sort (flat window order)
    otherwise."""
    bx, by, bd = _bits(w - 1), _bits(h - 1), _bits(2 * disp_high)
    if by + bx + bd <= 30:
        (ys, xs, dp), count = compact_packed(
            keep, ((ycoord, by), (src_x, bx), (d + disp_high, bd)), capacity)
        slot_ok = torch.arange(capacity, device=keep.device) < count
        return (xs, ys, torch.where(slot_ok, dp - disp_high, 0)), count
    return compact(keep, (src_x, ycoord, d), capacity)


def _rows_of(keep):
    h = keep.shape[0]
    return torch.arange(h, dtype=torch.int32,
                        device=keep.device)[:, None].expand(keep.shape)


def match_epipolar(code_src, code_tar, valid_src, valid_tar, disp_high: int,
                   capacity: int, packed: bool = False,
                   sort_impl: str = "auto", num_tests=None):
    """Per-row unique-collision matching of two (H, W) code images into the
    flat contract: ((x, y, d), count), each of x, y, d a (capacity,) int32
    buffer, d = x_src - x_tar with |d| <= disp_high.

    ``packed=True`` (codes below 2**30, i.e. <= 30 tests; callers check)
    gives invalid pixels unique sentinel keys, so each row sorts one key
    with a position payload; otherwise rows sort on (invalid, code)."""
    if packed:
        return _match_epipolar_packed(code_src, code_tar, valid_src,
                                      valid_tar, disp_high, capacity,
                                      sort_impl, num_tests=num_tests)
    h, w = code_src.shape
    invalid_s, code_s, idx = _two_key_sort(
        torch.cat([~valid_src, ~valid_tar], dim=1),
        torch.cat([code_src, code_tar], dim=1))
    flag_s = idx >= w
    x_s = (idx - w * flag_s).to(torch.int32)
    is_match = _pair_starts(invalid_s, code_s, flag_s)
    # unstable sort: each pair's (src, tar) order comes from the flag
    src_left = ~flag_s[:, :-1]
    src_x = torch.where(src_left, x_s[:, :-1], x_s[:, 1:])
    tar_x = torch.where(src_left, x_s[:, 1:], x_s[:, :-1])
    d = src_x - tar_x
    keep = is_match & (d.abs() <= disp_high)
    return _compact_supports(keep, src_x, _rows_of(keep), d, capacity, w, h,
                             disp_high)


def _match_epipolar_packed(code_src, code_tar, valid_src, valid_tar,
                           disp_high: int, capacity: int,
                           sort_impl: str = "auto", key=None, num_tests=None):
    """The sentinel-packed flat epipolar matcher, from codes and
    candidates or from a prebuilt (H, 2W) key image (``key=``, as
    ``ops.fused.fused_keys`` emits).  ``sort_impl="auto"`` sorts rows with
    ``_sort_key_pos``; ``"bitonic"`` pads them to N2 = max(256, pow2 >= 2W)
    with unique keys ``PAD_KEY_BASE + pos`` and runs the bitonic row sort
    kernel (``ops.sort.bitonic_sort_rows``)."""
    if sort_impl not in ("auto", "bitonic"):
        raise ValueError(f"sort_impl must be 'auto' or 'bitonic', got "
                         f"{sort_impl!r}")
    if key is None:
        key = _key_from_codes(code_src, code_tar, valid_src, valid_tar)
    h, w2 = key.shape
    w = w2 // 2
    if sort_impl == "bitonic":
        from opengpc_tpu_torch.ops.sort import (bitonic_sort_rows,
                                                padded_row_length)

        n2 = padded_row_length(w)
        pos = torch.arange(n2, dtype=torch.int32, device=key.device)
        key = torch.cat([key, (PAD_KEY_BASE + pos[w2:]).expand(h, -1)], dim=1)
        key_s, pos_s = bitonic_sort_rows(key, pos.expand(h, -1).contiguous())
    else:
        key_s, pos_s = _sort_key_pos(key, num_tests)
    keep, src_x, d = _detect_pairs_packed(key_s, pos_s, w, disp_high)
    if capacity is None:  # the row form (match_epipolar_rows)
        return _row_pack(keep, src_x, d, w, disp_high)
    return _compact_supports(keep, src_x, _rows_of(keep), d, capacity, w, h,
                             disp_high)


def _row_pack(keep, src_x, d, w, disp_high):
    """Row-form output: per-row left-packed (xs, ds) (R, W) buffers and the
    row counts, by one single-operand row sort of ``(x << bd) | (d +
    disp_high)``.  A row holds at most W supports (each takes two sorted
    slots), so the (R, W) slice is lossless."""
    bd, bx = _bits(2 * disp_high), _bits(w - 1)
    if bx + bd > 30:
        raise ValueError(
            f"row-form pack key needs x+d bits <= 30, got {bx}+{bd}; use the "
            "flat matcher (match_epipolar) for this width/disp_high")
    key = torch.where(keep, (src_x << bd) | (d + disp_high), _INT32_MAX)
    key_s = torch.sort(key, dim=1, stable=False).values[:, :w]
    counts = keep.sum(dim=1, dtype=torch.int32)
    slot_ok = torch.arange(w, device=keep.device)[None, :] < counts[:, None]
    xs = torch.where(slot_ok, key_s >> bd, 0)
    ds = torch.where(slot_ok, (key_s & ((1 << bd) - 1)) - disp_high, 0)
    return (xs, ds), counts


def match_epipolar_rows(code_src, code_tar, valid_src, valid_tar, disp_high,
                        key=None, num_tests=None):
    """Row-form epipolar matcher: ((xs (H, W), ds (H, W)), row_counts (H,)).
    The unique-collision rule of ``match_epipolar(packed=True)`` with the
    supports left in per-row buffers: row y's supports are
    (xs[y, :c], y, ds[y, :c]) with c = row_counts[y], ordered by x."""
    return _match_epipolar_packed(code_src, code_tar, valid_src, valid_tar,
                                  disp_high, capacity=None, key=key,
                                  num_tests=num_tests)


# default (chunk, k) of the chunk-compacted masked contract: k/chunk = 1/2
# makes the guard an effective per-row capacity of W candidates
MASKED_COMPACT_CHUNKS = (128, 64)


def resolve_masked_compact_chunks(chunk=None, k=None):
    """The one rule for the masked-compact (chunk, k): both None ->
    MASKED_COMPACT_CHUNKS; one None -> derived with its k/chunk ratio;
    k > chunk is refused."""
    s0, k0 = MASKED_COMPACT_CHUNKS
    if chunk is None and k is None:
        chunk, k = s0, k0
    elif chunk is None:
        chunk = k * (s0 // k0)
    elif k is None:
        k = max(1, chunk * k0 // s0)
    if k > chunk:
        raise ValueError(
            f"masked-compact chunk capacity k={k} exceeds chunk size "
            f"S={chunk}; pass k <= chunk")
    return chunk, k


def _strided_chunks(t, h, chunk, nc):
    """(h * nc, chunk) strided chunks of an (h, chunk * nc) image: chunk c
    of a row holds its columns {j : j % nc == c}."""
    return t.reshape(h, chunk, nc).transpose(1, 2).reshape(h * nc, chunk)


def _sort_with(key, payload):
    """Unstable sort of each row of ``key`` with ``payload`` alongside."""
    key_s, idx = torch.sort(key, dim=-1, stable=False)
    return key_s, torch.gather(payload, -1, idx)


def match_epipolar_masked_compact(key, disp_high, chunk=None, k=None,
                                  num_tests=None, row_overflow=False):
    """Low-density masked contract: strided chunked pre-compaction shrinks
    the row sort.

    Each (2W) key row splits into nc = 2W/chunk strided chunks (chunk c
    holds the positions p with p % nc == c); each chunk is sorted (codes
    below SENTINEL_BASE sort first), its first ``k`` columns survive, and
    one (nc*k) row sort finishes the row.  When a chunk holds more than
    ``k`` candidates the ``overflow`` flag is set and the caller must re-run
    the full-width masked matcher (``match_epipolar_masked``).

    Returns (buf (H, nc*k) int32, row_counts (H,), overflow): ``buf``
    decodes like the full-width masked buffer.  ``overflow`` is a bool
    scalar, or per row ((H,) bool) with ``row_overflow=True``."""
    h, w2 = key.shape
    w = w2 // 2
    chunk, k = resolve_masked_compact_chunks(chunk, k)
    pos = torch.arange(w2, dtype=torch.int32, device=key.device).expand(h, -1)
    if w2 % chunk:
        # pad to a chunk multiple with unique non-pairing sentinels
        # (positions >= 2W never pass the cross check)
        pad_pos = torch.arange(w2, w2 + chunk - w2 % chunk, dtype=torch.int32,
                               device=key.device).expand(h, -1)
        key = torch.cat([key, SENTINEL_BASE + pad_pos], dim=1)
        pos = torch.cat([pos, pad_pos], dim=1)
    w2p = key.shape[1]
    nc = w2p // chunk

    def chunk_overflow(kc):
        over = (kc < SENTINEL_BASE).sum(dim=1) > k
        return over.reshape(h, nc).any(dim=1) if row_overflow else over.any()

    if _pack_ok(num_tests, w2p):
        # one operand: pos rides inside the key through both sorts
        pb = _pos_bits(w2p)
        kc = _strided_chunks(_pack_keypos(key, pos, pb), h, chunk, nc)
        overflow = chunk_overflow(kc)
        ks = torch.sort(kc, dim=1, stable=False).values[:, :k]
        packed_s = torch.sort(ks.reshape(h, nc * k), dim=1,
                              stable=False).values
        key_s, pos_s = _unpack_keypos(packed_s, pb)
    else:
        kc = _strided_chunks(key, h, chunk, nc)
        overflow = chunk_overflow(kc)
        ks, ps = _sort_with(kc, _strided_chunks(pos, h, chunk, nc))
        key_s, pos_s = _sort_with(ks[:, :k].reshape(h, nc * k),
                                  ps[:, :k].reshape(h, nc * k))
    keep, src_x, d = _detect_pairs_packed(key_s, pos_s, w, disp_high)
    out, counts = _masked_emit(keep, src_x, d, w, disp_high)
    return out, counts, overflow


def _global_pairs(code_src, code_tar, valid_src, valid_tar, packed=False):
    """The global matchers' flat sort over both images' descriptors:
    (is_match, src_x, src_y, tar_x, tar_y) windows over the sorted order.
    ``packed=True`` (codes below 2**30 and 2HW < 2**30) sorts one
    sentinel-masked key; otherwise the sort is on (invalid, code)."""
    h, w = code_src.shape
    n = h * w
    code = torch.cat([code_src.reshape(-1), code_tar.reshape(-1)])
    valid = torch.cat([valid_src.reshape(-1), valid_tar.reshape(-1)])
    if packed:
        pos = torch.arange(2 * n, dtype=torch.int32, device=code.device)
        key_s, idx = torch.sort(torch.where(valid, code, SENTINEL_BASE + pos),
                                stable=False)
        pos_s = idx.to(torch.int32)
        eq = key_s[:-1] == key_s[1:]
        prev = F.pad(eq[:-1], (1, 0))
        nxt = F.pad(eq[1:], (0, 1))
        # unstable sort: normalize the (src, tar) order by position
        lo = torch.minimum(pos_s[:-1], pos_s[1:])
        hi = torch.maximum(pos_s[:-1], pos_s[1:]) - n
        is_match = eq & ~prev & ~nxt & (lo < n) & (hi >= 0)
        return is_match, lo % w, lo // w, hi % w, hi // w
    invalid_s, code_s, idx = _two_key_sort(~valid, code)
    flag_s = idx >= n
    p = (idx - n * flag_s).to(torch.int32)
    x_s, y_s = p % w, p // w
    is_match = _pair_starts(invalid_s, code_s, flag_s)
    # unstable sort: each pair's (src, tar) order comes from the flag
    src_left = ~flag_s[:-1]
    return (is_match,
            torch.where(src_left, x_s[:-1], x_s[1:]),
            torch.where(src_left, y_s[:-1], y_s[1:]),
            torch.where(src_left, x_s[1:], x_s[:-1]),
            torch.where(src_left, y_s[1:], y_s[:-1]))


def match_correspondences(code_src, code_tar, valid_src, valid_tar,
                          capacity: int, packed: bool = False):
    """Unfiltered global unique-collision correspondences of two (H, W)
    code images, the reference's stereoMatch output before its rectified
    filter: ((sx, sy, tx, ty), count), each a (capacity,) int32 buffer in
    the flat order of the sorted windows, ``count`` the true number."""
    is_match, src_x, src_y, tar_x, tar_y = _global_pairs(
        code_src, code_tar, valid_src, valid_tar, packed)
    return compact(is_match, (src_x, src_y, tar_x, tar_y), capacity)


def match_global(code_src, code_tar, valid_src, valid_tar, disp_high: int,
                 vertical_tolerance: int, capacity: int, packed: bool = False):
    """Global (non-epipolar) unique-collision matching of two (H, W) code
    images into the flat contract, keeping pairs with |d| <= disp_high and
    |y_src - y_tar| <= vertical_tolerance."""
    is_match, src_x, src_y, tar_x, tar_y = _global_pairs(
        code_src, code_tar, valid_src, valid_tar, packed)
    d = src_x - tar_x
    keep = (is_match & (d.abs() <= disp_high)
            & ((src_y - tar_y).abs() <= vertical_tolerance))
    h, w = code_src.shape
    return _compact_supports(keep, src_x, src_y, d, capacity, w, h, disp_high)


def match_global_rows(key_img, w: int, disp_high: int,
                      vertical_tolerance: int, num_rows: int = 0,
                      y_offset: int = 0):
    """Global unique-collision matching with segmented row-form output.

    ``key_img`` is an (H, 2W) sentinel-packed key image.  One flat sort of
    all its keys finds the globally unique collisions; the kept supports
    are then sorted by their ``(y << bx) | x`` key within R = ``num_rows``
    (default H) segments of the sorted order.  A source pixel pairs at
    most once, so that key orders a segment as the JAX package's
    ``((y << bx | x) << bd) | (d + disp_high)`` pack does, and d follows
    by position: the same buffers wherever the pack fits 30 bits, and no
    bound on d past it (2160 x 3840 at dispHigh 128 takes 12 + 12 + 9
    bits).  Returns ((xs, ys, ds) (R, C) int32, counts (R,)): segment r
    holds (xs[r, :c], ys[r, :c], ds[r, :c]) with c = counts[r], in (y, x)
    order.  ``y_offset`` is the row of ``key_img``'s first row in the full
    image; y and x have to fit 30 bits."""
    h, w2 = _check_global_key(key_img, w)
    return _global_rows_core(key_img.reshape(-1), None, w, w2, h, disp_high,
                             vertical_tolerance, num_rows, y_offset)


def _check_global_key(key_img, w):
    h, w2 = key_img.shape
    if w2 != 2 * w:
        raise ValueError(f"key image width {w2} is not 2 * {w}")
    return h, w2


def _global_rows_core(key, pos, w, w2, h, disp_high, vertical_tolerance,
                      num_rows, y_offset):
    """The segmented global contract over flat ``key``s with their
    ``pos`` payload (None: the flat positions, the sort's own indices):
    one flat sort of (key, pos) finds the globally unique collisions, and
    a segmented row sort of the (y, x) key, below SENTINEL_BASE, with the
    other slots on their columns' sentinels (the row-sort kernel's layout,
    up to MAX_N slots a segment) packs the (R, C) output.  A ``pos``
    decodes as (row, col) of the original (h, w2) key image via
    divmod(w2); entries whose keys are unique (pads, sentinels) are never
    emitted, so their pos may be anything."""
    bx, by = _bits(w - 1), _bits(h - 1 + y_offset)
    if by + bx > 30:
        raise ValueError(f"global row-form key needs y+x bits <= 30, got "
                         f"{by}+{bx}; use match_global")
    n = key.shape[0]
    with span("ogpc.gsort"):
        if pos is None:
            key_s, idx = torch.sort(key, stable=False)
            pos_s = idx.to(torch.int32)
        else:
            key_s, pos_s = _sort_with(key, pos)
    with span("ogpc.gdetect"):
        eq = key_s[:-1] == key_s[1:]
        pair = eq & ~F.pad(eq[:-1], (1, 0)) & ~F.pad(eq[1:], (0, 1))
        col_l, row_l = pos_s[:-1] % w2, pos_s[:-1] // w2
        col_r, row_r = pos_s[1:] % w2, pos_s[1:] // w2
        # equal sentinels can only meet within one image, which the cross
        # check rejects like any same-image run
        l_is_src = col_l < w
        src_x = torch.where(l_is_src, col_l, col_r)
        src_y = torch.where(l_is_src, row_l, row_r)
        tar_c = torch.where(l_is_src, col_r, col_l)
        tar_y = torch.where(l_is_src, row_r, row_l)
        d = src_x - (tar_c - w)
        keep = (pair & (src_x < w) & (tar_c >= w) & (d.abs() <= disp_high)
                & ((src_y - tar_y).abs() <= vertical_tolerance))
        src_y = src_y + y_offset
    with span("ogpc.gpack"):
        r = num_rows if num_rows > 0 else h
        c = -(-n // r)
        padn = r * c - (n - 1)
        keep_p = F.pad(keep, (0, padn)).reshape(r, c)
        counts = keep_p.sum(dim=1, dtype=torch.int32)
        col = torch.arange(c, dtype=torch.int32, device=key.device)
        slot_ok = col[None, :] < counts[:, None]
        # a source pixel pairs at most once, so (y, x) alone orders a
        # segment; the other slots take their column's sentinel, the row
        # sort's own layout, and d follows by column
        yx = F.pad((src_y << bx) | src_x, (0, padn)).reshape(r, c)
        yx = torch.where(keep_p, yx, SENTINEL_BASE + col)
        if c <= MAX_N:
            yx_s, cols = row_sort(yx)
            cols = cols.long()
        else:
            yx_s, cols = torch.sort(yx, dim=1, stable=False)
        d_s = torch.gather(F.pad(d, (0, padn)).reshape(r, c), 1, cols)
        ds = torch.where(slot_ok, d_s, 0)
        xs = torch.where(slot_ok, yx_s & ((1 << bx) - 1), 0)
        ys = torch.where(slot_ok, yx_s >> bx, 0)
        return (xs, ys, ds), counts


def global_compact_chunks(w2: int):
    """Default (chunk, k) of the chunk-compacted global contract: k/chunk =
    1/4 on wide rows (2W >= 2048), and the masked-compact 1/2 on narrower
    ones, where the strided chunk count is small and 1/4 would overflow on
    ordinary textured rows."""
    return (512, 128) if w2 >= 2048 else (128, 64)


def resolve_global_compact_chunks(w2: int, chunk=None, k=None):
    """The global-compact (chunk, k) from the width rule
    (:func:`global_compact_chunks`), a missing one derived with the rule's
    k/chunk ratio; k > chunk is refused."""
    dchunk, dk = global_compact_chunks(w2)
    if chunk is None and k is None:
        chunk, k = dchunk, dk
    elif chunk is None:
        chunk = k * (dchunk // dk)
    elif k is None:
        k = max(1, chunk // (dchunk // dk))
    if k > chunk:
        raise ValueError(
            f"global-compact chunk capacity k={k} exceeds chunk size "
            f"S={chunk}; pass k <= chunk (width defaults: "
            "match.global_compact_chunks)")
    return chunk, k


def match_global_rows_compact(key_img, w: int, disp_high: int,
                              vertical_tolerance: int, chunk=None, k=None,
                              num_rows: int = 0, y_offset: int = 0):
    """Low-density global contract: strided chunked pre-compaction
    (:func:`_strided_chunk_compact`) shrinks the flat uniqueness sort from
    2HW to 2HW * k/chunk keys.  Every candidate survives unless a chunk
    overflows, so the multiset of codes, the global uniqueness domain, is
    unchanged; the dropped entries are sentinels, which never pair across
    the images.  When ``overflow`` is set the caller must re-run
    :func:`match_global_rows`.  Returns ((xs, ys, ds) (R, C'), counts,
    overflow), decoded like the full contract."""
    h, w2 = _check_global_key(key_img, w)
    chunk, k = resolve_global_compact_chunks(w2, chunk, k)
    pos = torch.arange(h * w2, dtype=torch.int32,
                       device=key_img.device).reshape(h, w2)
    ks, ps, overflow = _strided_chunk_compact(key_img, pos, chunk, k,
                                              pos_never=h * w2)
    out = _global_rows_core(ks, ps, w, w2, h, disp_high, vertical_tolerance,
                            num_rows, y_offset)
    return out + (overflow,)


def _strided_chunk_compact(key_img, pos_img, chunk: int, k: int,
                           pos_never: int):
    """Strided chunked pre-compaction of the global contracts: each key row
    splits into nc strided chunks, each chunk sorts (codes below
    SENTINEL_BASE first) and its first ``k`` columns survive.  ``pos_img``
    is the caller's position payload (global flat positions on a shard);
    ``pos_never`` is the payload of the chunk-multiple column pads, which
    are never emitted.  Returns (keys (h*nc*k,), pos (h*nc*k,), overflow),
    ``overflow`` set iff some chunk held more than ``k`` candidates."""
    h, w2 = key_img.shape
    dev = key_img.device
    if w2 % chunk:
        # pad with keys unique within the image and above every real
        # sentinel (SENTINEL_BASE + [0, 2W)), so pads never form a run
        padn = chunk - w2 % chunk
        pad_k = (SENTINEL_BASE + w2
                 + torch.arange(h, dtype=torch.int32, device=dev)[:, None] * padn
                 + torch.arange(padn, dtype=torch.int32, device=dev)[None, :])
        key_img = torch.cat([key_img, pad_k], dim=1)
        pos_img = torch.cat([pos_img, torch.full(
            (h, padn), pos_never, dtype=torch.int32, device=dev)], dim=1)
    nc = key_img.shape[1] // chunk
    kc = _strided_chunks(key_img, h, chunk, nc)
    overflow = ((kc < SENTINEL_BASE).sum(dim=1) > k).any()
    ks, ps = _sort_with(kc, _strided_chunks(pos_img, h, chunk, nc))
    return ks[:, :k].reshape(-1), ps[:, :k].reshape(-1), overflow


def match_reference_quirk(
    desc_src, desc_tar, epipolar: bool = False
):
    """Host-side, bug-compatible reimplementation of the reference's exact
    sweep (findCorrespondences, inference.hpp:227-254), including its edge
    quirks: a match landing on the last target element is never emitted,
    and a duplicate pair occupying the last two target slots skips its
    uniqueness check.

    For users who need byte-identical behavior to the reference binary;
    the on-device matchers implement the clean unique-collision rule.

    ``desc_*``: (n, 3) int arrays of (x, y, state) rows (e.g. from
    infer.extract_descriptors).  Returns (m, 4) int array of
    (sx, sy, tx, ty).
    """
    def keyed(d):
        d = np.asarray(d, np.int64)
        state = d[:, 2].astype(np.uint64)
        if epipolar:
            state = state | (d[:, 1].astype(np.uint64) << np.uint64(32))
        order = np.argsort(state, kind="stable")
        return state[order], d[order, 0], d[order, 1]

    s_state, s_x, s_y = keyed(desc_src)
    t_state, t_x, t_y = keyed(desc_tar)
    out = []
    n = len(t_state)
    if n == 0:
        return np.zeros((0, 4), np.int32)
    j = 0
    i = 0
    while i < len(s_state):
        unique = True
        while i + 1 < len(s_state) and s_state[i] == s_state[i + 1]:
            i += 1
            unique = False
        if unique:
            while j < n - 1 and t_state[j] < s_state[i]:
                j += 1
            if (
                j != n - 1
                and t_state[j] == s_state[i]
                and (j + 1 == n - 1 or t_state[j] != t_state[j + 1])
            ):
                out.append((s_x[i], s_y[i], t_x[j], t_y[j]))
        i += 1
    return np.asarray(out, np.int32).reshape(-1, 4)


def match_hashmatch(
    desc_src, desc_tar, epipolar: bool = False,
    index_size: int = 214673, bucket_cap: int = 10,
):
    """Host-side, bug-compatible emulation of the reference's hash-table
    matcher (``useHashtable=true``; hashmatch.hpp:42-273, instantiated with
    214,673 buckets at inference.hpp:210-211) — the one matching behavior
    class the on-device sort matcher deliberately does NOT implement.

    Semantics: descriptors are inserted src-list first then tar-list into
    ``state % index_size`` buckets; each bucket is kept sorted by state
    (stable after equals) and CAPPED at ``bucket_cap`` elements — later
    arrivals are silently dropped (hashmatch.hpp:93-98).  A per-bucket
    adjacent sweep then emits states present exactly twice and from
    different images (hashmatch.hpp:162-197), with two pinned edge
    behaviors: an early bucket return when an equal third element is the
    bucket's last, and a skip-ahead after a same-image pair followed by a
    cross-image element.

    This diverges from the clean unique-collision rule: the bucket cap can
    both create matches (dropping the duplicates that would make a state
    non-unique — e.g. a state occurring 9x in src and 30x in tar keeps
    9 src + 1 tar and emits a bogus pair) and destroy them (dropping one
    element of a genuine pair in an overflowing bucket).  Differentially
    tested against the oracle's ``hashmatch`` command and, transitively,
    the real reference binary (tests/test_reference_binary.py).

    ``desc_*``: (n, 3) int arrays of (x, y, state) rows in candidate scan
    order (e.g. from infer.extract_descriptors).  Returns (m, 4) int array
    of (sx, sy, tx, ty) unfiltered pairs, like match_reference_quirk.
    """
    def states(d):
        d = np.asarray(d, np.int64)
        s = d[:, 2].astype(np.uint64)
        if epipolar:
            s = s | (d[:, 1].astype(np.uint64) << np.uint64(32))
        return s, d[:, 0], d[:, 1]

    buckets = {}

    def insert(state, x, y, is_src):
        b = buckets.setdefault(int(state % np.uint64(index_size)), [])
        if len(b) >= bucket_cap:
            return
        pos = 0
        while pos < len(b) and b[pos][0] <= state:
            pos += 1
        b.insert(pos, (int(state), int(x), int(y), is_src))

    for sd, is_src in ((desc_src, True), (desc_tar, False)):
        s, x, y = states(sd)
        for k in range(len(s)):
            insert(s[k], x[k], y[k], is_src)

    out = []
    for key in sorted(buckets):
        b = buckets[key]
        n = len(b)
        idx = 0
        while idx < n:
            prev = idx
            idx += 1
            if idx < n and b[prev][0] == b[idx][0]:
                if b[prev][3] != b[idx][3]:
                    if idx + 1 < n:
                        if b[idx + 1][0] != b[idx][0]:
                            out.append((b[prev][1], b[prev][2],
                                        b[idx][1], b[idx][2]))
                        if idx + 2 >= n:
                            break  # "checked the last triplet, leave"
                    else:
                        out.append((b[prev][1], b[prev][2],
                                    b[idx][1], b[idx][2]))
                elif idx + 1 < n and b[idx][3] != b[idx + 1][3]:
                    idx += 1  # skip the false same-image pair
    return np.asarray(out, np.int32).reshape(-1, 4)
