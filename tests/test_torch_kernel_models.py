"""numpy models of pieces of the CUDA kernels' arithmetic that the CPU
cannot run: ``StripTile``'s tests on two 16-bit lanes a word with their
MSB-first code assembly (``csrc/tile_codes.cuh``, which the key, code and
fused match kernels share), the source-window staging that gives the key
kernel its slab mode (``stage_raw``), the census kernel's two-lane
compares and byte assembly (``csrc/fused_census.cu``), and the fused
match kernel's neighbour exchange in detection (``csrc/fused_match.cu``).
Each model is held bit for bit against the plain PyTorch code the kernels
are compared with on the card, the census also against the JAX package's
Pallas kernel in interpret mode."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from opengpc_tpu.ops import fused as jfused

from opengpc_tpu_torch.forest import filter_mask_from_numpy
from opengpc_tpu_torch.match import SENTINEL_BASE, _detect_pairs_packed
from opengpc_tpu_torch.ops.census import census5x5
from opengpc_tpu_torch.ops import codes as tcodes
from opengpc_tpu_torch.ops import fused as tfused
from opengpc_tpu_torch.ops import preprocess as tpre

HALO = 13


def structured_image(rng, h, w):
    small = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2))
    img = np.kron(small, np.ones((4, 4)))[:h, :w]
    return np.clip(img + rng.integers(-12, 13, (h, w)), 0, 255).astype(np.uint8)


def brev32(x):
    """Bit reversal of each uint32 in ``x`` (CUDA's ``__brev``)."""
    x = x.astype(np.uint64)
    out = np.zeros_like(x)
    for i in range(32):
        out |= ((x >> np.uint64(i)) & np.uint64(1)) << np.uint64(31 - i)
    return out


def strip_tile_codes(smooth, i_off, j_off, tau):
    """The codes of every pixel as ``StripTile::codes`` makes them: pixels
    x and x + 1 (x even) share a word of two 16-bit lanes; a test adds
    ``0x8000 + clamp(tau, -255, 256) - 1`` to each lane of A and takes B
    away, and bit 15 of a lane is the test's bit; 16 tests shift into
    each of two accumulators, which reverse into the MSB-first code."""
    h, w = smooth.shape
    wp = w + (w & 1)  # whole words
    padded = np.zeros((h + 2 * HALO, wp + 2 * HALO), np.int64)
    padded[HALO:HALO + h, HALO:HALO + w] = smooth

    def words(dy, dx):
        win = padded[HALO + dy:HALO + dy + h, HALO + dx:HALO + dx + wp]
        return win[:, 0::2] | (win[:, 1::2] << 16)

    n = len(tau)
    acc = [np.zeros((h, wp // 2), np.int64) for _ in range(2)]
    for t in range(n):
        lane = 0x8000 + int(np.clip(tau[t], -255, 256)) - 1
        c = lane | (lane << 16)
        r = (words(*i_off[t]) + c - words(*j_off[t])) & 0xFFFFFFFF
        acc[t // 16] = (acc[t // 16] >> 1) | (r & 0x80008000)
    n2 = max(n - 16, 0)
    code = np.zeros((h, wp), np.uint64)
    for p in range(2):
        la = (acc[0] >> (16 * p)) & 0xFFFF
        lb = (acc[1] >> (16 * p)) & 0xFFFF
        code[:, p::2] = ((brev32(la) >> np.uint64(16 - n2))
                         | (brev32(lb) >> np.uint64(16)))
    return code[:, :w].astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("n_tests", [1, 15, 16, 17, 31, 32])
def test_strip_tile_two_lane_codes_equal_plain(n_tests):
    """The two-lane test and code assembly equal the code twin's codes and
    ``ops.codes.leaf_codes`` on the box-blurred image, for tau in
    [-400, 400] (past the +-255 two uint8 values can differ by) and test
    counts on both sides of each 16-test accumulator, 32 included (the
    code then fills the sign bit, as JAX's int32 wraps)."""
    rng = np.random.default_rng(100 + n_tests)
    img = structured_image(rng, 45, 71)
    i_off = rng.integers(-13, 14, (n_tests, 2))
    j_off = rng.integers(-13, 14, (n_tests, 2))
    tau = rng.integers(-400, 401, n_tests)
    tau[1:3] = (-400, 400)[:max(n_tests - 1, 0)]  # the clamp's both ends
    mask = filter_mask_from_numpy(i_off, j_off, tau, 1)
    t_img = torch.from_numpy(img)
    smooth = tpre.box3(t_img)
    model = strip_tile_codes(smooth.numpy().astype(np.int64), i_off, j_off,
                             tau)
    plain, _ = tfused.fused_codes_plain(t_img, mask, 5)
    np.testing.assert_array_equal(model, plain.numpy())
    np.testing.assert_array_equal(model,
                                  tcodes.leaf_codes(smooth, mask).numpy())
    assert len(np.unique(model)) > 1
    if n_tests == 32:
        assert (model < 0).any()


def stage_raw(src, src_row0, src_rows, w, gy0, gx0, rows, cols):
    """``stage_raw`` of ``csrc/tile_codes.cuh``: the rows x cols uint8
    window whose first pixel is image (gy0, gx0), read from ``src``, which
    holds image rows [src_row0, src_row0 + src_rows) of w bytes each;
    zeros outside those rows and the w columns."""
    sy = gy0 + np.arange(rows)[:, None] - src_row0
    gx = gx0 + np.arange(cols)[None, :]
    ok = (sy >= 0) & (sy < src_rows) & (gx >= 0) & (gx < w)
    flat = np.ascontiguousarray(src).reshape(-1)
    idx = np.clip(sy, 0, src_rows - 1) * w + np.clip(gx, 0, w - 1)
    return np.where(ok, flat[idx], 0).astype(np.uint8)


PAD = tfused.PAD
TILE_H = 32  # csrc/fused_keys.cu's kTileH


def keys_by_tiles(src, y0, rows, halo, h_total, mask, thr, pos_base):
    """The key kernel's output rows [y0, y0 + rows) of an h_total-row
    frame, tile row by tile row as its blocks make them: each 32-row tile
    stages its (60, W + 32) raw window (column 0 at x = -16) from the
    source window, image rows [y0 - halo, y0 + rows + halo), and takes the
    box border and candidate margin against h_total.  A tile spans the
    whole width here, so the columns' borders are the image's."""
    w = src.shape[1]
    cols = -(-(w + 32) // 16) * 16
    out = []
    for r0 in range(0, rows, TILE_H):
        raw = stage_raw(src, y0 - halo, rows + 2 * halo, w, y0 + r0 - PAD,
                        -16, TILE_H + 2 * PAD, cols)
        x32 = torch.from_numpy(raw[:, 16 - PAD:16 + w + PAD].astype(np.int32))
        code, cand = tfused._codes_body(x32, y0 + r0, h_total, mask, thr)
        keys = tfused._keys(code, cand, pos_base, SENTINEL_BASE)
        out.append(keys[:min(TILE_H, rows - r0)])
    return torch.cat(out)


@pytest.mark.parametrize("shard", ["top", "middle", "bottom"])
@pytest.mark.parametrize("forest", ["zero", "t32"])
def test_slab_source_window_gives_whole_frame_keys(shard, forest):
    """Staged from a slab's source window (src_row0 = y0 - 14, src_rows =
    sh + 28), with the box border and the margin in frame rows, a shard's
    keys are the whole frame's rows [y0, y0 + sh), at a shard height that
    is not a multiple of the 32-row tile (the last tile reads zero rows
    past the slab, for rows it does not write); the whole image staged
    through the same window (src_row0 = 0, src_rows = h) gives the whole
    frame's keys."""
    from test_torch_flat import masks

    _, mask = masks(forest)
    sh, n, w = 45, 3, 70
    h = sh * n
    img = structured_image(np.random.default_rng(7), h, w)
    y0 = {"top": 0, "middle": sh, "bottom": 2 * sh}[shard]
    whole = tfused.fused_keys_plain(torch.from_numpy(img), mask, 5, w,
                                    SENTINEL_BASE)
    slab = np.pad(img, ((PAD, PAD), (0, 0)))[y0:y0 + sh + 2 * PAD]
    got = keys_by_tiles(slab, y0, sh, PAD, h, mask, 5, w)
    assert torch.equal(got, whole[y0:y0 + sh])
    assert torch.equal(got, tfused.fused_keys_slab_plain(
        torch.from_numpy(slab), mask, 5, w, SENTINEL_BASE, y0, h))
    assert (got < SENTINEL_BASE).any()
    if shard == "top":
        assert torch.equal(keys_by_tiles(img, 0, h, 0, h, mask, 5, w), whole)


def byte_perm(x, y, s):
    """CUDA's ``__byte_perm(x, y, s)`` for selector nibbles 0-7: byte n of
    the result is byte (s >> 4n) & 7 of the 8 bytes of (y:x)."""
    src = [(x >> (8 * k)) & 0xFF for k in range(4)] + \
          [(y >> (8 * k)) & 0xFF for k in range(4)]
    return sum(src[(s >> (4 * n)) & 7] << (8 * n) for n in range(4))


def census_two_lane(img):
    """The census codes as ``csrc/fused_census.cu`` makes them: a strip of
    4 pixels at x reads raw bytes x-4 .. x+7 of each row (zeros outside the
    image) as three words, widens them into even words e[j] of columns
    (x-2+2j, x-1+2j) by byte permutes and odd words o[j] of (x-1+2j, x+2j)
    by funnel shifts; neighbour i of the pixel pair q is one word, and the
    compare ``A + (2^k - 1 in both lanes) - B`` puts nb > centre in bit k
    = 8 + i % 8 of each lane, merged into accumulator i / 8; two byte
    permutes gather a pixel's three high bytes into its code.  Asserts the
    lane ranges that make the compare exact and the zero bytes the
    assembly relies on."""
    h, w = img.shape
    ns = -(-w // 4)
    raw = np.zeros((h + 4, 4 * ns + 8), np.int64)
    raw[2:2 + h, 4:4 + w] = img
    words = (raw[:, 0::4] | raw[:, 1::4] << 8 | raw[:, 2::4] << 16
             | raw[:, 3::4] << 24)  # word j: image columns 4j-4 .. 4j-1
    r0, r1, r2 = words[:, :ns], words[:, 1:ns + 1], words[:, 2:ns + 2]
    e = [byte_perm(r0, 0, 0x4342), byte_perm(r1, 0, 0x4140),
         byte_perm(r1, 0, 0x4342), byte_perm(r2, 0, 0x4140)]
    o = [((e[j] >> 16) | (e[j + 1] << 16)) & 0xFFFFFFFF for j in range(3)]

    def word(dy, dx, q):  # raw row y + 2 + dy for image row y
        lanes = o[q + (dx + 1) // 2] if dx % 2 else e[q + (dx + 2) // 2]
        return lanes[2 + dy:2 + dy + h]

    acc = np.zeros((3, 2, h, ns), np.int64)
    for q in range(2):
        centre = word(0, 0, q)
        i = 0
        for px in range(-2, 3):
            for py in range(-2, 3):
                if px == 0 and py == 0:
                    continue
                k = 8 + i % 8
                bit = 0x10001 << k
                r = (word(py, px, q) + (bit - 0x10001) - centre) & 0xFFFFFFFF
                for lane in (r & 0xFFFF, r >> 16):
                    assert (1 << k) - 256 <= lane.min()
                    assert lane.max() <= (1 << k) + 254
                acc[i // 8, q] |= r & bit
                i += 1
    assert not (acc & 0x00FF00FF).any()
    code = np.zeros((h, 4 * ns), np.int64)
    for q in range(2):
        a0, a1, a2 = acc[:, q]
        code[:, 2 * q::4] = byte_perm(byte_perm(a0, a1, 0x0051), a2, 0x2510)
        code[:, 2 * q + 1::4] = byte_perm(byte_perm(a0, a1, 0x0073), a2,
                                          0x2710)
    ys, xs = np.mgrid[:h, :w]
    valid = (ys >= 2) & (ys <= h - 4) & (xs >= 2) & (xs <= w - 3)
    return np.where(valid, code[:, :w], 0).astype(np.int32)


@pytest.mark.parametrize("kind, shape", [
    ("random", (37, 130)), ("random", (61, 97)), ("random", (5, 6)),
    ("random", (12, 13)), ("extremes", (40, 71)), ("constant", (33, 50)),
    ("constant_max", (20, 34)), ("structured", (48, 64))])
def test_census_two_lane_form_equals_plain_and_pallas(kind, shape):
    """The census kernel's two-lane compares and byte assembly equal
    ``census5x5`` (its plain twin) and the JAX package's ``fused_census``
    (Pallas, interpret mode) on uniform random images, images of only 0
    and 255 (the lanes' extreme values), constant images (no neighbour
    brighter: all codes 0) and a structured image, at W % 4 = 0-3, W <
    16 and h <= 5."""
    h, w = shape
    rng = np.random.default_rng(h * 1000 + w)
    img = {"random": lambda: rng.integers(0, 256, shape),
           "extremes": lambda: rng.choice([0, 255], shape),
           "constant": lambda: np.full(shape, 137),
           "constant_max": lambda: np.full(shape, 255),
           "structured": lambda: structured_image(rng, h, w)}[kind]()
    img = img.astype(np.uint8)
    model = census_two_lane(img)
    np.testing.assert_array_equal(model, census5x5(torch.from_numpy(img)))
    np.testing.assert_array_equal(
        model, np.asarray(jfused.fused_census(img, interpret=True)))
    assert model.any() == (kind not in ("constant", "constant_max")
                           and h > 5)


LANES = 16  # csrc/fused_match.cu's kLanes


def detection_model(key_s, pos_s, w, disp_high, threads):
    """numpy model of the fused match kernel's detection on sorted rows:
    blocks of ``threads`` threads hold 16 ``threads`` lanes (whole rows,
    one after another), register r of thread t holding block lane 16 t +
    r.  A thread takes key i0-1 from the thread before and keys i0+16,
    i0+17 and position i0+16 from the thread after by warp shuffles
    (``__shfl_up_sync`` / ``__shfl_down_sync`` by 1, which return the
    thread's own value past the warp's edge), and across a warp boundary
    from the neighbouring warp's words in shared memory.  A row's first
    lane has no left neighbour, its last two no right pair."""
    rows, n = key_s.shape
    per_block = LANES * threads // n
    blocks = -(-rows // per_block)
    pad = blocks * per_block - rows
    k = np.concatenate([key_s, np.zeros((pad, n), np.int32)])
    v = np.concatenate([pos_s, np.zeros((pad, n), np.int32)])
    k = k.reshape(blocks, threads, LANES)
    v = v.reshape(blocks, threads, LANES)
    t = np.arange(threads)
    lane, warp = t % 32, t // 32
    warps = threads // 32

    def shfl(x, delta):
        src = t + delta
        ok = (lane + delta >= 0) & (lane + delta < 32)
        return np.where(ok[None, :], x[:, np.where(ok, src, t)], x)

    kprev = shfl(k[:, :, -1], -1)
    knext0 = shfl(k[:, :, 0], 1)
    knext1 = shfl(k[:, :, 1], 1)
    vnext0 = shfl(v[:, :, 0], 1)
    edge = [k[:, 0::32, 0], k[:, 0::32, 1], v[:, 0::32, 0], k[:, 31::32, -1]]
    from_next = (lane == 31) & (warp + 1 < warps)
    nxt = np.minimum(warp + 1, warps - 1)
    knext0 = np.where(from_next, edge[0][:, nxt], knext0)
    knext1 = np.where(from_next, edge[1][:, nxt], knext1)
    vnext0 = np.where(from_next, edge[2][:, nxt], vnext0)
    from_prev = (lane == 0) & (warp > 0)
    kprev = np.where(from_prev, edge[3][:, np.maximum(warp - 1, 0)], kprev)

    i0 = (t * LANES) % n
    first, last = i0 == 0, i0 + LANES == n
    eq = np.empty(k.shape[:2] + (LANES + 2,), bool)
    eq[..., 0] = ~first & (kprev == k[..., 0])
    eq[..., 1:LANES] = k[..., :-1] == k[..., 1:]
    eq[..., LANES] = ~last & (k[..., -1] == knext0)
    eq[..., LANES + 1] = ~last & (knext0 == knext1)
    a = v
    b = np.concatenate([v[..., 1:], vnext0[..., None]], axis=-1)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    d = lo - (hi - w)
    keep = (eq[..., 1:LANES + 1] & ~eq[..., :LANES] & ~eq[..., 2:]
            & (lo < w) & (hi >= w) & (hi < 2 * w) & (np.abs(d) <= disp_high))
    out = [x.reshape(-1, n)[:rows] for x in (keep, np.where(keep, lo, 0),
                                               np.where(keep, d, 0))]
    return tuple(out)


def sorted_rows_with_runs(rng, rows, n):
    """Ascending int32 keys with runs of 1 to 4 equal keys, a run of 2, 3
    or 4 straddling each 16-lane boundary in turn (so also every 512-lane
    one), and a random permutation of the lanes as positions."""
    new_run = rng.random((rows, n)) < 0.5
    for r in range(rows):
        for b in range(LANES, n, LANES):
            length = 2 + (b // LANES + r) % 3      # 2, 3, 4
            start = b - 1 - (b // LANES + r) % (length - 1)
            new_run[r, start + 1:start + length] = False
            new_run[r, start] = True
            if start + length < n:
                new_run[r, start + length] = True
        run = 0
        for i in range(n):  # no run longer than 4
            run = 1 if new_run[r, i] else run + 1
            if run > 4:
                new_run[r, i], run = True, 1
    key = (np.cumsum(new_run, axis=1) * 7 - 3).astype(np.int32)
    pos = np.stack([rng.permutation(n) for _ in range(rows)]).astype(np.int32)
    return key, pos


@pytest.mark.parametrize("n, threads, rows", [(256, 256, 19), (2048, 256, 5),
                                              (4096, 512, 3)])
def test_detection_neighbour_exchange_equals_split_detection(n, threads, rows):
    """The kernel's detection, in its layout and with its exchange, equals
    ``match._detect_pairs_packed`` (the twin's detection) on sorted rows
    whose runs of 1-4 equal keys straddle 16- and 512-lane boundaries, at
    the thread counts the kernel uses for each row length, on row counts
    that leave the last block part empty."""
    rng = np.random.default_rng(n + rows)
    key, pos = sorted_rows_with_runs(rng, rows, n)
    starts = np.flatnonzero(np.diff(key[0]) != 0) + 1
    run_len = np.diff(np.concatenate([[0], starts, [n]]))
    assert set(run_len) == {1, 2, 3, 4}
    w = n // 2
    keep_t, src_t, d_t = _detect_pairs_packed(
        torch.from_numpy(key), torch.from_numpy(pos), w, n)
    want = [F.pad(keep_t, (0, 1)).numpy(),
            F.pad(torch.where(keep_t, src_t, 0), (0, 1)).numpy(),
            F.pad(torch.where(keep_t, d_t, 0), (0, 1)).numpy()]
    got = detection_model(key, pos, w, n, threads)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)
    assert want[0].sum() > rows
    # kept pairs across thread boundaries, and runs across warp boundaries
    kept = np.flatnonzero(want[0].any(axis=0))
    assert (kept % LANES == LANES - 1).any()
    if n >= 1024:
        assert (key[:, 511] == key[:, 512]).any()
