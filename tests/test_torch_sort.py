"""The row sorts on the CPU.  The bitonic row sort's plain twin against the
JAX package's Pallas kernel (interpret mode): keys AND payloads
bit-identical, since the network is fixed.  The matcher's row sort
(``ops.sort.row_sort``): its twin and a numpy model of its kernel's
stages against the stable (key, column) sort, the routing of
``match._sort_key_pos`` by row width, and every route through it against
the ``torch.sort`` branches it replaced."""

import os

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from opengpc_tpu.ops import sort as jsort

import opengpc_tpu_torch.match as tmatch
from opengpc_tpu_torch.ops import sort as tsort

from test_torch_match import random_key_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rows(shape, dup_every, seed):
    """Signed int32 keys drawn from a pool of N / dup_every values (many
    duplicates) and a distinct payload per element."""
    r, n = shape
    rng = np.random.default_rng(seed)
    pool = rng.integers(-(1 << 31), 1 << 31, n // dup_every,
                        dtype=np.int64).astype(np.int32)
    key = pool[rng.integers(0, len(pool), (r, n))]
    pay = rng.permutation(r * n).reshape(r, n).astype(np.int32)
    return key, pay


@pytest.mark.parametrize("shape", [(5, 256), (17, 1024)])
@pytest.mark.parametrize("dup_every", [2, 7])
def test_bitonic_plain_equals_pallas_bit_for_bit(shape, dup_every):
    key, pay = rows(shape, dup_every, sum(shape) + dup_every)
    jk, jp = jsort.bitonic_sort_rows(key, pay, interpret=True)
    before = tsort.bitonic_sort_rows.launches
    tk, tp = tsort.bitonic_sort_rows(torch.from_numpy(key),
                                     torch.from_numpy(pay))
    assert tsort.bitonic_sort_rows.launches == before == 0
    assert tk.dtype == tp.dtype == torch.int32
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tk.numpy(), np.sort(key, axis=1))


def test_bitonic_keeps_equal_keys_in_network_order():
    """All-equal keys never swap: the payload comes back unchanged."""
    key = torch.zeros((3, 512), dtype=torch.int32)
    pay = torch.arange(3 * 512, dtype=torch.int32).reshape(3, 512)
    tk, tp = tsort.bitonic_sort_rows(key, pay)
    assert torch.equal(tp, pay) and torch.equal(tk, key)


@pytest.mark.parametrize("n, match", [(300, "power of two"),
                                      (128, "power of two"),
                                      (32768, "16384")])
def test_bitonic_rejects_bad_rows(n, match):
    key = torch.zeros((2, n), dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        tsort.bitonic_sort_rows(key, key)
    if n == 300:
        with pytest.raises(ValueError):
            jsort.bitonic_sort_rows(key.numpy(), key.numpy(), interpret=True)


def test_bitonic_rejects_bad_types_and_devices():
    key = torch.zeros((2, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        tsort.bitonic_sort_rows(key.long(), key)
    with pytest.raises(ValueError, match="payload"):
        tsort.bitonic_sort_rows(key, key[:1])
    with pytest.raises(ValueError, match="no kernel"):
        tsort.bitonic_sort_rows(key.to("meta"), key.to("meta"))


@pytest.mark.parametrize("w", [1, 100, 128, 129, 1024, 1920])
def test_padded_row_length_matches_jax(w):
    n2 = tsort.padded_row_length(w)
    assert n2 == max(256, 1 << (2 * w - 1).bit_length())
    assert n2 >= 2 * w and n2 & (n2 - 1) == 0


LANES = 16  # csrc/bitonic_sort.cu's kLanes


def swizzle(u):
    """The kernel's shared-memory word of block lane u."""
    return u ^ (((u >> 5) & 7) << 2)


def register_network_model(key, pay):
    """numpy model of the row-sort kernel's layouts.  A block of
    max(128, N / 16) threads holds max(2048, N) lanes.  Layout A: register
    r of thread t holds lane 16 t + r; layout B: register r of lane l of
    warp w holds lane 512 w + 32 r + l.  Each size runs ascending on keys
    XORed with -1 in the lanes whose pairs descend: distances >= 512 in
    shared memory (at ``swizzle``), 32 .. 256 in layout B's registers, 16
    across lanes (l ^ 16 in B, l ^ 1 in A, each thread deciding alone:
    the lower lane keeps the smaller key), < 16 in layout A's
    registers."""
    e = LANES
    rows, n = key.shape
    threads = max(128, n // e)
    elems = e * threads
    total = rows * n
    blocks = -(-total // elems)
    t = np.arange(threads)
    l, seg = t % 32, t // 32 * 32 * e
    a_lane = t[:, None] * e + np.arange(e)[None, :]          # layout A
    b_lane = seg[:, None] + 32 * np.arange(e)[None, :] + l[:, None]  # B
    assert sorted(swizzle(np.arange(elems))) == list(range(elems))

    def lay(a):
        flat = np.zeros(blocks * elems, np.int32)
        flat[:total] = a.ravel()
        return flat.reshape(blocks, elems)[:, a_lane]

    def relay(k, v, src, dst):
        sk = np.empty((blocks, elems), np.int32)
        sv = np.empty_like(sk)
        sk[:, swizzle(src)], sv[:, swizzle(src)] = k, v
        return sk[:, swizzle(dst)], sv[:, swizzle(dst)]

    def registers(k, v, jr_below):
        j = e // 2
        while j > 0:
            if j < jr_below:
                for r in range(e):
                    if r & j:
                        continue
                    ka, kb = k[..., r].copy(), k[..., r + j].copy()
                    pa, pb = v[..., r].copy(), v[..., r + j].copy()
                    s = kb < ka
                    k[..., r], k[..., r + j] = (np.minimum(ka, kb),
                                                np.maximum(ka, kb))
                    v[..., r] = np.where(s, pb, pa)
                    v[..., r + j] = np.where(s, pa, pb)
            j //= 2
        return k, v

    def lanes(k, v, upper, m):
        ko, vo = k[:, t ^ m], v[:, t ^ m]
        kn = np.where(upper[:, None], np.maximum(k, ko), np.minimum(k, ko))
        return kn, np.where(kn != k, vo, v)

    k, v = lay(key), lay(pay)
    i0 = (t * e) & (n - 1)
    lane = a_lane & (n - 1)
    size, prev = 2, 0
    while size <= n:
        flip = ((lane & prev) != 0) ^ ((lane & size) != 0)
        k = k ^ -flip.astype(np.int32)
        j = size // 2
        b_layout = False
        if j >= 32 * e:
            sk = np.empty((blocks, elems), np.int32)
            sv = np.empty_like(sk)
            sk[:, swizzle(a_lane)], sv[:, swizzle(a_lane)] = k, v
            while j >= 32 * e:
                q = np.arange(elems // 2)
                lo = swizzle(((q & ~(j - 1)) << 1) | (q & (j - 1)))
                hi = lo + j
                ka, kb, pa, pb = sk[:, lo], sk[:, hi], sv[:, lo], sv[:, hi]
                s = kb < ka
                sk[:, lo], sk[:, hi] = np.minimum(ka, kb), np.maximum(ka, kb)
                sv[:, lo], sv[:, hi] = (np.where(s, pb, pa),
                                        np.where(s, pa, pb))
                j //= 2
            k, v = sk[:, swizzle(b_lane)], sv[:, swizzle(b_lane)]
            b_layout = True
        elif j >= 32:
            k, v = relay(k, v, a_lane, b_lane)
            b_layout = True
        if b_layout:
            k, v = registers(k, v, j // 16)
            k, v = lanes(k, v, (l & 16) != 0, 16)
            k, v = relay(k, v, b_lane, a_lane)
        elif j == 16:
            k, v = lanes(k, v, (i0 & 16) != 0, 1)
        k, v = registers(k, v, size)
        size, prev = size * 2, size
    out = []
    for a in (k, v):
        flat = np.empty((blocks, elems), np.int32)
        flat[:, a_lane] = a
        out.append(flat.reshape(-1)[:total].reshape(rows, n))
    return tuple(out)


@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096, 8192])
@pytest.mark.parametrize("kind", ["random", "equal", "two-valued"])
def test_register_layout_model_equals_plain(n, kind):
    """The kernel's element-to-thread map runs the same network: keys and
    payloads of the layout model equal the plain twin's, on row counts
    that leave a block part empty."""
    r = 3 if n < 2048 else 2
    key, pay = rows((r, n), 5, n)
    if kind == "equal":
        key = np.full((r, n), 7, np.int32)
    elif kind == "two-valued":
        key = (key & 1) - 1
    mk, mp = register_network_model(key, pay)
    tk, tp = tsort.bitonic_sort_rows_plain(torch.from_numpy(key),
                                           torch.from_numpy(pay))
    np.testing.assert_array_equal(mk, tk.numpy())
    np.testing.assert_array_equal(mp, tp.numpy())


# -- the matcher's row sort (ops.sort.row_sort, csrc/row_sort.cu) ------------

SENTINEL = 0x40000000  # match.SENTINEL_BASE
WIDTHS = [256, 2048, 7680, 16384]


def matcher_rows(rng, r, n, kind):
    """(r, n) int32 rows of the kinds the row sort is held to: ``codes``
    15 % candidates with duplicated codes among sentinels, ``dense`` every
    key a candidate, ``sentinels`` none, ``signed`` negative and positive
    candidates, ``odd`` the codes rows with keys >= SENTINEL_BASE off
    their column's sentinel (one moved key, duplicated sentinels)."""
    col = np.arange(n, dtype=np.int64)
    key = np.tile(SENTINEL + col, (r, 1))
    pool = rng.integers(0, 1 << 30, max(1, n // 20))
    if kind == "sentinels":
        return key.astype(np.int32)
    share = 1.0 if kind == "dense" else 0.15
    cand = rng.random((r, n)) < share
    codes = pool[rng.integers(0, len(pool), (r, n))]
    if kind == "signed":
        codes = codes - (1 << 30)
    key = np.where(cand, codes, key)
    if kind == "odd":
        key[0, n // 2] = SENTINEL + n // 3          # one key off its column
        if r > 1:
            key[1, :] = np.where(cand[1], codes[1], SENTINEL + col // 2)
        if r > 2:
            key[2, -1] = 0x7FFFFFFF
    return key.astype(np.int32)


def stable_order(key):
    """numpy's stable (key, column) sort: (keys, columns)."""
    idx = np.argsort(key, axis=1, kind="stable")
    return np.take_along_axis(key, idx, 1), idx.astype(np.int32)


def row_sort_threads(n):
    """csrc/row_sort.cu's block size: 16 keys a thread, at least 128."""
    return max(128, 1 << (-(-n // 16) - 1).bit_length())


def row_swizzle(u):
    """The kernel's shared-memory word of rank u."""
    return u ^ (((u >> 4) & 7) << 1)


def row_sort_model(key):
    """numpy model of csrc/row_sort.cu, one block a row: the 4 x 4 keys a
    thread loads (vector v of thread t is columns 4 (v T + t) ..), the
    layout check, the block scan (bytewise in a warp, 16-bit halves across
    warps), the 64-bit words at their swizzled ranks, the network's warp
    passes (8 words a lane: distances >= 8 across lanes, each lane
    deciding alone, < 8 in registers) and shared-memory stages, and the
    sentinels' columns staged at their index among them."""
    rows, n_cols = key.shape
    t = row_sort_threads(n_cols)
    warps = t // 32
    p_max = max(256, 1 << (n_cols - 1).bit_length())
    tid = np.arange(t)
    lane, warp = tid % 32, tid // 32
    col = 4 * (np.arange(4)[:, None, None] * t + tid[None, :, None]) \
        + np.arange(4)                                   # (v, t, p)
    valid = col < n_cols
    out_k = np.empty_like(key)
    out_p = np.empty_like(key)
    for y in range(rows):
        k = np.where(valid, key[y][np.minimum(col, n_cols - 1)], 0)
        cand = valid & (k < SENTINEL)
        whole = bool((valid & ~cand & (k != SENTINEL + col)).any())
        sel = valid if whole else cand
        cnt = sel.sum(-1)                                # (v, t)
        packed = sum(cnt[v].astype(np.int64) << (8 * v) for v in range(4))
        incl = packed.reshape(warps, 32).cumsum(1).reshape(-1)
        assert incl.max() < 1 << 32
        ws = incl.reshape(warps, 32)[:, 31]
        h01 = np.cumsum((ws & 0xFF) | ((ws >> 8) & 0xFF) << 16)
        h23 = np.cumsum(((ws >> 16) & 0xFF) | (ws >> 24) << 16)
        assert max(h01[-1] & 0xFFFF, h01[-1] >> 16, h23[-1] & 0xFFFF,
                   h23[-1] >> 16) <= 4096 * 4
        tot = [h01[-1] & 0xFFFF, h01[-1] >> 16, h23[-1] & 0xFFFF,
               h23[-1] >> 16]
        e01 = np.where(warp > 0, h01[np.maximum(warp - 1, 0)], 0)
        e23 = np.where(warp > 0, h23[np.maximum(warp - 1, 0)], 0)
        before = [e01 & 0xFFFF, e01 >> 16, e23 & 0xFFFF, e23 >> 16]
        n = int(sum(tot))
        rank = np.stack([sum(tot[:v]) + before[v]
                         + (((incl - packed) >> (8 * v)) & 0xFF)
                         for v in range(4)])             # (v, t)
        within = np.cumsum(sel, -1) - sel                # selected before p
        words = ((k.astype(np.int64) & 0xFFFFFFFF) ^ 0x80000000) << 14 | col
        buf = np.zeros(p_max, np.uint64)
        r = (rank[..., None] + within)[sel]
        buf[row_swizzle(r)] = words[sel].astype(np.uint64)
        big = 1 << (n - 1).bit_length() if n > 1 else 1
        pn = 256 if n <= 256 else big
        if n:
            buf[row_swizzle(np.arange(n, pn))] = np.uint64(0xFFFFFFFFFFFFFFFF)
            sorted_words = row_network_model(buf, pn)
            out_k[y, :n] = ((sorted_words[:n] >> np.uint64(14)).astype(np.int64)
                            ^ 0x80000000).astype(np.uint32).view(np.int32)
            out_p[y, :n] = (sorted_words[:n] & np.uint64(0x3FFF)).astype(np.int32)
        if n < n_cols:
            assert not whole
            cols = np.full(2 * p_max, -1, np.int64)
            other = valid & ~sel
            cols[(col - (rank[..., None] + within))[other]] = col[other]
            out_k[y, n:] = SENTINEL + cols[:n_cols - n]
            out_p[y, n:] = cols[:n_cols - n]
    return out_k, out_p


def row_network_model(buf, pn):
    """The kernel's network over ranks [0, pn) of the swizzled words:
    returns the words in rank order as the last warp pass holds them."""
    lane = np.arange(32)
    segs = pn // 256
    i0 = (np.arange(segs)[:, None] * 256 + lane[None, :] * 8)  # (seg, lane)
    idx = i0[..., None] + np.arange(8)

    def warp_pass(w, size, jtop):
        asc = (i0 & size) == 0
        j = jtop
        while j >= 8:
            keep_min = ((i0 & j) == 0) == asc
            o = w[:, lane ^ (j // 8), :]
            w = np.where((keep_min[..., None]) == (o < w), o, w)
            j //= 2
        for j in (4, 2, 1):
            if j >= size:
                continue
            for r in range(8):
                if r & j:
                    continue
                a, b = w[..., r].copy(), w[..., r + j].copy()
                up = ((i0 + r) & size) == 0
                s = np.where(up, b < a, a < b)
                w[..., r], w[..., r + j] = np.where(s, b, a), np.where(s, a, b)
        return w

    w = buf[row_swizzle(idx)]
    size = 2
    while size <= 256:
        w = warp_pass(w, size, size // 2)
        size *= 2
    while size <= pn:
        buf[row_swizzle(idx)] = w
        j = size // 2
        while j >= 256:
            q = np.arange(pn // 2)
            lo = ((q & ~(j - 1)) << 1) | (q & (j - 1))
            a = row_swizzle(lo)
            b = a + j
            assert (b == row_swizzle(lo + j)).all()
            x, y = buf[a].copy(), buf[b].copy()
            s = np.where((lo & size) == 0, y < x, x < y)
            buf[a], buf[b] = np.where(s, y, x), np.where(s, x, y)
            j //= 2
        w = warp_pass(buf[row_swizzle(idx)], size, 128)
        size *= 2
    return w.reshape(-1)


def test_row_swizzle_spreads_layout_a_over_the_banks():
    """The kernel's swizzle is a permutation of every shared-memory size,
    and each 16-byte access of a layout-A load or store (8 words a lane,
    a quarter warp at once) hits 8 distinct 16-byte bank groups."""
    for p in (256, 2048, 16384):
        assert sorted(row_swizzle(np.arange(p))) == list(range(p))
    lane = np.arange(32)
    for q in range(4):
        chunk = row_swizzle(lane * 8 + 2 * q) // 2
        assert row_swizzle(lane * 8 + 2 * q).min() % 2 == 0
        for quarter in chunk.reshape(4, 8):
            assert len(set(quarter % 8)) == 8


@pytest.mark.parametrize("n", WIDTHS + [130, 2046, 4100])
@pytest.mark.parametrize("kind", ["codes", "dense", "sentinels", "signed",
                                  "odd"])
def test_row_sort_model_equals_stable_sort(n, kind):
    """The kernel's model gives the stable (key, column) sort: keys and
    columns, on rows of every kind and width (N % 4 = 2 among them)."""
    key = matcher_rows(np.random.default_rng(n + len(kind)), 3, n, kind)
    mk, mp = row_sort_model(key)
    sk, sp = stable_order(key)
    np.testing.assert_array_equal(mk, sk)
    np.testing.assert_array_equal(mp, sp)


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("kind", ["codes", "dense", "sentinels", "signed",
                                  "odd"])
def test_row_sort_plain_is_the_stable_sort(n, kind):
    """The twin, which the CPU takes through the op, is the stable (key,
    column) sort, and launches nothing."""
    key = matcher_rows(np.random.default_rng(7 * n + len(kind)), 4, n, kind)
    before = tsort.row_sort.launches
    tk, tp = tsort.row_sort(torch.from_numpy(key))
    assert tsort.row_sort.launches == before == 0
    assert tk.dtype == tp.dtype == torch.int32
    sk, sp = stable_order(key)
    np.testing.assert_array_equal(tk.numpy(), sk)
    np.testing.assert_array_equal(tp.numpy(), sp)
    pk, pp = tsort.row_sort_plain(torch.from_numpy(key))
    assert torch.equal(pk, tk) and torch.equal(pp, tp)


@pytest.mark.parametrize("bad, match", [
    (torch.zeros((2, 256), dtype=torch.int64), "int32"),
    (torch.zeros((256,), dtype=torch.int32), r"\(R, N\)"),
    (torch.zeros((2, 3, 256), dtype=torch.int32), r"\(R, N\)"),
    (torch.zeros((2, 16388), dtype=torch.int32), "16384"),
    (torch.zeros((2, 256), dtype=torch.int32, device="meta"), "no kernel")])
def test_row_sort_rejects_bad_images(bad, match):
    with pytest.raises(ValueError, match=match):
        tsort.row_sort(bad)


def packable(key, num_tests):
    """``key`` with its candidates' codes cut to ``num_tests`` bits."""
    return np.where(key < SENTINEL, key & ((1 << num_tests) - 1),
                    key).astype(np.int32)


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("branch", ["packed", "key-value"])
@pytest.mark.parametrize("kind", ["codes", "dense", "sentinels", "odd"])
def test_sort_key_pos_is_the_stable_sort(n, branch, kind):
    """``match._sort_key_pos`` on CPU key images of up to MAX_N columns:
    exactly the stable (key, column) sort on both of today's branches,
    the packed one (which gave that order) and the key-value one."""
    num_tests = 30 - tmatch._pos_bits(n) if branch == "packed" else 30
    assert tmatch._pack_ok(num_tests, n) == (branch == "packed")
    key = packable(matcher_rows(np.random.default_rng(n), 3, n, kind),
                   num_tests)
    tk, tp = tmatch._sort_key_pos(torch.from_numpy(key), num_tests)
    sk, sp = stable_order(key)
    np.testing.assert_array_equal(tk.numpy(), sk)
    np.testing.assert_array_equal(tp.numpy(), sp)


class OpLog(TorchDispatchMode):
    """The op overloads a region dispatches, by name."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("n, routed", [(2048, True), (7680, True),
                                       (16384, True), (16386, False)])
def test_sort_key_pos_routes_by_row_width(n, routed):
    """A CUDA key image of at most MAX_N columns goes to the op (traced
    on fake CUDA tensors, so nothing launches); a wider one to
    ``torch.sort``, counted in ``row_sort.wide_calls``.  CPU images route
    alike and count nothing."""
    wide = tsort.row_sort.wide_calls
    with FakeTensorMode():
        key = torch.empty((3, n), dtype=torch.int32, device="cuda")
        with OpLog() as log:
            ks, ps = tmatch._sort_key_pos(key, 30)
    assert ks.shape == ps.shape == (3, n)
    assert ks.dtype == ps.dtype == torch.int32
    assert ("ogpc.row_sort.default" in log.names) == routed
    assert any(name.startswith("aten.sort") for name in log.names) != routed
    assert tsort.row_sort.wide_calls == wide + (not routed)
    assert tsort.row_sort.launches == 0
    key = torch.from_numpy(matcher_rows(np.random.default_rng(n), 2, n,
                                        "codes"))
    with OpLog() as log:
        ks, ps = tmatch._sort_key_pos(key, 30)
    assert ("ogpc.row_sort.default" in log.names) == routed
    assert tsort.row_sort.wide_calls == wide + (not routed)
    np.testing.assert_array_equal(ks.numpy(), stable_order(key.numpy())[0])


def torch_sort_route(key, num_tests):
    """Today's ``torch.sort`` branches of ``match._sort_key_pos``: the
    packed single-operand sort, or the unstable key-value sort."""
    w2 = key.shape[1]
    if tmatch._pack_ok(num_tests, w2):
        pb = tmatch._pos_bits(w2)
        pos = torch.arange(w2, dtype=torch.int32)
        packed_s = torch.sort(tmatch._pack_keypos(key, pos, pb), dim=1,
                              stable=False).values
        return tmatch._unpack_keypos(packed_s, pb)
    key_s, idx = torch.sort(key, dim=1, stable=False)
    return key_s, idx.to(torch.int32)


def leaves(out):
    """The tensors of nested output tuples, in order."""
    if isinstance(out, tuple):
        return [t for o in out for t in leaves(o)]
    return [out]


@pytest.mark.parametrize("num_tests", [17, 19, 30])
@pytest.mark.parametrize("w, disp_high", [(128, 24), (1024, 128),
                                          (3840, 128)])
def test_every_route_of_the_row_sort_equals_torch_sorts(monkeypatch,
                                                        num_tests, w,
                                                        disp_high):
    """The masked buffer and row counts, the row form and the flat
    buffer, the three routes through ``_sort_key_pos``, equal what they
    gave with ``torch.sort`` (either branch), on key images with cross and
    same-image pairs, runs of three and unique codes."""
    key = torch.from_numpy(random_key_image(
        np.random.default_rng(w + num_tests), 4, w, num_tests, disp_high))

    def routes():
        return (tmatch.match_epipolar_masked(None, None, None, None,
                                             disp_high, key=key,
                                             num_tests=num_tests),
                tmatch.match_epipolar_rows(None, None, None, None,
                                           disp_high, key=key,
                                           num_tests=num_tests),
                tmatch._match_epipolar_packed(None, None, None, None,
                                              disp_high, 4 * w, key=key,
                                              num_tests=num_tests))

    got = leaves(routes())
    monkeypatch.setattr(tmatch, "_sort_key_pos", torch_sort_route)
    want = leaves(routes())
    assert len(got) == len(want) == 9
    for g, t in zip(got, want):
        assert g.dtype == t.dtype and torch.equal(g, t)
    assert int(got[1].sum()) > 0


def test_masked_module_exports_with_the_row_sort():
    """``torch.export`` of the masked module (CPU) carries the row-sort op
    and no ``torch.sort``; the program equals the live module."""
    from opengpc_tpu_torch import (InferenceSettings, build_sparsematch_masked,
                                   load_forest, make_filter_mask)
    from opengpc_tpu_torch.utils import make_pair

    mask = make_filter_mask(load_forest(os.path.join(
        REPO, "forests", "defaultZeroForest.txt")))
    module = build_sparsematch_masked(mask, InferenceSettings(
        epipolar_mode=True, gradient_threshold=5, disp_high=64),
        device="cpu")
    left, right = (torch.from_numpy(a) for a in make_pair(64, 200, 9))
    program = torch.export.export(module, (left, right), strict=False)
    targets = [str(node.target) for node in program.graph.nodes
               if node.op == "call_function"]
    assert "ogpc.row_sort.default" in targets
    assert not any(t.startswith("aten.sort") for t in targets)
    got, want = program.module()(left, right), module(left, right)
    assert all(torch.equal(g, t) for g, t in zip(got, want))
    assert int(want[1].sum()) > 0
