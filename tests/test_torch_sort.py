"""The bitonic row sort's plain twin against the JAX package's Pallas kernel
(interpret mode): keys AND payloads bit-identical, since the network is
fixed."""

import numpy as np
import pytest
import torch

from opengpc_tpu.ops import sort as jsort

from opengpc_tpu_torch.ops import sort as tsort


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
