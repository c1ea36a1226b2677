"""The port's masked epipolar matcher against the JAX package's, on seeded
random key images, with exact equality of buffer and row counts."""

import numpy as np
import pytest
import torch

import opengpc_tpu.match as jmatch

import opengpc_tpu_torch.match as tmatch


def random_key_image(rng, rows, w, num_tests, disp_high):
    """An (rows, 2W) sentinel-packed key image holding, per row: cross pairs
    inside and beyond ``disp_high``, same-image pairs, runs of three, and
    unique codes; the rest are sentinels."""
    key = tmatch.SENTINEL_BASE + np.tile(np.arange(2 * w, dtype=np.int64),
                                         (rows, 1))
    hi = 1 << num_tests
    for y in range(rows):
        slots = rng.permutation(w)
        codes = rng.choice(hi, size=w, replace=False)
        c = iter(codes)
        s = iter(slots)
        for _ in range(w // 10):          # cross pairs, any disparity
            xs = next(s)
            xt = int(rng.integers(0, w))
            code = next(c)
            key[y, xs] = code
            key[y, w + xt] = code
        for _ in range(w // 40):          # same-image pairs (left or right)
            side = int(rng.integers(0, 2)) * w
            code = next(c)
            a, b = next(s), next(s)
            key[y, side + a] = code
            key[y, side + b] = code
        for _ in range(w // 40):          # runs of three across both images
            code = next(c)
            key[y, next(s)] = code
            key[y, w + next(s)] = code
            key[y, w + next(s)] = code
        for _ in range(w // 20):          # unique codes
            key[y, int(rng.integers(0, 2)) * w + next(s)] = next(c)
    return key.astype(np.int32)


@pytest.mark.parametrize("num_tests", [17, 18, 19, 20, 30])
def test_masked_matcher_matches_jax(num_tests):
    w, rows, disp_high = 1024, 6, 128
    rng = np.random.default_rng(num_tests)
    key = random_key_image(rng, rows, w, num_tests, disp_high)
    jbuf, jcounts = jmatch.match_epipolar_masked(
        None, None, None, None, disp_high, key=key, num_tests=num_tests)
    buf, counts = tmatch.match_epipolar_masked(
        None, None, None, None, disp_high, key=torch.from_numpy(key),
        num_tests=num_tests)
    assert buf.dtype == counts.dtype == torch.int32
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert counts.sum() > 0
    # the single-operand route runs exactly up to 19 tests at W=1024
    assert tmatch._pack_ok(num_tests, 2 * w) == (num_tests <= 19)
    assert tmatch._pack_ok(num_tests, 2 * w) == jmatch._pack_ok(num_tests, 2 * w)


@pytest.mark.parametrize("disp_high", [0, 5, 128])
def test_masked_matcher_disp_high_matches_jax(disp_high):
    w, rows, num_tests = 200, 8, 30
    key = random_key_image(np.random.default_rng(disp_high), rows, w,
                           num_tests, disp_high)
    jbuf, jcounts = jmatch.match_epipolar_masked(
        None, None, None, None, disp_high, key=key, num_tests=num_tests)
    buf, counts = tmatch.match_epipolar_masked(
        None, None, None, None, disp_high, key=torch.from_numpy(key),
        num_tests=num_tests)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))


def test_pack_keypos_roundtrip_matches_jax():
    rng = np.random.default_rng(0)
    w2, num_tests = 2048, 19
    pb = tmatch._pos_bits(w2)
    key = random_key_image(rng, 4, w2 // 2, num_tests, 128)
    pos = np.broadcast_to(np.arange(w2, dtype=np.int32), key.shape)
    tkey, tpos = torch.from_numpy(key), torch.from_numpy(pos.copy())
    packed = tmatch._pack_keypos(tkey, tpos, pb)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jmatch._pack_keypos(key, pos, pb)))
    k2, p2 = tmatch._unpack_keypos(packed, pb)
    assert torch.equal(k2, tkey) and torch.equal(p2, tpos)


@pytest.mark.parametrize("num_tests", [19, 20])
def test_sort_key_pos_orders_like_jax(num_tests):
    """Sorted keys equal JAX's; positions are the same multiset per key
    (ties may come out in another order)."""
    key = random_key_image(np.random.default_rng(num_tests + 100), 5, 1024,
                           num_tests, 128)
    pos = np.broadcast_to(np.arange(2048, dtype=np.int32), key.shape)
    jk, jp = jmatch._sort_key_pos(key, pos, 2048, num_tests)
    tk, tp = tmatch._sort_key_pos(torch.from_numpy(key), num_tests)
    assert tk.dtype == tp.dtype == torch.int32
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    for y in range(key.shape[0]):
        got = sorted(zip(tk[y].tolist(), tp[y].tolist()))
        want = sorted(zip(np.asarray(jk)[y].tolist(), np.asarray(jp)[y].tolist()))
        assert got == want


def test_masked_emit_rejects_wide_pack():
    keep = torch.zeros((1, 7), dtype=torch.bool)
    src = torch.zeros((1, 7), dtype=torch.int32)
    with pytest.raises(ValueError, match="30"):
        tmatch._masked_emit(keep, src, src, 1 << 22, 1 << 10)


def test_matcher_rejects_non_int32_keys():
    with pytest.raises(ValueError, match="int32"):
        tmatch.match_epipolar_masked(
            None, None, None, None, 8,
            key=torch.zeros((2, 8), dtype=torch.int64), num_tests=30)
