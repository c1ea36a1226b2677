"""The port's matchers against a brute-force O(n^2) statement of the
unique-collision rule (the counterpart of tests/test_match_properties.py),
and the codes form of ``match_epipolar_masked`` against JAX's codes form
and the port's key form.  Random codes from a tiny alphabet give heavy
duplication: pairs, runs of three and singletons in every row.  Every
comparison is exact."""

import numpy as np
import pytest
import torch

import opengpc_tpu.match as jmatch
import opengpc_tpu_torch.match as tmatch
from opengpc_tpu_torch.infer import masked_supports_to_numpy
from test_match_properties import brute_force_epipolar, brute_force_global


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codes(seed, h, w, alphabet, density):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, alphabet, (h, w)).astype(np.int32),
            rng.integers(0, alphabet, (h, w)).astype(np.int32),
            rng.random((h, w)) < density, rng.random((h, w)) < density)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _got(res):
    (xs, ys, ds), count = res
    n = int(count)
    return set(zip(xs[:n].tolist(), ys[:n].tolist(), ds[:n].tolist()))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("packed", [False, True])
def test_epipolar_matches_brute_force(seed, packed):
    codes_l, codes_r, valid_l, valid_r = _codes(seed, 12, 40, 25, 0.6)
    want = brute_force_epipolar(codes_l, codes_r, valid_l, valid_r, 30)
    got = _got(tmatch.match_epipolar(*_t(codes_l, codes_r, valid_l, valid_r),
                                     30, 4096, packed=packed))
    assert got == want
    assert len(want) > 0


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("packed", [False, True])
def test_global_matches_brute_force(seed, packed):
    codes_l, codes_r, valid_l, valid_r = _codes(seed, 10, 24, 60, 0.5)
    want = brute_force_global(codes_l, codes_r, valid_l, valid_r, 20, 2)
    got = _got(tmatch.match_global(*_t(codes_l, codes_r, valid_l, valid_r),
                                   20, 2, 4096, packed=packed))
    assert got == want
    assert len(want) > 0


def test_capacity_overflow_truncates_deterministically():
    """count is the true total; the buffer holds the first ``capacity``
    matches in scan order and never garbage, as in JAX's test."""
    rng = np.random.default_rng(9)
    codes = torch.from_numpy(rng.integers(0, 1 << 20, (16, 64))
                             .astype(np.int32))
    valid = torch.ones((16, 64), dtype=torch.bool)
    full = _got(tmatch.match_epipolar(codes, codes, valid, valid, 8, 4096))
    cap = 17
    (xs, ys, ds), count = tmatch.match_epipolar(codes, codes, valid, valid,
                                                8, cap)
    assert int(count) == len(full) > cap
    held = set(zip(xs.tolist(), ys.tolist(), ds.tolist()))
    assert held <= full and len(held) == cap
    jres = jmatch.match_epipolar(codes.numpy(), codes.numpy(), valid.numpy(),
                                 valid.numpy(), 8, cap)
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jres[0][0]))
    np.testing.assert_array_equal(ys.numpy(), np.asarray(jres[0][1]))


# (seed, num_tests): W = 40 gives pos_bits(80) = 7, so 5 and 23 tests take
# the single-operand packed sort, 24, 30 and None the (key, pos) sort
CODES_CASES = [(5, 5), (6, 23), (7, 24), (8, 30), (9, None)]


@pytest.mark.parametrize("seed,num_tests", CODES_CASES)
@pytest.mark.parametrize("disp_high", [3, 30])
def test_masked_codes_form_matches_jax_and_key_form(seed, num_tests,
                                                    disp_high):
    h, w = 12, 40
    codes_l, codes_r, valid_l, valid_r = _codes(seed, h, w, 25, 0.6)
    assert tmatch._pack_ok(num_tests, 2 * w) == (
        num_tests is not None and num_tests <= 23)
    jbuf, jcounts = jmatch.match_epipolar_masked(
        codes_l, codes_r, valid_l, valid_r, disp_high, num_tests=num_tests)
    buf, counts = tmatch.match_epipolar_masked(
        *_t(codes_l, codes_r, valid_l, valid_r), disp_high,
        num_tests=num_tests)
    assert buf.dtype == counts.dtype == torch.int32
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))

    pos = np.arange(2 * w, dtype=np.int32)
    key = np.where(np.concatenate([valid_l, valid_r], axis=1),
                   np.concatenate([codes_l, codes_r], axis=1),
                   tmatch.SENTINEL_BASE + pos).astype(np.int32)
    kbuf, kcounts = tmatch.match_epipolar_masked(
        None, None, None, None, disp_high, key=torch.from_numpy(key),
        num_tests=num_tests)
    assert torch.equal(kbuf, buf) and torch.equal(kcounts, counts)

    got = set(map(tuple, masked_supports_to_numpy(buf, counts,
                                                  disp_high).tolist()))
    assert got == brute_force_epipolar(codes_l, codes_r, valid_l, valid_r,
                                       disp_high)
    assert got


def test_masked_key_form_ignores_the_code_arguments():
    """With ``key=`` the code arguments are not read: garbage there gives
    the key image's buffer."""
    codes_l, codes_r, valid_l, valid_r = _codes(11, 6, 40, 25, 0.6)
    key = tmatch._key_from_codes(*_t(codes_l, codes_r, valid_l, valid_r))
    want = tmatch.match_epipolar_masked(None, None, None, None, 16, key=key)
    junk = torch.zeros((1, 1), dtype=torch.int32)
    got = tmatch.match_epipolar_masked(junk, junk, junk, junk, 16, key=key)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
