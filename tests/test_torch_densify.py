"""The port's densify against the JAX package's, bit for bit, on the CPU.

The cases of ``tests/test_densify.py`` run on ``opengpc_tpu_torch.densify``
(``device="cpu"``) with their own checks, and each result must equal JAX's
``densify_supports`` exactly (both methods).  ``densify_from_masked`` must
equal the port's and JAX's supports path and JAX's
``densify_from_masked`` for both methods and both seedings, on masked
buffers from the matcher, a chunk-compacted buffer with an explicit
``width``, and synthetic buffers with empty and full rows.
"""

import os

import numpy as np
import pytest
import torch

import opengpc_tpu as jt
import opengpc_tpu.densify as jd
import opengpc_tpu_torch.densify as td
from opengpc_tpu.infer import build_sparsematch_masked as j_masked
from opengpc_tpu.infer import build_sparsematch_masked_compact as j_compact
from opengpc_tpu_torch import masked_supports_to_numpy
from opengpc_tpu_torch.match import MASKED_SENTINEL
from opengpc_tpu_torch.utils import make_scene, make_sparse_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOREST = os.path.join(REPO, "forests", "defaultZeroForest.txt")
METHODS = ("multigrid", "jacobi")
SEEDINGS = ("scatter", "sortmerge")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's intra-op threads only add overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def densify(sup, shape, **kw):
    """The port's densify_supports on the CPU, held to JAX's bit for bit."""
    got = td.densify_supports(sup, shape, device="cpu", **kw)
    want = jd.densify_supports(sup, shape, **kw)
    assert got[0].dtype == np.float32 and got[1].dtype == bool
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    return got


def test_constant_disparity_fills_constant():
    sup = np.array([[10, 10, 7], [30, 20, 7], [50, 15, 7]])
    dense, filled = densify(sup, (32, 64))
    assert filled.all()
    np.testing.assert_allclose(dense, 7.0, atol=1e-4)
    dense, filled = densify(sup, (32, 64), num_iters=100, method="jacobi")
    assert filled.all()
    np.testing.assert_allclose(dense, 7.0, atol=1e-4)


def test_known_pixels_pinned():
    sup = np.array([[5, 5, 2], [20, 20, 10]])
    dense, filled = densify(sup, (28, 28), num_iters=60)
    assert dense[5, 5] == 2.0 and dense[20, 20] == 10.0
    assert filled.all()
    assert dense.min() >= 2.0 - 1e-4 and dense.max() <= 10.0 + 1e-4


def test_limited_iters_leave_far_pixels_unfilled():
    sup = np.array([[0, 0, 3]])
    dense, filled = densify(sup, (16, 16), num_iters=4, method="jacobi")
    assert filled[0, 0] and filled[4, 0] and not filled[15, 15]
    dense, filled = densify(sup, (16, 16))
    assert filled.all()


def test_empty_supports():
    for method in METHODS:
        dense, filled = densify(np.zeros((0, 3)), (8, 8), num_iters=4,
                                method=method)
        assert not filled.any() and not dense.any()


def test_two_plane_scene_accuracy():
    rng = np.random.default_rng(0)
    h, w = 48, 96
    gt = np.where(np.arange(w)[None, :] < w // 2, 4, 12).astype(np.int32)
    gt = np.broadcast_to(gt, (h, w))
    ys = rng.integers(0, h, 300)
    xs = rng.integers(0, w, 300)
    sup = np.stack([xs, ys, gt[ys, xs]], axis=1)
    dense, filled = densify(sup, (h, w))
    assert filled.all()
    err = np.abs(dense - gt)
    interior = np.ones((h, w), bool)
    interior[:, w // 2 - 6: w // 2 + 6] = False
    assert np.median(err[interior]) < 1.0


def test_jacobi_relaxes_toward_linear_ramp():
    sup = np.array([[2, 1, 0], [18, 1, 16]])
    dense, filled = densify(sup, (3, 21), num_iters=2000, method="jacobi")
    assert filled.all()
    line = dense[1, 2:19]
    assert np.abs(line - np.linspace(0, 16, 17)).max() < 1.5
    assert (np.diff(line) > 0).all()


def _masked_buf(h, w, seed, compact=False):
    """A JAX masked (or chunk-compacted masked) buffer of a make_scene
    pair and its row counts, numpy."""
    settings = jt.InferenceSettings(gradient_threshold=5,
                                    vertical_tolerance=0, disp_high=32,
                                    epipolar_mode=True, capacity=1 << 16)
    forest = jt.load_forest(FOREST)
    if compact:
        left, right = make_sparse_pair(h, w, 8, density=0.15, seed=seed)
        buf, counts, ovf = j_compact(forest, settings, use_pallas=False,
                                     chunk=128, k=64)(left, right)
        assert not bool(np.asarray(ovf))
    else:
        left, right, _, _ = make_scene(np.random.default_rng(seed), h, w)
        buf, counts = j_masked(forest, settings, use_pallas=False)(left,
                                                                   right)
    return np.array(buf), np.array(counts)


def _from_masked_all(buf, counts, shape, num_iters, width=0):
    """densify_from_masked through every method and seeding: equal to the
    port's supports path, to JAX's supports path and to JAX's
    densify_from_masked."""
    supp = masked_supports_to_numpy(buf, counts, 32)
    for method in METHODS:
        want = densify(supp, shape, num_iters=num_iters, method=method)
        jgot = jd.densify_from_masked(buf, counts, 32, num_iters=num_iters,
                                      width=width, method=method)
        np.testing.assert_array_equal(np.asarray(jgot[0]), want[0])
        d, f = td.densify_from_masked(torch.from_numpy(buf), counts, 32,
                                      num_iters=num_iters, width=width,
                                      method=method, device="cpu")
        assert d.device.type == "cpu" and d.dtype == torch.float32
        np.testing.assert_array_equal(f.numpy(), want[1])
        np.testing.assert_array_equal(d.numpy(), want[0])
        for seed in SEEDINGS:
            d, f = td._densify_from_masked(torch.from_numpy(buf), 32,
                                           num_iters, seed_impl=seed,
                                           width=width, method=method)
            np.testing.assert_array_equal(f.numpy(), want[1])
            np.testing.assert_array_equal(d.numpy(), want[0])
            jd_, jf_ = jd._densify_from_masked(
                buf, 32, num_iters, seed_impl=seed, width=width,
                method=method)
            np.testing.assert_array_equal(d.numpy(), np.asarray(jd_))
            np.testing.assert_array_equal(f.numpy(), np.asarray(jf_))
    return supp


def test_densify_from_masked_equals_host_path():
    """Masked buffer -> dense map on the device equals decode-then-densify
    and JAX's, for both methods and both seedings."""
    buf, counts = _masked_buf(160, 320, 31)
    supp = _from_masked_all(buf, counts, (160, 320), 24)
    assert len(supp) > 500


def test_densify_from_masked_compact_buffer_with_width():
    """A chunk-compacted buffer is narrower than 2W: ``width`` names W."""
    buf, counts = _masked_buf(150, 250, 150, compact=True)
    assert buf.shape[1] != 2 * 250
    supp = _from_masked_all(buf, counts, (150, 250), 10, width=250)
    assert len(supp) > 200


@pytest.mark.parametrize("seed_impl", SEEDINGS)
def test_masked_seedings_on_empty_and_full_rows(seed_impl):
    """Rows with no valid entry, and rows where every column of W holds a
    support (the most a row can hold), in random slots of the 2W buffer:
    the unstable sorts of the sort-merge seeding and the scatter give
    JAX's seeds exactly."""
    rng = np.random.default_rng(5)
    h, w, dh = 9, 37, 8
    bd = int(2 * dh).bit_length()
    buf = np.full((h, 2 * w), MASKED_SENTINEL, np.int32)
    for y in range(h):
        kind = y % 3  # empty, full, partial
        xs = (np.arange(w) if kind == 1 else
              rng.choice(w, rng.integers(1, w), replace=False)
              if kind == 2 else np.zeros(0, np.int64))
        slots = rng.choice(2 * w, len(xs), replace=False)
        buf[y, slots] = (xs << bd) | rng.integers(0, 2 * dh + 1, len(xs))
    counts = (buf != MASKED_SENTINEL).sum(1).astype(np.int32)
    value, known = td._masked_seed_sortmerge(torch.from_numpy(buf), dh, w) \
        if seed_impl == "sortmerge" else \
        td._masked_seed_scatter(torch.from_numpy(buf), dh, w)
    jv, jk = (jd._masked_seed_sortmerge if seed_impl == "sortmerge"
              else jd._masked_seed_scatter)(buf, dh, w)
    np.testing.assert_array_equal(value.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(known.numpy(), np.asarray(jk))
    assert known.numpy()[1::3].all() and not known.numpy()[0::3].any()
    supp = masked_supports_to_numpy(buf, counts, dh)
    want_v = np.zeros((h, w), np.float32)
    want_v[supp[:, 1], supp[:, 0]] = supp[:, 2]
    np.testing.assert_array_equal(value.numpy(), want_v)
    for method in METHODS:
        d, f = td._densify_from_masked(torch.from_numpy(buf), dh, 6,
                                       seed_impl=seed_impl, width=w,
                                       method=method)
        want = jd.densify_supports(supp, (h, w), num_iters=6, method=method)
        np.testing.assert_array_equal(d.numpy(), want[0])
        np.testing.assert_array_equal(f.numpy(), want[1])


def test_multigrid_fills_wide_hole_exactly_constant():
    h, w = 160, 300
    sup = ([(x, 0, 7) for x in range(w)] + [(x, h - 1, 7) for x in range(w)]
           + [(0, y, 7) for y in range(h)] + [(w - 1, y, 7) for y in range(h)])
    sup = np.array(sup)
    dense, filled = densify(sup, (h, w))
    assert filled.all()
    np.testing.assert_allclose(dense, 7.0, atol=1e-4)
    _, fj = densify(sup, (h, w), method="jacobi")
    assert not fj.all()


def test_multigrid_bounded_diff_vs_converged_jacobi():
    h, w = 48, 160
    sup = np.array([(0, y, 0) for y in range(h)]
                   + [(w - 1, y, w - 1) for y in range(h)])
    dm, fm = densify(sup, (h, w))
    assert fm.all()
    ramp = np.broadcast_to(np.arange(w, dtype=np.float32), (h, w))
    err = np.abs(dm - ramp)
    assert err.max() < 8.0, err.max()
    assert err.mean() < 5.0, err.mean()
    d24, _ = densify(sup, (h, w), num_iters=24)
    assert np.abs(d24 - ramp).max() < err.max()


def test_multigrid_pins_seeds_and_stays_in_range():
    rng = np.random.default_rng(9)
    h, w, n = 64, 96, 40
    xs, ys = rng.integers(0, w, n), rng.integers(0, h, n)
    ds = rng.integers(-20, 21, n)
    sup = np.stack([xs, ys, ds], axis=1)
    dense, filled = densify(sup, (h, w))
    assert filled.all()
    assert dense.min() >= ds.min() - 1e-3 and dense.max() <= ds.max() + 1e-3
    seen = {}
    for x, y, d in sup.tolist():
        seen.setdefault((x, y), []).append(d)
    for (x, y), vals in seen.items():
        if len(vals) == 1:
            assert dense[y, x] == float(vals[0])


@pytest.mark.parametrize("method", METHODS)
def test_multigrid_odd_prime_shapes(method):
    """Odd and prime sides hit the restriction's zero padding and the
    upsample's crop at every level; duplicate seed pixels take their
    mean.  Seeds pinned, range bounded, JAX's bits."""
    rng = np.random.default_rng(31)
    for h, w in ((77, 131), (53, 9), (7, 257), (1, 13), (2, 2)):
        n = max(6, (h * w) // 200)
        xs, ys = rng.integers(0, w, n), rng.integers(0, h, n)
        ds = rng.integers(-20, 21, n)
        sup = np.stack([xs, ys, ds], axis=1)
        dense, filled = densify(sup, (h, w), method=method)
        assert dense.shape == (h, w) and filled.shape == (h, w)
        if method == "multigrid":
            assert filled.all(), (h, w)
        assert dense[filled].min() >= ds.min() - 1e-3, (h, w)
        assert dense[filled].max() <= ds.max() + 1e-3, (h, w)

