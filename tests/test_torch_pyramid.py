"""The port's pyramid against the JAX package's on the CPU: the same
seeded pairs through ``opengpc_tpu.pyramid``'s ``use_pallas=False``
builders and ``opengpc_tpu_torch.pyramid``'s on ``device="cpu"`` give
equal arrays (values, shapes and dtypes, not only support sets): the rows
pyramid of one pair and its batched fold (K counts a level inside the
candidate margin whole), the compact pyramid with its overflow flags, the
global-mode flat fallback, the unpackable dedup branch and the one-call
``sparsematch(..., levels=N)``."""

import os

import jax
import numpy as np
import pytest
import torch

import opengpc_tpu as jt
import opengpc_tpu.pyramid as jpyr

import opengpc_tpu_torch as pt
import opengpc_tpu_torch.pyramid as tpyr
from opengpc_tpu_torch.infer import _MARGIN, route
from opengpc_tpu_torch.utils import make_pair, make_sparse_pair

FORESTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "forests")
ZERO = os.path.join(FORESTS, "defaultZeroForest.txt")
TAU = os.path.join(FORESTS, "defaultTauForest.txt")
CLI = dict(gradient_threshold=5, epipolar_mode=True)


def masks(path=ZERO):
    return (jt.make_filter_mask(jt.load_forest(path)),
            pt.make_filter_mask(pt.load_forest(path)))


def settings_pair(**kw):
    return jt.InferenceSettings(**kw), pt.InferenceSettings(**kw)


def assert_same(jout, tout):
    """Every leaf equal, shape and dtype included."""
    jl = [np.asarray(a) for a in jax.tree_util.tree_leaves(jout)]
    tl = [t.numpy() for t in tout]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                           a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a)


def t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("shape", [(7, 9), (10, 14), (64, 128), (3, 33, 17)])
def test_downscale2_matches_jax(shape):
    img = np.random.default_rng(sum(shape)).integers(
        0, 256, shape).astype(np.uint8)
    got = tpyr.downscale2(torch.from_numpy(img))
    want = np.asarray(jpyr.downscale2(img))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    x = img[..., :shape[-2] // 2 * 2, :shape[-1] // 2 * 2].astype(int)
    plain = (x[..., 0::2, 0::2] + x[..., 0::2, 1::2] + x[..., 1::2, 0::2]
             + x[..., 1::2, 1::2]) // 4
    np.testing.assert_array_equal(got.numpy(), plain)


@pytest.mark.parametrize("shape,levels,forest", [
    ((64, 128), 3, ZERO),    # level 2 (16 x 32) lies inside the margin
    ((96, 160), 2, TAU),
    ((97, 161), 3, ZERO),    # odd sizes drop a row and a column a level
])
def test_rows_pyramid_matches_jax(shape, levels, forest):
    jm, tm = masks(forest)
    js, ts = settings_pair(**CLI)
    left, right = make_pair(*shape, 6, seed=shape[0])
    assert route(tm, shape, ts, levels) == "pyramid-rows"
    jout = jpyr.build_pyramid_sparsematch(jm, js, num_levels=levels,
                                          use_pallas=False)(left, right)
    tout = tpyr.build_pyramid_sparsematch(tm, ts, num_levels=levels,
                                          device="cpu")(*t(left, right))
    assert_same(jout, tout)
    counts = tout[4].numpy()
    assert counts.shape == (levels,) and counts[0] > 0 and counts[1] > 0


def test_batched_fold_matches_jax_and_counts_k():
    """The (B, H, W) fold: one key image and one row sort a level; K =
    sum_l (H_l - 2 m_l) W_l with the 16-row level counted whole; both
    the one (B, K) dedup sort gives the arrays of B sorts pair by pair."""
    jm, tm = masks()
    js, ts = settings_pair(**CLI)
    pairs = [make_pair(64, 128, 6, seed=s) for s in range(3)]
    lefts = np.stack([p[0] for p in pairs])
    rights = np.stack([p[1] for p in pairs])
    jout = jpyr.build_pyramid_sparsematch(jm, js, num_levels=3,
                                          use_pallas=False)(lefts, rights)
    mod = tpyr.build_pyramid_sparsematch(tm, ts, num_levels=3, device="cpu")
    tout = mod(*t(lefts, rights))
    assert_same(jout, tout)
    k = sum((h - 2 * (_MARGIN if h > 2 * _MARGIN + 1 else 0)) * w
            for h, w in ((64, 128), (32, 64), (16, 32)))
    assert tout[0].shape == (3, k) and tout[4].shape == (3, 3)
    mult, nbd = tpyr._pack_params(ts, 3)
    keys = tpyr._pyramid_batched_keys(*t(lefts, rights), tm, ts, 3, mult,
                                      nbd)
    per_pair = [tpyr._dedup_unpack(k, mult, nbd, 128, ts.disp_high, 3)
                for k in keys]
    for i, single in enumerate(per_pair):
        for a, b in zip(single, tout):
            assert torch.equal(a, b[i])
    for i, (left, right) in enumerate(pairs):
        single = mod(*t(left, right))
        got = tpyr.pyramid_supports_to_numpy(*(o[i] for o in tout))
        np.testing.assert_array_equal(
            got, tpyr.pyramid_supports_to_numpy(*single))


def test_compact_pyramid_matches_jax():
    """Single pairs: the sparse pair keeps its flag clear and equals the
    rows pyramid, the dense pair overflows; a batch of both flags the
    dense pair alone."""
    jm, tm = masks()
    js, ts = settings_pair(disp_high=32, **CLI)
    sparse = make_sparse_pair(120, 256, 8, density=0.15)
    dense = make_pair(120, 256, 8, seed=1)
    jmod = jpyr.build_pyramid_sparsematch_compact(jm, js, num_levels=3,
                                                  use_pallas=False)
    tmod = tpyr.build_pyramid_sparsematch_compact(tm, ts, num_levels=3,
                                                  device="cpu")
    for pair, flag in ((sparse, False), (dense, True)):
        tout = tmod(*t(*pair))
        assert_same(jmod(*pair), tout)
        assert bool(tout[5]) is flag
    rows = tpyr.build_pyramid_sparsematch(tm, ts, num_levels=3,
                                          device="cpu")(*t(*sparse))
    got = tpyr.pyramid_supports_to_numpy(*tmod(*t(*sparse))[:5])
    assert len(got) > 0
    np.testing.assert_array_equal(got, tpyr.pyramid_supports_to_numpy(*rows))
    lefts, rights = (np.stack([sparse[i], dense[i]]) for i in (0, 1))
    tout = tmod(*t(lefts, rights))
    assert_same(jmod(lefts, rights), tout)
    assert tout[5].tolist() == [False, True]


def test_compact_pyramid_refusals():
    _, tm = masks()
    left, right = t(*make_pair(64, 128, 6))
    with pytest.raises(ValueError, match="disp_high"):
        tpyr.build_pyramid_sparsematch_compact(
            tm, pt.InferenceSettings(disp_high=0, **CLI), device="cpu")
    glob = tpyr.build_pyramid_sparsematch_compact(
        tm, pt.InferenceSettings(disp_high=32), device="cpu")
    with pytest.raises(ValueError, match="compact pyramid"):
        glob(left, right)


@pytest.mark.parametrize("case", ["global", "unpackable"])
def test_flat_fallback_matches_jax(case):
    """Global mode at the library defaults (the packed dedup sort), and
    epipolar 128 x 256 at disp_high 4096 over 3 levels, whose dedup key
    (h w 4) << 14 reaches 2^31 (the (pixel, level) sort with gathered
    payloads); a batch runs pair by pair."""
    jm, tm = masks()
    kw = {} if case == "global" else dict(disp_high=4096, **CLI)
    shape = (64, 128) if case == "global" else (128, 256)
    js, ts = settings_pair(**kw)
    assert route(tm, shape, ts, 3) == "pyramid-flat"
    mult, nbd = tpyr._pack_params(ts, 3)
    packable = (shape[0] * shape[1] * mult) << nbd < 0x7FFFFFFF
    assert packable == (case == "global")
    pairs = [make_pair(*shape, 6, seed=s) for s in range(2)]
    jmod = jpyr.build_pyramid_sparsematch(jm, js, num_levels=3,
                                          use_pallas=False)
    tmod = tpyr.build_pyramid_sparsematch(tm, ts, num_levels=3, device="cpu")
    tout = tmod(*t(*pairs[0]))
    assert_same(jmod(*pairs[0]), tout)
    assert tout[4][0] > 0
    lefts, rights = (np.stack([p[i] for p in pairs]) for i in (0, 1))
    assert_same(jmod(lefts, rights), tmod(*t(lefts, rights)))


def test_dedup_false_keeps_capacity_trimmed_buffers():
    jm, tm = masks()
    js, ts = settings_pair(capacity=300, **CLI)
    left, right = make_pair(64, 128, 6)
    jout = jpyr.build_pyramid_sparsematch(jm, js, num_levels=2,
                                          use_pallas=False,
                                          dedup=False)(left, right)
    tout = tpyr.build_pyramid_sparsematch(tm, ts, num_levels=2, dedup=False,
                                          device="cpu")(*t(left, right))
    assert_same(jout, tout)
    assert tout[0].shape == (600,)


@pytest.mark.parametrize("settings_kw,levels", [(CLI, 2), ({}, 3)])
def test_one_call_levels_matches_jax(settings_kw, levels):
    """``sparsematch(levels=N)`` on arrays and on a batch list: JAX's
    (n, 4) arrays."""
    js, ts = settings_pair(**settings_kw)
    pairs = [make_pair(64, 128, 6, seed=10 + s) for s in range(2)]
    left, right = pairs[0]
    got = pt.sparsematch(left, right, ZERO, ts, device="cpu", levels=levels)
    want = jt.sparsematch(left, right, ZERO, js, levels=levels)
    assert got.shape[1] == 4 and len(got) > 0
    np.testing.assert_array_equal(got, want)
    got_b = pt.sparsematch([p[0] for p in pairs], [p[1] for p in pairs],
                           ZERO, ts, device="cpu", levels=levels)
    assert len(got_b) == 2
    np.testing.assert_array_equal(got_b[0], want)
    np.testing.assert_array_equal(
        got_b[1], jt.sparsematch(*pairs[1], ZERO, js, levels=levels))
