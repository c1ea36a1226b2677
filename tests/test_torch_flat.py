"""The port's flat contract, its fused code kernel's twin and
``extract_descriptors`` against the JAX package on the CPU, on the same
seeded images, with exact equality: every value is an integer, and the
flat buffers are compared in order."""

import os

import numpy as np
import pytest
import torch

import opengpc_tpu as jt
import opengpc_tpu.forest as jforest
import opengpc_tpu.infer as jinfer
import opengpc_tpu.match as jmatch
from opengpc_tpu.ops import codes as jcodes
from opengpc_tpu.ops import fused as jfused

import opengpc_tpu_torch as pt
import opengpc_tpu_torch.forest as tforest
import opengpc_tpu_torch.infer as tinfer
import opengpc_tpu_torch.match as tmatch
from opengpc_tpu_torch.ops import fused as tfused
from opengpc_tpu_torch.utils import make_pair, make_scene, make_sparse_pair

FORESTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "forests")
ZERO = os.path.join(FORESTS, "defaultZeroForest.txt")
TAU = os.path.join(FORESTS, "defaultTauForest.txt")
H, W = 72, 200
THR = 5


def structured_image(rng, h, w):
    small = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2))
    img = np.kron(small, np.ones((4, 4)))[:h, :w]
    return np.clip(img + rng.integers(-12, 13, (h, w)), 0, 255).astype(np.uint8)


def _mask(pkg_forest, name):
    zero = pkg_forest.load_forest(ZERO)
    if name == "tau":
        return pkg_forest.make_filter_mask(pkg_forest.load_forest(TAU))
    if name.startswith("t3"):
        # the six tau ferns, then the six zero ferns: 60 tests, cut in
        # file order to 31 or 32
        both = pkg_forest.Forest(pkg_forest.load_forest(TAU).ferns
                                 + zero.ferns)
        return pkg_forest.make_filter_mask(both, int(name[1:]))
    return pkg_forest.make_filter_mask(zero, 17 if name == "zero17" else 32)


def masks(name):
    """(JAX mask, port mask): "zero" (30 tests), "tau" (30), "zero17",
    "t31" and "t32" (31 and 32 tests)."""
    return _mask(jforest, name), _mask(tforest, name)


def settings_pair(**kw):
    kw.setdefault("gradient_threshold", THR)
    return jt.InferenceSettings(**kw), pt.InferenceSettings(**kw)


def scene(kind, seed=0, h=H, w=W):
    if kind == "pair":
        return make_pair(h, w, 9, seed=seed)
    if kind == "sparse":
        return make_sparse_pair(h, w, 9, density=0.3, seed=seed)
    left, right, _, _ = make_scene(np.random.default_rng(seed), h, w)
    return left, right


def assert_same(jout, tout):
    for j, t in zip(jout, tout):
        want = np.asarray(j)
        assert t.dtype == torch.int32 and t.shape == want.shape
        np.testing.assert_array_equal(t.numpy(), want)


@pytest.mark.parametrize("name", ["zero", "tau", "t32"])
def test_fused_codes_plain_matches_pallas_and_jnp(name):
    img = structured_image(np.random.default_rng(len(name)), H, W)
    jm, tm = masks(name)
    codes, cand = tinfer._codes_and_candidates(
        torch.from_numpy(img), tm, pt.InferenceSettings(gradient_threshold=THR))
    assert codes.dtype == torch.int32 and cand.dtype == torch.bool
    jcodes_k, jcand_k = jfused.fused_codes(img, jm, THR, interpret=True)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes_k))
    np.testing.assert_array_equal(cand.numpy(), np.asarray(jcand_k))
    smooth, jcand = jinfer.preprocess(img, THR)
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jcodes.leaf_codes(smooth, jm)))
    np.testing.assert_array_equal(cand.numpy(), np.asarray(jcand))
    assert cand.any()
    if name == "t32":
        assert (codes < 0).any()  # the 32nd bit is set: int32 wrap covered


def test_fused_codes_batch_equals_single_images_without_a_launch():
    rng = np.random.default_rng(5)
    imgs = torch.from_numpy(np.stack([structured_image(rng, 50, 90)
                                      for _ in range(3)]))
    _, tm = masks("t32")
    before = tfused.fused_codes.launches
    codes, cand = tfused.fused_codes(imgs, tm, THR)
    assert codes.shape == cand.shape == (3, 50, 90)
    for i in range(3):
        c, v = tfused.fused_codes(imgs[i], tm, THR)
        assert torch.equal(codes[i], c) and torch.equal(cand[i], v)
    assert tfused.fused_codes.launches == before == 0
    with pytest.raises(ValueError, match="no kernel"):
        tfused.fused_codes(imgs.to("meta"), tm, THR)
    with pytest.raises(ValueError, match="uint8"):
        tfused.fused_codes(imgs.float(), tm, THR)


@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("name", ["zero", "t32"])
def test_fused_codes_pair_equals_two_twins_and_jax(batch, name):
    """The one-launch pair wrapper on CPU tensors, at an odd width, one
    image or a batch: two plain twins, and the JAX package's Pallas code
    kernel (interpret mode) on each image, bit for bit."""
    rng = np.random.default_rng(len(name) + (batch or 0))
    shape = (50, 101) if batch is None else (batch, 50, 101)
    lefts, rights = (np.stack([structured_image(rng, 50, 101)
                               for _ in range(batch or 1)]).reshape(shape)
                     for _ in range(2))
    jm, tm = masks(name)
    before = tfused.fused_codes.launches
    got = tfused.fused_codes_pair(torch.from_numpy(lefts),
                                  torch.from_numpy(rights), tm, THR)
    assert tfused.fused_codes.launches == before == 0
    for (codes, cand), img in zip(got, (lefts, rights)):
        assert codes.shape == cand.shape == shape
        assert codes.dtype == torch.int32 and cand.dtype == torch.bool
        want_c, want_v = tfused.fused_codes_plain(torch.from_numpy(img), tm,
                                                  THR)
        assert torch.equal(codes, want_c) and torch.equal(cand, want_v)
        for i, one in enumerate(img.reshape(-1, 50, 101)):
            jc, jv = jfused.fused_codes(one, jm, THR, interpret=True)
            np.testing.assert_array_equal(codes.reshape(-1, 50, 101)[i],
                                          np.asarray(jc))
            np.testing.assert_array_equal(cand.reshape(-1, 50, 101)[i],
                                          np.asarray(jv))
        assert cand.any()


def test_fused_codes_pair_rejects_bad_pairs():
    _, tm = masks("zero")
    img = torch.zeros((2, 40, 40), dtype=torch.uint8)
    with pytest.raises(ValueError, match="one shape"):
        tfused.fused_codes_pair(img, img[:1], tm, THR)
    with pytest.raises(ValueError, match="one shape"):
        tfused.fused_codes_pair(img, img.to("meta"), tm, THR)
    with pytest.raises(ValueError, match="uint8"):
        tfused.fused_codes_pair(img, img.float(), tm, THR)
    with pytest.raises(ValueError, match="no kernel"):
        tfused.fused_codes_pair(img.to("meta"), img.to("meta"), tm, THR)


@pytest.mark.parametrize("name", ["zero17", "zero", "t32"])
@pytest.mark.parametrize("epipolar", [True, False], ids=["epipolar", "global"])
def test_flat_matcher_matches_jax(epipolar, name):
    jm, tm = masks(name)
    js, ts = settings_pair(epipolar_mode=epipolar)
    left, right = scene("scene", seed=len(name))
    jout = jinfer.build_sparsematch(jm, js, use_pallas=False)(left, right)
    mod = pt.build_sparsematch(tm, ts, device="cpu")
    assert isinstance(mod, torch.nn.Module)
    tout = mod(torch.from_numpy(left), torch.from_numpy(right))
    assert_same(jout, tout)
    assert int(tout[3]) > 0


@pytest.mark.parametrize("epipolar", [True, False], ids=["epipolar", "global"])
def test_flat_matcher_batch_matches_jax(epipolar):
    jm, tm = masks("t32")
    js, ts = settings_pair(epipolar_mode=epipolar)
    pairs = [scene(k, seed=i) for i, k in enumerate(("pair", "scene", "sparse"))]
    lefts = np.stack([p[0] for p in pairs])
    rights = np.stack([p[1] for p in pairs])
    jout = jinfer.build_sparsematch(jm, js, use_pallas=False)(lefts, rights)
    mod = pt.build_sparsematch(tm, ts, device="cpu")
    tout = mod(torch.from_numpy(lefts), torch.from_numpy(rights))
    assert tout[0].shape == (3, ts.capacity) and tout[3].shape == (3,)
    assert_same(jout, tout)
    for i, (left, right) in enumerate(pairs):
        single = mod(torch.from_numpy(left), torch.from_numpy(right))
        assert all(torch.equal(a, b[i]) for a, b in zip(single, tout))


@pytest.mark.parametrize("name", ["zero", "t32"])
@pytest.mark.parametrize("epipolar", [True, False], ids=["epipolar", "global"])
def test_flat_matcher_truncates_at_capacity_like_jax(epipolar, name):
    jm, tm = masks(name)
    js, ts = settings_pair(epipolar_mode=epipolar, capacity=300)
    left, right = scene("pair", seed=3)
    jout = jinfer.build_sparsematch(jm, js, use_pallas=False)(left, right)
    tout = pt.build_sparsematch(tm, ts, device="cpu")(
        torch.from_numpy(left), torch.from_numpy(right))
    assert_same(jout, tout)
    assert int(tout[3]) > ts.capacity
    got = pt.supports_to_numpy(*tout)
    np.testing.assert_array_equal(got, jt.supports_to_numpy(*jout))
    assert got.shape == (ts.capacity, 3)


@pytest.mark.parametrize("name", ["zero", "t32"])
@pytest.mark.parametrize("epipolar, disp_high", [(True, 1 << 22),
                                                 (False, 1 << 15)],
                         ids=["epipolar", "global"])
def test_flat_matcher_generic_compact_matches_jax(epipolar, disp_high, name):
    """A disparity range past the 30-bit (y, x, d) pack takes the generic
    position-sort compaction, whose order is the flat window order."""
    jm, tm = masks(name)
    js, ts = settings_pair(epipolar_mode=epipolar, disp_high=disp_high)
    assert not jinfer._rows_ok(jm, (H, W), js)
    assert not jinfer._global_rows_ok(jm, (H, W), js)
    left, right = scene("scene", seed=7)
    jout = jinfer.build_sparsematch(jm, js, use_pallas=False)(left, right)
    tout = pt.build_sparsematch(tm, ts, device="cpu")(
        torch.from_numpy(left), torch.from_numpy(right))
    assert_same(jout, tout)
    assert int(tout[3]) > 0


@pytest.mark.parametrize("packed", [True, False])
def test_compaction_helpers_match_jax(packed):
    rng = np.random.default_rng(int(packed))
    keep = rng.random((30, 41)) < 0.2
    a = rng.integers(0, 1 << 8, (30, 41)).astype(np.int32)
    b = rng.integers(-100, 100, (30, 41)).astype(np.int32)
    t = [torch.from_numpy(v) for v in (keep, a, b)]
    for capacity in (50, int(keep.sum()), 2000):
        if packed:
            jo, jc = jmatch.compact_packed(keep, ((a, 8), (b + 100, 9)),
                                           capacity)
            to, tc = tmatch.compact_packed(t[0], ((t[1], 8), (t[2] + 100, 9)),
                                           capacity)
        else:
            jo, jc = jmatch.compact(keep, (a, b), capacity)
            to, tc = tmatch.compact(t[0], (t[1], t[2]), capacity)
        assert int(tc) == int(jc) == int(keep.sum())
        assert_same(jo, to)


def test_match_epipolar_bitonic_matches_jax():
    """``sort_impl="bitonic"`` equals JAX's same call in order, and the
    default sort's output: the packed compaction fixes the order."""
    rng = np.random.default_rng(3)
    h, w = 40, 100  # 2W = 200 pads to 256
    codes_l = rng.integers(0, 1 << 20, (h, w)).astype(np.int32)
    codes_r = np.roll(codes_l, -4, axis=1)
    valid = rng.random((h, w)) < 0.5
    args = (codes_l, codes_r, valid, np.roll(valid, -4, axis=1))
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    jout, jc = jmatch.match_epipolar(*args, 64, 4096, packed=True,
                                     sort_impl="bitonic")
    tout, tc = tmatch.match_epipolar(*targs, 64, 4096, packed=True,
                                     sort_impl="bitonic", num_tests=20)
    assert int(tc) == int(jc) > 10
    assert_same(jout, tout)
    auto, ac = tmatch.match_epipolar(*targs, 64, 4096, packed=True,
                                     num_tests=20)
    assert int(ac) == int(tc)
    assert all(torch.equal(x, y) for x, y in zip(auto, tout))
    with pytest.raises(ValueError, match="sort_impl"):
        tmatch.match_epipolar(*targs, 64, 4096, packed=True, sort_impl="lax")
    # capacity=None is the row form, after either sort
    for impl in ("auto", "bitonic"):
        (jxs, jds), jcounts = jmatch._match_epipolar_packed(
            *args, 64, None, sort_impl=impl)
        (txs, tds), tcounts = tmatch._match_epipolar_packed(
            *targs, 64, None, sort_impl=impl, num_tests=20)
        assert_same((jxs, jds, jcounts), (txs, tds, tcounts))
        assert int(tcounts.sum()) == int(tc)


@pytest.mark.parametrize("case", ["t32_epipolar", "t32_global", "global_wide",
                                  "epipolar_wide"])
def test_one_call_flat_route_matches_jax(case):
    name = "t32" if case.startswith("t32") else "zero"
    jm, tm = masks(name)
    kw = dict(epipolar_mode="epipolar" in case, capacity=H * W)
    if case == "global_wide":
        kw["disp_high"] = 1 << 15
    elif case == "epipolar_wide":
        kw["disp_high"] = 1 << 22
    js, ts = settings_pair(**kw)
    left, right = scene("pair", seed=11)

    def expect(want):
        if case != "global_wide":
            return want
        # past the 30-bit pack the port's global mode takes the global-rows
        # route, whose (y, x) key keeps every support in (y, x, d) order;
        # the JAX package takes the flat route, in its window order
        assert tinfer.route(tm, left.shape, ts) == "global-rows"
        return want[np.lexsort((want[:, 2], want[:, 0], want[:, 1]))]

    got = pt.sparsematch(left, right, tm, ts, device="cpu")
    want = jt.sparsematch(left, right, jm, js)
    assert got.dtype == np.int32 and len(got) > 0
    np.testing.assert_array_equal(got, expect(want))
    pairs = [scene("pair", seed=s) for s in (11, 12)]
    batch = pt.sparsematch([p[0] for p in pairs], [p[1] for p in pairs], tm,
                           ts, device="cpu")
    np.testing.assert_array_equal(batch[0], got)
    np.testing.assert_array_equal(
        batch[1], expect(jt.sparsematch(pairs[1][0], pairs[1][1], jm, js)))


def test_one_call_flat_route_raises_past_capacity():
    jm, tm = masks("t32")
    js, ts = settings_pair(epipolar_mode=True, capacity=100)
    left, right = scene("pair")
    with pytest.raises(ValueError, match="capacity=100"):
        jt.sparsematch(left, right, jm, js)
    with pytest.raises(ValueError, match="capacity=100"):
        pt.sparsematch(left, right, tm, ts, device="cpu")
    with pytest.raises(ValueError, match=r"pair\(s\) \[0, 1\]"):
        pt.sparsematch(np.stack([left, left]), np.stack([right, right]), tm,
                       ts, device="cpu")


@pytest.mark.parametrize("name", ["zero", "t32"])
def test_extract_descriptors_matches_jax(name):
    jm, tm = masks(name)
    js, ts = settings_pair()
    img = structured_image(np.random.default_rng(9), H, W)
    got = pt.extract_descriptors(img, tm, ts, device="cpu")
    want = jinfer.extract_descriptors(img, jm, js, use_pallas=False)
    assert got.dtype == np.int64 and got.shape[1] == 3 and len(got) > 0
    np.testing.assert_array_equal(got, want)
    if name == "t32":
        assert got[:, 2].max() >= 1 << 31  # states are unsigned
    with pytest.raises(ValueError, match="one"):
        pt.extract_descriptors(img[None], tm, ts, device="cpu")
