"""The port's row-form, masked-compact and global-compact contracts against
the JAX package's builders on the CPU (``use_pallas=False``), with exact
equality: buffers bit for bit, and the overflow flags equal.  A flagged
result must be re-run full-width, so it is held to the flag only.  Also
the segmented global core on a compacted (key, pos) pair."""

import numpy as np
import pytest
import torch

import opengpc_tpu as jt
import opengpc_tpu.infer as jinfer
import opengpc_tpu.match as jmatch

import opengpc_tpu_torch as pt
import opengpc_tpu_torch.match as tmatch
from test_torch_flat import masks, scene, settings_pair

ODD = (61, 131)  # 2W = 262: no chunk size divides it


def leaves(out):
    if isinstance(out, tuple):
        return [leaf for o in out for leaf in leaves(o)]
    return [out]


def assert_same(jout, tout):
    """Leaf by leaf: equal shapes, dtypes and values."""
    for j, t in zip(jout, tout, strict=True):
        want = np.asarray(j)
        assert t.shape == want.shape and t.numpy().dtype == want.dtype
        np.testing.assert_array_equal(t.numpy(), want)


def epi():
    return settings_pair(epipolar_mode=True)


def glob():
    return settings_pair(epipolar_mode=False)


def as_set(arr):
    return set(map(tuple, np.asarray(arr).tolist()))


def seeded_keys(rng, h, w2, code_bits, density):
    """An (h, w2) sentinel-packed key image: codes below 2**code_bits at
    ``density`` of the positions, per-position sentinels elsewhere."""
    pos = np.arange(w2, dtype=np.int64)[None, :]
    codes = rng.integers(0, 1 << code_bits, (h, w2))
    cand = rng.random((h, w2)) < density
    return np.where(cand, codes, tmatch.SENTINEL_BASE + pos).astype(np.int32)


def test_global_rows_core_decodes_the_pos_operand():
    """The core decodes (row, col) from the ``pos`` payload, not from the
    sort index: on a compacted, permuted (key, pos) pair, as
    _strided_chunk_compact produces, it equals JAX's core."""
    rng = np.random.default_rng(5)
    h, w = 24, 64
    key = seeded_keys(rng, h, 2 * w, 9, 0.5)
    pos = np.arange(h * 2 * w, dtype=np.int32).reshape(h, 2 * w)
    ks, ps, ovf = jmatch._strided_chunk_compact(key, pos, 32, 24,
                                                pos_never=h * 2 * w)
    assert not bool(ovf)
    perm = rng.permutation(ks.shape[0])
    ks, ps = np.asarray(ks)[perm], np.asarray(ps)[perm]
    jout = jmatch._global_rows_core(ks, ps, w, 2 * w, h, 16, 3, h, 0)
    tout = tmatch._global_rows_core(torch.from_numpy(ks),
                                    torch.from_numpy(ps), w, 2 * w, h, 16, 3,
                                    h, 0)
    assert_same(leaves(jout), leaves(tout))
    assert int(tout[1].sum()) > 0


@pytest.mark.parametrize("name", ["zero17", "zero", "tau"])
@pytest.mark.parametrize("kind", ["pair", "scene", "sparse"])
def test_rows_matcher_matches_jax(kind, name):
    jm, tm = masks(name)
    js, ts = epi()
    left, right = scene(kind, seed=len(name))
    jout = jinfer.build_sparsematch_rows(jm, js, use_pallas=False)(left, right)
    mod = pt.build_sparsematch_rows(tm, ts, device="cpu")
    assert isinstance(mod, torch.nn.Module)
    tout = mod(torch.from_numpy(left), torch.from_numpy(right))
    assert_same(leaves(jout), leaves(tout))
    got = pt.row_supports_to_numpy(*tout[0], tout[1])
    np.testing.assert_array_equal(got, jt.row_supports_to_numpy(
        *[np.asarray(a) for a in jout[0]], np.asarray(jout[1])))
    assert len(got) > 0
    # the masked contract's support set, in the flat packed order
    flat = pt.supports_to_numpy(*pt.build_sparsematch(
        tm, pt.InferenceSettings(capacity=1 << 16, gradient_threshold=5,
                                 epipolar_mode=True), device="cpu")(
        torch.from_numpy(left), torch.from_numpy(right)))
    np.testing.assert_array_equal(got, flat)


def test_rows_batch_fold_matches_jax():
    jm, tm = masks("zero")
    js, ts = epi()
    pairs = [scene(k, seed=i)
             for i, k in enumerate(("pair", "scene", "sparse"))]
    lefts = np.stack([p[0] for p in pairs])
    rights = np.stack([p[1] for p in pairs])
    jout = jinfer.build_sparsematch_rows(jm, js, use_pallas=False)(lefts,
                                                                   rights)
    mod = pt.build_sparsematch_rows(tm, ts, device="cpu")
    tout = mod(torch.from_numpy(lefts), torch.from_numpy(rights))
    assert tout[1].shape == (3, lefts.shape[1])
    assert_same(leaves(jout), leaves(tout))
    for i, (left, right) in enumerate(pairs):
        single = mod(torch.from_numpy(left), torch.from_numpy(right))
        assert all(torch.equal(a, b[i])
                   for a, b in zip(leaves(single), leaves(tout)))


@pytest.mark.parametrize("shape", [(72, 200), ODD])
@pytest.mark.parametrize("name", ["zero17", "zero", "tau"])
@pytest.mark.parametrize("kind", ["pair", "sparse"])
def test_masked_compact_matches_jax(kind, name, shape):
    """Dense pairs trip the overflow flag, sparse ones keep it clear and
    give the masked contract's buffer rows and support set."""
    jm, tm = masks(name)
    js, ts = epi()
    left, right = scene(kind, seed=2, h=shape[0], w=shape[1])
    jout = jinfer.build_sparsematch_masked_compact(jm, js, use_pallas=False)(
        left, right)
    tout = pt.build_sparsematch_masked_compact(tm, ts, device="cpu")(
        torch.from_numpy(left), torch.from_numpy(right))
    assert tout[2].dtype == torch.bool and tout[2].dim() == 0
    assert bool(tout[2]) == bool(jout[2]) == (kind == "pair")
    if kind == "pair":
        return
    assert_same(leaves(jout), leaves(tout))
    masked = pt.build_sparsematch_masked(tm, ts, device="cpu")(
        torch.from_numpy(left), torch.from_numpy(right))
    got = pt.masked_supports_to_numpy(tout[0], tout[1], ts.disp_high)
    assert len(got) > 0 and as_set(got) == as_set(
        pt.masked_supports_to_numpy(*masked, ts.disp_high))


def test_masked_compact_batch_folds_with_one_flag():
    jm, tm = masks("zero")
    js, ts = epi()
    pairs = [scene("sparse", seed=i) for i in range(3)]
    lefts = np.stack([p[0] for p in pairs])
    rights = np.stack([p[1] for p in pairs])
    jout = jinfer.build_sparsematch_masked_compact(jm, js, use_pallas=False)(
        lefts, rights)
    tout = pt.build_sparsematch_masked_compact(tm, ts, device="cpu")(
        torch.from_numpy(lefts), torch.from_numpy(rights))
    assert tout[0].shape[0] == 3 and tout[2].dim() == 0
    assert not bool(tout[2]) and not bool(jout[2])
    assert_same(leaves(jout), leaves(tout))


@pytest.mark.parametrize("num_tests", [19, 20])
@pytest.mark.parametrize("row_overflow", [False, True])
def test_masked_compact_one_and_two_operand_branches(num_tests, row_overflow):
    """At W = 1024 the one-operand sort holds up to 19 tests (19 + 11
    position bits <= 30); 20 takes the (key, pos) branch.  Both equal JAX,
    with the per-row flags of ``row_overflow``."""
    rng = np.random.default_rng(num_tests)
    h, w2 = 6, 2048
    key = seeded_keys(rng, h, w2, 10, 0.3)  # codes below 2**num_tests
    key[0, :600] = 7  # one dense row overflows its chunks
    assert tmatch._pack_ok(num_tests, w2) == (num_tests == 19)
    jout = jmatch.match_epipolar_masked_compact(
        key, 128, num_tests=num_tests, row_overflow=row_overflow)
    tout = tmatch.match_epipolar_masked_compact(
        torch.from_numpy(key), 128, num_tests=num_tests,
        row_overflow=row_overflow)
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
    assert tout[2].any() and not tout[2].all() if row_overflow else tout[2]
    # rows whose chunks held every candidate are exact
    ok = slice(1, None)
    for j, t in zip(jout[:2], tout[:2]):
        np.testing.assert_array_equal(t.numpy()[ok], np.asarray(j)[ok])
    assert int(tout[1][ok].sum()) > 0


@pytest.mark.parametrize("shape", [(72, 200), ODD])
@pytest.mark.parametrize("name", ["zero17", "zero", "tau"])
@pytest.mark.parametrize("kind", ["pair", "sparse"])
def test_global_compact_matches_jax(kind, name, shape):
    jm, tm = masks(name)
    js, ts = glob()
    left, right = scene(kind, seed=4, h=shape[0], w=shape[1])
    jout = jinfer.build_sparsematch_global_compact(jm, js, use_pallas=False)(
        left, right)
    tout = pt.build_sparsematch_global_compact(tm, ts, device="cpu")(
        torch.from_numpy(left), torch.from_numpy(right))
    assert bool(tout[2]) == bool(jout[2]) == (kind == "pair")
    if kind == "pair":
        return
    assert_same(leaves(jout), leaves(tout))
    got = pt.global_row_supports_to_numpy(*tout[0], tout[1])
    rows = pt.build_sparsematch_global_rows(tm, ts, device="cpu")(
        torch.from_numpy(left), torch.from_numpy(right))
    assert len(got) > 0 and as_set(got) == as_set(
        pt.global_row_supports_to_numpy(*rows[0], rows[1]))


def test_global_compact_batch_gives_per_pair_flags():
    jm, tm = masks("zero")
    js, ts = glob()
    pairs = [scene(k, seed=i) for i, k in enumerate(("sparse", "pair",
                                                      "sparse"))]
    lefts = np.stack([p[0] for p in pairs])
    rights = np.stack([p[1] for p in pairs])
    jout = jinfer.build_sparsematch_global_compact(jm, js, use_pallas=False)(
        lefts, rights)
    tout = pt.build_sparsematch_global_compact(tm, ts, device="cpu")(
        torch.from_numpy(lefts), torch.from_numpy(rights))
    assert tout[2].tolist() == [False, True, False]
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
    for i in (0, 2):
        assert_same([np.asarray(a)[i] for a in leaves(jout)[:4]],
                    [a[i] for a in leaves(tout)[:4]])


@pytest.mark.parametrize("chunk, k, num_rows, y_offset",
                         [(None, None, 0, 0), (64, 48, 7, 13),
                          (32, None, 50, 2)])
def test_match_global_rows_compact_direct(chunk, k, num_rows, y_offset):
    rng = np.random.default_rng(num_rows)
    h, w = 20, 100
    key = seeded_keys(rng, h, 2 * w, 12, 0.3)
    jout = jmatch.match_global_rows_compact(key, w, 16, 2, chunk=chunk, k=k,
                                            num_rows=num_rows,
                                            y_offset=y_offset)
    tout = tmatch.match_global_rows_compact(torch.from_numpy(key), w, 16, 2,
                                            chunk=chunk, k=k,
                                            num_rows=num_rows,
                                            y_offset=y_offset)
    assert not bool(tout[2]) and not bool(jout[2])
    assert_same(leaves(jout), leaves(tout))
    assert int(tout[1].sum()) > 0


def test_chunk_rules_match_jax():
    for args in [(None, None), (None, 32), (256, None), (64, 64)]:
        assert (tmatch.resolve_masked_compact_chunks(*args)
                == jmatch.resolve_masked_compact_chunks(*args))
        for w2 in (400, 2048):
            assert (tmatch.resolve_global_compact_chunks(w2, *args)
                    == jmatch.resolve_global_compact_chunks(w2, *args))
    assert tmatch.MASKED_COMPACT_CHUNKS == jmatch.MASKED_COMPACT_CHUNKS
    with pytest.raises(ValueError, match="exceeds"):
        tmatch.resolve_masked_compact_chunks(16, 32)
    with pytest.raises(ValueError, match="exceeds"):
        tmatch.resolve_global_compact_chunks(400, 16, 32)
    with pytest.raises(ValueError, match="exceeds"):
        pt.build_sparsematch_masked_compact(masks("zero")[1], epi()[1],
                                            chunk=8, k=9, device="cpu")


def test_contract_guards():
    _, tm = masks("zero")
    left, right = (torch.from_numpy(a) for a in scene("pair"))
    with pytest.raises(ValueError, match="epipolar-only"):
        pt.build_sparsematch_rows(tm, glob()[1], device="cpu")(left, right)
    with pytest.raises(ValueError, match="30-test"):
        pt.build_sparsematch_rows(masks("t32")[1], epi()[1],
                                  device="cpu")(left, right)
    with pytest.raises(ValueError, match="30 bits"):
        wide = settings_pair(epipolar_mode=True, disp_high=1 << 22)[1]
        pt.build_sparsematch_rows(tm, wide, device="cpu")(left, right)
    with pytest.raises(ValueError, match="epipolar mode"):
        pt.build_sparsematch_masked_compact(tm, glob()[1],
                                            device="cpu")(left, right)
    with pytest.raises(ValueError, match="global mode"):
        pt.build_sparsematch_global_compact(tm, epi()[1],
                                            device="cpu")(left, right)
    with pytest.raises(ValueError, match="30"):
        tmatch.match_epipolar_rows(None, None, None, None, 1 << 22,
                                   key=torch.zeros((2, 400),
                                                   dtype=torch.int32))
