"""The port's global-rows contract (the route of the library's default
settings) against the JAX package's on the CPU, with exact equality of the
segmented buffers, and the one-call route against JAX's one-call and the
native oracle in global mode."""

import os
import subprocess

import numpy as np
import pytest
import torch

import opengpc_tpu as jt
import opengpc_tpu.infer as jinfer
import opengpc_tpu.match as jmatch
from opengpc_tpu.io.raw import write_raw

import opengpc_tpu_torch as pt
import opengpc_tpu_torch.infer as tinfer
import opengpc_tpu_torch.match as tmatch
from opengpc_tpu_torch.utils import make_pair
from test_torch_flat import (H, W, ZERO, assert_same, masks, scene,
                             settings_pair)


def global_settings(**kw):
    return settings_pair(epipolar_mode=False, **kw)


def flat_leaves(out):
    (xs, ys, ds), counts = out
    return xs, ys, ds, counts


@pytest.mark.parametrize("name", ["zero17", "zero", "tau"])
@pytest.mark.parametrize("kind", ["pair", "scene", "sparse"])
def test_global_rows_matcher_matches_jax(kind, name):
    jm, tm = masks(name)
    js, ts = global_settings()
    left, right = scene(kind, seed=len(name))
    jout = jinfer.build_sparsematch_global_rows(jm, js, use_pallas=False)(
        left, right)
    mod = pt.build_sparsematch_global_rows(tm, ts, device="cpu")
    assert isinstance(mod, torch.nn.Module)
    tout = mod(torch.from_numpy(left), torch.from_numpy(right))
    assert_same(flat_leaves(jout), flat_leaves(tout))
    assert int(tout[1].sum()) > 0
    got = pt.global_row_supports_to_numpy(*tout[0], tout[1])
    np.testing.assert_array_equal(got, jt.global_row_supports_to_numpy(
        *[np.asarray(a) for a in jout[0]], np.asarray(jout[1])))
    # the same support set as the flat contract in global mode
    flat = pt.supports_to_numpy(*pt.build_sparsematch(tm, ts, device="cpu")(
        torch.from_numpy(left), torch.from_numpy(right)))
    assert set(map(tuple, flat.tolist())) == set(map(tuple, got.tolist()))


def test_global_rows_batch_matches_jax():
    jm, tm = masks("zero")
    js, ts = global_settings()
    pairs = [scene(k, seed=i) for i, k in enumerate(("pair", "scene", "sparse"))]
    lefts = np.stack([p[0] for p in pairs])
    rights = np.stack([p[1] for p in pairs])
    jout = jinfer.build_sparsematch_global_rows(jm, js, use_pallas=False)(
        lefts, rights)
    mod = pt.build_sparsematch_global_rows(tm, ts, device="cpu")
    tout = mod(torch.from_numpy(lefts), torch.from_numpy(rights))
    assert tout[1].shape[0] == 3 and tout[0][0].dim() == 3
    assert_same(flat_leaves(jout), flat_leaves(tout))
    for i, (left, right) in enumerate(pairs):
        single = flat_leaves(mod(torch.from_numpy(left),
                                 torch.from_numpy(right)))
        assert all(torch.equal(a, b[i])
                   for a, b in zip(single, flat_leaves(tout)))


@pytest.mark.parametrize("num_rows, y_offset", [(0, 0), (7, 13), (50, 2)])
def test_match_global_rows_segments_match_jax(num_rows, y_offset):
    """Direct calls on a seeded key image: any segment count and row
    offset give JAX's buffers."""
    rng = np.random.default_rng(num_rows)
    h, w = 20, 64
    key = tmatch.SENTINEL_BASE + np.arange(h * 2 * w, dtype=np.int64)
    key = key.reshape(h, 2 * w) % (1 << 31)
    codes = rng.integers(0, 1 << 12, (h, 2 * w))
    cand = rng.random((h, 2 * w)) < 0.6
    key = np.where(cand, codes, key).astype(np.int32)
    jout = jmatch.match_global_rows(key, w, 16, 2, num_rows=num_rows,
                                    y_offset=y_offset)
    tout = tmatch.match_global_rows(torch.from_numpy(key), w, 16, 2,
                                    num_rows=num_rows, y_offset=y_offset)
    assert_same(flat_leaves(jout), flat_leaves(tout))
    assert int(tout[1].sum()) > 0


def test_global_rows_guards():
    _, tm = masks("zero")
    _, ts = global_settings()
    key = torch.zeros((4, 10), dtype=torch.int32)
    with pytest.raises(ValueError, match="width"):
        tmatch.match_global_rows(key, 4, 8, 1)
    # past the 30-bit (y, x, d) pack (2 + 3 + 28 bits) the segments sort
    # the (y, x) key alone ...
    (xs, ys, ds), counts = tmatch.match_global_rows(key, 5, 1 << 26, 1)
    assert xs.dtype == ys.dtype == ds.dtype == torch.int32
    assert int(counts.sum()) == 0
    # ... which has to fit 30 bits
    with pytest.raises(ValueError, match="30"):
        tmatch.match_global_rows(key, 5, 8, 1, y_offset=1 << 30)
    left, right = make_pair(40, 80, 3)
    epi = pt.InferenceSettings(epipolar_mode=True)
    with pytest.raises(ValueError, match="global mode"):
        pt.build_sparsematch_global_rows(tm, epi, device="cpu")(
            torch.from_numpy(left), torch.from_numpy(right))
    for shape, disp in [((H, W), 128), ((436, 1024), 128), ((436, 1024), 1024),
                        ((4000, 4000), 128)]:
        js, ts = global_settings(disp_high=disp)
        jm, tm = masks("zero")
        # the JAX package also asks the (y, x, d) pack to fit 30 bits,
        # which the last two miss (9 + 10 + 11 and 12 + 12 + 9) ...
        assert jinfer._global_rows_ok(jm, shape, js) == (
            disp == 128 and shape != (4000, 4000))
        # ... the port asks (y, x) alone, and takes the global-rows route
        # at every one
        assert tinfer._global_rows_ok(tm, shape, ts)
        assert tinfer.route(tm, shape, ts) == "global-rows"
    assert not tinfer._global_rows_ok(masks("t32")[1], (H, W), ts)
    assert tinfer.route(masks("t32")[1], (H, W), ts) == "flat"


def oracle_set(oracle_path, tmp_path, left, right, forest, settings):
    lp, rp, op = (str(tmp_path / n) for n in ("l.raw", "r.raw", "o.txt"))
    write_raw(lp, left)
    write_raw(rp, right)
    subprocess.run([oracle_path, "sparsematch", forest, lp, rp, op,
                    str(settings.gradient_threshold),
                    str(settings.vertical_tolerance),
                    str(settings.disp_high), str(int(settings.epipolar_mode)),
                    "0"], check=True)
    with open(op) as f:
        return {tuple(int(v) for v in ln.split()) for ln in f if ln.strip()}


@pytest.mark.parametrize("kind", ["pair", "scene"])
def test_one_call_default_settings_match_jax_and_oracle(kind, oracle_path,
                                                        tmp_path):
    """The library's default settings (global mode, threshold 10) take the
    global-rows route: the port equals JAX's one-call, order included, and
    the oracle's set."""
    left, right = scene(kind, seed=21)
    got = pt.sparsematch(left, right, ZERO, device="cpu")
    want = jt.sparsematch(left, right, ZERO)
    assert got.dtype == np.int32 and len(got) > 0
    np.testing.assert_array_equal(got, want)
    assert set(map(tuple, got.tolist())) == oracle_set(
        oracle_path, tmp_path, left, right, ZERO, pt.InferenceSettings())
    batch = pt.sparsematch([left, right], [right, left], ZERO, device="cpu")
    np.testing.assert_array_equal(batch[0], got)
    np.testing.assert_array_equal(batch[1], jt.sparsematch(right, left, ZERO))
