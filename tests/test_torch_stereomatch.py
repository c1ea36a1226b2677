"""The port's ``build_stereomatch`` against the JAX package's on the CPU:
the same seeded pairs give equal (sx, sy, tx, ty, count) arrays with the
packed sort (<= 30 tests) and the two-key sort (31 tests), for single
pairs and pair by pair for a batch; filtered as the rectified contract
filters, the correspondences are the global-mode ``sparsematch`` set."""

import os

import numpy as np
import pytest
import torch

import opengpc_tpu as jt
import opengpc_tpu.infer as jinfer

import opengpc_tpu_torch as pt
from opengpc_tpu_torch.forest import Forest
from opengpc_tpu_torch.utils import make_pair, make_scene

FORESTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "forests")
ZERO = os.path.join(FORESTS, "defaultZeroForest.txt")
TAU = os.path.join(FORESTS, "defaultTauForest.txt")


def masks(name):
    if name == "tests31":
        jm = jt.make_filter_mask(jt.Forest(
            jt.load_forest(TAU).ferns + jt.load_forest(ZERO).ferns), 31)
        tm = pt.make_filter_mask(Forest(
            pt.load_forest(TAU).ferns + pt.load_forest(ZERO).ferns), 31)
        return jm, tm
    path = {"zero": ZERO, "tau": TAU}[name]
    return (jt.make_filter_mask(jt.load_forest(path)),
            pt.make_filter_mask(pt.load_forest(path)))


def settings_pair(**kw):
    kw = {"gradient_threshold": 5, "capacity": 8192, **kw}
    return jt.InferenceSettings(**kw), pt.InferenceSettings(**kw)


def assert_same(jout, tout):
    assert len(jout) == len(tout) == 5
    for a, b in zip(jout, tout):
        a = np.asarray(a)
        assert b.shape == a.shape and b.numpy().dtype == a.dtype
        np.testing.assert_array_equal(b.numpy(), a)


@pytest.mark.parametrize("name", ["zero", "tau", "tests31"])
def test_stereomatch_matches_jax(name):
    jm, tm = masks(name)
    js, ts = settings_pair()
    left, right, _, _ = make_scene(np.random.default_rng(4), 64, 120)
    jout = jinfer.build_stereomatch(jm, js, use_pallas=False)(left, right)
    tout = pt.build_stereomatch(tm, ts, device="cpu")(
        torch.from_numpy(left), torch.from_numpy(right))
    assert_same(jout, tout)
    assert 50 < int(tout[4]) <= ts.capacity


def test_stereomatch_batch_and_truncation_match_jax():
    """A batch runs pair by pair; a capacity below the count keeps the
    first ``capacity`` correspondences and the true count."""
    jm, tm = masks("zero")
    js, ts = settings_pair(capacity=100)
    pairs = [make_pair(48, 96, 5, seed=s) for s in range(3)]
    lefts = np.stack([p[0] for p in pairs])
    rights = np.stack([p[1] for p in pairs])
    jout = jinfer.build_stereomatch(jm, js, use_pallas=False)(lefts, rights)
    tout = pt.build_stereomatch(tm, ts, device="cpu")(
        torch.from_numpy(lefts), torch.from_numpy(rights))
    assert_same(jout, tout)
    assert tout[0].shape == (3, 100) and (tout[4] > 100).all()


def test_stereomatch_filtered_equals_global_sparsematch():
    """Kept where |sy - ty| <= vertical_tolerance and |sx - tx| <=
    disp_high, the correspondences are global sparsematch's supports."""
    _, tm = masks("zero")
    ts = pt.InferenceSettings(gradient_threshold=5, epipolar_mode=False,
                              disp_high=32, vertical_tolerance=1,
                              capacity=8192)
    left, right = make_pair(64, 96, 3, seed=2)
    sx, sy, tx, ty, count = (o.numpy() for o in pt.build_stereomatch(
        tm, ts, device="cpu")(torch.from_numpy(left),
                              torch.from_numpy(right)))
    n = int(count)
    dx = sx[:n] - tx[:n]
    keep = (np.abs(sy[:n] - ty[:n]) <= ts.vertical_tolerance) & (
        np.abs(dx) <= ts.disp_high)
    got = set(zip(sx[:n][keep].tolist(), sy[:n][keep].tolist(),
                  dx[keep].tolist()))
    want = set(map(tuple, pt.sparsematch(left, right, tm, ts,
                                         device="cpu").tolist()))
    assert got == want and len(want) > 50
