"""Random forests through the port (the counterpart of
tests/test_parity.py's random-forest fuzz).

``utils.fuzz.random_forest`` draws the same forest text as the JAX
package's for one seed.  The JAX test's eight draws of a forest (1-4
ferns, random scales and offsets, zero and tau types), a scene and
settings, plus a forced draw for each route, forest type or test count
past 32 they leave out, go through the port's one-call
``sparsematch(device="cpu")``; each support set must equal JAX's
``build_sparsematch(use_pallas=False)`` and the native oracle's exactly,
and the masked builder's where the draw is eligible."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import opengpc_tpu.forest as jforest
import opengpc_tpu.infer as jinfer
import opengpc_tpu.utils.fuzz as jfuzz
from opengpc_tpu.config import InferenceSettings as JSettings
from opengpc_tpu_torch import (Fern, Forest, InferenceSettings,
                               build_sparsematch_masked, make_filter_mask,
                               masked_supports_to_numpy, save_forest,
                               serialize_forest, sparsematch)
from opengpc_tpu_torch.infer import _rows_ok, route
from opengpc_tpu_torch.utils import make_scene, random_forest
from test_parity import _oracle_supports

SEED, TRIALS = 4096, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", range(32))
def test_random_forest_text_matches_jax(seed):
    kw = dict(max_ferns=4, max_tests_per_fern=12) if seed % 2 else {}
    port = random_forest(np.random.default_rng(seed), **kw)
    jax_forest = jfuzz.random_forest(np.random.default_rng(seed), **kw)
    assert serialize_forest(port) == jforest.serialize_forest(jax_forest)


def _draw(rng, forest, epipolar=None):
    """One draw in the JAX test's order of rng calls after the forest: h,
    w, epipolar (unless forced), threshold, disp_high, vertical tolerance,
    scene."""
    h = int(rng.integers(48, 120))
    w = int(rng.integers(56, 160))
    drawn = bool(rng.integers(0, 2))
    kw = dict(gradient_threshold=int(rng.integers(1, 30)),
              disp_high=int(rng.choice([16, 64, 128])),
              vertical_tolerance=int(rng.integers(0, 3)),
              epipolar_mode=drawn if epipolar is None else epipolar,
              capacity=65536)
    left, right, _, _ = make_scene(rng, h, w)
    return forest, kw, left, right


def _classes(draw):
    forest, kw, left, _ = draw
    mask = make_filter_mask(forest)
    out = {route(mask, left.shape, InferenceSettings(**kw)),
           "zero" if forest.is_zero else "tau"}
    if forest.num_tests > 32:
        out.add("over-32")
    return out


@functools.lru_cache(maxsize=1)
def _draws():
    """The JAX test's eight draws (seed 4096), then one forced draw for
    each class they leave out, from the same generator: a route, a forest
    type, or a forest past 32 tests (the file-order cap; past 30 the flat
    matcher).  Seed 4096's eight draws hold 7-29 tests, so the forced draw
    past 32 tests is what takes the flat route here."""
    rng = np.random.default_rng(SEED)
    out = [_draw(rng, random_forest(rng)) for _ in range(TRIALS)]
    seen = set().union(*map(_classes, out))
    for cls in ("masked", "global-rows", "flat", "over-32", "zero", "tau"):
        if cls in seen:
            continue
        ferns = random_forest(rng).ferns
        while cls in ("flat", "over-32") and \
                sum(len(f.tests) for f in ferns) <= 32:
            ferns += random_forest(rng).ferns
        if cls in ("zero", "tau"):
            ferns = tuple(Fern(f.scale, tuple(
                dataclasses.replace(t, tau=0 if cls == "zero" else
                                    int(rng.integers(1, 10)))
                for t in f.tests)) for f in ferns)
        if cls in ("masked", "global-rows"):
            ferns = ferns[:2]  # at most 24 tests
        epipolar = {"masked": True, "global-rows": False}.get(cls)
        out.append(_draw(rng, Forest(ferns), epipolar))
        seen |= _classes(out[-1])
    return tuple(out)


def test_draws_cross_both_routing_boundaries():
    """The draws take every level-1 route, both forest types and a forest
    past 32 tests."""
    seen = set().union(*map(_classes, _draws()))
    assert seen == {"masked", "global-rows", "flat", "over-32", "zero",
                    "tau"}, seen
    assert len(_draws()) > TRIALS  # seed 4096 alone never passes 30 tests


@pytest.mark.parametrize("trial", range(len(_draws())))
def test_random_forest_sparsematch_matches_jax_and_oracle(trial, oracle_path,
                                                          tmp_path):
    forest, kw, left, right = _draws()[trial]
    forest_path = str(tmp_path / f"rf{trial}.txt")
    save_forest(forest, forest_path)
    settings = InferenceSettings(**kw)
    got = set(map(tuple, sparsematch(left, right, forest, settings,
                                     device="cpu").tolist()))
    jmatch = jinfer.build_sparsematch(jforest.load_forest(forest_path),
                                      JSettings(**kw), use_pallas=False)
    jgot = set(map(tuple, jinfer.supports_to_numpy(
        *jmatch(left, right)).tolist()))
    want = _oracle_supports(oracle_path, tmp_path, forest_path, left, right,
                            settings, settings.epipolar_mode)
    ctx = (f"trial {trial}: {len(forest.ferns)} ferns/{forest.num_tests} "
           f"tests zero={forest.is_zero} {left.shape} {kw}")
    assert got == want, ctx
    assert jgot == want, ctx
    mask = make_filter_mask(forest)
    if _rows_ok(mask, left.shape, settings):
        buf, counts = build_sparsematch_masked(forest, settings,
                                               device="cpu")(
            torch.from_numpy(left), torch.from_numpy(right))
        got_m = set(map(tuple, masked_supports_to_numpy(
            buf, counts, settings.disp_high).tolist()))
        assert got_m == want, f"masked {ctx}"
