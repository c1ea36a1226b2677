"""The port's host modules (forest, settings, raw I/O, scenes) against the
JAX package's: same inputs from a seed, exact equality."""

import dataclasses
import os

import numpy as np
import pytest

import opengpc_tpu.config as jconfig
import opengpc_tpu.forest as jforest
import opengpc_tpu.io.raw as jraw
import opengpc_tpu.utils.scenes as jscenes
from opengpc_tpu.utils.fuzz import random_forest

import opengpc_tpu_torch.config as tconfig
import opengpc_tpu_torch.forest as tforest
import opengpc_tpu_torch.io.raw as traw
import opengpc_tpu_torch.utils.scenes as tscenes

FORESTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "forests")
FOREST_FILES = ["defaultZeroForest.txt", "defaultTauForest.txt"]


def assert_masks_equal(jm, tm):
    for field in ("i_off", "j_off", "tau"):
        a, b = getattr(jm, field), getattr(tm, field)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert jm.type == tm.type
    assert jm.num_tests == tm.num_tests


@pytest.mark.parametrize("name", FOREST_FILES)
def test_forest_file_matches_jax(name):
    path = os.path.join(FORESTS, name)
    jf, tf = jforest.load_forest(path), tforest.load_forest(path)
    assert tforest.serialize_forest(tf) == jforest.serialize_forest(jf)
    assert (tf.num_tests, tf.is_zero) == (jf.num_tests, jf.is_zero)
    for max_tests in (32, 17):
        assert_masks_equal(jforest.make_filter_mask(jf, max_tests),
                           tforest.make_filter_mask(tf, max_tests))


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_forest_matches_jax(seed, tmp_path):
    jf = random_forest(np.random.default_rng(seed), max_ferns=4,
                       max_tests_per_fern=12)
    text = jforest.serialize_forest(jf)
    tf = tforest.parse_forest(text)
    assert tforest.serialize_forest(tf) == text
    path = str(tmp_path / "f.txt")
    tforest.save_forest(tf, path)
    with open(path) as f:
        assert f.read() == text
    assert tforest.serialize_forest(tforest.load_forest(path)) == text
    assert_masks_equal(jforest.make_filter_mask(jf),
                       tforest.make_filter_mask(tf))


@pytest.mark.parametrize("name", FOREST_FILES)
def test_filter_mask_from_numpy_carries_jax_mask(name):
    path = os.path.join(FORESTS, name)
    jm = jforest.make_filter_mask(jforest.load_forest(path))
    got = tforest.filter_mask_from_numpy(jm.i_off, jm.j_off, jm.tau, jm.type)
    assert_masks_equal(jm, got)
    assert_masks_equal(tforest.make_filter_mask(tforest.load_forest(path)), got)


def test_offset_guard_rejects_out_of_patch_offsets():
    bad = "1\n0 l 1\n0 14 0 0 0 0\n"
    with pytest.raises(ValueError, match="patch window"):
        jforest.make_filter_mask(jforest.parse_forest(bad))
    with pytest.raises(ValueError, match="patch window"):
        tforest.make_filter_mask(tforest.parse_forest(bad))
    with pytest.raises(ValueError, match="patch window"):
        tforest.filter_mask_from_numpy([[0, -14]], [[0, 0]], [0], 0)


@pytest.mark.parametrize("args, match", [
    (([], [], [], 0), "no tests"),
    (([[0, 0]], [[0, 0], [1, 1]], [0], 0), "disagree"),
    (([[0, 0]] * 33, [[0, 0]] * 33, [0] * 33, 0), "at most 32"),
    (([[0, 0]], [[0, 0]], [0], 2), "type"),
])
def test_filter_mask_from_numpy_rejects_bad_arrays(args, match):
    with pytest.raises(ValueError, match=match):
        tforest.filter_mask_from_numpy(*args)


def test_parse_errors_match_jax():
    for text in ("2\n0 s 1\n0 1 1 1 1 0\n", "1\n0 x 0\n"):
        with pytest.raises(ValueError):
            jforest.parse_forest(text)
        with pytest.raises(ValueError):
            tforest.parse_forest(text)


def test_inference_settings_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.InferenceSettings)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.InferenceSettings)]
    assert tf == jf
    for bad in (-1, 256):
        with pytest.raises(ValueError):
            tconfig.InferenceSettings(gradient_threshold=bad)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint32, np.int32, np.float32])
def test_raw_io_interchanges_with_jax(dtype, tmp_path):
    arr = (np.random.default_rng(5).integers(0, 200, (7, 11))).astype(dtype)
    p1, p2 = str(tmp_path / "a.raw"), str(tmp_path / "b.raw")
    traw.write_raw(p1, arr)
    jraw.write_raw(p2, arr)
    with open(p1, "rb") as f1, open(p2, "rb") as f2:
        assert f1.read() == f2.read()
    got = jraw.read_raw(p1)
    assert got.dtype == dtype
    np.testing.assert_array_equal(traw.read_raw(p2), arr)
    np.testing.assert_array_equal(got, arr)


def test_scenes_match_jax():
    for a, b in zip(tscenes.make_pair(40, 90, 7, seed=3),
                    jscenes.make_pair(40, 90, 7, seed=3)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tscenes.make_sparse_pair(60, 100, 5, seed=4),
                    jscenes.make_sparse_pair(60, 100, 5, seed=4)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tscenes.make_scene(np.random.default_rng(2), 50, 80),
                    jscenes.make_scene(np.random.default_rng(2), 50, 80)):
        np.testing.assert_array_equal(a, b)
