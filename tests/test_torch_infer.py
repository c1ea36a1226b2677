"""The port's masked pipeline against the JAX package's on the CPU: the
built matcher's (buf, row_counts) bit-identical to JAX
``build_sparsematch_masked(use_pallas=False)``, and the one-call
``sparsematch`` equal to JAX ``sparsematch`` and to the native oracle."""

import inspect
import os
import subprocess

import numpy as np
import pytest
import torch

import opengpc_tpu as jt
import opengpc_tpu.infer as jinfer
from opengpc_tpu.io.raw import write_raw

import opengpc_tpu_torch as pt
import opengpc_tpu_torch.aot as taot
import opengpc_tpu_torch.cli.aot as taot_cli
import opengpc_tpu_torch.cli.sparsematch as tsparsematch_cli
import opengpc_tpu_torch.densify as tdensify
import opengpc_tpu_torch.infer as tinfer
import opengpc_tpu_torch.mine as tmine
import opengpc_tpu_torch.parallel as tparallel
import opengpc_tpu_torch.pyramid as tpyramid
from opengpc_tpu_torch.forest import Forest
from opengpc_tpu_torch.io import write_png
from opengpc_tpu_torch.match import MASKED_SENTINEL
from opengpc_tpu_torch.utils import make_pair, make_scene, make_sparse_pair

FORESTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "forests")
ZERO = os.path.join(FORESTS, "defaultZeroForest.txt")
TAU = os.path.join(FORESTS, "defaultTauForest.txt")
MASKS = {"zero": (ZERO, 32), "tau": (TAU, 32), "zero17": (ZERO, 17)}
H, W = 72, 200


def settings_pair(**kw):
    kw = dict(gradient_threshold=5, epipolar_mode=True, **kw)
    return jt.InferenceSettings(**kw), pt.InferenceSettings(**kw)


def masks(name):
    path, max_tests = MASKS[name]
    return (jt.make_filter_mask(jt.load_forest(path), max_tests),
            pt.make_filter_mask(pt.load_forest(path), max_tests))


def scene(kind, seed=0):
    if kind == "pair":
        return make_pair(H, W, 9, seed=seed)
    if kind == "sparse":
        return make_sparse_pair(H, W, 9, density=0.3, seed=seed)
    left, right, _, _ = make_scene(np.random.default_rng(seed), H, W)
    return left, right


def assert_same_masked(jout, tout):
    (jbuf, jc), (tbuf, tc) = jout, tout
    assert tbuf.dtype == tc.dtype == torch.int32
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("mask_name", sorted(MASKS))
@pytest.mark.parametrize("kind", ["pair", "scene", "sparse"])
def test_masked_matcher_matches_jax(kind, mask_name):
    jm, tm = masks(mask_name)
    js, ts = settings_pair()
    left, right = scene(kind)
    jout = jinfer.build_sparsematch_masked(jm, js, use_pallas=False)(left, right)
    mod = pt.build_sparsematch_masked(tm, ts, device="cpu")
    tout = mod(torch.from_numpy(left), torch.from_numpy(right))
    assert_same_masked(jout, tout)
    assert tout[1].sum() > 0


@pytest.mark.parametrize("mask_name", sorted(MASKS))
def test_masked_batch_fold_matches_jax(mask_name):
    jm, tm = masks(mask_name)
    js, ts = settings_pair()
    pairs = [scene(k, seed=i) for i, k in enumerate(("pair", "scene", "sparse"))]
    lefts = np.stack([p[0] for p in pairs])
    rights = np.stack([p[1] for p in pairs])
    jout = jinfer.build_sparsematch_masked(jm, js, use_pallas=False)(lefts, rights)
    mod = pt.build_sparsematch_masked(tm, ts, device="cpu")
    tout = mod(torch.from_numpy(lefts), torch.from_numpy(rights))
    assert tout[0].shape == (3, H, 2 * W) and tout[1].shape == (3, H)
    assert_same_masked(jout, tout)
    for i, (left, right) in enumerate(pairs):
        buf, rc = mod(torch.from_numpy(left), torch.from_numpy(right))
        assert torch.equal(buf, tout[0][i]) and torch.equal(rc, tout[1][i])


def test_built_module_holds_tests_buffer():
    _, tm = masks("tau")
    _, ts = settings_pair()
    mod = pt.build_sparsematch_masked(tm, ts, device="cpu")
    assert isinstance(mod, torch.nn.Module)
    assert mod.tests.dtype == torch.int32 and mod.tests.shape == (30, 5)
    assert "tests" in dict(mod.named_buffers())
    np.testing.assert_array_equal(mod.tests[:, 0].numpy(), tm.i_off[:, 0])
    np.testing.assert_array_equal(mod.tests[:, 4].numpy(), tm.tau)
    with pytest.raises(ValueError, match="uint8"):
        mod(torch.zeros((40, 60)), torch.zeros((40, 60)))


def test_small_frame_skips_interior_slice():
    """Frames of <= 27 rows keep every row (no margin slice)."""
    jm, tm = masks("zero")
    js, ts = settings_pair()
    left, right = make_pair(27, 80, 3)
    jout = jinfer.build_sparsematch_masked(jm, js, use_pallas=False)(left, right)
    tout = pt.build_sparsematch_masked(tm, ts, device="cpu")(
        torch.from_numpy(left), torch.from_numpy(right))
    assert_same_masked(jout, tout)


def oracle_set(oracle_path, tmp_path, left, right, forest):
    lp, rp, op = (str(tmp_path / n) for n in ("l.raw", "r.raw", "o.txt"))
    write_raw(lp, left)
    write_raw(rp, right)
    subprocess.run([oracle_path, "sparsematch", forest, lp, rp, op, "5", "1",
                    "128", "1", "0"], check=True)
    with open(op) as f:
        return {tuple(int(v) for v in ln.split()) for ln in f if ln.strip()}


def test_one_call_sintel_size_matches_jax_and_oracle(oracle_path, tmp_path):
    """The one 436x1024 case: one-call sparsematch equals JAX's, order
    included, and the oracle's set."""
    js, ts = settings_pair()
    left, right = make_pair(436, 1024, 16)
    got = pt.sparsematch(left, right, ZERO, ts, device="cpu")
    want = jt.sparsematch(left, right, ZERO, js)
    assert got.dtype == np.int32 and got.shape[1] == 3
    np.testing.assert_array_equal(got, want)
    assert set(map(tuple, got.tolist())) == oracle_set(oracle_path, tmp_path,
                                                       left, right, ZERO)
    assert (got[:, 2] == 16).mean() > 0.99


@pytest.mark.parametrize("forest", [TAU, "mask17"])
def test_one_call_matches_jax_and_oracle(forest, oracle_path, tmp_path):
    js, ts = settings_pair()
    left, right = scene("scene", seed=4)
    if forest == "mask17":
        jm, tm = masks("zero17")
        got = pt.sparsematch(left, right, tm, ts, device="cpu")
        want = jt.sparsematch(left, right, jm, js)
    else:
        got = pt.sparsematch(left, right, pt.load_forest(forest), ts,
                             device="cpu")
        want = jt.sparsematch(left, right, forest, js)
        assert set(map(tuple, got.tolist())) == oracle_set(
            oracle_path, tmp_path, left, right, forest)
    np.testing.assert_array_equal(got, want)
    assert len(got) > 0


def test_one_call_batch_matches_jax():
    js, ts = settings_pair()
    pairs = [scene("pair", seed=i) for i in range(3)]
    lefts = np.stack([p[0] for p in pairs])
    rights = np.stack([p[1] for p in pairs])
    got = pt.sparsematch(lefts, rights, ZERO, ts, device="cpu")
    want = jt.sparsematch(lefts, rights, ZERO, js)
    as_list = pt.sparsematch([p[0] for p in pairs], [p[1] for p in pairs],
                             ZERO, ts, device="cpu")
    assert len(got) == len(want) == len(as_list) == 3
    for g, w, a in zip(got, want, as_list):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(a, w)


def test_one_call_guards():
    _, ts = settings_pair()
    left, right = make_pair(40, 80, 3)
    with pytest.raises(ValueError, match="uint8"):
        pt.sparsematch(left.astype(np.float64) / 255, right, ZERO, ts,
                       device="cpu")
    with pytest.raises(ValueError, match="shapes differ"):
        pt.sparsematch(left, right[:, :70], ZERO, ts, device="cpu")
    with pytest.raises(ValueError, match="one"):
        pt.sparsematch(left[None, None], right[None, None], ZERO, ts,
                       device="cpu")
    with pytest.raises(ValueError, match="levels"):
        pt.sparsematch(left, right, ZERO, ts, device="cpu", levels=0)
    with pytest.raises(ValueError, match="empty"):
        pt.sparsematch([], [], ZERO, ts, device="cpu")


@pytest.mark.parametrize("case", ["pyramid", "png"])
def test_one_call_refuses_other_routes(case, tmp_path):
    """The routes the port once refused now run and equal JAX's one-call
    (the pyramid, a PNG path); what JAX's refuses, the port refuses: a
    missing PNG raises OSError, a pyramid with levels < 1 ValueError."""
    js, ts = settings_pair()
    left, right = make_pair(40, 80, 3)
    if case == "pyramid":
        got = pt.sparsematch(left, right, ZERO, ts, device="cpu", levels=2)
        want = jt.sparsematch(left, right, ZERO, js, levels=2)
        with pytest.raises(ValueError, match="levels"):
            pt.sparsematch(left, right, ZERO, ts, device="cpu", levels=0)
    else:
        path = str(tmp_path / "left.png")
        write_png(path, left)
        got = pt.sparsematch(path, right, ZERO, ts, device="cpu")
        want = jt.sparsematch(path, right, ZERO, js)
        with pytest.raises(OSError):
            pt.sparsematch(str(tmp_path / "missing.png"), right, ZERO, ts,
                           device="cpu")
    assert len(got) > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["global", "tests31", "wide_pack"])
def test_one_call_former_refusals_match_jax(case):
    """Global mode, a 31-test forest and an (x, d) pack wider than 30 bits
    take the global-rows and flat routes, equal to JAX's one-call."""
    js, ts = settings_pair()
    left, right = make_pair(40, 80, 3)
    jm, tm = masks("tau")
    if case == "global":
        kw = dict(gradient_threshold=5, epipolar_mode=False)
        js, ts = jt.InferenceSettings(**kw), pt.InferenceSettings(**kw)
    elif case == "tests31":
        jm = jt.make_filter_mask(jt.Forest(
            jt.load_forest(TAU).ferns + jt.load_forest(ZERO).ferns), 31)
        tm = pt.make_filter_mask(Forest(
            pt.load_forest(TAU).ferns + pt.load_forest(ZERO).ferns), 31)
        assert tm.num_tests == 31
    else:
        kw = dict(gradient_threshold=5, epipolar_mode=True, disp_high=1 << 26)
        js, ts = jt.InferenceSettings(**kw), pt.InferenceSettings(**kw)
    got = pt.sparsematch(left, right, tm, ts, device="cpu")
    want = jt.sparsematch(left, right, jm, js)
    assert len(got) > 0
    np.testing.assert_array_equal(got, want)


def test_forest_cache_keys_on_inode_and_content(tmp_path):
    """A rename swap to other content of the same size, with the mtime
    preserved, is caught by the inode in the cache key."""
    _, ts = settings_pair()
    path = tmp_path / "f.txt"
    with open(ZERO) as f:
        zero_text = f.read()
    assert zero_text.endswith(" 0\n")
    path.write_text(zero_text)
    f1 = tinfer._load_forest_cached(str(path))
    assert f1 is tinfer._load_forest_cached(str(path)) and f1.is_zero
    st = os.stat(path)
    other = tmp_path / "g.txt"
    other.write_text(zero_text[:-2] + "1\n")  # last tau 0 -> 1, same size
    os.utime(other, ns=(st.st_atime_ns, st.st_mtime_ns))
    os.replace(other, path)
    assert (os.stat(path).st_size, os.stat(path).st_mtime_ns) == (
        st.st_size, st.st_mtime_ns)
    f2 = tinfer._load_forest_cached(str(path))
    assert not f2.is_zero
    left, right = make_pair(48, 96, 5)
    assert len(pt.sparsematch(left, right, str(path), ts, device="cpu")) > 0


def test_forest_cache_raises_on_a_file_that_keeps_changing(tmp_path,
                                                           monkeypatch):
    path = tmp_path / "f.txt"
    with open(ZERO) as f:
        path.write_text(f.read())
    calls = iter(range(100))
    real_key = tinfer._file_key
    monkeypatch.setattr(tinfer, "_file_key",
                        lambda p: real_key(p) + (next(calls),))
    with pytest.raises(RuntimeError, match="changing"):
        tinfer._load_forest_cached(str(path))


def test_decode_matches_jax_numpy_branch():
    jm, tm = masks("zero")
    js, ts = settings_pair()
    left, right = scene("pair")
    buf, rc = pt.build_sparsematch_masked(tm, ts, device="cpu")(
        torch.from_numpy(left), torch.from_numpy(right))
    got = pt.masked_supports_to_numpy(buf, rc, 128)
    want = jt.masked_supports_to_numpy(buf.numpy(), rc.numpy(), 128)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="index the batch"):
        pt.masked_supports_to_numpy(buf[None], rc[None], 128)
    bad = buf.clone()
    bad[0, 0] = 5
    assert int(bad[0, 0]) != MASKED_SENTINEL
    with pytest.raises(ValueError, match="row counts"):
        pt.masked_supports_to_numpy(bad, rc, 128)


def test_cuda_request_never_runs_on_cpu():
    """Without a usable CUDA device a device="cuda" call raises instead of
    quietly running the plain twin."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    _, ts = settings_pair()
    left, right = make_pair(40, 80, 3)
    with pytest.raises((RuntimeError, AssertionError)):
        pt.sparsematch(left, right, ZERO, ts)


@pytest.mark.parametrize("fn", [
    pt.build_sparsematch_masked, pt.build_sparsematch,
    pt.build_sparsematch_global_rows, pt.build_sparsematch_rows,
    pt.build_sparsematch_masked_compact, pt.build_sparsematch_global_compact,
    tparallel.build_sharded_frame_sparsematch, tinfer._Matcher,
    pt.sparsematch, pt.extract_descriptors, tinfer.preprocess,
    pt.build_stereomatch,
    tpyramid.build_pyramid_sparsematch,
    tpyramid.build_pyramid_sparsematch_compact,
    pt.train_forest, pt.train_fern, tmine.extract_triplets_device,
    tdensify.densify_supports, tdensify.densify_from_masked,
    tsparsematch_cli.main, taot.export_sparsematch,
    taot.export_sharded_frame, taot.export_batched_sharded_frame,
    taot.save_artifact, taot_cli.main,
], ids=lambda fn: "aot_main" if fn is taot_cli.main else fn.__name__)
def test_entry_points_default_to_the_card(fn):
    """Every builder, the modules' base, the one-call entry points, the
    trainers, the device extractor, densify and the sparsematch CLI's
    ``--device``, the AOT exports (and the device an artifact's header
    records) and ``cli.aot export --device`` run on the card unless the
    caller asks for the CPU."""
    if fn is tsparsematch_cli.main:
        args = tsparsematch_cli._parser().parse_args(["f.txt", "l", "r"])
        assert args.device == "cuda"
        return
    if fn is taot_cli.main:
        args = taot_cli._parser().parse_args(
            ["export", "f.txt", "a.ogpcx", "--height", "8", "--width", "8"])
        assert args.device == "cuda"
        return
    assert inspect.signature(fn).parameters["device"].default == "cuda"
