"""The port's ``sparsematch`` CLI against the JAX package's, single pair.

Each case runs ``opengpc_tpu.cli.sparsematch.main`` and
``opengpc_tpu_torch.cli.sparsematch.main`` (``--device cpu``) in process
with the same arguments, each into a directory of its own, and requires
the same exit code and byte-identical output files (supports text,
``disparity.png`` in both ``--viz-compat`` modes, the ``--densify`` PNG);
where the run is deterministic, the same stderr too.  The port's outputs
are also held to the checks of the JAX package's own CLI tests
(``tests/test_api.py``), run on the port's own builders.  The host
matchers are held to the native oracle.  ``--data-parallel`` and
``--shard-frame`` above 1 exit 1 in the port, naming the builders that are
not ported yet.
"""

import collections
import os
import subprocess

import numpy as np
import pytest
import torch

import opengpc_tpu.cli.sparsematch as jcli
import opengpc_tpu_torch.cli.sparsematch as tcli
import opengpc_tpu_torch.match as tmatch
from opengpc_tpu.infer import extract_descriptors as j_extract
from opengpc_tpu.io.raw import write_raw
from opengpc_tpu.match import match_hashmatch as j_hashmatch
from opengpc_tpu.match import match_reference_quirk as j_quirk
from opengpc_tpu_torch import (InferenceSettings, build_sparsematch,
                               extract_descriptors, load_forest,
                               make_filter_mask, supports_to_numpy)
from opengpc_tpu_torch.io import read_png, read_supports, write_png
from opengpc_tpu_torch.utils import make_pair as scene_pair
from opengpc_tpu_torch.utils import make_sparse_pair
from test_api import make_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOREST = os.path.join(REPO, "forests", "defaultZeroForest.txt")

Run = collections.namedtuple("Run", "rc err files")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's intra-op threads only add overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _files(d):
    return {str(p.relative_to(d)): p.read_bytes() for p in sorted(d.rglob("*"))
            if p.is_file() and "trace" not in p.relative_to(d).parts}


def run_both(tmp_path, argv, capfd, tag="run", same_err=True):
    """Run both CLIs on ``argv(out_dir)`` (the port with ``--device
    cpu``); require equal exit codes and byte-identical files (and equal
    stderr with ``same_err``).  Returns the (jax, torch) Runs."""
    runs = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("torch", tcli.main, ["--device", "cpu"])):
        d = tmp_path / f"{tag}_{name}"
        d.mkdir()
        capfd.readouterr()
        rc = main(argv(d) + extra)
        runs[name] = Run(rc, capfd.readouterr().err, _files(d))
    j, t = runs["jax"], runs["torch"]
    assert t.rc == j.rc, (tag, j.err, t.err)
    assert sorted(t.files) == sorted(j.files), tag
    for k in j.files:
        assert t.files[k] == j.files[k], (tag, k)
    if same_err:
        assert t.err == j.err, (tag, j.err, t.err)
    return j, t


def pair_paths(tmp_path, name, left, right):
    lp, rp = tmp_path / f"{name}_l.png", tmp_path / f"{name}_r.png"
    write_png(str(lp), left)
    write_png(str(rp), right)
    return str(lp), str(rp)


def support_set(path):
    return set(map(tuple, read_supports(str(path)).tolist()))


def flat_set(left, right, disp_high, mask=None, epipolar=True):
    settings = InferenceSettings(gradient_threshold=5, vertical_tolerance=0,
                                 disp_high=disp_high,
                                 epipolar_mode=epipolar, capacity=1 << 16)
    mask = mask if mask is not None else load_forest(FOREST)
    got = supports_to_numpy(*build_sparsematch(mask, settings, device="cpu")(
        torch.from_numpy(left), torch.from_numpy(right)))
    return set(map(tuple, got.tolist()))


def oracle_supports(oracle_path, tmp_path, left, right, mode):
    lp, rp, op = (str(tmp_path / n) for n in ("l.raw", "r.raw", "o.txt"))
    write_raw(lp, left)
    write_raw(rp, right)
    subprocess.run([oracle_path, "sparsematch", FOREST, lp, rp, op,
                    "5", "1", "64", "1", str(mode)], check=True)
    with open(op) as f:
        return [tuple(int(v) for v in line.split()) for line in f
                if line.strip()]


def filtered(corr, vt=1, dh=64):
    return [(int(sx), int(sy), int(sx) - int(tx)) for sx, sy, tx, ty in corr
            if abs(int(sy) - int(ty)) <= vt and abs(int(sx) - int(tx)) <= dh]


@pytest.mark.parametrize("matcher,mode", [("quirk", 1), ("hashmatch", 2)])
def test_host_matchers_vs_oracle_and_jax(matcher, mode, oracle_path,
                                         tmp_path):
    """The port's numpy host matchers on the port's descriptors reproduce
    the oracle's quirk (set) and hashmatch (in order) supports, and give
    the JAX package's pairs on its descriptors."""
    left, right = make_pair(72, 104, 4, seed=5)
    settings = InferenceSettings(gradient_threshold=5, disp_high=64,
                                 vertical_tolerance=1, capacity=16384)
    forest = load_forest(FOREST)
    dl = extract_descriptors(left, forest, settings, device="cpu")
    dr = extract_descriptors(right, forest, settings, device="cpu")
    import opengpc_tpu as jt

    jforest = jt.load_forest(FOREST)
    jsettings = jt.InferenceSettings(gradient_threshold=5, disp_high=64,
                                     vertical_tolerance=1, capacity=16384)
    jdl = j_extract(left, jforest, jsettings, use_pallas=False)
    jdr = j_extract(right, jforest, jsettings, use_pallas=False)
    np.testing.assert_array_equal(dl, jdl)
    np.testing.assert_array_equal(dr, jdr)
    tfn = {"quirk": tmatch.match_reference_quirk,
           "hashmatch": tmatch.match_hashmatch}[matcher]
    jfn = {"quirk": j_quirk, "hashmatch": j_hashmatch}[matcher]
    got = tfn(dl, dr, epipolar=True)
    np.testing.assert_array_equal(got, jfn(jdl, jdr, epipolar=True))
    want = oracle_supports(oracle_path, tmp_path, left, right, mode)
    assert len(want) > 0
    if matcher == "quirk":
        assert set(filtered(got)) == set(want)
    else:
        assert filtered(got) == want


@pytest.mark.parametrize("kind", ["empty", "one_sided"])
def test_host_matchers_edge_inputs(kind):
    rng = np.random.default_rng(3)
    desc = np.stack([rng.integers(0, 50, 40), rng.integers(0, 9, 40),
                     rng.integers(0, 12, 40)], axis=1)
    empty = np.zeros((0, 3), np.int64)
    a, b = (empty, desc) if kind == "empty" else (desc, desc[:1])
    for tfn, jfn in ((tmatch.match_reference_quirk, j_quirk),
                     (tmatch.match_hashmatch, j_hashmatch)):
        for epi in (False, True):
            np.testing.assert_array_equal(tfn(a, b, epipolar=epi),
                                          jfn(a, b, epipolar=epi))
            np.testing.assert_array_equal(tfn(b, a, epipolar=epi),
                                          jfn(b, a, epipolar=epi))


@pytest.mark.parametrize("matcher", ["quirk", "hashmatch"])
def test_cli_host_matcher(matcher, tmp_path, capfd):
    """``--matcher quirk|hashmatch``: the same files as the JAX CLI, in
    both ``--viz-compat`` modes, and the same refusals."""
    lp, rp = pair_paths(tmp_path, "p", *make_pair(72, 104, 4, seed=5))
    for compat in ("canonical", "reference"):
        run_both(tmp_path, lambda d: [
            FOREST, lp, rp, "--disp-high", "64", "--vertical-tolerance", "1",
            "--matcher", matcher, "--viz-compat", compat, "--out",
            str(d / "d.png"), "--supports-out", str(d / "s.txt")], capfd,
            tag=compat)
    for extra in (["--pyramid", "2"], ["--repeats", "2"],
                  ["--contract", "rows"]):
        j, t = run_both(tmp_path, lambda d: [
            FOREST, lp, rp, "--matcher", matcher, "--out",
            str(d / "d.png")] + extra, capfd, tag="x" + extra[0])
        assert t.rc == 1


@pytest.mark.parametrize("contract", ["auto", "flat", "rows", "masked",
                                      "masked-compact"])
@pytest.mark.parametrize("scene", ["dense", "sparse"])
def test_cli_contracts_byte_identical(contract, scene, tmp_path, capfd):
    """Every epipolar contract on a dense and a sparse pair: supports,
    ``disparity.png`` (both colormaps) and the ``--densify`` PNG equal the
    JAX CLI's bytes; the supports equal the flat pipeline's set."""
    left, right = (make_pair(96, 160, 7, seed=77) if scene == "dense"
                   else make_sparse_pair(160, 256, 8, density=0.15, seed=9))
    lp, rp = pair_paths(tmp_path, "p", left, right)
    for compat in ("canonical", "reference"):
        j, t = run_both(tmp_path, lambda d: [
            FOREST, lp, rp, "--disp-high", "32", "--contract", contract,
            "--viz-compat", compat, "--out", str(d / "d.png"),
            "--supports-out", str(d / "s.txt"), "--densify",
            str(d / "dense.png")], capfd, tag=compat)
        assert t.rc == 0
    assert support_set(tmp_path / "reference_torch" / "s.txt") == \
        flat_set(left, right, 32)


@pytest.mark.parametrize("contract", ["auto", "global-rows",
                                      "global-compact", "flat"])
def test_cli_global_contracts_byte_identical(contract, tmp_path, capfd):
    left, right = make_sparse_pair(160, 256, 8, density=0.15, seed=9)
    lp, rp = pair_paths(tmp_path, "p", left, right)
    j, t = run_both(tmp_path, lambda d: [
        FOREST, lp, rp, "--disp-high", "32", "--global-mode", "--contract",
        contract, "--out", str(d / "d.png"), "--supports-out",
        str(d / "s.txt"), "--densify", str(d / "dense.png")], capfd)
    assert t.rc == 0
    assert support_set(tmp_path / "run_torch" / "s.txt") == \
        flat_set(left, right, 32, epipolar=False)


def test_cli_flag_combinations_smoke(tmp_path, capfd):
    """--pyramid with --densify and --trace together (single pair), and
    --contract flat refused in sequence mode; --shard-frame in sequence
    mode, which the JAX CLI runs on its 2-D mesh, exits 1 in the port."""
    left, right = make_pair(64, 96, 3, seed=5)
    lp, rp = pair_paths(tmp_path, "p", left, right)
    j, t = run_both(tmp_path, lambda d: [
        FOREST, lp, rp, "--disp-high", "16", "--pyramid", "2", "--densify",
        str(d / "dense.png"), "--trace", str(d / "trace"), "--out",
        str(d / "d.png"), "--supports-out", str(d / "s.txt")], capfd,
        same_err=False)
    assert t.rc == 0
    assert (tmp_path / "run_torch" / "trace" / "trace.json").exists()
    arr, _ = read_png(str(tmp_path / "run_torch" / "dense.png"))
    assert arr.ndim == 3 and arr.shape[:2] == (64, 96)
    ldir, rdir = tmp_path / "ld", tmp_path / "rd"
    ldir.mkdir()
    rdir.mkdir()
    write_png(str(ldir / "f0.png"), left)
    write_png(str(rdir / "f0.png"), right)
    j, t = run_both(tmp_path, lambda d: [
        FOREST, str(ldir), str(rdir), "--contract", "flat", "--out",
        str(d / "x" / "d.png")], capfd, tag="flat")
    assert t.rc == 1
    assert tcli.main([FOREST, str(ldir), str(rdir), "--shard-frame", "2",
                      "--out", str(tmp_path / "x" / "d.png"), "--device",
                      "cpu"]) == 1


def test_cli_max_tests_fast_preset(tmp_path, capfd):
    """--max-tests 17 truncates the forest before any builder sees it:
    the supports equal a direct run on make_filter_mask(forest, 17);
    out-of-range N exits 1 with the JAX CLI's message."""
    left, right = make_pair(96, 160, 7, seed=77)
    lp, rp = pair_paths(tmp_path, "p", left, right)
    j, t = run_both(tmp_path, lambda d: [
        FOREST, lp, rp, "--disp-high", "48", "--max-tests", "17", "--out",
        str(d / "d.png"), "--supports-out", str(d / "s.txt")], capfd)
    mask17 = make_filter_mask(load_forest(FOREST), max_tests=17)
    want = flat_set(left, right, 48, mask=mask17)
    assert len(want) > 100
    assert support_set(tmp_path / "run_torch" / "s.txt") == want
    for n in ("31", "0"):
        j, t = run_both(tmp_path, lambda d: [
            FOREST, lp, rp, "--max-tests", n, "--out", str(d / "d2.png")],
            capfd, tag=f"bad{n}")
        assert t.rc == 1


def test_cli_densify_device_path_byte_equal(tmp_path, capfd):
    """--densify on the masked contracts densifies from the masked buffer
    on the device; the PNG equals the flat contract's supports path and
    the JAX CLI's, for the full-width and the chunk-compacted buffers."""
    left, right = make_sparse_pair(96, 128, 6, density=0.15, seed=11)
    lp, rp = pair_paths(tmp_path, "p", left, right)
    pngs = {}
    for contract in ("flat", "masked", "masked-compact"):
        run_both(tmp_path, lambda d: [
            FOREST, lp, rp, "--disp-high", "16", "--out", str(d / "d.png"),
            "--contract", contract, "--densify", str(d / "dense.png")],
            capfd, tag=contract)
        pngs[contract] = (tmp_path / f"{contract}_torch" /
                          "dense.png").read_bytes()
    assert pngs["masked"] == pngs["flat"]
    assert pngs["masked-compact"] == pngs["flat"]


@pytest.mark.parametrize("scene", ["sparse", "dense"])
def test_cli_masked_compact_contract(scene, tmp_path, capfd):
    """--contract masked-compact: the default run's supports on a sparse
    frame; the dense frame trips the overflow guard and takes the
    full-width fallback (the same notice as the JAX CLI's)."""
    left, right = (make_sparse_pair(160, 256, 8, density=0.15)
                   if scene == "sparse" else scene_pair(160, 256, 8, seed=3))
    lp, rp = pair_paths(tmp_path, "p", left, right)
    j, a = run_both(tmp_path, lambda d: [
        FOREST, lp, rp, "--disp-high", "32", "--out", str(d / "d.png"),
        "--supports-out", str(d / "s.txt")], capfd, tag="a")
    j, b = run_both(tmp_path, lambda d: [
        FOREST, lp, rp, "--disp-high", "32", "--contract", "masked-compact",
        "--out", str(d / "d.png"), "--supports-out", str(d / "s.txt")],
        capfd, tag="b")
    assert ("masked-compact overflow" in b.err) == (scene == "dense")
    sa = support_set(tmp_path / "a_torch" / "s.txt")
    assert len(sa) > 100
    assert sa == support_set(tmp_path / "b_torch" / "s.txt")


@pytest.mark.parametrize("scene", ["sparse", "dense"])
def test_cli_global_compact_contract(scene, tmp_path, capfd):
    """--contract global-compact equals explicit global-rows; auto
    density-selects it on the sparse frame; the dense frame overflows;
    without --global-mode the explicit contract exits 1."""
    left, right = (make_sparse_pair(160, 256, 8, density=0.15)
                   if scene == "sparse" else scene_pair(160, 256, 8, seed=3))
    lp, rp = pair_paths(tmp_path, "p", left, right)
    base = [FOREST, lp, rp, "--disp-high", "32", "--global-mode"]
    j, a = run_both(tmp_path, lambda d: base + [
        "--contract", "global-rows", "--out", str(d / "d.png"),
        "--supports-out", str(d / "s.txt")], capfd, tag="a")
    assert "compact" not in a.err
    j, c = run_both(tmp_path, lambda d: base + [
        "--out", str(d / "d.png"), "--supports-out", str(d / "s.txt")],
        capfd, tag="c")
    assert ("chunk-compacted global contract" in c.err) == (
        scene == "sparse")
    j, b = run_both(tmp_path, lambda d: base + [
        "--contract", "global-compact", "--out", str(d / "d.png"),
        "--supports-out", str(d / "s.txt")], capfd, tag="b")
    assert ("global-compact overflow" in b.err) == (scene == "dense")
    sa = support_set(tmp_path / "a_torch" / "s.txt")
    assert len(sa) > 100
    assert sa == support_set(tmp_path / "b_torch" / "s.txt") == \
        support_set(tmp_path / "c_torch" / "s.txt")
    j, t = run_both(tmp_path, lambda d: [
        FOREST, lp, rp, "--disp-high", "32", "--contract", "global-compact",
        "--out", str(d / "d.png")], capfd, tag="bad")
    assert t.rc == 1


@pytest.mark.parametrize("scene", ["sparse", "dense"])
def test_cli_single_pair_auto_density_adaptive(scene, tmp_path, capfd):
    """Single-pair auto: a sparse pair probes onto the chunk-compacted
    masked contract (the supports of explicit rows), a dense pair stays on
    row form without the probe's notice."""
    left, right = (make_sparse_pair(160, 256, 8, density=0.15, seed=9)
                   if scene == "sparse" else scene_pair(160, 256, 8, seed=9))
    lp, rp = pair_paths(tmp_path, "p", left, right)
    j, a = run_both(tmp_path, lambda d: [
        FOREST, lp, rp, "--disp-high", "32", "--out", str(d / "d.png"),
        "--supports-out", str(d / "s.txt")], capfd, tag="auto")
    assert ("auto contract: candidate density" in a.err) == (
        scene == "sparse")
    j, b = run_both(tmp_path, lambda d: [
        FOREST, lp, rp, "--disp-high", "32", "--contract", "rows", "--out",
        str(d / "d.png"), "--supports-out", str(d / "s.txt")], capfd,
        tag="rows")
    sa = support_set(tmp_path / "auto_torch" / "s.txt")
    assert len(sa) > 100
    assert sa == support_set(tmp_path / "rows_torch" / "s.txt")


@pytest.mark.parametrize("contract", ["auto", "masked-compact"])
@pytest.mark.parametrize("scene", ["sparse", "dense"])
def test_cli_single_pair_pyramid(contract, scene, tmp_path, capfd):
    """--pyramid 2 with the auto probe (the compact pyramid on the sparse
    pair) and with masked-compact (the dense pair overflows to the rows
    pyramid): the JAX CLI's bytes and notices."""
    left, right = (make_sparse_pair(96, 144, 4, density=0.15, seed=110)
                   if scene == "sparse" else make_pair(96, 144, 4, seed=100))
    lp, rp = pair_paths(tmp_path, "p", left, right)
    j, t = run_both(tmp_path, lambda d: [
        FOREST, lp, rp, "--disp-high", "32", "--pyramid", "2", "--contract",
        contract, "--out", str(d / "d.png"), "--supports-out",
        str(d / "s.txt"), "--densify", str(d / "dense.png")], capfd)
    assert t.rc == 0
    assert ("chunk-compacted pyramid" in t.err) == (
        scene == "sparse" and contract == "auto")
    assert ("overflow:" in t.err) == (
        scene == "dense" and contract == "masked-compact")
    j, t = run_both(tmp_path, lambda d: [
        FOREST, lp, rp, "--pyramid", "2", "--contract", "rows", "--out",
        str(d / "d.png")], capfd, tag="bad")
    assert t.rc == 1


def test_cli_repeats_and_capacity(tmp_path, capfd):
    """--repeats times the best of N runs (same outputs); --capacity
    below the support count trims to the first supports in output order
    with the JAX CLI's warning, on every contract."""
    lp, rp = pair_paths(tmp_path, "p", *make_pair(96, 160, 7, seed=77))
    j, t = run_both(tmp_path, lambda d: [
        FOREST, lp, rp, "--repeats", "3", "--out", str(d / "d.png"),
        "--supports-out", str(d / "s.txt")], capfd, tag="rep")
    assert t.rc == 0
    for contract in ("rows", "masked", "flat"):
        j, t = run_both(tmp_path, lambda d: [
            FOREST, lp, rp, "--capacity", "100", "--contract", contract,
            "--out", str(d / "d.png"), "--supports-out", str(d / "s.txt"),
            "--densify", str(d / "dense.png")], capfd, tag=contract)
        assert "WARNING" in t.err
        assert len(read_supports(str(tmp_path / f"{contract}_torch" /
                                     "s.txt"))) == 100


@pytest.mark.parametrize("sequence", [False, True],
                         ids=["single_pair", "sequence"])
@pytest.mark.parametrize("flag", ["--data-parallel", "--shard-frame"])
def test_cli_refuses_unported_multi_device(flag, sequence, tmp_path, capfd):
    """N > 1 exits 1 before any work, naming the builders not ported."""
    left, right = make_pair(64, 96, 3, seed=5)
    if sequence:
        ldir, rdir = tmp_path / "l", tmp_path / "r"
        ldir.mkdir()
        rdir.mkdir()
        write_png(str(ldir / "f0.png"), left)
        write_png(str(rdir / "f0.png"), right)
        lp, rp = str(ldir), str(rdir)
    else:
        lp, rp = pair_paths(tmp_path, "p", left, right)
    capfd.readouterr()
    rc = tcli.main([FOREST, lp, rp, flag, "2", "--device", "cpu", "--out",
                    str(tmp_path / "o" / "d.png")])
    err = capfd.readouterr().err
    assert rc == 1
    assert f"{flag} 2: " in err and "not ported to opengpc_tpu_torch" in err
    assert "parallel.build_batched_" in err
    assert not (tmp_path / "o").exists()
    # N = 1 is a no-op, as in the JAX CLI
    assert tcli.main([FOREST, lp, rp, flag, "1", "--device", "cpu", "--out",
                      str(tmp_path / "o" / "d.png")]) == 0


def test_auto_compact_threshold_and_probe_equal_jax():
    """The auto cutoff tracks the contract's chunk capacity as in the JAX
    CLI, and the density probe gives JAX's float32 mean exactly."""
    for masked in (True, False):
        for width in (96, 256, 1024, 4096):
            assert tcli._auto_compact_threshold(masked, width) == \
                jcli._auto_compact_threshold(masked, width)
    import opengpc_tpu as jt

    for gt in (5, 10, 40):
        settings = InferenceSettings(gradient_threshold=gt)
        jset = jt.InferenceSettings(gradient_threshold=gt)
        for left, right in (make_pair(96, 144, 4, seed=1),
                            make_sparse_pair(96, 144, 4, density=0.15,
                                             seed=2),
                            make_sparse_pair(160, 256, 8, density=0.3,
                                             seed=9),
                            scene_pair(37, 61, 3)):
            got = tcli._probe_density(settings, left, right,
                                      torch.device("cpu"))
            assert got == jcli._probe_density(jset, left, right)


def test_cli_input_errors_report_cleanly(tmp_path, capfd):
    """Missing and corrupt inputs exit 1 with a one-line ``error:``
    message; OGPC_CLI_TRACEBACK=1 re-raises."""
    lp, rp = pair_paths(tmp_path, "p", *make_pair(64, 96, 4, seed=3))
    bad_forest = str(tmp_path / "bad.txt")
    with open(bad_forest, "w") as f:
        f.write("not a forest\n")
    bad_png = str(tmp_path / "bad.png")
    with open(bad_png, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\nnot really")
    missing = str(tmp_path / "missing.txt")
    for argv in ([missing, lp, rp], [bad_forest, lp, rp],
                 [FOREST, bad_png, rp]):
        j, t = run_both(tmp_path, lambda d: argv + ["--out",
                                                    str(d / "o.png")],
                        capfd, tag=os.path.basename(argv[0]) + argv[1][-5:],
                        same_err=False)
        assert t.rc == 1
        assert "error:" in t.err and "Traceback" not in t.err, t.err
    os.environ["OGPC_CLI_TRACEBACK"] = "1"
    try:
        with pytest.raises(FileNotFoundError):
            tcli.main([missing, lp, rp, "--out", str(tmp_path / "o.png"),
                       "--device", "cpu"])
    finally:
        del os.environ["OGPC_CLI_TRACEBACK"]
    capfd.readouterr()


def test_cli_runs_as_module(tmp_path):
    """``python -m opengpc_tpu_torch.cli.sparsematch`` in a process that
    imports no JAX writes the in-process CLI's files."""
    lp, rp = pair_paths(tmp_path, "p", *make_pair(64, 96, 3, seed=5))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [os.sys.executable, "-m", "opengpc_tpu_torch.cli.sparsematch",
         FOREST, lp, rp, "--device", "cpu", "--out", str(tmp_path / "a.png"),
         "--supports-out", str(tmp_path / "a.txt")], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "tTotal:" in proc.stdout and "tAssemble" in proc.stdout
    assert tcli.main([FOREST, lp, rp, "--device", "cpu", "--out",
                      str(tmp_path / "b.png"), "--supports-out",
                      str(tmp_path / "b.txt")]) == 0
    for a, b in (("a.png", "b.png"), ("a.txt", "b.txt")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes()
