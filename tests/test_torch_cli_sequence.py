"""The port's ``sparsematch`` CLI in sequence (directory) mode against the
JAX package's.

Both CLIs run in process on the same frame directories (the port with
``--device cpu``); every per-frame ``supports_NNNN.txt`` and
``dense_NNNN.png`` must be byte-identical and the exit codes equal.  The
port's files are also held to the checks of the JAX package's own
sequence tests (``tests/test_api.py``): each frame equal to a single-pair
run or to an independent contract, the density probe, the overflow
fallback and the hysteresis taken where they must be.  Where the pipeline's
timing decides how many dense frames reach the compact contract before the
flag is seen, the notices are checked by their bounds, not compared.
"""

import os

import numpy as np
import pytest
import torch

import opengpc_tpu.cli.sparsematch as jcli
import opengpc_tpu_torch.cli.sparsematch as tcli
from opengpc_tpu_torch import (InferenceSettings, build_sparsematch,
                               load_forest, supports_to_numpy)
from opengpc_tpu_torch.io import read_supports, write_png
from opengpc_tpu_torch.utils import make_sparse_pair
from test_api import make_pair
from test_torch_cli import FOREST, run_both

DH = ["--disp-high", "32"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's intra-op threads only add overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frame_dirs(tmp_path, frames, tag=""):
    ldir, rdir = tmp_path / f"{tag}left", tmp_path / f"{tag}right"
    ldir.mkdir()
    rdir.mkdir()
    for i, (left, right) in enumerate(frames):
        write_png(str(ldir / f"f{i:04d}.png"), left)
        write_png(str(rdir / f"f{i:04d}.png"), right)
    return str(ldir), str(rdir)


def seq(dirs, *extra):
    """argv of a sequence run writing under ``d/out``."""
    return lambda d: [FOREST, *dirs, *DH, "--out",
                      str(d / "out" / "d.png"), *extra]


def run_over_ranks(tmp_path, argv, n, capfd, tag):
    """The JAX CLI in process and the port's over n gloo ranks (``--device
    cpu``) on ``argv(out_dir)``, into ``<tag>_jax`` and ``<tag>_torch``:
    equal exit codes and byte-identical files.  Returns rank 0's Run."""
    from test_torch_cli import Run, _files
    from test_torch_cli_parallel import launch

    jd, td = tmp_path / f"{tag}_jax", tmp_path / f"{tag}_torch"
    jd.mkdir()
    td.mkdir()
    capfd.readouterr()
    jrc = jcli.main(argv(jd))
    capfd.readouterr()
    ranks = launch("opengpc_tpu_torch.cli.sparsematch",
                   argv(td) + ["--device", "cpu"], n, tmp_path)
    assert all(rc == jrc for rc, _, _ in ranks), [e for _, _, e in ranks]
    assert _files(td) == _files(jd), tag
    return Run(ranks[0][0], ranks[0][2], _files(td))


def frame_sets(out_dir, n):
    return [sorted(map(tuple, read_supports(
        str(out_dir / f"supports_{i:04d}.txt")).tolist())) for i in range(n)]


def flat_frames(frames, epipolar=True):
    settings = InferenceSettings(gradient_threshold=5, vertical_tolerance=0,
                                 disp_high=32, epipolar_mode=epipolar,
                                 capacity=1 << 16)
    m = build_sparsematch(load_forest(FOREST), settings, device="cpu")
    return [sorted(map(tuple, supports_to_numpy(*m(
        torch.from_numpy(l), torch.from_numpy(r))).tolist()))
        for l, r in frames]


def single_pyramid_sets(tmp_path, dirs, n, capfd):
    """Single-pair ``--pyramid 2`` runs of the port, one a frame."""
    out = []
    for i in range(n):
        sp = tmp_path / f"single_{i}.txt"
        assert tcli.main([FOREST, os.path.join(dirs[0], f"f{i:04d}.png"),
                          os.path.join(dirs[1], f"f{i:04d}.png"), *DH,
                          "--pyramid", "2", "--out",
                          str(tmp_path / "sp.png"), "--supports-out",
                          str(sp), "--device", "cpu"]) == 0
        out.append(sorted(map(tuple, read_supports(str(sp)).tolist())))
    capfd.readouterr()
    return out


@pytest.mark.parametrize("extra", [[], ["--batch", "3"],
                                   ["--batch", "2", "--contract", "masked"]],
                         ids=["default", "batch3", "masked_batch2"])
def test_cli_sequence_shape_change(extra, tmp_path, capfd):
    """12 frames with a mid-sequence shape change (flat fallback for the
    odd shape, batched groups flushed, a leftover group): every frame
    equals a single-pair flat run and the JAX CLI's bytes."""
    frames = [make_pair(72, 112, 3 + (i % 4), seed=50 + i) if i in (5, 6)
              else make_pair(96, 144, 3 + (i % 4), seed=50 + i)
              for i in range(12)]
    dirs = frame_dirs(tmp_path, frames)
    j, t = run_both(tmp_path, seq(dirs, *extra), capfd)
    assert t.rc == 0
    want = flat_frames(frames)
    assert min(map(len, want)) > 50
    assert frame_sets(tmp_path / "run_torch" / "out", 12) == want
    if extra[:2] == ["--batch", "3"]:
        # --batch outside sequence mode is rejected
        j, t = run_both(tmp_path, lambda d: [
            FOREST, os.path.join(dirs[0], "f0000.png"),
            os.path.join(dirs[1], "f0000.png"), "--batch", "2", "--out",
            str(d / "d.png")], capfd, tag="single")
        assert t.rc == 1
    if "masked" in extra:
        j, t = run_both(tmp_path, seq(dirs, "--global-mode", "--contract",
                                      "masked"), capfd, tag="bad")
        assert t.rc == 1


def test_cli_sequence_mode_global_rows(tmp_path, capfd):
    frames = [make_pair(80, 128, 2 + i, seed=60 + i) for i in range(5)]
    dirs = frame_dirs(tmp_path, frames)
    j, t = run_both(tmp_path, seq(dirs, "--global-mode", "--batch", "2"),
                    capfd)
    assert t.rc == 0
    want = flat_frames(frames, epipolar=False)
    assert min(map(len, want)) > 50
    assert frame_sets(tmp_path / "run_torch" / "out", 5) == want


def _mixed(dense_at, n, dense_seed=50, sparse_seed=60):
    return [make_pair(96, 144, 4, seed=dense_seed) if i == dense_at
            else make_sparse_pair(96, 144, 4, density=0.15,
                                  seed=sparse_seed + i) for i in range(n)]


def test_cli_sequence_global_compact(tmp_path, capfd):
    """A sparse global sequence rides global-compact through the probe; a
    dense frame in a --batch 2 group overflows and the dispatch re-runs
    full-width."""
    frames = _mixed(3, 6)
    dirs = frame_dirs(tmp_path, frames)
    j, t = run_both(tmp_path, seq(dirs, "--global-mode", "--batch", "2"),
                    capfd, same_err=False)
    assert "chunk-compacted global contract" in t.err, t.err
    assert "global-compact overflow" in t.err, t.err
    assert frame_sets(tmp_path / "run_torch" / "out", 6) == \
        flat_frames(frames, epipolar=False)


def test_cli_sequence_masked_compact(tmp_path, capfd):
    """--contract masked-compact with a dense frame inside a --batch 2
    group: the overflow re-run on the writer thread, every frame equal to
    an explicit rows run."""
    frames = _mixed(5, 8)
    dirs = frame_dirs(tmp_path, frames)
    j, c = run_both(tmp_path, seq(dirs, "--batch", "2", "--contract",
                                  "masked-compact"), capfd, tag="compact",
                    same_err=False)
    assert "masked-compact overflow" in c.err, c.err
    j, r = run_both(tmp_path, seq(dirs, "--batch", "2", "--contract", "rows"),
                    capfd, tag="rows")
    got = frame_sets(tmp_path / "compact_torch" / "out", 8)
    want = frame_sets(tmp_path / "rows_torch" / "out", 8)
    assert got == want and sum(map(len, want)) > 400


def test_cli_sequence_pyramid(tmp_path, capfd):
    """Sequence --pyramid 2: the batched rows pyramid, a shape change
    dispatched through the same builder; every frame equals a single-pair
    --pyramid run.  Incompatible combinations exit 1."""
    frames = [make_pair(72, 112, 3, seed=94) if i == 4
              else make_pair(96, 144, 2 + (i % 3), seed=90 + i)
              for i in range(7)]
    dirs = frame_dirs(tmp_path, frames)
    j, t = run_both(tmp_path, lambda d: seq(dirs, "--pyramid", "2")(d) + [
        "--densify", str(d / "dense")], capfd)
    assert t.rc == 0
    want = single_pyramid_sets(tmp_path, dirs, 7, capfd)
    assert min(map(len, want)) > 50
    assert frame_sets(tmp_path / "run_torch" / "out", 7) == want
    j, t = run_both(tmp_path, seq(dirs, "--pyramid", "2", "--contract",
                                  "masked"), capfd, tag="bad")
    assert t.rc == 1 and "sequence --pyramid" in t.err


def test_cli_sequence_pyramid_density_adaptive(tmp_path, capfd):
    """A sparse pyramid sequence probes onto the compact pyramid; a dense
    frame overflows onto the rows pyramid; every frame equals a
    single-pair --pyramid run."""
    frames = _mixed(3, 6, dense_seed=100, sparse_seed=110)
    dirs = frame_dirs(tmp_path, frames)
    j, t = run_both(tmp_path, seq(dirs, "--pyramid", "2", "--batch", "1"),
                    capfd, same_err=False)
    assert "chunk-compacted pyramid" in t.err, t.err
    assert "pyramid-compact overflow" in t.err, t.err
    assert frame_sets(tmp_path / "run_torch" / "out", 6) == \
        single_pyramid_sets(tmp_path, dirs, 6, capfd)


def test_cli_sequence_overflow_hysteresis(tmp_path, capfd):
    """A 6-frame dense stretch trips the overflow once or a few times
    (pipeline lag), then dense frames go straight to the full-width
    builder; the first sparse frame resumes compact.  Every frame equals
    an explicit rows run."""
    n, dense = 14, set(range(4, 10))
    frames = [make_pair(96, 144, 4, seed=70 + i) if i in dense
              else make_sparse_pair(96, 144, 4, density=0.15, seed=80 + i)
              for i in range(n)]
    dirs = frame_dirs(tmp_path, frames)
    j, c = run_both(tmp_path, seq(dirs, "--batch", "1", "--contract",
                                  "masked-compact"), capfd, tag="compact",
                    same_err=False)
    assert 1 <= c.err.count("masked-compact overflow") <= 4, c.err
    assert "resuming the compact contract" in c.err, c.err
    j, r = run_both(tmp_path, seq(dirs, "--batch", "1", "--contract",
                                  "rows"), capfd, tag="rows")
    want = frame_sets(tmp_path / "rows_torch" / "out", n)
    assert frame_sets(tmp_path / "compact_torch" / "out", n) == want
    assert sum(map(len, want)) > 400


@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_cli_sequence_auto_density_adaptive(kind, tmp_path, capfd):
    frames = [make_sparse_pair(96, 144, 4, density=0.15, seed=80 + i)
              if kind == "sparse" else make_pair(96, 144, 4, seed=80 + i)
              for i in range(4)]
    dirs = frame_dirs(tmp_path, frames)
    j, a = run_both(tmp_path, seq(dirs), capfd, tag="auto")
    assert ("auto contract: candidate density" in a.err) == (
        kind == "sparse"), a.err
    j, r = run_both(tmp_path, seq(dirs, "--contract", "rows"), capfd,
                    tag="rows")
    want = frame_sets(tmp_path / "rows_torch" / "out", 4)
    assert frame_sets(tmp_path / "auto_torch" / "out", 4) == want
    assert sum(map(len, want)) > 200


def test_cli_sequence_densify_and_rejections(tmp_path, capfd):
    """Sequence --densify writes dense_NNNN.png into its directory, each
    byte-identical to the single-pair --densify PNG of that frame and to
    the JAX CLI's; single-pair-only flags exit 1."""
    frames = [make_pair(64, 96, 3, seed=80 + i) for i in range(3)]
    ld, rd = frame_dirs(tmp_path, frames)
    base = [FOREST, ld, rd, "--disp-high", "16"]
    j, t = run_both(tmp_path, lambda d: base + [
        "--out", str(d / "seq" / "d.png"), "--densify", str(d / "dense")],
        capfd)
    dense_dir = tmp_path / "run_torch" / "dense"
    for i in range(3):
        assert (dense_dir / f"dense_{i:04d}.png").exists(), i
    single = tmp_path / "single_dense.png"
    assert tcli.main([FOREST, os.path.join(ld, "f0001.png"),
                      os.path.join(rd, "f0001.png"), "--disp-high", "16",
                      "--out", str(tmp_path / "s.png"), "--densify",
                      str(single), "--device", "cpu"]) == 0
    assert single.read_bytes() == (dense_dir / "dense_0001.png").read_bytes()
    for k, extra in enumerate((["--matcher", "quirk"], ["--repeats", "3"],
                               ["--trace", str(tmp_path / "tr")])):
        j, t = run_both(tmp_path, lambda d: base + [
            "--out", str(d / "seq" / "d.png")] + extra, capfd, tag=f"x{k}")
        assert t.rc == 1


def test_cli_sequence_randomized_policy_fuzz(tmp_path, capfd):
    """Random density patterns x --batch x pyramid through the adaptive
    policy (probe, compact, overflow guard, hysteresis, resume): each
    frame equals a non-adaptive baseline and the JAX CLI's bytes.  The
    draw is the JAX test's; its --data-parallel 2 trials run the port over
    2 gloo ranks (``test_torch_cli_parallel.launch``) against the JAX CLI
    with the flag on its virtual devices."""
    seed = int(os.environ.get("OGPC_FUZZ_SEED", 20260819))
    trials = int(os.environ.get("OGPC_FUZZ_TRIALS", 2))
    rng = np.random.default_rng(seed)
    for t in range(trials):
        n = int(rng.integers(5, 11))
        p_dense = float(rng.uniform(0.2, 0.8))
        dense = rng.random(n) < p_dense
        pyramid = bool(rng.integers(0, 2))
        dp = int(rng.choice([1, 2]))
        batch = int(rng.choice([2, 4]) if dp == 2 else rng.integers(1, 5))
        frames = [make_pair(96, 144, 4, seed=1000 * t + i) if dense[i]
                  else make_sparse_pair(96, 144, 4,
                                        density=float(rng.uniform(0.08, 0.2)),
                                        seed=5000 + 1000 * t + i)
                  for i in range(n)]
        dirs = frame_dirs(tmp_path, frames, tag=f"t{t}")
        extra = ["--batch", str(batch)] + (
            ["--pyramid", "2"] if pyramid else ["--contract",
                                                "masked-compact"])
        label = (t, n, p_dense, pyramid, dp, batch)
        if dp == 2:
            r = run_over_ranks(tmp_path, seq(dirs, *extra, "--data-parallel",
                                             "2"), 2, capfd, tag=f"t{t}")
        else:
            j, r = run_both(tmp_path, seq(dirs, *extra), capfd, tag=f"t{t}",
                            same_err=False)
        assert r.rc == 0, (label, r.err)
        if pyramid:
            want = single_pyramid_sets(tmp_path, dirs, n, capfd)
        else:
            j, b = run_both(tmp_path, seq(dirs, "--contract", "rows"), capfd,
                            tag=f"rows{t}")
            want = frame_sets(tmp_path / f"rows{t}_torch" / "out", n)
        assert frame_sets(tmp_path / f"t{t}_torch" / "out", n) == want, label
        assert sum(map(len, want)) > 50 * n, label
