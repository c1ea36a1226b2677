"""The port's CLIs over gloo ranks against the JAX CLIs on the conftest's 8
virtual CPU devices.

Each case starts the port's ``sparsematch`` or ``train`` CLI as N
subprocess ranks with the environment ``torchrun`` would give them (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR=127.0.0.1 and a free MASTER_PORT) and
``--device cpu``, and runs the JAX CLI in process with the same flags.
Every file must be byte-identical; rank 0's stdout must be the one-device
port CLI's (its float timings aside) and the other ranks' empty.  Covered:
single pair (``--shard-frame``, with ``--pyramid`` and in global mode with
its overflow), sequence mode (``--data-parallel``, ``--shard-frame`` and
both, across a dense stretch: the probe, the overflow re-run and the
hysteresis) and ``cli.train --data-parallel`` with a bootstrap that the
ranks do not divide.  The refusals: N > 1 without a torchrun launch, and
D x N other than WORLD_SIZE.
"""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

import opengpc_tpu.cli.sparsematch as jcli
import opengpc_tpu.cli.train as jtrain_cli
import opengpc_tpu_torch.cli.sparsematch as tcli
import opengpc_tpu_torch.cli.train as ttrain_cli
from opengpc_tpu_torch.io import write_png
from opengpc_tpu_torch.io.triplets import save_triplets
from opengpc_tpu_torch.utils import make_pair, make_sparse_pair
from test_torch_cli import FOREST, _files
from test_train import make_triplets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(module, argv, n, cwd, timeout=240):
    """``python -m module argv`` as n ranks of one launch: [(rc, stdout,
    stderr)] in rank order.  A rank still running at the timeout is
    killed and fails the test."""
    port = str(_free_port())
    procs = []
    for rank in range(n):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *argv], env=env, cwd=cwd,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def in_process(main, argv, capfd):
    capfd.readouterr()
    rc = main(argv)
    out, err = capfd.readouterr()
    return rc, out, err


def untimed(stdout: str) -> str:
    """A report with its float readings (times, rates) masked."""
    return re.sub(r"\d+\.\d+", "#", stdout)


def check_launch(ranks, one_device, jax_dir, port_dir, one_dir):
    """Every rank exited 0, rank 0 printed the one-device CLI's report
    (paths aside), the others nothing, and the launch wrote the JAX CLI's
    files, which are the one-device port CLI's: byte for byte, the lines
    of a supports file as a set (the sharded pyramid writes its supports
    in per-rank blocks, as JAX's does)."""
    assert all(rc == 0 for rc, _, _ in ranks), [e for _, _, e in ranks]
    assert untimed(ranks[0][1]).replace(str(port_dir), "D") == \
        untimed(one_device[1]).replace(str(one_dir), "D")
    assert all(out == "" for _, out, _ in ranks[1:])
    want = _files(jax_dir)
    assert want and _files(port_dir) == want
    one = _files(one_dir)
    assert sorted(one) == sorted(want)
    for name, data in want.items():
        if name.endswith(".txt"):
            assert sorted(one[name].splitlines()) == \
                sorted(data.splitlines()), name
        else:
            assert one[name] == data, name


def one_device_flags(flags):
    """``flags`` without --data-parallel / --shard-frame and their
    values."""
    out, skip = [], False
    for f in flags:
        if skip:
            skip = False
        elif f in ("--data-parallel", "--shard-frame"):
            skip = True
        else:
            out.append(f)
    return out


def pair_pngs(tmp_path, left, right):
    lp, rp = tmp_path / "l.png", tmp_path / "r.png"
    write_png(str(lp), left)
    write_png(str(rp), right)
    return str(lp), str(rp)


SINGLE = {
    "shard2": (2, ["--shard-frame", "2", "--disp-high", "32"], "sparse"),
    "shard4_pyramid2": (4, ["--shard-frame", "4", "--pyramid", "2",
                            "--disp-high", "32"], "dense"),
    "shard2_global": (2, ["--shard-frame", "2", "--global-mode",
                          "--disp-high", "32"], "dense"),
}


@pytest.mark.parametrize("case", list(SINGLE))
def test_cli_single_pair_over_ranks(case, tmp_path, capfd):
    """Single pair ``--shard-frame N``: the row-sharded masked contract,
    the sharded pyramid and the distributed global sort (a dense pair
    overflows it onto the single-device matcher): supports, disparity.png
    and --densify PNG equal the JAX CLI's."""
    n, flags, scene = SINGLE[case]
    pair = (make_pair(112, 144, 4, seed=31) if scene == "dense"
            else make_sparse_pair(112, 144, 4, density=0.15, seed=32))
    lp, rp = pair_pngs(tmp_path, *pair)

    def argv(d):
        return [FOREST, lp, rp, *flags, "--out", str(d / "d.png"),
                "--supports-out", str(d / "s.txt"), "--densify",
                str(d / "dense.png")]

    dirs = {k: tmp_path / k for k in ("jax", "port", "one")}
    for d in dirs.values():
        d.mkdir()
    j = in_process(jcli.main, argv(dirs["jax"]), capfd)
    assert j[0] == 0, j[2]
    ranks = launch("opengpc_tpu_torch.cli.sparsematch",
                   argv(dirs["port"]) + ["--device", "cpu"], n, tmp_path)
    one = in_process(tcli.main, one_device_flags(argv(dirs["one"])) + [
        "--device", "cpu"], capfd)
    assert one[0] == 0
    check_launch(ranks, one, dirs["jax"], dirs["port"], dirs["one"])
    if case == "shard2_global":
        assert "global-compact overflow" in j[2]
        assert "global-compact overflow" in ranks[0][2]


def sequence_dirs(tmp_path):
    """10 pairs at 96x144: 3 sparse, 4 dense, 3 sparse."""
    ldir, rdir = tmp_path / "left", tmp_path / "right"
    ldir.mkdir()
    rdir.mkdir()
    for i in range(10):
        left, right = (make_pair(96, 144, 4, seed=70 + i) if 3 <= i < 7
                       else make_sparse_pair(96, 144, 4, density=0.15,
                                             seed=80 + i))
        write_png(str(ldir / f"f{i:04d}.png"), left)
        write_png(str(rdir / f"f{i:04d}.png"), right)
    return str(ldir), str(rdir)


SEQUENCE = {
    "data2": (2, ["--data-parallel", "2", "--batch", "4"]),
    "data2_shard2": (4, ["--data-parallel", "2", "--shard-frame", "2",
                         "--batch", "4"]),
    "shard2_pyramid2": (2, ["--shard-frame", "2", "--pyramid", "2",
                            "--batch", "2"]),
}


@pytest.mark.parametrize("case", list(SEQUENCE))
def test_cli_sequence_over_ranks(case, tmp_path, capfd):
    """Sequence mode over ranks across a dense stretch: the batched
    contracts (the density probe picks masked-compact, the dense groups
    overflow and re-run on rank 0, the hysteresis routes the dense frames
    and resumes), the D x N grid and the sharded pyramid: every
    supports_NNNN.txt equals the JAX CLI's."""
    n, flags = SEQUENCE[case]
    ldir, rdir = sequence_dirs(tmp_path)

    def argv(d):
        return [FOREST, ldir, rdir, *flags, "--disp-high", "32", "--out",
                str(d / "d.png")]

    dirs = {k: tmp_path / k for k in ("jax", "port", "one")}
    j = in_process(jcli.main, argv(dirs["jax"]), capfd)
    assert j[0] == 0, j[2]
    ranks = launch("opengpc_tpu_torch.cli.sparsematch",
                   argv(dirs["port"]) + ["--device", "cpu"], n, tmp_path)
    one = in_process(tcli.main, one_device_flags(argv(dirs["one"])) + [
        "--device", "cpu"], capfd)
    assert one[0] == 0, one[2]
    check_launch(ranks, one, dirs["jax"], dirs["port"], dirs["one"])
    if case == "data2":
        assert "chunk-compacted masked contract" in ranks[0][2]
        assert "masked-compact overflow" in ranks[0][2]
        assert "resuming the compact contract" in ranks[0][2]


@pytest.mark.parametrize("n,kind", [(2, "zero"), (4, "tau")])
def test_cli_train_over_ranks(n, kind, tmp_path, capfd):
    """``cli.train --data-parallel N`` over N gloo ranks: a 205-triplet
    set whose 143-triplet bootstraps the ranks do not divide; the forest
    file equals the JAX CLI's with the same flags and the one-device
    port's."""
    trips = str(tmp_path / "t.bin")
    save_triplets(make_triplets(np.random.default_rng(9), 205), trips)
    flags = ["--num-s", "1", "--num-m", "1", "--num-l", "1", "--depth", "3",
             "--num-resamples", "4", "--fern-type", kind, "--seed", "2"]
    paths = {k: str(tmp_path / f"{k}.txt") for k in ("jax", "port", "one")}
    j = in_process(jtrain_cli.main, [trips, paths["jax"], *flags,
                                     "--data-parallel", str(n)], capfd)
    assert j[0] == 0, j[2]
    ranks = launch("opengpc_tpu_torch.cli.train",
                   [trips, paths["port"], *flags, "--data-parallel", str(n),
                    "--device", "cpu"], n, tmp_path)
    assert all(rc == 0 for rc, _, _ in ranks), [e for _, _, e in ranks]
    one = in_process(ttrain_cli.main, [trips, paths["one"], *flags,
                                       "--device", "cpu"], capfd)
    assert one[0] == 0
    assert untimed(ranks[0][1]).replace(paths["port"], "F") == \
        untimed(one[1]).replace(paths["one"], "F")
    assert all(out == "" for _, out, _ in ranks[1:])
    want = open(paths["jax"], "rb").read()
    assert open(paths["port"], "rb").read() == want
    assert open(paths["one"], "rb").read() == want


@pytest.mark.parametrize("argv,flags", [
    (["single"], ["--shard-frame", "2"]),
    (["sequence"], ["--data-parallel", "2", "--shard-frame", "1"]),
    (["train"], ["--data-parallel", "2"]),
], ids=["single_pair", "sequence", "train"])
def test_cli_refuses_ranks_unlike_world_size(argv, flags, tmp_path, capsys,
                                             monkeypatch):
    """Under a torchrun environment D x N must be WORLD_SIZE (an unset
    flag counts as 1): exit 1 before any work."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "4")
    left, right = make_pair(64, 96, 3, seed=5)
    lp, rp = pair_pngs(tmp_path, left, right)
    out = str(tmp_path / "o" / "d.png")
    if argv == ["train"]:
        trips = str(tmp_path / "t.bin")
        save_triplets(make_triplets(np.random.default_rng(1), 8), trips)
        rc = ttrain_cli.main([trips, str(tmp_path / "f.txt"), *flags,
                              "--device", "cpu"])
        assert "WORLD_SIZE=4" in capsys.readouterr().err
        assert rc == 1 and not os.path.exists(tmp_path / "f.txt")
        return
    rc = tcli.main([FOREST, lp if argv == ["single"] else str(tmp_path),
                    rp if argv == ["single"] else str(tmp_path), *flags,
                    "--device", "cpu", "--out", out])
    assert rc == 1
    assert "WORLD_SIZE=4" in capsys.readouterr().err
    assert not (tmp_path / "o").exists()
