"""AOT export and serving through ``torch.export`` (``opengpc_tpu_torch.aot``,
``cli.aot``, ``examples/serve_torch.py``) against the JAX package's
``jax.export`` artifacts, on the CPU with the same seeded inputs.

For every contract the port's export -> save -> load output equals the
live port module and the JAX package's loaded artifact
(``use_pallas=False``) bit for bit.  The eligibility refusals are JAX's,
the compact contracts raise ``OverflowError`` on a dense frame, and each
package refuses the other's artifacts.  The CLI's supports files and the
serve example's files are byte-identical to the JAX CLI's and
``examples/serve.py``'s.  The sharded artifacts (one program a rank) run
over 2 gloo ranks in subprocesses (``tests/torch_gloo_worker.py aot``)
and equal JAX's sharded artifacts on the conftest's virtual devices.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import opengpc_tpu.aot as jaot
import opengpc_tpu.cli.aot as jcli
from opengpc_tpu.config import InferenceSettings as JSettings
from opengpc_tpu.forest import load_forest as jload_forest
from opengpc_tpu.forest import make_filter_mask as jmake_mask
from opengpc_tpu.parallel import make_mesh, make_mesh_2d

import opengpc_tpu_torch as pt
import opengpc_tpu_torch.aot as taot
import opengpc_tpu_torch.cli.aot as tcli
from opengpc_tpu_torch.io import write_png
from opengpc_tpu_torch.parallel import build_sharded_frame_sparsematch
from opengpc_tpu_torch.utils import make_pair, make_sparse_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZERO = os.path.join(REPO, "forests", "defaultZeroForest.txt")
H, W = 96, 144
GLOO_H, GLOO_W = 112, 96  # 56-row shards at n = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def settings_pair(epipolar=True, **kw):
    kw = dict(dict(gradient_threshold=5, epipolar_mode=epipolar, disp_high=32,
                   vertical_tolerance=0 if epipolar else 1, capacity=8192),
              **kw)
    return JSettings(**kw), pt.InferenceSettings(**kw)


def masks(path=ZERO):
    return jmake_mask(jload_forest(path)), pt.make_filter_mask(
        pt.load_forest(path))


def leaves(out):
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in leaves(o)]
    return [out]


def assert_same(jout, tout):
    for j, t in zip(leaves(jout), leaves(tout), strict=True):
        want = np.asarray(j)
        got = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def sparse_scene(h, w, seed=15):
    """tests/test_aot.py's low-density texture: pyramid-compact stays
    under its chunk caps."""
    rng = np.random.default_rng(seed)
    base = np.zeros((h, w + 4), np.float32)
    ys, xs = rng.integers(4, h - 4, 220), rng.integers(4, w - 4, 220)
    base[ys, xs] = rng.integers(64, 255, 220)
    for _ in range(2):
        base = (np.roll(base, 1, 0) + np.roll(base, -1, 0)
                + np.roll(base, 1, 1) + np.roll(base, -1, 1) + base) / 5
    scene = base.astype(np.uint8)
    return scene[:, :w].copy(), scene[:, 4:].copy()


def scene_for(contract):
    """The low-density scene for the pyramids and the compact contracts
    (no overflow), a dense pair for the rest."""
    return (sparse_scene(H, W) if contract.startswith("pyramid")
            or contract.endswith("compact") else make_pair(H, W, 4, seed=11))


def save_port(path, contract, ts, levels=3):
    blob = taot.export_sparsematch(pt.make_filter_mask(pt.load_forest(ZERO)),
                                   ts, (H, W), contract, device="cpu",
                                   num_levels=levels)
    extra = {"num_levels": levels} if contract.startswith("pyramid") else None
    taot.save_artifact(path, blob, contract=contract, settings=ts,
                       shape=(H, W), device="cpu", extra=extra)
    return blob


@pytest.mark.parametrize("contract", taot.CONTRACTS)
def test_round_trip_equals_live_module_and_jax(contract, tmp_path):
    """export -> save -> load -> call equals the live port module and the
    JAX package's loaded artifact bit for bit; the container routes the
    decode from its header (the pyramid contracts as tests/test_aot.py
    checks them: arrays, then the decoded (x, y, d, level) set)."""
    js, ts = settings_pair(not contract.startswith("global"))
    jm, tm = masks()
    left, right = scene_for(contract)
    path = str(tmp_path / "m.ogpcx")
    blob = save_port(path, contract, ts)
    call, meta = taot.load_artifact(path)
    assert meta["contract"] == contract and meta["shape"] == [H, W]
    assert meta["package"] == "opengpc_tpu_torch" and meta["device"] == "cpu"
    assert meta["use_pallas"] is False
    got = call(left, right)
    live = taot._module_for(contract, tm, ts, (H, W), torch.device("cpu"))(
        torch.from_numpy(left), torch.from_numpy(right))
    assert all(torch.equal(a, b) for a, b in
               zip(leaves(got), leaves(live), strict=True))
    assert_same(jaot.load_sparsematch(jaot.export_sparsematch(
        jm, js, (H, W), contract, use_pallas=False))(left, right), got)
    assert_same(got, taot.load_sparsematch(blob)(torch.from_numpy(left),
                                                 torch.from_numpy(right)))
    if contract.endswith("compact"):
        assert not bool(got[-1])
    sup = taot.decode_outputs(meta, got)
    jsup = jaot.decode_outputs(
        {**meta, "contract": contract},
        tuple(np.asarray(x) if not isinstance(x, tuple)
              else tuple(np.asarray(y) for y in x) for x in got))
    assert set(map(tuple, sup.tolist())) == set(map(tuple, jsup.tolist()))
    assert sup.shape[1] == (4 if contract.startswith("pyramid") else 3)
    assert len(sup) > 50
    if contract.startswith("pyramid"):
        assert (sup[:, 3] >= 1).any(), "no coarse-level supports"


REFUSALS = [  # contract, epipolar, forest tests, shape, extra settings, match
    ("bogus", True, None, (H, W), {}, "contract"),
    ("global-rows", True, None, (H, W), {}, "epipolar_mode=False"),
    ("global-compact", True, None, (H, W), {}, "epipolar_mode=False"),
    ("global-rows", False, None, (16384, 32768), {}, "packable"),
    ("rows", False, None, (H, W), {}, "epipolar"),
    ("masked", False, None, (H, W), {}, "epipolar"),
    ("masked-compact", True, 32, (H, W), {}, "30-test"),
    ("rows", True, 32, (H, W), {}, "30-test"),
    ("pyramid-compact", False, None, (H, W), {}, "pyramid-compact"),
    ("pyramid-compact", True, None, (H, W), {"disp_high": 0},
     "pyramid-compact"),
]


@pytest.mark.parametrize("contract,epipolar,tests,shape,extra,match",
                         REFUSALS, ids=lambda v: str(v)[:24])
def test_export_refuses_as_jax_does(contract, epipolar, tests, shape, extra,
                                    match):
    """Every eligibility refusal of JAX's ``_impl_for``: the same
    condition raises ``ValueError`` of the same meaning in both
    packages."""
    js, ts = settings_pair(epipolar, **extra)
    jm, tm = masks()
    if tests:
        rng = np.random.default_rng(0)
        arrays = (rng.integers(-13, 14, (tests, 2)),
                  rng.integers(-13, 14, (tests, 2)),
                  np.zeros(tests, np.int32), 0)
        from opengpc_tpu.forest import FilterMask as JMask

        jm = JMask(*(np.asarray(a, np.int32) for a in arrays[:3]), type=0)
        tm = pt.filter_mask_from_numpy(*arrays)
    with pytest.raises(ValueError, match=match):
        taot.export_sparsematch(tm, ts, shape, contract, device="cpu")
    with pytest.raises(ValueError, match=match):
        jaot.export_sparsematch(jm, js, shape, contract, use_pallas=False)


@pytest.mark.parametrize("contract,epipolar,match", [
    ("masked-compact", True, "full-width 'masked'"),
    ("global-compact", False, "full-width 'global-rows'"),
    ("pyramid-compact", True, "full 'pyramid'")])
def test_compact_artifacts_raise_on_a_dense_frame(contract, epipolar, match,
                                                  tmp_path):
    """A dense frame through a compact artifact sets the overflow flag
    and ``decode_outputs`` raises: the frozen program cannot fall back."""
    _, ts = settings_pair(epipolar)
    path = str(tmp_path / "c.ogpcx")
    save_port(path, contract, ts)
    call, meta = taot.load_artifact(path)
    left, right = make_pair(H, W, 4, seed=16)
    out = call(left, right)
    assert bool(out[-1])
    with pytest.raises(OverflowError, match=match):
        taot.decode_outputs(meta, out)


def test_the_magics_refuse_each_other(tmp_path):
    """The port writes its own magic: JAX's loader refuses a port artifact
    ("bad magic"), the port's refuses JAX's naming the JAX package, and
    the port's peek reads both headers."""
    js, ts = settings_pair()
    jm, _ = masks()
    mine, theirs = str(tmp_path / "pt.ogpcx"), str(tmp_path / "jax.ogpcx")
    save_port(mine, "masked", ts)
    jaot.save_artifact(theirs, jaot.export_sparsematch(
        jm, js, (H, W), "masked", use_pallas=False), contract="masked",
        settings=js, shape=(H, W))
    with open(mine, "rb") as f:
        assert f.read(8) == b"OGPCPT01"
    with pytest.raises(ValueError, match="magic"):
        jaot.load_artifact(mine)
    with pytest.raises(ValueError, match="JAX package"):
        taot.load_artifact(theirs)
    assert taot.peek_artifact_meta(theirs)["package"] == "opengpc_tpu"
    assert taot.peek_artifact_meta(mine)["package"] == "opengpc_tpu_torch"
    bad = tmp_path / "bad.ogpcx"
    bad.write_bytes(b"NOTANARTIFACT")
    with pytest.raises(ValueError, match="magic"):
        taot.load_artifact(str(bad))


def test_a_cuda_artifact_never_runs_on_the_cpu(tmp_path, monkeypatch):
    """A header that says cuda on a host without CUDA raises before the
    program is read, and a CPU program refuses to be served elsewhere."""
    _, ts = settings_pair()
    blob = save_port(str(tmp_path / "cpu.ogpcx"), "masked", ts)
    path = str(tmp_path / "cuda.ogpcx")
    taot.save_artifact(path, blob, contract="masked", settings=ts,
                       shape=(H, W), device="cuda")
    assert taot.peek_artifact_meta(path)["use_pallas"] is True
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        taot.load_artifact(path)
    with pytest.raises(ValueError, match="exported for cpu"):
        taot.load_sparsematch(blob, device="cuda")
    assert tcli.main(["run", path, "l.png", "r.png"]) == 1


def test_import_loads_no_jax():
    """``opengpc_tpu_torch.aot``, its CLI and a load bring in neither jax
    nor the JAX package."""
    code = ("import sys, opengpc_tpu_torch.aot, opengpc_tpu_torch.cli.aot\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'opengpc_tpu.')) or m == 'opengpc_tpu')\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _pngs(tmp_path, left, right, name="p"):
    lp, rp = str(tmp_path / f"{name}_l.png"), str(tmp_path / f"{name}_r.png")
    write_png(lp, left)
    write_png(rp, right)
    return lp, rp


@pytest.mark.parametrize("flags", [
    [], ["--contract", "global-rows", "--global-mode"],
    ["--contract", "pyramid", "--levels", "2"]], ids=lambda f: "-".join(f))
def test_cli_export_run_matches_jax_cli(flags, tmp_path):
    """``export`` then ``run``: the supports file is byte-identical to the
    JAX CLI's for the same forest, flags and pair."""
    left, right = make_pair(H, W, 4, seed=15)
    lp, rp = _pngs(tmp_path, left, right)
    files = {}
    for name, main, device in (("jax", jcli.main, ["--pallas", "off"]),
                               ("port", tcli.main, ["--device", "cpu"])):
        art, sup = str(tmp_path / f"{name}.ogpcx"), str(tmp_path / name)
        assert main(["export", ZERO, art, "--height", str(H), "--width",
                     str(W), "--disp-high", "32", *flags, *device]) == 0
        assert main(["run", art, lp, rp, "--supports-out", sup]) == 0
        with open(sup, "rb") as f:
            files[name] = f.read()
    assert files["port"] == files["jax"] and files["port"].count(b"\n") > 50


def test_cli_refusals_have_jax_exit_codes(tmp_path, capfd):
    """The JAX CLI's refusals exit 1 in the port too; the port also
    refuses JAX's lowering flags and a --shard-frame export outside a
    torchrun launch, naming what to run instead."""
    lp, rp = _pngs(tmp_path, *make_pair(64, 96, 3, seed=16))
    x = str(tmp_path / "x.ogpcx")
    both = (
        ["export", ZERO, x, "--height", "64", "--width", "96", "--batch",
         "2"],
        ["export", ZERO, x, "--height", "64", "--width", "96", "--batch",
         "1"],
        ["export", ZERO, x, "--height", "64", "--width", "96",
         "--max-tests", "0"],
        ["export", ZERO, x, "--height", "64", "--width", "96",
         "--contract", "rows", "--global-mode"],
        ["export", ZERO, x, "--height", "64", "--width", "96",
         "--shard-frame", "4", "--data-parallel", "2", "--batch", "3"])
    for argv in both:
        assert jcli.main(argv + ["--pallas", "off"]) == 1
        assert tcli.main(argv + ["--device", "cpu"]) == 1
    capfd.readouterr()
    for flag in (["--pallas", "off"], ["--platforms", "cpu"]):
        assert tcli.main(["export", ZERO, x, "--height", "64", "--width",
                          "96", *flag]) == 1
        assert "--device" in capfd.readouterr().err
    assert tcli.main(["export", ZERO, x, "--height", "64", "--width", "96",
                      "--shard-frame", "2", "--device", "cpu"]) == 1
    assert "torchrun --nproc-per-node 2" in capfd.readouterr().err
    # run: a frame of another shape, a stacked artifact, a sharded one on
    # too few ranks, routed on the header before any load
    _, ts = settings_pair()
    art = str(tmp_path / "m.ogpcx")
    save_port(art, "masked", ts)
    assert tcli.main(["run", art, lp, rp]) == 1
    stacked, big = str(tmp_path / "s.ogpcx"), str(tmp_path / "b.ogpcx")
    taot.save_artifact(stacked, b"not-a-program", contract="masked",
                       settings=ts, shape=(64, 96), device="cpu",
                       extra={"mesh_shape": [4, 4], "batch": 4,
                              "n_devices": 16})
    taot.save_artifact(big, b"not-a-program", contract="masked",
                       settings=ts, shape=(64, 96), device="cpu",
                       extra={"n_devices": 64})
    capfd.readouterr()
    assert tcli.main(["run", stacked, lp, rp]) == 1
    assert "serve it with" in capfd.readouterr().err
    assert tcli.main(["run", big, lp, rp]) == 1
    assert "64 ranks" in capfd.readouterr().err


def test_serve_example_files_equal_jax(tmp_path):
    """examples/serve_torch.py --device cpu over two pairs writes the same
    files as examples/serve.py (supports and densify PNGs byte for byte);
    its reuse path loads the artifact without exporting."""
    ld, rd = tmp_path / "l", tmp_path / "r"
    ld.mkdir(), rd.mkdir()
    for i in range(2):
        left, right = make_pair(80, 112, 4, seed=70 + i)
        write_png(str(ld / f"f{i}.png"), left)
        write_png(str(rd / f"f{i}.png"), right)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    outs = {}
    for name, script, extra in (("jax", "serve.py", []),
                                ("port", "serve_torch.py",
                                 ["--device", "cpu"])):
        od = tmp_path / name
        cmd = [sys.executable, os.path.join(REPO, "examples", script), ZERO,
               str(ld), str(rd), str(od), "--disp-high", "16", "--densify",
               *extra]
        run = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             timeout=300)
        assert run.returncode == 0, run.stdout + run.stderr
        outs[name] = {f: (od / f).read_bytes() for f in sorted(os.listdir(od))
                      if f != "matcher.ogpcx"}
        if name == "port":
            again = subprocess.run(cmd + ["--reuse-artifact",
                                          str(od / "matcher.ogpcx")],
                                   capture_output=True, text=True, env=env,
                                   timeout=300)
            assert again.returncode == 0, again.stdout + again.stderr
            assert "exported" not in again.stdout
    assert sorted(outs["port"]) == ["dense_f0.png", "dense_f1.png", "f0.txt",
                                    "f1.txt"]
    assert outs["port"] == outs["jax"]


# -- the sharded artifacts over gloo ranks -----------------------------------


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """The inputs and both ranks' outputs of ``torch_gloo_worker.py aot``
    over 2 gloo ranks in subprocesses."""
    tmp = tmp_path_factory.mktemp("gloo_aot")
    left, right = make_sparse_pair(GLOO_H, GLOO_W, 9, density=0.3, seed=3)
    pairs = [make_pair(GLOO_H, GLOO_W, 9, seed=i) if i % 2 else
             make_sparse_pair(GLOO_H, GLOO_W, 9, density=0.3, seed=i)
             for i in range(2)]
    pleft, pright = make_pair(GLOO_H, GLOO_W, 9, seed=4)
    inputs = dict(left=left, right=right, forest=ZERO, pleft=pleft,
                  pright=pright, lefts=np.stack([p[0] for p in pairs]),
                  rights=np.stack([p[1] for p in pairs]))
    data = str(tmp / "inputs.npz")
    np.savez(data, **inputs)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    worker = os.path.join(REPO, "tests", "torch_gloo_worker.py")
    outs = [str(tmp / f"rank{r}.npz") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, worker, str(tmp / "store"), "2", str(r), data, out,
         "aot"], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r, out in enumerate(outs)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return inputs, [np.load(o) for o in outs]


def _named(rank, name):
    keys = sorted((k for k in rank.files if k.startswith(name + "/")),
                  key=lambda k: int(k.rsplit("/", 1)[1]))
    return [rank[k] for k in keys]


def _gloo_settings(global_mode=False):
    kw = dict(gradient_threshold=5, disp_high=64,
              epipolar_mode=not global_mode)
    return JSettings(**kw), pt.InferenceSettings(**kw)


@pytest.mark.parametrize("contract,frame,levels", [
    ("masked", "", 3), ("global-compact", "", 3), ("pyramid", "p", 2)])
def test_sharded_artifact_over_gloo_equals_jax(gloo, contract, frame,
                                               levels):
    """Every rank exported its program, both loaded them over a group of
    another name, and each got the whole result: JAX's sharded artifact
    on 2 virtual devices, bit for bit."""
    inputs, ranks = gloo
    jm, _ = masks()
    js, _ = _gloo_settings(contract == "global-compact")
    left, right = inputs[frame + "left"], inputs[frame + "right"]
    want = jaot.load_sharded_frame(jaot.export_sharded_frame(
        jm, js, left.shape, make_mesh(jax.devices()[:2]), contract,
        use_pallas=False, num_levels=levels))(left, right)
    for rank in ranks:
        assert_same(want, _named(rank, f"aot/{contract}"))


@pytest.mark.parametrize("grid", [(1, 2), (2, 1)])
@pytest.mark.parametrize("contract", ["masked", "pyramid"])
def test_2d_artifact_over_gloo_equals_jax(gloo, grid, contract):
    """The 2-D frame and pyramid, one program a rank of the (n_data,
    n_rows) grid, loaded over a grid made afresh: JAX's 2-D artifact on
    the same mesh shape, bit for bit."""
    inputs, ranks = gloo
    jm, _ = masks()
    js, _ = _gloo_settings()
    lefts, rights = inputs["lefts"], inputs["rights"]
    want = jaot.load_batched_sharded_frame(jaot.export_batched_sharded_frame(
        jm, js, lefts.shape[0], lefts.shape[1:], make_mesh_2d(*grid),
        contract, use_pallas=False, num_levels=2), grid)(lefts, rights)
    for rank in ranks:
        assert_same(want, _named(rank, f"aot2d/{grid[0]}x{grid[1]}/"
                                 f"{contract}"))


def test_sharded_artifact_serves_on_a_larger_world(gloo):
    """A world-1 artifact in a world of 2 runs on its first rank (the
    second gets no callable), equal to the one-rank module; the masked
    artifact rank 0 saved serves through the container on every rank,
    decoding to the single-device module's supports."""
    inputs, ranks = gloo
    _, tm = masks()
    _, ts = _gloo_settings()
    left, right = (torch.from_numpy(inputs[k]) for k in ("left", "right"))
    want = build_sharded_frame_sparsematch(tm, ts, device="cpu")(left, right)
    assert [bool(r["first_served"]) for r in ranks] == [True, False]
    assert_same(tuple(_named(ranks[0], "first")), want)
    single = pt.masked_supports_to_numpy(
        *pt.build_sparsematch_masked(tm, ts, device="cpu")(left, right),
        ts.disp_high)
    for r in ranks:
        assert set(map(tuple, r["container"].tolist())) == set(
            map(tuple, single.tolist()))
    assert len(single) > 20
    ranks_blob = ranks[0]["blob"].tobytes()
    assert len(taot._rank_programs(ranks_blob)) == 2


def test_cli_sharded_export_and_run_over_ranks(tmp_path):
    """``export --shard-frame 2`` and ``run`` as 2 ranks of a launch (the
    torchrun environment set by hand, gloo): rank 0 writes the artifact
    and the supports file, byte-identical to the JAX CLI's
    ``--shard-frame 2`` on 2 virtual devices; the other rank prints
    nothing."""
    from test_torch_cli_parallel import launch

    left, right = make_pair(GLOO_H, GLOO_W, 3, seed=17)
    lp, rp = _pngs(tmp_path, left, right)
    flags = ["--height", str(GLOO_H), "--width", str(GLOO_W), "--disp-high",
             "32", "--shard-frame", "2"]
    art, sup = str(tmp_path / "pod.ogpcx"), str(tmp_path / "port.txt")
    for argv in (["export", ZERO, art, *flags, "--device", "cpu"],
                 ["run", art, lp, rp, "--supports-out", sup]):
        ranks = launch("opengpc_tpu_torch.cli.aot", argv, 2, str(tmp_path))
        assert [rc for rc, _, _ in ranks] == [0, 0], ranks
        assert ranks[1][1] == ""
    assert taot.peek_artifact_meta(art)["n_devices"] == 2
    jart, jsup = str(tmp_path / "jpod.ogpcx"), str(tmp_path / "jax.txt")
    assert jcli.main(["export", ZERO, jart, *flags, "--pallas", "off"]) == 0
    assert jcli.main(["run", jart, lp, rp, "--supports-out", jsup]) == 0
    with open(sup, "rb") as a, open(jsup, "rb") as b:
        got, want = a.read(), b.read()
    assert got == want and got.count(b"\n") > 20
