"""The four-card run of ``chip_smoke.py --gpus 4`` rehearsed on the CPU,
and what it leans on.

The rank worker (``chip_smoke.py --rank-worker``) runs as 4 gloo ranks
at the CPU rehearsal's shapes (``--small``: frames of 64 rows a rank, B =
8): its phases must pass on every rank, and the whole results rank 0
kept must equal the one-process helper's (``parallel._run_in_one_process``)
bit for bit and the JAX package's sharded builders on 4 of the conftest's
virtual CPU devices.  Besides: the kernels' build lock compiles once for
processes that start together, ``--gpus N`` refuses fewer than N cards,
and ``entry_torch.py`` under a launch runs its dry run over the launch's
ranks.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import opengpc_tpu as jt
import opengpc_tpu.parallel as jpar
import opengpc_tpu_torch as pt
import opengpc_tpu_torch.parallel as tpar

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZERO = os.path.join(REPO, "forests", "defaultZeroForest.txt")
N = 4
LEVELS = 3  # chip_smoke.MD_LEVELS


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv, n, cwd, timeout=240):
    """``python argv`` as n ranks with the environment torchrun gives
    them: [(rc, stdout)] in rank order; a rank still running at the
    timeout is killed and fails."""
    port = str(_free_port())
    procs = []
    for rank in range(n):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, *argv], env=env, cwd=cwd,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            out = p.communicate(timeout=timeout)[0]
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


@pytest.fixture(scope="module")
def worker(tmp_path_factory):
    """Every rank's (rc, output) of the rank worker over 4 gloo ranks,
    and what rank 0 saved."""
    tmp = tmp_path_factory.mktemp("md4")
    save = str(tmp / "rank0.npz")
    ranks = launch([os.path.join(REPO, "chip_smoke.py"), "--rank-worker",
                    "--device", "cpu", "--small", "--save", save], N, REPO)
    assert all(rc == 0 for rc, _ in ranks), "\n".join(o for _, o in ranks)
    return ranks, dict(np.load(save))


def phase_lines(out):
    return {d["phase"]: d for d in (json.loads(ln) for ln in out.splitlines()
                                    if ln.startswith('{"phase"'))}


def test_rank_worker_passes_on_every_rank(worker):
    """Rank 0 prints the correctness phases, each with every rank's
    report and no failure; the other ranks print none; every path held
    on every rank and the sharded trainer's forest is the one-card
    forest."""
    ranks, _ = worker
    lines = phase_lines(ranks[0][1])
    assert set(lines) == {"md4_kernels", "md4_builders", "md4_step",
                          "md4_train", "md4_worker_exit"}
    del lines["md4_worker_exit"]
    for line in lines.values():
        assert line["world"] == N and len(line["ranks"]) == N
        assert all(r["failures"] == [] for r in line["ranks"])
    assert all(not phase_lines(out) for _, out in ranks[1:])
    for r in lines["md4_builders"]["ranks"]:
        assert r["paths"] == r["passed"] > 100 and r["gated_frames"] > 0
    sz = _chip_smoke().MD4_SMALL
    h, w, per = sz.h, sz.w, sz.b // N
    for r in lines["md4_kernels"]["ranks"]:
        for k in ("fused_keys", "fused_keys_slab", "fused_codes"):
            assert r["cases"][k] > 0 and r["with_candidates"][k] > 0
            assert r["max_abs_err"][k] == 0
        shapes = {k: {tuple(s[1]) for s in v} for k, v in r["shapes"].items()}
        # a rank's block on the folding contracts, a pair on the flat and
        # global ones, the batched pyramid's coarsest level
        assert {(per, h, w), (1, h, w),
                (per, sz.ph >> (LEVELS - 1), w >> (LEVELS - 1))} <= shapes[
                    "fused_keys"]
        # a shard's two slabs of the row-sharded frame, both shapes
        assert {(1, h // N + 28, w),
                (1, sz.big[0] // N + 28, sz.big[1])} <= shapes[
                    "fused_keys_slab"]
        assert r["shapes"]["fused_codes"] == [["fused_codes_pair", [h, w],
                                               32]]
    assert all(r["equals_one_card"] for r in lines["md4_train"]["ranks"])


def leaves(out):
    if isinstance(out, tuple):
        return [leaf for o in out for leaf in leaves(o)]
    return [out]


def settings(global_mode=False):
    """chip_smoke's epipolar settings (the CLI's) and the library's
    defaults for the global contracts."""
    if global_mode:
        return jt.InferenceSettings(), pt.InferenceSettings()
    kw = dict(gradient_threshold=5, epipolar_mode=True)
    return jt.InferenceSettings(**kw), pt.InferenceSettings(**kw)


def saved(store, key):
    return [store[f"{key}/{i}"] for i in range(sum(
        k.startswith(key + "/") for k in store))]


def check(store, key, helper, jout=None, flagged=False):
    """The saved result equals the one-process helper's bit for bit, and
    JAX's where it is given (not when an overflow flag is set)."""
    got = saved(store, key)
    want = [t.numpy() for t in leaves(helper)]
    assert len(got) == len(want), key
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=key)
    if jout is not None and not flagged:
        for g, j in zip(got, leaves(jout), strict=True):
            np.testing.assert_array_equal(g, np.asarray(j), err_msg=key)


def inputs(store, kind, *key):
    return tuple(store["/".join(("input", kind, *key, side))]
                 for side in "lr")


def test_rank_worker_frames_equal_helper_and_jax(worker):
    """The row-sharded frame over 4 ranks, every contract on the sparse
    pair at both of the rehearsal's shapes."""
    _, store = worker
    mesh = jpar.make_mesh(jax.devices()[:N])
    jm, tm = (pkg.make_filter_mask(pkg.load_forest(ZERO)) for pkg in (jt, pt))
    shapes = sorted({k.split("/")[2] for k in store
                     if k.startswith("input/frame/")})
    assert len(shapes) == 2
    for shape in shapes:
        left, right = inputs(store, "frame", shape, "sparse")
        for contract in tpar.CONTRACTS:
            js, ts = settings(contract == "global-compact")
            mod = tpar.build_sharded_frame_sparsematch(tm, ts, None, contract,
                                                       device="cpu")
            helper = tpar._run_in_one_process(
                mod, torch.from_numpy(left), torch.from_numpy(right), N)
            jout = jpar.build_sharded_frame_sparsematch(
                jm, js, mesh, use_pallas=False, contract=contract)(left,
                                                                   right)
            flagged = contract.endswith("compact") and bool(helper[-1])
            if contract.endswith("compact"):
                assert flagged == bool(np.asarray(jout[-1]))
            check(store, f"frame/{shape}/{contract}/defaultZeroForest/sparse",
                  helper, jout, flagged)


def test_rank_worker_batched_equal_helper_and_jax(worker):
    """The six batched contracts and the batched pyramid over 4 ranks, B
    = 8: the helper for all of them, JAX for masked, global-compact and
    the pyramid."""
    _, store = worker
    mesh = jpar.make_mesh(jax.devices()[:N])
    jf, tf = jt.load_forest(ZERO), pt.load_forest(ZERO)
    (h,) = {k.split("/")[2] for k in store if k.startswith("input/batch/")}
    lefts, rights = inputs(store, "batch", h, "sparse")
    tl, tr = torch.from_numpy(lefts), torch.from_numpy(rights)
    for contract in tpar.BATCHED_CONTRACTS + ("pyramid",):
        js, ts = settings(contract.startswith("global"))
        if contract == "flat":  # every support: capacity H * W
            js, ts = (dataclasses.replace(s, capacity=int(h) * 128)
                      for s in (js, ts))
        name = ("build_batched_pyramid" if contract == "pyramid" else
                "build_batched_sparsematch" + ("" if contract == "flat" else
                                               "_" + contract.replace(
                                                   "-", "_")))
        kw = {"num_levels": LEVELS} if contract == "pyramid" else {}
        helper = tpar._run_in_one_process(
            getattr(tpar, name)(tf, ts, device="cpu", **kw), tl, tr, N)
        jout = None
        if contract in ("masked", "global-compact", "pyramid"):
            jout = getattr(jpar, name)(jf, js, mesh, use_pallas=False,
                                       **kw)(lefts, rights)
        check(store, f"batched/{contract}/defaultZeroForest/sparse", helper,
              jout)


def test_rank_worker_grids_and_pyramids_equal_helper_and_jax(worker):
    """The 2-D frame (three contracts) and pyramid on the (1, 4), (2, 2)
    and (4, 1) grids, and the row-sharded pyramid on frame 0: the helper
    for all, JAX for the masked 2-D frame on every grid, the 2-D pyramid
    on (2, 2) and the sharded pyramid."""
    _, store = worker
    jm, tm = (pkg.make_filter_mask(pkg.load_forest(ZERO)) for pkg in (jt, pt))
    js, ts = settings()
    (h,) = {k.split("/")[2] for k in store if k.startswith("input/batch/")}
    lefts, rights = inputs(store, "batch", h, "sparse")
    tl, tr = torch.from_numpy(lefts), torch.from_numpy(rights)
    for grid in ((1, 4), (2, 2), (4, 1)):
        tag = f"{grid[0]}x{grid[1]}"
        mesh = jpar.make_mesh_2d(*grid)
        for contract in tpar.CONTRACTS[:3]:
            helper = tpar._run_in_one_process(
                tpar.build_batched_sharded_frame_sparsematch(
                    tm, ts, contract=contract, device="cpu"), tl, tr, grid)
            jout = None
            if contract == "masked":
                jout = jpar.build_batched_sharded_frame_sparsematch(
                    jm, js, mesh, use_pallas=False, contract=contract)(
                    lefts, rights)
            check(store, f"2d/{contract}/{tag}/defaultZeroForest/sparse",
                  helper, jout)
        helper = tpar._run_in_one_process(
            tpar.build_batched_sharded_frame_pyramid(
                tm, ts, num_levels=LEVELS, device="cpu"), tl, tr, grid)
        jout = None
        if grid == (2, 2):
            jout = jpar.build_batched_sharded_frame_pyramid(
                jm, js, mesh, LEVELS, use_pallas=False)(lefts, rights)
        check(store, f"2d/pyramid/{tag}/defaultZeroForest/sparse", helper,
              jout)
    helper = tpar._run_in_one_process(
        tpar.build_sharded_frame_pyramid(tm, ts, num_levels=LEVELS,
                                         device="cpu"), tl[0], tr[0], N)
    jout = jpar.build_sharded_frame_pyramid(
        jm, js, jpar.make_mesh(jax.devices()[:N]), LEVELS,
        use_pallas=False)(lefts[0], rights[0])
    check(store, "sharded_pyramid/defaultZeroForest/sparse", helper, jout)


class _Rank:
    """What ``chip_smoke.md4_kernels`` reads of a rank (``chip_smoke.Md4``)
    without a group: its finish keeps the phase's fields."""

    def __init__(self, cs):
        self.rank, self.failures, self.timed_calls = 0, [], {}
        self.calls, self.lines = cs.Md4Calls(), []

    def sync(self):
        pass

    def finish(self, phase, **fields):
        self.lines.append(dict(fields, failures=self.failures))


def test_md4_kernels_holds_every_recorded_call():
    """The four-card run's kernel check replays every key and code op call
    that ``Md4Calls`` recorded (its copies of the inputs and output)
    against the plain version: equal calls pass, one wrong element fails
    naming the op and shape, and the library's ops are restored after."""
    from opengpc_tpu_torch.match import SENTINEL_BASE
    from opengpc_tpu_torch.ops import fused, library

    cs = _chip_smoke()
    mask = pt.make_filter_mask(pt.load_forest(ZERO))
    rng = np.random.default_rng(0)
    l, r = (torch.from_numpy(rng.integers(0, 256, (2, 48, 40), np.uint8))
            for _ in range(2))
    pads = [torch.nn.functional.pad(x, (0, 0, 14, 14)) for x in (l, r)]
    ops = {op: getattr(library, op) for op in cs.MD4_OPS}
    for corrupt in (False, True):
        c = _Rank(cs)
        with c.calls.on():
            fused.fused_key_image(l, r, mask, 5, SENTINEL_BASE)
            fused.fused_key_image_slab(pads[0][:, :44], pads[1][:, :44],
                                       mask, 5, SENTINEL_BASE, 0, 48)
            fused.fused_codes_pair(l[0], r[0], mask, 5)
        assert {op: getattr(library, op) for op in cs.MD4_OPS} == ops
        assert [op for op, _, _ in c.calls.calls] == [
            "fused_key_image", "fused_key_image_slab", "fused_codes_pair"]
        if corrupt:
            c.calls.calls[1][2][0][0, 3, 5] += 1
        errs = cs.md4_kernels(c)
        line = c.lines[0]
        assert line["cases"] == {"fused_keys": 1, "fused_keys_slab": 1,
                                 "fused_codes": 1}
        assert errs["fused_keys_slab"] == int(corrupt)
        assert bool(line["failures"]) == corrupt
        if corrupt:
            assert "fused_key_image_slab on (2, 44, 40)" in line[
                "failures"][0]
        assert set(c.timed_calls) == set(line["cases"])
        assert c.calls.calls == []


def test_build_lock_compiles_once(tmp_path):
    """Two processes that find no kernel library at once compile it once:
    the second waits on the first's lock and loads its library."""
    count = tmp_path / "compiles"
    code = f"""
import ctypes, os, time
from opengpc_tpu_torch.ops import _build

_build.BUILD_DIR = {str(tmp_path / "build")!r}

def compile_(sources, target):
    with open({str(count)!r}, "a") as f:
        f.write("1\\n")
    time.sleep(1.0)
    open(target, "w").close()

class Lib:
    def __getattr__(self, name):
        return ctypes.CFUNCTYPE(None)()

_build._compile = compile_
_build.ctypes.CDLL = lambda path: Lib()
assert isinstance(_build.load_library(), Lib)
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert count.read_text() == "1\n"
    assert [p.name for p in (tmp_path / "build").iterdir()
            if p.suffix == ".so"]


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cards", [0, 1, 3])
def test_gpus_mode_refuses_fewer_cards(cards, monkeypatch, capsys):
    """``--gpus 4`` with fewer than 4 visible cards exits non-zero,
    naming the count, before any work: never fewer ranks, never gloo."""
    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(SystemExit) as e:
        cs.main(["--gpus", "4"])
    assert e.value.code not in (0, None)
    out, err = capsys.readouterr()
    assert f"needs 4 CUDA devices, {cards} visible" in err
    assert '"ok"' not in out


def test_gpus_mode_without_a_card_prints_no_result():
    """The script itself, on this host: exit non-zero, no result line."""
    r = subprocess.run([sys.executable, "chip_smoke.py", "--gpus", "4"],
                       cwd=REPO, capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert "needs 4 CUDA devices, 0 visible" in r.stderr
    assert '"ok"' not in r.stdout


def test_entry_script_joins_the_launch():
    """``entry_torch.py`` under a launch of 2 ranks runs the dry run over
    both (it once ran a world of one on every rank)."""
    ranks = launch([os.path.join(REPO, "entry_torch.py"), "--device",
                    "cpu"], 2, REPO)
    assert all(rc == 0 for rc, _ in ranks), ranks
    assert all("dryrun_multichip ok: 2 rank(s)" in out for _, out in ranks)
