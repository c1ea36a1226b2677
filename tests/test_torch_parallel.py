"""The port's row-sharded single-frame matcher against the JAX package's
``build_sharded_frame_sparsematch`` (on meshes of the conftest's virtual
CPU devices) and against the port's single-device builders, for all four
contracts: n = 1 with ``group=None``, n = 2, 4, 8 through the one-process
helper, and n = 2, 4 over real gloo process groups in subprocesses.
Buffers are compared bit for bit; the global contract's segments follow the
bucket order, so against the single-device module it is compared as a
support set."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import opengpc_tpu as jt
from opengpc_tpu.parallel import build_sharded_frame_sparsematch as jbuild
from opengpc_tpu.parallel import make_mesh

import opengpc_tpu_torch as pt
from opengpc_tpu_torch.parallel import (CONTRACTS, _run_in_one_process,
                                        build_sharded_frame_sparsematch,
                                        gather_blocks, split_frame)
from opengpc_tpu_torch.utils import make_pair, make_sparse_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZERO = os.path.join(REPO, "forests", "defaultZeroForest.txt")
TAU = os.path.join(REPO, "forests", "defaultTauForest.txt")
H, W = 112, 96  # 14-row shards at n = 8, 28 at n = 4


def settings_pair(contract, **kw):
    kw = dict(gradient_threshold=5, disp_high=64,
              epipolar_mode=contract != "global-compact", **kw)
    return jt.InferenceSettings(**kw), pt.InferenceSettings(**kw)


def masks(path=ZERO):
    return (jt.make_filter_mask(jt.load_forest(path)),
            pt.make_filter_mask(pt.load_forest(path)))


def scenes():
    return {"dense": make_pair(H, W, 9),
            "sparse": make_sparse_pair(H, W, 9, density=0.3, seed=3)}


def leaves(out):
    if isinstance(out, tuple):
        return [leaf for o in out for leaf in leaves(o)]
    return [out]


def assert_same(jout, tout):
    for j, t in zip(leaves(jout), leaves(tout), strict=True):
        want = np.asarray(j)
        assert t.shape == want.shape and t.numpy().dtype == want.dtype
        np.testing.assert_array_equal(t.numpy(), want)


def single_device(contract, mask, settings, left, right):
    """The port's single-device module of a contract on the whole frame."""
    build = {"masked": pt.build_sparsematch_masked,
             "rows": pt.build_sparsematch_rows,
             "masked-compact": pt.build_sparsematch_masked_compact,
             "global-compact": pt.build_sparsematch_global_compact}[contract]
    return build(mask, settings, device="cpu")(torch.from_numpy(left),
                                               torch.from_numpy(right))


def support_set(contract, out, settings):
    if contract == "global-compact":
        sup = pt.global_row_supports_to_numpy(*out[0], out[1])
    elif contract == "rows":
        sup = pt.row_supports_to_numpy(*out[0], out[1])
    else:
        sup = pt.masked_supports_to_numpy(out[0], out[1], settings.disp_high)
    return set(map(tuple, sup.tolist()))


def run_sharded(mod, left, right, n):
    """n = 1 is the module itself with no group; n > 1 the one-process
    helper."""
    left, right = torch.from_numpy(left), torch.from_numpy(right)
    return mod(left, right) if n == 1 else _run_in_one_process(mod, left,
                                                               right, n)


def check_against_single(contract, tout, single, settings):
    """The sharded result equals the single-device module's: bit for bit
    on the epipolar contracts, as a support set on the global one; the
    compact contracts' flags agree, and a flagged result is not compared."""
    if contract.endswith("compact"):
        assert bool(tout[-1]) == bool(single[-1])
        if bool(tout[-1]):
            return
    if contract == "global-compact":
        assert (support_set(contract, tout, settings)
                == support_set(contract, single, settings))
    else:
        assert all(torch.equal(a, b)
                   for a, b in zip(leaves(tout), leaves(single), strict=True))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("contract", CONTRACTS)
def test_sharded_frame_matches_jax_and_single_device(contract, n):
    jm, tm = masks()
    js, ts = settings_pair(contract)
    mod = build_sharded_frame_sparsematch(tm, ts, contract=contract,
                                          device="cpu")
    assert isinstance(mod, torch.nn.Module)
    jrun = jbuild(jm, js, make_mesh(jax.devices()[:n]), use_pallas=False,
                  contract=contract)
    flags = {}
    for name, (left, right) in scenes().items():
        tout = run_sharded(mod, left, right, n)
        jout = jrun(left, right)
        if contract.endswith("compact"):
            flags[name] = bool(tout[-1])
            assert flags[name] == bool(np.asarray(jout[-1]))
        if not flags.get(name):
            assert_same(jout, tout)
        single = single_device(contract, tm, ts, left, right)
        check_against_single(contract, tout, single, ts)
        assert int(tout[-2 if contract.endswith("compact") else 1].sum()) > 0
    if contract.endswith("compact"):
        assert flags == {"dense": True, "sparse": False}


def test_sharded_frame_tau_forest_rows_and_masked():
    """The tau forest, n = 4: masked and rows equal the single-device
    modules bit for bit."""
    _, tm = masks(TAU)
    left, right = scenes()["dense"]
    for contract in ("masked", "rows"):
        _, ts = settings_pair(contract)
        mod = build_sharded_frame_sparsematch(tm, ts, contract=contract,
                                              device="cpu")
        check_against_single(contract, run_sharded(mod, left, right, 4),
                             single_device(contract, tm, ts, left, right), ts)


def test_one_process_helper_equals_gathered_ranks():
    """The helper's result is the rank blocks joined: at n = 2 each half
    of the masked buffer is what one rank's module would hold."""
    _, tm = masks()
    _, ts = settings_pair("masked")
    left, right = (torch.from_numpy(a) for a in scenes()["sparse"])
    mod = build_sharded_frame_sparsematch(tm, ts, device="cpu")
    whole = _run_in_one_process(mod, left, right, 2)
    blocks = [tuple(t[i * H // 2:(i + 1) * H // 2] for t in whole)
              for i in range(2)]
    assert all(torch.equal(a, b)
               for a, b in zip(gather_blocks(blocks), whole))
    assert [s.shape for s in split_frame(left, 4)] == [(H // 4, W)] * 4


def _spawn_gloo(tmp_path, n, left, right):
    data = str(tmp_path / "pair.npz")
    np.savez(data, left=left, right=right, forest=ZERO)
    store = str(tmp_path / "store")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    worker = os.path.join(REPO, "tests", "torch_gloo_worker.py")
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, worker, store, str(n), str(r), data, outs[r]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [np.load(o) for o in outs]


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_frame_over_gloo_process_groups(tmp_path, n):
    """n ranks in n processes, halos by batch_isend_irecv, the global
    exchange by all_to_all_single and the flag by all_reduce(MAX): the
    joined blocks equal the one-process helper's and JAX's result."""
    jm, tm = masks()
    left, right = scenes()["sparse"]
    ranks = _spawn_gloo(tmp_path, n, left, right)
    for contract in CONTRACTS:
        js, ts = settings_pair(contract)
        mod = build_sharded_frame_sparsematch(tm, ts, contract=contract,
                                              device="cpu")
        want = leaves(run_sharded(mod, left, right, n))
        for i, leaf in enumerate(want):
            got = [r[f"{contract}/{i}"] for r in ranks]
            if leaf.dim() == 0:  # the flag, the same on every rank
                assert all(bool(g) == bool(leaf) for g in got)
            else:
                np.testing.assert_array_equal(np.concatenate(got),
                                              leaf.numpy())
        jout = jbuild(jm, js, make_mesh(jax.devices()[:n]),
                      use_pallas=False, contract=contract)(left, right)
        assert_same(jout, tuple(want))


def test_sharded_frame_rejects_bad_inputs():
    """The JAX builder's refusals (tests/test_parallel.py): the contract
    name, a height the group does not divide, global settings on an
    epipolar contract, shards below the halo, and float images."""
    _, tm = masks()
    _, ts = settings_pair("masked")
    with pytest.raises(ValueError, match="contract"):
        build_sharded_frame_sparsematch(tm, ts, contract="global",
                                        device="cpu")
    mod = build_sharded_frame_sparsematch(tm, ts, device="cpu")
    left, right = (torch.from_numpy(a) for a in make_pair(100, 64, 3))
    with pytest.raises(ValueError, match="divide"):
        _run_in_one_process(mod, left, right, 8)
    _, gs = settings_pair("global-compact")
    with pytest.raises(ValueError, match="epipolar"):
        build_sharded_frame_sparsematch(tm, gs, device="cpu")
    small_l, small_r = (torch.from_numpy(a) for a in make_pair(64, 64, 3))
    with pytest.raises(ValueError, match="halo"):
        _run_in_one_process(mod, small_l, small_r, 8)
    with pytest.raises(ValueError, match="halo"):
        mod(small_l[:8], small_r[:8])
    with pytest.raises(ValueError, match="uint8"):
        mod(left.float() / 255, right.float() / 255)
    with pytest.raises(ValueError, match="ONE"):
        _run_in_one_process(mod, left[None], right[None], 1)
    # uint8 still flows
    assert int(mod(left, right)[1].sum()) > 0


def test_sharded_frame_global_rejects_epipolar_settings():
    _, tm = masks()
    _, ts = settings_pair("masked")
    with pytest.raises(ValueError, match="global"):
        build_sharded_frame_sparsematch(tm, ts, contract="global-compact",
                                        device="cpu")


def test_sharded_frame_rejects_unpackable_forests():
    """_rows_ok and _global_rows_ok are taken on the whole frame: a
    32-test forest fits neither pack."""
    rng = np.random.default_rng(0)
    t32 = pt.filter_mask_from_numpy(rng.integers(-13, 14, (32, 2)),
                                    rng.integers(-13, 14, (32, 2)),
                                    rng.integers(-10, 11, 32), 1)
    left, right = (torch.from_numpy(a) for a in make_pair(H, W, 3))
    for contract, match in (("masked", "_rows_ok"),
                            ("global-compact", "_global_rows_ok")):
        _, ts = settings_pair(contract)
        mod = build_sharded_frame_sparsematch(t32, ts, contract=contract,
                                              device="cpu")
        with pytest.raises(ValueError, match=match):
            _run_in_one_process(mod, left, right, 2)


def test_sharded_frame_global_lossless_and_overflow():
    """k == chunk makes the chunk compaction lossless, so the distributed
    sort is exact on a dense frame; the default chunks trip the flag there,
    as JAX's do, and a bucket capacity below the load trips it too."""
    jm, tm = masks()
    js, ts = settings_pair("global-compact", vertical_tolerance=0)
    left, right = make_pair(128, 96, 3, seed=21)
    single = pt.build_sparsematch_global_rows(tm, ts, device="cpu")(
        torch.from_numpy(left), torch.from_numpy(right))
    want = support_set("global-compact", single, ts)
    assert len(want) > 1000
    mesh = make_mesh()
    lossless = build_sharded_frame_sparsematch(
        tm, ts, contract="global-compact", chunk=128, k=128, device="cpu")
    out = run_sharded(lossless, left, right, 8)
    assert not bool(out[2])
    assert support_set("global-compact", out, ts) == want
    jout = jbuild(jm, js, mesh, use_pallas=False, contract="global-compact",
                  chunk=128, k=128)(left, right)
    assert_same(jout, out)
    for kw in ({}, {"chunk": 128, "k": 128, "bucket_cap": 256}):
        flagged = build_sharded_frame_sparsematch(
            tm, ts, contract="global-compact", device="cpu", **kw)
        out = run_sharded(flagged, left, right, 8)
        jflag = jbuild(jm, js, mesh, use_pallas=False,
                       contract="global-compact", **kw)(left, right)[2]
        assert bool(out[2]) and bool(np.asarray(jflag))
        sup = pt.global_row_supports_to_numpy(*out[0], out[1])
        if len(sup):  # well-formed even when flagged
            assert sup[:, 0].min() >= 0 and sup[:, 0].max() < 96
            assert sup[:, 1].min() >= 0 and sup[:, 1].max() < 128
            assert np.abs(sup[:, 2]).max() <= ts.disp_high
