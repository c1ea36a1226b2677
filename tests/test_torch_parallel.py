"""The port's row-sharded single-frame matcher against the JAX package's
``build_sharded_frame_sparsematch`` (on meshes of the conftest's virtual
CPU devices) and against the port's single-device builders, for all four
contracts: n = 1 with ``group=None``, n = 2, 4, 8 through the one-process
helper, and n = 2, 4 over real gloo process groups in subprocesses, which
also run the batched, pyramid and 2-D builders and the sharded trainer.
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
                                        split_frame)
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
               for a, b in zip(mod.gather(blocks, 1, 2), whole))
    assert [s.shape for s in split_frame(left, 4)] == [(H // 4, W)] * 4


TRIPLETS = 205  # a bootstrap of 143 and 205 triplets: pads at n = 2 and 4


def _gloo_inputs():
    """What every gloo rank runs on: the sparse frame, a batch of 8
    pairs (dense and sparse by turns), a 224-row frame for the pyramid and
    a triplet set whose counts divide by neither 2 nor 4."""
    from test_train import make_triplets

    left, right = scenes()["sparse"]
    pairs = [make_pair(H, W, 9, seed=i) if i % 2
             else make_sparse_pair(H, W, 9, density=0.3, seed=i)
             for i in range(8)]
    pleft, pright = make_pair(224, W, 9, seed=4)
    return dict(left=left, right=right, forest=ZERO,
                lefts=np.stack([p[0] for p in pairs]),
                rights=np.stack([p[1] for p in pairs]), pleft=pleft,
                pright=pright,
                triplets=make_triplets(np.random.default_rng(7), TRIPLETS))


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """The inputs and each rank's outputs of 2 and 4 gloo ranks in
    subprocesses (``tests/torch_gloo_worker.py``), all six started at
    once, each with a timeout."""
    tmp = tmp_path_factory.mktemp("gloo")
    inputs = _gloo_inputs()
    data = str(tmp / "inputs.npz")
    np.savez(data, **inputs)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    worker = os.path.join(REPO, "tests", "torch_gloo_worker.py")
    runs = {n: [str(tmp / f"n{n}_rank{r}.npz") for r in range(n)]
            for n in (2, 4)}
    procs = [subprocess.Popen(
        [sys.executable, worker, str(tmp / f"store{n}"), str(n), str(r),
         data, out], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for n, outs in runs.items() for r, out in enumerate(outs)]
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
    return inputs, {n: [np.load(o) for o in outs]
                    for n, outs in runs.items()}


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_frame_over_gloo_process_groups(gloo, n):
    """n ranks in n processes, halos by batch_isend_irecv, the global
    exchange by all_to_all_single and the flag by all_reduce(MAX): the
    joined blocks equal the one-process helper's and JAX's result."""
    jm, tm = masks()
    inputs, runs = gloo
    left, right = inputs["left"], inputs["right"]
    ranks = runs[n]
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


def _whole(ranks, name, want):
    """Every rank gathered the same whole result, ``want``'s leaves."""
    for i, leaf in enumerate(leaves(want)):
        for r in ranks:
            np.testing.assert_array_equal(r[f"{name}/{i}"], leaf.numpy())


@pytest.mark.parametrize("n", [2, 4])
def test_batched_builders_over_gloo_process_groups(gloo, n):
    """The six batched contracts and the batched pyramid over n gloo
    ranks: every rank's gathered result equals the one-process helper's
    and JAX's on n virtual devices."""
    import opengpc_tpu.parallel as jpar
    import opengpc_tpu_torch.parallel as tpar

    inputs, runs = gloo
    lefts, rights = inputs["lefts"], inputs["rights"]
    jf, tf = jt.load_forest(ZERO), pt.load_forest(ZERO)
    mesh = make_mesh(jax.devices()[:n])
    for contract in tpar.BATCHED_CONTRACTS + ("pyramid",):
        js, ts = settings_pair("global-compact"
                               if contract.startswith("global")
                               else "masked")
        name = ("build_batched_pyramid" if contract == "pyramid" else
                "build_batched_sparsematch" + ("" if contract == "flat" else
                                               "_" + contract.replace(
                                                   "-", "_")))
        kw = {"num_levels": 2} if contract == "pyramid" else {}
        want = _run_in_one_process(
            getattr(tpar, name)(tf, ts, device="cpu", **kw),
            torch.from_numpy(lefts), torch.from_numpy(rights), n)
        _whole(runs[n], f"batched/{contract}", want)
        jkw = {"num_levels": 2} if contract == "pyramid" else {}
        assert_same(getattr(jpar, name)(jf, js, mesh, use_pallas=False,
                                        **jkw)(lefts, rights), want)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_pyramids_and_grids_over_gloo_process_groups(gloo, n):
    """The row-sharded pyramid over n ranks, and the 2-D frame (three
    contracts) and pyramid on every grid of n ranks: each rank's gathered
    result equals the one-process helper's and JAX's (the pyramids in
    JAX's per-rank block order)."""
    import opengpc_tpu.parallel as jpar
    import opengpc_tpu_torch.parallel as tpar

    inputs, runs = gloo
    jm, tm = masks()
    js, ts = settings_pair("masked")
    pl, pr = inputs["pleft"], inputs["pright"]
    want = _run_in_one_process(
        tpar.build_sharded_frame_pyramid(tm, ts, num_levels=2, device="cpu"),
        torch.from_numpy(pl), torch.from_numpy(pr), n)
    _whole(runs[n], "pyramid", want)
    assert_same(jpar.build_sharded_frame_pyramid(
        jm, js, make_mesh(jax.devices()[:n]), 2, use_pallas=False)(pl, pr),
        want)
    lefts, rights = inputs["lefts"], inputs["rights"]
    tl, tr = torch.from_numpy(lefts), torch.from_numpy(rights)
    for grid in ([(1, 2), (2, 1)] if n == 2 else [(2, 2), (1, 4), (4, 1)]):
        tag = f"{grid[0]}x{grid[1]}"
        mesh = jpar.make_mesh_2d(*grid)
        for contract in CONTRACTS[:3]:
            want = _run_in_one_process(
                tpar.build_batched_sharded_frame_sparsematch(
                    tm, ts, contract=contract, device="cpu"), tl, tr, grid)
            _whole(runs[n], f"2d/{tag}/{contract}", want)
            assert_same(jpar.build_batched_sharded_frame_sparsematch(
                jm, js, mesh, use_pallas=False, contract=contract)(
                lefts, rights), want)
        want = _run_in_one_process(
            tpar.build_batched_sharded_frame_pyramid(tm, ts, num_levels=2,
                                                     device="cpu"),
            tl, tr, grid)
        _whole(runs[n], f"2dpyr/{tag}", want)
        assert_same(jpar.build_batched_sharded_frame_pyramid(
            jm, js, mesh, 2, use_pallas=False)(lefts, rights), want)


@pytest.mark.parametrize("n", [2, 4])
def test_trainer_over_gloo_process_groups(gloo, n):
    """``train_forest(group=)`` over n ranks, the bootstrap padded to a
    multiple of n: every rank's forest text equals the one-device port's
    and JAX's ``mesh`` trainer's byte for byte, for the zero and tau
    optimizers, batched and fern at a time; ``sharded_train_fern``'s fern
    the one-device ``train_fern``'s; and the dry run
    ``sharded_sparsematch_step`` passed on every rank."""
    import opengpc_tpu.train as jtrain

    import opengpc_tpu_torch.train as ttrain

    inputs, runs = gloo
    trips = inputs["triplets"]
    assert int(0.7 * TRIPLETS) % n and TRIPLETS % n
    mesh = make_mesh(jax.devices()[:n])
    for kind in ("zero", "tau"):
        jopt = getattr(jt, f"{kind}_optimizer")(num_resamples=4)
        topt = getattr(pt, f"{kind}_optimizer")(num_resamples=4)
        for batched in (True, False):
            text = pt.serialize_forest(ttrain.train_forest(
                trips, pt.fern_factory(1, 1, 1, 3), topt, seed=3,
                verbose=False, batch_ferns=batched, device="cpu"))
            jtext = jt.serialize_forest(jtrain.train_forest(
                trips, jt.fern_factory(1, 1, 1, 3), jopt, seed=3,
                verbose=False, batch_ferns=batched, mesh=mesh))
            assert text == jtext
            for r in runs[n]:
                assert str(r[f"train/{kind}/{batched}"]) == text
    fern, _ = ttrain.train_fern(trips, pt.forest.SCALE_L,
                                pt.tau_optimizer(num_resamples=4), 3,
                                rng=np.random.default_rng(5), verbose=False,
                                device="cpu")
    want = pt.serialize_forest(pt.forest.Forest((fern,)))
    for r in runs[n]:
        assert str(r["fern"]) == want and int(r["step"]) == 1


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
