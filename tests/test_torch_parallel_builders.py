"""The port's batch data-parallel, 2-D and pyramid builders against the JAX
package's (``opengpc_tpu.parallel`` on meshes of the conftest's virtual CPU
devices, ``use_pallas=False``) and against the port's single-device
modules, in one process: n = 1 is the module itself with ``group=None``,
n > 1 the one-process helper.  Buffers are compared bit for bit (the
sharded pyramids in JAX's per-rank block order); against the single-device
pyramid the comparison is the support set and the per-level counts.  The
same builders over real gloo process groups are in
``tests/test_torch_parallel.py``."""

import os

import jax
import numpy as np
import pytest
import torch

import opengpc_tpu as jt
from opengpc_tpu import parallel as jpar

import opengpc_tpu_torch as pt
from opengpc_tpu_torch import parallel as tpar
from opengpc_tpu_torch.parallel import _run_in_one_process
from opengpc_tpu_torch.pyramid import (build_pyramid_sparsematch,
                                       pyramid_supports_to_numpy)
from opengpc_tpu_torch.utils import make_pair, make_sparse_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORESTS = {name: os.path.join(REPO, "forests", f"default{name}Forest.txt")
           for name in ("Zero", "Tau")}
H, W, B = 112, 96, 8  # 28-row shards at n_rows = 4, 14 at n = 8
PH = 224  # the single-frame pyramid: 14-row coarsest slabs at n = 8, L = 2
BATCHED = {
    "flat": (jpar.build_batched_sparsematch,
             tpar.build_batched_sparsematch, pt.build_sparsematch),
    "rows": (jpar.build_batched_sparsematch_rows,
             tpar.build_batched_sparsematch_rows, pt.build_sparsematch_rows),
    "masked": (jpar.build_batched_sparsematch_masked,
               tpar.build_batched_sparsematch_masked,
               pt.build_sparsematch_masked),
    "masked-compact": (jpar.build_batched_sparsematch_masked_compact,
                       tpar.build_batched_sparsematch_masked_compact,
                       pt.build_sparsematch_masked_compact),
    "global-rows": (jpar.build_batched_sparsematch_global_rows,
                    tpar.build_batched_sparsematch_global_rows,
                    pt.build_sparsematch_global_rows),
    "global-compact": (jpar.build_batched_sparsematch_global_compact,
                       tpar.build_batched_sparsematch_global_compact,
                       pt.build_sparsematch_global_compact),
}
SINGLE_2D = {"masked": pt.build_sparsematch_masked,
             "rows": pt.build_sparsematch_rows,
             "masked-compact": pt.build_sparsematch_masked_compact}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's intra-op threads only add overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def settings_pair(global_mode=False, **kw):
    kw = dict(dict(gradient_threshold=5, disp_high=64,
                   epipolar_mode=not global_mode), **kw)
    return jt.InferenceSettings(**kw), pt.InferenceSettings(**kw)


def forests(name):
    return jt.load_forest(FORESTS[name]), pt.load_forest(FORESTS[name])


def batch(h=H, w=W, b=B, seed=0):
    """b pairs, dense and sparse by turns."""
    pairs = [make_pair(h, w, 9, seed=seed + i) if i % 2
             else make_sparse_pair(h, w, 9, density=0.3, seed=seed + i)
             for i in range(b)]
    return (np.stack([p[0] for p in pairs]),
            np.stack([p[1] for p in pairs]))


def leaves(out):
    if isinstance(out, tuple):
        return [leaf for o in out for leaf in leaves(o)]
    return [out]


def assert_same(jout, tout):
    for j, t in zip(leaves(jout), leaves(tout), strict=True):
        want = np.asarray(j)
        assert t.shape == want.shape and t.numpy().dtype == want.dtype
        np.testing.assert_array_equal(t.numpy(), want)


def equal(a, b):
    return all(torch.equal(x, y) for x, y in
               zip(leaves(a), leaves(b), strict=True))


def run(mod, lefts, rights, n):
    """n = 1 (or (1, 1)): the module itself, no group; else the
    one-process helper."""
    lefts, rights = torch.from_numpy(lefts), torch.from_numpy(rights)
    if n in (1, (1, 1)):
        return mod(lefts, rights)
    return _run_in_one_process(mod, lefts, rights, n)


def pyramid_set(out):
    return set(map(tuple, pyramid_supports_to_numpy(*out).tolist()))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("forest", ["Zero", "Tau"])
@pytest.mark.parametrize("contract", list(BATCHED))
def test_batched_matches_jax_and_single_device(contract, forest, n):
    """Each rank's contiguous block of B/n pairs through the single-device
    module: JAX's shard_map layout bit for bit, the masked-compact flag
    one a rank, the global-compact flags one a pair."""
    jbuild, tbuild, single = BATCHED[contract]
    jf, tf = forests(forest)
    js, ts = settings_pair(contract.startswith("global"))
    lefts, rights = batch()
    mod = tbuild(tf, ts, device="cpu")
    assert isinstance(mod, torch.nn.Module)
    tout = run(mod, lefts, rights, n)
    jout = jbuild(jf, js, jpar.make_mesh(jax.devices()[:n]),
                  use_pallas=False)(lefts, rights)
    assert_same(jout, tout)
    want = single(tf, ts, device="cpu")(torch.from_numpy(lefts),
                                        torch.from_numpy(rights))
    if contract == "masked-compact":
        assert tout[2].shape == (n,)
        assert bool(tout[2].any()) == bool(want[2])
        if not bool(want[2]):
            assert equal(tout[:2], want[:2])
    else:
        assert equal(tout, want)
    counts = tout[-2] if contract.endswith("compact") else tout[-1]
    assert int(counts.sum()) > 0


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("forest", ["Zero", "Tau"])
def test_batched_pyramid_matches_jax_and_single_device(forest, n):
    """Each rank's pairs through the single-device pyramid, each level
    folded: JAX's (B, K) arrays and (B, L) counts bit for bit."""
    jf, tf = forests(forest)
    js, ts = settings_pair()
    lefts, rights = batch()
    mod = tpar.build_batched_pyramid(tf, ts, num_levels=2, device="cpu")
    tout = run(mod, lefts, rights, n)
    assert_same(jpar.build_batched_pyramid(
        jf, js, jpar.make_mesh(jax.devices()[:n]), 2, use_pallas=False)(
        lefts, rights), tout)
    assert equal(tout, build_pyramid_sparsematch(tf, ts, 2, device="cpu")(
        torch.from_numpy(lefts), torch.from_numpy(rights)))
    assert tout[4].shape == (B, 2) and int(tout[4].sum()) > 0


def test_batched_pyramid_flat_fallback_global_mode():
    """Global settings take the flat pyramid pair by pair, as JAX's
    ``lax.map`` of ``_pyramid_impl``."""
    jf, tf = forests("Zero")
    js, ts = settings_pair(True)
    lefts, rights = batch(b=4)
    tout = run(tpar.build_batched_pyramid(tf, ts, num_levels=2,
                                          device="cpu"), lefts, rights, 2)
    assert_same(jpar.build_batched_pyramid(
        jf, js, jpar.make_mesh(jax.devices()[:2]), 2, use_pallas=False)(
        lefts, rights), tout)
    assert int(tout[4].sum()) > 0


@pytest.mark.parametrize("n,levels", [(1, 2), (2, 2), (4, 2), (8, 2),
                                      (1, 3), (2, 3), (4, 3)])
@pytest.mark.parametrize("forest", ["Zero", "Tau"])
def test_sharded_frame_pyramid_matches_jax(forest, n, levels):
    """One frame's rows over n ranks at every level: JAX's per-rank block
    order bit for bit, the single-device pyramid's support set and
    counts."""
    jf, tf = forests(forest)
    js, ts = settings_pair()
    left, right = make_pair(PH, W, 9, seed=4)
    mod = tpar.build_sharded_frame_pyramid(tf, ts, num_levels=levels,
                                           device="cpu")
    tout = run(mod, left, right, n)
    jout = jpar.build_sharded_frame_pyramid(
        jt.make_filter_mask(jf), js, jpar.make_mesh(jax.devices()[:n]),
        levels, use_pallas=False)(left, right)
    assert_same(jout, tout)
    want = build_pyramid_sparsematch(tf, ts, levels, device="cpu")(
        torch.from_numpy(left), torch.from_numpy(right))
    assert torch.equal(tout[4], want[4])
    assert pyramid_set(tout) == pyramid_set(want) and pyramid_set(want)


GRIDS = [(1, 1), (2, 2), (1, 4), (4, 1), (2, 4)]


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("forest", ["Zero", "Tau"])
@pytest.mark.parametrize("contract", list(SINGLE_2D))
def test_batched_sharded_frame_matches_jax(contract, forest, grid):
    """Frames over the frame groups, rows over their ranks: JAX's 2-D
    mesh layout bit for bit (the masked-compact flag one a frame group),
    each frame the single-device module's."""
    jf, tf = forests(forest)
    js, ts = settings_pair()
    lefts, rights = batch()
    mod = tpar.build_batched_sharded_frame_sparsematch(
        tf, ts, contract=contract, device="cpu")
    tout = run(mod, lefts, rights, grid)
    jout = jpar.build_batched_sharded_frame_sparsematch(
        jt.make_filter_mask(jf), js, jpar.make_mesh_2d(*grid),
        use_pallas=False, contract=contract)(lefts, rights)
    assert_same(jout, tout)
    single = SINGLE_2D[contract](tf, ts, device="cpu")
    for i in range(B):
        want = single(torch.from_numpy(lefts[i]), torch.from_numpy(rights[i]))
        got = tuple(t[i] for t in leaves(tout)[:2 if contract != "rows"
                                                 else 3])
        if contract == "masked-compact":
            flag = bool(tout[2][i // (B // grid[0])])
            assert flag >= bool(want[2])
            if flag:
                continue
        assert equal(got, tuple(leaves(want)[:len(got)]))


@pytest.mark.parametrize("grid", GRIDS[:4], ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("forest", ["Zero", "Tau"])
def test_batched_sharded_frame_pyramid_matches_jax(forest, grid):
    """Pyramids over a 2-D grid: JAX's layout bit for bit, each frame the
    single-device pyramid's support set and counts."""
    jf, tf = forests(forest)
    js, ts = settings_pair()
    lefts, rights = batch()
    mod = tpar.build_batched_sharded_frame_pyramid(tf, ts, num_levels=2,
                                                   device="cpu")
    tout = run(mod, lefts, rights, grid)
    assert_same(jpar.build_batched_sharded_frame_pyramid(
        jt.make_filter_mask(jf), js, jpar.make_mesh_2d(*grid), 2,
        use_pallas=False)(lefts, rights), tout)
    single = build_pyramid_sparsematch(tf, ts, 2, device="cpu")
    for i in range(B):
        want = single(torch.from_numpy(lefts[i]), torch.from_numpy(rights[i]))
        got = tuple(t[i] for t in tout)
        assert torch.equal(got[4], want[4])
        assert pyramid_set(got) == pyramid_set(want)


def test_one_process_helper_equals_gathered_ranks():
    """The batched helper's result is its ranks' blocks joined: each
    rank's ``shard`` (a module placed at that rank's cell) cuts its
    contiguous block, and ``gather`` of the blocks' outputs in rank order
    is the helper's result."""
    _, tf = forests("Zero")
    _, ts = settings_pair()
    lefts, rights = (torch.from_numpy(a) for a in batch())
    mod = tpar.build_batched_sparsematch_masked(tf, ts, device="cpu")
    whole = _run_in_one_process(mod, lefts, rights, 4)
    outs = []
    for d in range(4):
        mod._place(tpar.Grid(4, 1, data_rank=d))
        block = mod.shard(lefts, rights)
        assert torch.equal(block[0], lefts[2 * d:2 * d + 2])
        outs.append(mod(*block))
    assert equal(mod.gather(outs), whole)


def test_builders_reject_bad_inputs():
    """The JAX builders' refusals: a batch or height the grid does not
    divide, a pyramid height off its alignment, coarsest slabs under the
    halo, dedup keys past int32, global settings on the epipolar
    builders, a bad contract name."""
    _, tf = forests("Zero")
    _, ts = settings_pair()
    _, gs = settings_pair(True)
    lefts, rights = (torch.from_numpy(a) for a in batch())
    with pytest.raises(ValueError, match="batch 8 must divide"):
        _run_in_one_process(tpar.build_batched_sparsematch_masked(
            tf, ts, device="cpu"), lefts, rights, 3)
    two_d = tpar.build_batched_sharded_frame_sparsematch(tf, ts,
                                                         device="cpu")
    with pytest.raises(ValueError, match="batch 8 must divide"):
        _run_in_one_process(two_d, lefts, rights, (3, 1))
    with pytest.raises(ValueError, match="height 112 must divide"):
        _run_in_one_process(two_d, lefts, rights, (1, 3))
    with pytest.raises(ValueError, match="halo"):
        _run_in_one_process(two_d, lefts, rights, (1, 16))
    with pytest.raises(ValueError, match=r"\(B, H, W\)"):
        _run_in_one_process(two_d, lefts[0], rights[0], (1, 2))
    with pytest.raises(ValueError, match="contract"):
        tpar.build_batched_sharded_frame_sparsematch(
            tf, ts, contract="global-compact", device="cpu")
    with pytest.raises(ValueError, match="epipolar"):
        tpar.build_batched_sharded_frame_sparsematch(tf, gs, device="cpu")
    with pytest.raises(ValueError, match="epipolar"):
        tpar.build_sharded_frame_pyramid(tf, gs, device="cpu")
    with pytest.raises(ValueError, match="epipolar"):
        tpar.build_batched_sharded_frame_pyramid(tf, gs, device="cpu")
    pyr = tpar.build_sharded_frame_pyramid(tf, ts, num_levels=3,
                                           device="cpu")
    left, right = (torch.from_numpy(a) for a in make_pair(204, W, 9))
    with pytest.raises(ValueError, match="2\\^\\(levels-1\\) = 8"):
        _run_in_one_process(pyr, left, right, 2)
    left, right = (torch.from_numpy(a) for a in make_pair(PH, W, 9))
    with pytest.raises(ValueError, match="coarsest-level slabs of 7"):
        _run_in_one_process(pyr, left, right, 8)
    with pytest.raises(ValueError, match="ONE"):
        _run_in_one_process(pyr, lefts, rights, 2)
    _, wide = settings_pair(disp_high=1 << 20)
    with pytest.raises(ValueError, match="exceed int32"):
        _run_in_one_process(tpar.build_sharded_frame_pyramid(
            tf, wide, num_levels=2, device="cpu"), left, right, 2)


def test_sharded_sparsematch_step_one_process():
    """The dry run with no group: every builder at n = 1 against its
    single-device module, and the trainer."""
    tpar.sharded_sparsematch_step(None, device="cpu")
