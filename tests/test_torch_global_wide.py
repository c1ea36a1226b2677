"""The global-rows route past the 30-bit (y, x, d) pack, on the CPU: the
(y, x) key's segment sort against the JAX package's pack, the route at HD
and 4K, the whole route at a 31-bit
frame against the plain PyTorch reference (``opengpc_tpu_torch.plain``) and
the benchmark's NumPy reference (``gpcbench.reference.gpc``) on pools with
vertical offsets of -2..2, the one-call past the flat route's capacity, a
batch of one, and the route's stage spans."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import opengpc_tpu as jt
import opengpc_tpu.infer as jinfer
import opengpc_tpu.match as jmatch
import opengpc_tpu_torch as pt
import opengpc_tpu_torch.cli.sparsematch as tcli
import opengpc_tpu_torch.infer as tinfer
import opengpc_tpu_torch.match as tmatch
from opengpc_tpu_torch.forest import Forest, truncate_forest
from opengpc_tpu_torch.parallel import (_run_in_one_process,
                                        build_sharded_frame_sparsematch)
from opengpc_tpu_torch.plain import global_match
from opengpc_tpu_torch.utils.fuzz import random_forest
from gpcbench import generator
from gpcbench.reference import gpc

from test_torch_flat import ZERO, assert_same, masks

SMALL = (120, 320)   # (y, x, d) in 7 + 9 + 9 bits: the 30-bit pack
WIDE = (540, 2100)   # 10 + 12 + 9 = 31 bits: the (y, x) key
SETTINGS = pt.InferenceSettings()  # global mode, threshold 10, tol 1, 128


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def forest_of(name):
    """The shipped zero forest, or a seeded random forest of exactly 30
    tests (``utils.fuzz.random_forest`` draws, joined and cut)."""
    if name == "zero":
        return pt.load_forest(ZERO)
    rng = np.random.default_rng(int(name.split("-")[1]))
    ferns = ()
    while sum(len(f.tests) for f in ferns) < 30:
        ferns += random_forest(rng).ferns
    forest = truncate_forest(Forest(ferns), 30)
    assert forest.num_tests == 30
    return forest


FORESTS = ["zero", "random-1", "random-2"]


def pool(seed, pairs, shape):
    lefts, rights, _ = generator.make_pool(seed, pairs, *shape, 0.15,
                                           (8, 128), vertical=(-2, 2))
    return lefts, rights


def as_set(xs, ys, ds):
    return set(zip(np.asarray(xs).tolist(), np.asarray(ys).tolist(),
                   np.asarray(ds).tolist()))


def ref_tests(forest):
    return np.array([(t.ix, t.iy, t.jx, t.jy, t.tau)
                     for t in forest.flat_tests()], np.int64)


def key_rows(left, right, mask, settings=SETTINGS):
    key = tinfer._key_image(left, right, mask, settings)
    return tinfer._interior_rows(key)


@pytest.mark.parametrize("name", FORESTS)
def test_yx_key_equals_the_pack(name, monkeypatch):
    """On a frame whose (y, x, d) pack fits 30 bits, the segment sort of
    the (y, x) key gives the buffers of the JAX package's pack, which the
    30-bit pack of earlier versions of the port gave bit for bit, on the
    row sort and on ``torch.sort`` past its MAX_N: the same segments,
    slots and order, for both contracts that share the core."""
    mask = pt.make_filter_mask(forest_of(name))
    args = (SMALL[1], 128, 1)
    total = 0
    for left, right in zip(*pool(2**33 + 5, 3, SMALL)):
        key, m = key_rows(left, right, mask)
        (jx, jy, jd), jc = jmatch.match_global_rows(key.numpy(), *args,
                                                    y_offset=m)
        (kx, ky, kd), kc, kovf = jmatch.match_global_rows_compact(
            key.numpy(), *args, y_offset=m)
        pack = (jx, jy, jd, jc, kx, ky, kd, kc)
        total += int(np.asarray(jc).sum())
        for max_n in (tmatch.MAX_N, 0):
            monkeypatch.setattr(tmatch, "MAX_N", max_n)
            (xs, ys, ds), counts = tmatch.match_global_rows(key, *args,
                                                            y_offset=m)
            (cx, cy, cd), cc, ovf = tmatch.match_global_rows_compact(
                key, *args, y_offset=m)
            monkeypatch.undo()
            assert_same(pack, (xs, ys, ds, counts, cx, cy, cd, cc))
            assert bool(ovf) == bool(kovf)
    assert total > 0


@pytest.mark.parametrize("shape", [(1080, 1920), (2160, 3840), WIDE])
def test_route_is_global_rows_past_30_bits(shape):
    mask = pt.make_filter_mask(pt.load_forest(ZERO))
    # the JAX package asks the (y, x, d) pack to fit 30 bits; the port
    # asks (y, x) alone
    assert not jinfer._global_rows_ok(masks("zero")[0], shape,
                                     jt.InferenceSettings())
    assert tinfer._global_rows_ok(mask, shape, SETTINGS)
    assert tinfer.route(mask, shape, SETTINGS) == "global-rows"
    # the CLI's global contracts and the sharded frame take one rule
    assert tcli._global_ok(mask, shape, SETTINGS)
    build_sharded_frame_sparsematch(
        mask, SETTINGS, contract="global-compact",
        device="cpu")._check_shard(shape[0] // 4, shape[1], 4)


@pytest.mark.parametrize("shape", [SMALL, WIDE], ids=["30bit", "31bit"])
@pytest.mark.parametrize("name", FORESTS)
def test_global_rows_match_both_references(name, shape):
    """The port's route, the plain PyTorch reference and the NumPy
    reference give the same supports on each pair of a pool whose
    vertical offsets put some pairs' true matches past the tolerance."""
    forest = forest_of(name)
    mask = pt.make_filter_mask(forest)
    assert tinfer.route(mask, shape, SETTINGS) == "global-rows"
    seed = 11 if shape == WIDE else 2**33 + 5
    lefts, rights = pool(seed, 2, shape)
    dys = generator.vertical_offsets(seed, 2, -2, 2)
    assert dys.abs().max() == 2 and dys.abs().min() <= 1
    mod = pt.build_sparsematch_global_rows(mask, SETTINGS, device="cpu")
    (xs, ys, ds), counts = mod(lefts, rights)
    want = gpc.global_supports(lefts.numpy(), rights.numpy(),
                               ref_tests(forest), 10, 128, 1)
    total = 0
    for b in range(len(lefts)):
        got = pt.global_row_supports_to_numpy(xs[b], ys[b], ds[b], counts[b])
        plain = global_match.global_supports(lefts[b], rights[b], forest, 10,
                                             128, 1)
        sel = want[0] == b
        numpy_ref = as_set(want[2][sel], want[1][sel], want[3][sel])
        assert len(got) == int(counts[b].sum()) == len(as_set(*got.T))
        assert as_set(*got.T) == as_set(plain[1], plain[0], plain[2])
        assert as_set(*got.T) == numpy_ref
        total += len(got)
    assert total > 0


def test_one_call_past_30_bits_returns_what_the_flat_route_drops():
    forest = pt.load_forest(ZERO)
    mask = pt.make_filter_mask(forest)
    settings = pt.InferenceSettings(capacity=64)
    left, right = (t[0].numpy() for t in pool(11, 1, WIDE))
    got = pt.sparsematch(left, right, forest, settings, device="cpu")
    want = gpc.global_supports(left, right, ref_tests(forest), 10, 128, 1)
    assert len(got) == len(want[0]) > 64
    assert as_set(*got.T) == as_set(want[2], want[1], want[3])
    # the flat route at the same settings overflows its capacity
    xs, ys, ds, count = pt.build_sparsematch(mask, settings, device="cpu")(
        torch.from_numpy(left), torch.from_numpy(right))
    assert int(count) == len(got) and xs.shape == (64,)
    assert len(pt.supports_to_numpy(xs, ys, ds, count)) == 64


@pytest.mark.parametrize("shape", [SMALL, WIDE], ids=["30bit", "31bit"])
def test_batch_of_one_is_the_pair_with_a_leading_axis(shape):
    mask = pt.make_filter_mask(pt.load_forest(ZERO))
    mod = pt.build_sparsematch_global_rows(mask, SETTINGS, device="cpu")
    lefts, rights = pool(987654321, 1, shape)  # dy 0
    (xs, ys, ds), counts = mod(lefts, rights)
    (px, py, pd), pc = mod(lefts[0], rights[0])
    for batched, single in zip((xs, ys, ds, counts), (px, py, pd, pc)):
        assert batched.shape == (1,) + single.shape
        assert torch.equal(batched[0], single)
        assert batched._is_view()  # no stack copy
    assert int(pc.sum()) > 0


def test_global_rows_spans_nest_in_stage_order():
    mask = pt.make_filter_mask(pt.load_forest(ZERO))
    mod = pt.build_sparsematch_global_rows(mask, SETTINGS, device="cpu")
    lefts, rights = pool(987654321, 1, SMALL)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mod(lefts, rights)
    spans = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("ogpc.")),
                   key=lambda s: (s[0], -s[1]))
    assert [n for _, _, n in spans] == [
        "ogpc.forward", "ogpc.keys", "ogpc.fold", "ogpc.gsort",
        "ogpc.gdetect", "ogpc.gpack"]
    s0, e0, _ = spans[0]
    inner = spans[1:]
    assert all(s0 <= s and e <= e0 for s, e, _ in inner)
    assert all(a[1] <= b[0] for a, b in zip(inner, inner[1:]))


def test_global_compact_past_30_bits_equals_global_rows():
    """The chunk-compacted contract and the sharded frame (four ranks run
    in one process) share the core, and with it the reach: at a 31-bit
    frame each gives the global-rows route's supports."""
    mask = pt.make_filter_mask(pt.load_forest(ZERO))
    lefts, rights = pool(11, 1, WIDE)
    (xs, ys, ds), counts = pt.build_sparsematch_global_rows(
        mask, SETTINGS, device="cpu")(lefts, rights)
    (cx, cy, cd), cc, ovf = pt.build_sparsematch_global_compact(
        mask, SETTINGS, device="cpu")(lefts, rights)
    assert not bool(torch.as_tensor(ovf).any())
    want = pt.global_row_supports_to_numpy(xs[0], ys[0], ds[0], counts[0])
    got = pt.global_row_supports_to_numpy(cx[0], cy[0], cd[0], cc[0])
    assert len(want) > 0
    assert as_set(*got.T) == as_set(*want.T)
    sharded = _run_in_one_process(build_sharded_frame_sparsematch(
        mask, SETTINGS, contract="global-compact", device="cpu"),
        lefts[0], rights[0], 4)
    assert not bool(sharded[2])
    got = pt.global_row_supports_to_numpy(*sharded[0], sharded[1])
    assert as_set(*got.T) == as_set(*want.T)
