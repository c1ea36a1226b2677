"""The kernels as ``torch.library`` custom ops
(``opengpc_tpu_torch.ops.library``, namespace ``ogpc``), on the CPU.

Every op passes ``torch.library.opcheck`` (schema, autograd registration,
the fake against the CPU kernel, a trace with dynamic shapes) at two
shapes and with two forests.  Its CPU output equals the plain twin bit for
bit and the JAX package's Pallas kernel in interpret mode on the same
seeded inputs.  The fakes give the right shapes on meta tensors, where the
public wrappers still refuse; and the package exports every name the JAX
package's ``__init__`` does (the forest types and the ``aot`` surface
among them)."""

import os

import numpy as np
import pytest
import torch

import opengpc_tpu
import opengpc_tpu.forest as jforest
from opengpc_tpu.match import SENTINEL_BASE as J_SENTINEL_BASE
from opengpc_tpu.ops import fused as jfused
from opengpc_tpu.ops import fused_match as jfm
from opengpc_tpu.ops import sort as jsort

import opengpc_tpu_torch
import opengpc_tpu_torch.forest as tforest
from opengpc_tpu_torch.match import SENTINEL_BASE
from opengpc_tpu_torch.ops import fused as tfused
from opengpc_tpu_torch.ops import fused_match as tfm
from opengpc_tpu_torch.ops import library
from opengpc_tpu_torch.ops import sort as tsort
from opengpc_tpu_torch.ops.census import census5x5

FORESTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "forests")
SHAPES = [(40, 70), (33, 131)]  # N2 = 256 and 512
THR, DISP_HIGH = 5, 24
TESTS_OPS = ("fused_key_image", "fused_key_image_slab", "fused_keys",
             "fused_keys_slab", "fused_codes", "fused_codes_pair",
             "fused_sparsematch_rows")
CASES = ([(op, shape, forest) for op in TESTS_OPS for shape in SHAPES
          for forest in ("defaultZeroForest.txt", "defaultTauForest.txt")]
         + [(op, shape, None) for op in ("fused_census", "bitonic_sort_rows")
            for shape in SHAPES])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def structured_image(rng, h, w):
    small = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2))
    img = np.kron(small, np.ones((4, 4)))[:h, :w]
    return np.clip(img + rng.integers(-12, 13, (h, w)), 0, 255).astype(np.uint8)


def slab_of(img, y0, sh):
    """Frame rows [y0 - 14, y0 + sh + 14) of ``img``, zeros outside."""
    pad = np.pad(img, ((tfused.PAD, tfused.PAD), (0, 0)))
    return np.ascontiguousarray(pad[y0:y0 + sh + 2 * tfused.PAD])


def case(op, shape, forest):
    """(op args, twin outputs, JAX outputs) of one case: the seeded inputs
    through the op's arguments, the plain twin and the JAX package's
    kernel (interpret mode)."""
    h, w = shape
    rng = np.random.default_rng(h * 1000 + w + len(op))
    left, right = structured_image(rng, h, w), structured_image(rng, h, w)
    tl, tr = torch.from_numpy(left), torch.from_numpy(right)
    if op == "fused_census":
        return ((tl,), (census5x5(tl),),
                (jfused.fused_census(left, interpret=True),))
    if op == "bitonic_sort_rows":
        n = tsort.padded_row_length(w)
        key = rng.integers(0, 64, (h, n), dtype=np.int32)  # many equal keys
        pay = np.broadcast_to(np.arange(n, dtype=np.int32), (h, n)).copy()
        tk, tp = torch.from_numpy(key), torch.from_numpy(pay)
        return ((tk, tp), tsort.bitonic_sort_rows_plain(tk, tp),
                jsort.bitonic_sort_rows(key, pay, interpret=True))
    jm = jforest.make_filter_mask(jforest.load_forest(
        os.path.join(FORESTS, forest)))
    tm = tmask(forest)
    tests = tfused.op_tests(tm)
    if op == "fused_key_image":
        twin = torch.cat([
            tfused.fused_keys_plain(tl, tm, THR, 0, SENTINEL_BASE),
            tfused.fused_keys_plain(tr, tm, THR, w, SENTINEL_BASE)], dim=1)
        jax = np.concatenate([
            jfused.fused_keys(img, jm, THR, pos_base=pos,
                              sentinel_base=J_SENTINEL_BASE, interpret=True)
            for img, pos in ((left, 0), (right, w))], axis=1)
        return ((tl[None], tr[None], tests, THR, SENTINEL_BASE),
                (twin[None],), (jax[None],))
    if op == "fused_keys":
        return ((tl, tests, THR, w, SENTINEL_BASE, 0),
                (tfused.fused_keys_plain(tl, tm, THR, w, SENTINEL_BASE),),
                (jfused.fused_keys(left, jm, THR, pos_base=w,
                                   sentinel_base=J_SENTINEL_BASE,
                                   interpret=True),))
    if op in ("fused_key_image_slab", "fused_keys_slab"):
        y0, sh = h // 4, h // 2
        slabs = [slab_of(img, y0, sh) for img in (left, right)]
        ts = [torch.from_numpy(s) for s in slabs]
        twins = [tfused.fused_keys_slab_plain(s, tm, THR, pos, SENTINEL_BASE,
                                              y0, h)
                 for s, pos in zip(ts, (0, w))]
        jax = [jfused.fused_keys_slab(s, jm, THR, pos, J_SENTINEL_BASE, y0, h,
                                      interpret=True)
               for s, pos in zip(slabs, (0, w))]
        if op == "fused_keys_slab":
            return ((ts[0], tests, THR, 0, SENTINEL_BASE, y0, h),
                    (twins[0],), (jax[0],))
        return ((ts[0][None], ts[1][None], tests, THR, SENTINEL_BASE, y0, h),
                (torch.cat(twins, dim=1)[None],),
                (np.concatenate(jax, axis=1)[None],))
    if op == "fused_codes":
        return ((tl, tests, THR), tfused.fused_codes_plain(tl, tm, THR),
                jfused.fused_codes(left, jm, THR, interpret=True))
    if op == "fused_codes_pair":
        return ((tl, tr, tests, THR),
                tfused.fused_codes_plain(tl, tm, THR)
                + tfused.fused_codes_plain(tr, tm, THR),
                tuple(jfused.fused_codes(left, jm, THR, interpret=True))
                + tuple(jfused.fused_codes(right, jm, THR, interpret=True)))
    assert op == "fused_sparsematch_rows"
    return ((tl, tr, tests, THR, DISP_HIGH),
            tfm.fused_sparsematch_rows_plain(tl, tr, tm, THR, DISP_HIGH),
            jfm.fused_sparsematch_rows(left, right, jm, THR, DISP_HIGH,
                                       interpret=True))


def tmask(forest):
    return tforest.make_filter_mask(tforest.load_forest(
        os.path.join(FORESTS, forest)))


def _outputs(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


@pytest.mark.parametrize("op,shape,forest", CASES)
def test_opcheck(op, shape, forest):
    """opcheck's default tests pass on the CPU kernel, and it launched
    nothing."""
    args, _, _ = case(op, shape, forest)
    counters = (tfused.fused_keys, tfused.fused_keys_slab, tfused.fused_codes,
                tfused.fused_census, tsort.bitonic_sort_rows,
                tfm.fused_sparsematch_rows)
    result = torch.library.opcheck(library.OPS[op], args)
    assert result and set(result.values()) == {"SUCCESS"}, result
    assert [c.launches for c in counters] == [0] * len(counters)


@pytest.mark.parametrize("op,shape,forest", CASES)
def test_op_equals_twin_and_jax(op, shape, forest):
    """The op on CPU tensors is its plain twin, bit for bit, and the JAX
    package's Pallas kernel in interpret mode."""
    args, twin, jax = case(op, shape, forest)
    got = _outputs(getattr(torch.ops.ogpc, op)(*args))
    assert len(got) == len(twin) == len(jax)
    for g, t, j in zip(got, twin, jax):
        assert g.dtype == t.dtype and torch.equal(g, t)
        want = np.asarray(j)
        assert g.numpy().dtype == want.dtype
        np.testing.assert_array_equal(g.numpy(), want)


@pytest.mark.parametrize("op,shape,forest",
                         [c for c in CASES if c[1] == SHAPES[0]])
def test_fake_gives_the_shapes_on_meta(op, shape, forest):
    """On meta tensors the op runs its fake: the CPU kernel's shapes and
    dtypes, no values."""
    args, twin, _ = case(op, shape, forest)
    meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args)
    got = _outputs(getattr(torch.ops.ogpc, op)(*meta))
    assert [(g.device.type, g.shape, g.dtype) for g in got] == [
        ("meta", t.shape, t.dtype) for t in twin]


def test_wrappers_refuse_meta_tensors():
    """The public wrappers keep their device check: only the CPU and CUDA
    have a kernel, though the ops' fakes take meta tensors."""
    tm = tmask("defaultZeroForest.txt")
    img = torch.zeros((40, 40), dtype=torch.uint8, device="meta")
    slab = torch.zeros((40, 40), dtype=torch.uint8, device="meta")
    key = torch.zeros((2, 256), dtype=torch.int32, device="meta")
    for call in (
            lambda: tfused.fused_keys(img, tm, THR, 0, SENTINEL_BASE),
            lambda: tfused.fused_keys_slab(slab, tm, THR, 0, SENTINEL_BASE,
                                           0, 12),
            lambda: tfused.fused_key_image(img[None], img[None], tm, THR,
                                           SENTINEL_BASE),
            lambda: tfused.fused_key_image_slab(slab, slab, tm, THR,
                                                SENTINEL_BASE, 0, 12),
            lambda: tfused.fused_codes(img, tm, THR),
            lambda: tfused.fused_codes_pair(img, img, tm, THR),
            lambda: tfused.fused_census(img),
            lambda: tsort.bitonic_sort_rows(key, key),
            lambda: tfm.fused_sparsematch_rows(img, img, tm, THR, 8)):
        with pytest.raises(ValueError, match="no kernel"):
            call()


def test_ops_registered_with_int_list_tests():
    """The nine ops are in ``torch.ops.ogpc``; the ones that take the
    forest take it as an ``int[]`` (T * 5 host ints, a constant of an
    exported graph), and none mutates its arguments."""
    assert sorted(library.OPS) == sorted(TESTS_OPS + ("fused_census",
                                                      "bitonic_sort_rows"))
    for name in library.OPS:
        schema = getattr(torch.ops.ogpc, name).default._schema
        args = {a.name: str(a.type) for a in schema.arguments}
        if name in TESTS_OPS:
            assert args["tests"] == "List[int]"
        assert not any(a.alias_info for a in schema.arguments)
    tm = tmask("defaultTauForest.txt")
    flat = tfused.op_tests(tm)
    assert len(flat) == 5 * tm.num_tests
    assert tfused._test_rows(flat) == tfused.mask_tests(tm)


@pytest.mark.parametrize("w", [1, 64, 127, 128, 129, 500, 1024, 1025, 8192])
def test_padded_row_length_loop_matches_bit_length(w):
    """The fakes' N2, a loop of compares that a symbolic W traces, is the
    JAX package's ``max(256, 1 << (2W - 1).bit_length())``."""
    assert library.padded_row_length(w) == tsort.padded_row_length(w) == max(
        256, 1 << (2 * w - 1).bit_length())


def test_slab_into_copies_the_op_result():
    """``fused_keys_slab_into`` writes the slab op's keys into its column
    range and leaves the rest of ``out`` alone."""
    rng = np.random.default_rng(3)
    img = structured_image(rng, 60, 50)
    slab = torch.from_numpy(slab_of(img, 20, 20))
    tm = tmask("defaultZeroForest.txt")
    out = torch.full((20, 100), -1, dtype=torch.int32)
    tfused.fused_keys_slab_into(slab, out, 50, tm, THR, 50, SENTINEL_BASE,
                                20, 60)
    assert (out[:, :50] == -1).all()
    assert torch.equal(out[:, 50:], torch.ops.ogpc.fused_keys_slab(
        slab, tfused.op_tests(tm), THR, 50, SENTINEL_BASE, 20, 60))


def test_package_exports_the_jax_packages_names():
    """Every public name of ``opengpc_tpu/__init__.py`` is importable from
    ``opengpc_tpu_torch`` and listed in its ``__all__``: the forest types
    (``Forest``, ``Fern``, ``Test``, ``FilterMask``, ``parse_forest``,
    ``truncate_forest``) and the nine ``aot`` functions among them."""
    names = [n for n in vars(opengpc_tpu) if not n.startswith("_")
             and not isinstance(getattr(opengpc_tpu, n), type(os))]
    for name in ("Forest", "Fern", "Test", "FilterMask", "parse_forest",
                 "truncate_forest", "export_sparsematch", "load_sparsematch",
                 "export_sharded_frame", "load_sharded_frame",
                 "export_batched_sharded_frame",
                 "load_batched_sharded_frame", "save_artifact",
                 "load_artifact", "peek_artifact_meta"):
        assert name in names
    missing = [n for n in names if not hasattr(opengpc_tpu_torch, n)
               or n not in opengpc_tpu_torch.__all__]
    assert not missing
    from opengpc_tpu_torch import (Fern, FilterMask, Forest, Test,  # noqa
                                   parse_forest, truncate_forest)
    assert Forest is tforest.Forest and FilterMask is tforest.FilterMask
