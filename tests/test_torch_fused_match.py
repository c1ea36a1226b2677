"""The fused match kernel's plain twin against the JAX package's Pallas
kernel (interpret mode), and ``_sparsematch_impl(fused_match=True)``
against JAX's same call: (keep, src_x, d) and the flat buffers
bit-identical."""

import numpy as np
import pytest
import torch

import opengpc_tpu as jt
import opengpc_tpu.infer as jinfer
from opengpc_tpu.ops import fused_match as jfm

import opengpc_tpu_torch as pt
import opengpc_tpu_torch.infer as tinfer
from opengpc_tpu_torch.ops import fused_match as tfm
from opengpc_tpu_torch.ops.sort import padded_row_length
from test_torch_flat import assert_same, masks, structured_image

SHAPES = [(48, 80), (70, 100), (37, 130)]  # N2 = 256, 256, 512


def shifted_pair(shape):
    """tests/test_fused_match.py's inputs: a structured image and its copy
    shifted 3 px, with fresh noise in the uncovered columns."""
    rng = np.random.default_rng(sum(shape))
    h, w = shape
    left = structured_image(rng, h, w)
    right = np.roll(left, -3, axis=1)
    right[:, -3:] = rng.integers(0, 256, (h, 3)).astype(np.uint8)
    return left, right


def settings_pair():
    kw = dict(gradient_threshold=5, vertical_tolerance=0, disp_high=64,
              epipolar_mode=True, capacity=16384)
    return jt.InferenceSettings(**kw), pt.InferenceSettings(**kw)


@pytest.mark.parametrize("name", ["zero", "tau"])
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_match_plain_equals_pallas(shape, name):
    left, right = shifted_pair(shape)
    jm, tm = masks(name)
    jkeep, jsrc, jd = jfm.fused_sparsematch_rows(left, right, jm, 5, 64,
                                                 interpret=True)
    before = tfm.fused_sparsematch_rows.launches
    keep, src, d = tfm.fused_sparsematch_rows(
        torch.from_numpy(left), torch.from_numpy(right), tm, 5, 64)
    assert tfm.fused_sparsematch_rows.launches == before == 0
    assert keep.dtype == torch.bool
    assert keep.shape == (shape[0], padded_row_length(shape[1]))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert keep.any() and not keep[:, -1].any()


@pytest.mark.parametrize("name", ["zero", "tau"])
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_match_impl_equals_jax(shape, name):
    left, right = shifted_pair(shape)
    jm, tm = masks(name)
    js, ts = settings_pair()
    jout = jinfer._sparsematch_impl(left, right, mask=jm, settings=js,
                                    fused_match=True)
    tout = tinfer._sparsematch_impl(torch.from_numpy(left),
                                    torch.from_numpy(right), tm, ts,
                                    fused_match=True)
    assert_same(jout, tout)
    split = tinfer._sparsematch_impl(torch.from_numpy(left),
                                     torch.from_numpy(right), tm, ts)
    got = pt.supports_to_numpy(*tout)
    want = pt.supports_to_numpy(*split)
    assert len(got) > 0
    assert set(map(tuple, got.tolist())) == set(map(tuple, want.tolist()))


def test_fused_match_limits():
    _, tm = masks("zero")
    _, t32 = masks("t32")
    img = torch.zeros((30, 40), dtype=torch.uint8)
    with pytest.raises(ValueError, match="30 tests"):
        tfm.fused_sparsematch_rows(img, img, t32, 5, 64)
    wide = torch.zeros((2, tfm.MAX_WIDTH + 1), dtype=torch.uint8)
    with pytest.raises(ValueError, match="W <= 8192"):
        tfm.fused_sparsematch_rows(wide, wide, tm, 5, 64)
    with pytest.raises(ValueError, match="disp_high"):
        tfm.fused_sparsematch_rows(img, img, tm, 5, -1)
    with pytest.raises(ValueError, match="no kernel"):
        tfm.fused_sparsematch_rows(img.to("meta"), img.to("meta"), tm, 5, 64)
    with pytest.raises(ValueError, match="uint8"):
        tfm.fused_sparsematch_rows(img.float(), img, tm, 5, 64)
