"""The port's preprocessing ops and the key kernel's plain twin against the
JAX package's jnp ops and its Pallas ``fused_keys`` (interpret mode), on
the same seeded images, with exact equality: every value is an integer."""

import os

import numpy as np
import pytest
import torch

import opengpc_tpu.forest as jforest
from opengpc_tpu.match import SENTINEL_BASE as J_SENTINEL_BASE
from opengpc_tpu.ops import codes as jcodes
from opengpc_tpu.ops import fused as jfused
from opengpc_tpu.ops import preprocess as jpre

import opengpc_tpu_torch.forest as tforest
from opengpc_tpu_torch.match import SENTINEL_BASE, _pos_bits
from opengpc_tpu_torch.ops import codes as tcodes
from opengpc_tpu_torch.ops import fused as tfused
from opengpc_tpu_torch.ops import preprocess as tpre

FORESTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "forests")
SHAPES = [(64, 96), (100, 250), (37, 130), (129, 1023)]
THR = 5


def structured_image(rng, h, w):
    small = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2))
    img = np.kron(small, np.ones((4, 4)))[:h, :w]
    return np.clip(img + rng.integers(-12, 13, (h, w)), 0, 255).astype(np.uint8)


def masks(name, max_tests=32):
    path = os.path.join(FORESTS, name)
    return (jforest.make_filter_mask(jforest.load_forest(path), max_tests),
            tforest.make_filter_mask(tforest.load_forest(path), max_tests))


def same(jarr, tensor):
    got = tensor.numpy()
    want = np.asarray(jarr)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_box3_sobel3_candidates_match_jnp(shape):
    img = structured_image(np.random.default_rng(sum(shape)), *shape)
    t = torch.from_numpy(img)
    same(jpre.box3(img), tpre.box3(t))
    jgrad = jpre.sobel3(img, THR)
    tgrad = tpre.sobel3(t, THR)
    same(jgrad, tgrad)
    cand = tpre.candidate_mask(tgrad)
    same(jpre.candidate_mask(jgrad), cand)
    assert cand.any()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("forest", ["defaultZeroForest.txt",
                                    "defaultTauForest.txt"])
def test_leaf_codes_match_jnp(shape, forest):
    img = structured_image(np.random.default_rng(sum(shape) + 1), *shape)
    jm, tm = masks(forest)
    smooth = jpre.box3(img)
    same(jcodes.leaf_codes(smooth, jm),
         tcodes.leaf_codes(torch.from_numpy(np.array(smooth)), tm))


def test_require_u8_rejects_float():
    img = np.zeros((40, 40), np.float32)
    for fn in (lambda x: tpre.box3(torch.from_numpy(x)),
               lambda x: tpre.sobel3(torch.from_numpy(x), THR),
               lambda x: tpre.require_u8(x)):
        with pytest.raises(ValueError, match="uint8"):
            fn(img)


def test_mask_tests_match_jax():
    jm, tm = masks("defaultTauForest.txt")
    assert tfused.mask_tests(tm) == jfused.mask_tests(jm)


@pytest.mark.parametrize("forest", ["defaultZeroForest.txt",
                                    "defaultTauForest.txt"])
def test_fused_keys_plain_matches_pallas_interpret(forest):
    h, w = 100, 250
    img = structured_image(np.random.default_rng(3), h, w)
    jm, tm = masks(forest)
    assert SENTINEL_BASE == J_SENTINEL_BASE
    for pos_base in (0, w):
        want = jfused.fused_keys(img, jm, THR, pos_base=pos_base,
                                 sentinel_base=J_SENTINEL_BASE, interpret=True)
        got = tfused.fused_keys_plain(torch.from_numpy(img), tm, THR,
                                      pos_base, SENTINEL_BASE)
        same(want, got)
        assert (got < SENTINEL_BASE).any()


def test_fused_keys_plain_pack_bits_matches_pallas_interpret():
    h, w = 100, 250
    img = structured_image(np.random.default_rng(4), h, w)
    jm, tm = masks("defaultZeroForest.txt", max_tests=17)
    pb = _pos_bits(2 * w)
    for pos_base in (0, w):
        want = jfused.fused_keys(img, jm, THR, pos_base=pos_base,
                                 sentinel_base=J_SENTINEL_BASE,
                                 interpret=True, pack_bits=pb)
        got = tfused.fused_keys_plain(torch.from_numpy(img), tm, THR,
                                      pos_base, SENTINEL_BASE, pack_bits=pb)
        same(want, got)


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_keys_plain_matches_jnp_key_build(shape):
    """The twin equals the key image the jnp ops build, at every shape."""
    h, w = shape
    img = structured_image(np.random.default_rng(sum(shape) + 2), h, w)
    jm, tm = masks("defaultTauForest.txt")
    cand = np.asarray(jpre.candidate_mask(jpre.sobel3(img, THR)))
    codes = np.asarray(jcodes.leaf_codes(jpre.box3(img), jm))
    want = np.where(cand, codes, SENTINEL_BASE + w + np.arange(w)[None, :])
    got = tfused.fused_keys_plain(torch.from_numpy(img), tm, THR, w,
                                  SENTINEL_BASE)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_keys_batch_and_columns_equal_single_images():
    """Each side of a batch of pairs, in its columns of the one-launch key
    image, equals the single-image wrapper at that side's positions."""
    rng = np.random.default_rng(11)
    lefts, imgs = (torch.from_numpy(np.stack([structured_image(rng, 60, 90)
                                              for _ in range(3)]))
                   for _ in range(2))
    _, tm = masks("defaultZeroForest.txt")
    out = tfused.fused_key_image(lefts, imgs, tm, THR, SENTINEL_BASE)
    for i in range(3):
        single = tfused.fused_keys(imgs[i], tm, THR, 90, SENTINEL_BASE)
        assert single.shape == (60, 90) and single.dtype == torch.int32
        assert torch.equal(out[i, :, 90:], single)
        assert torch.equal(out[i, :, :90], tfused.fused_keys(
            lefts[i], tm, THR, 0, SENTINEL_BASE))


@pytest.mark.parametrize("kwargs, match", [
    (dict(pack_bits=31), "pack_bits"),
    (dict(pack_bits=-1), "pack_bits"),
])
def test_fused_keys_rejects_bad_arguments(kwargs, match):
    _, tm = masks("defaultZeroForest.txt")
    img = torch.zeros((40, 40), dtype=torch.uint8)
    with pytest.raises(ValueError, match=match):
        tfused.fused_keys(img, tm, THR, 0, SENTINEL_BASE, **kwargs)
    with pytest.raises(ValueError, match="uint8"):
        tfused.fused_keys(img.float(), tm, THR, 0, SENTINEL_BASE)


def test_fused_keys_rejects_out_of_patch_offsets_and_device_mismatch():
    _, tm = masks("defaultZeroForest.txt")
    bad = tforest.FilterMask(i_off=tm.i_off.copy(), j_off=tm.j_off.copy(),
                             tau=tm.tau, type=tm.type)
    bad.i_off[0, 1] = 14
    img = torch.zeros((40, 40), dtype=torch.uint8)
    with pytest.raises(ValueError, match="offsets"):
        tfused.fused_keys(img, bad, THR, 0, SENTINEL_BASE)
    out = torch.empty((12, 40), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="output on"):
        tfused.fused_keys_slab_into(img, out, 0, tm, THR, 0, SENTINEL_BASE,
                                    0, 12)
    with pytest.raises(ValueError, match="no kernel"):
        tfused.fused_keys(img.to("meta"), tm, THR, 0, SENTINEL_BASE)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("forest", ["defaultZeroForest.txt",
                                    "defaultTauForest.txt"])
@pytest.mark.parametrize("w", [96, 101])
def test_fused_key_image_equals_two_twins_and_jax(batch, forest, w):
    """The one-launch pair wrapper on CPU tensors: two plain twins side by
    side, and the JAX package's key image of each pair (jnp ops and the
    Pallas kernel in interpret mode), bit for bit, at an odd width too."""
    import opengpc_tpu.infer as jinfer
    from opengpc_tpu.config import InferenceSettings as JSettings

    rng = np.random.default_rng(batch * 1000 + w)
    lefts, rights = (np.stack([structured_image(rng, 60, w)
                               for _ in range(batch)]) for _ in range(2))
    jm, tm = masks(forest)
    before = tfused.fused_keys.launches
    got = tfused.fused_key_image(torch.from_numpy(lefts),
                                 torch.from_numpy(rights), tm, THR,
                                 SENTINEL_BASE)
    assert tfused.fused_keys.launches == before == 0
    assert got.shape == (batch, 60, 2 * w) and got.dtype == torch.int32
    twins = torch.cat([
        tfused.fused_keys_plain(torch.from_numpy(lefts), tm, THR, 0,
                                SENTINEL_BASE),
        tfused.fused_keys_plain(torch.from_numpy(rights), tm, THR, w,
                                SENTINEL_BASE)], dim=2)
    assert torch.equal(got, twins)
    js = JSettings(gradient_threshold=THR, epipolar_mode=True)
    for i in range(batch):
        same(jinfer._key_image_jnp(lefts[i], rights[i], jm, js), got[i])
    pallas = [jfused.fused_keys(img, jm, THR, pos_base=pos,
                                sentinel_base=J_SENTINEL_BASE, interpret=True)
              for img, pos in ((lefts[0], 0), (rights[0], w))]
    same(np.concatenate(pallas, axis=1), got[0])


def test_fused_key_image_rejects_bad_pairs():
    _, tm = masks("defaultZeroForest.txt")
    img = torch.zeros((2, 40, 40), dtype=torch.uint8)
    with pytest.raises(ValueError, match="batches"):
        tfused.fused_key_image(img, img[:1], tm, THR, SENTINEL_BASE)
    with pytest.raises(ValueError, match="batches"):
        tfused.fused_key_image(img[0], img[0], tm, THR, SENTINEL_BASE)
    with pytest.raises(ValueError, match="uint8"):
        tfused.fused_key_image(img.float(), img, tm, THR, SENTINEL_BASE)
    with pytest.raises(ValueError, match="no kernel"):
        tfused.fused_key_image(img.to("meta"), img.to("meta"), tm, THR,
                               SENTINEL_BASE)
