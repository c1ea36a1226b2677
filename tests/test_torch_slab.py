"""The slab key kernel's plain twin against the JAX package's
``fused_keys_slab`` (Pallas interpret mode) and ``_key_image_jnp_slab`` on
the CPU, bit for bit, for slabs at the top, in the middle and at the bottom
of a frame whose shard height is not a multiple of the kernel's 32-row
tile; and the slabs joined equal the whole-frame key image."""

import numpy as np
import pytest
import torch

import opengpc_tpu.infer as jinfer
from opengpc_tpu.ops import fused as jfused

import opengpc_tpu_torch as pt
import opengpc_tpu_torch.infer as tinfer
from opengpc_tpu_torch.match import SENTINEL_BASE
from opengpc_tpu_torch.ops import fused as tfused
from test_torch_flat import masks, structured_image

PAD = tfused.PAD
SH, N, W = 37, 3, 90  # three 37-row shards of a 111-row frame
THR = 5


def slab_of(img, y0, sh):
    """Rows [y0 - PAD, y0 + sh + PAD) of ``img``, zeros outside it."""
    padded = np.pad(img, ((PAD, PAD), (0, 0)))
    return np.ascontiguousarray(padded[y0:y0 + sh + 2 * PAD])


@pytest.mark.parametrize("shard", [0, 1, 2])
@pytest.mark.parametrize("name", ["zero", "tau", "t32"])
def test_slab_twin_matches_pallas_and_jnp(name, shard):
    jm, tm = masks(name)
    rng = np.random.default_rng(shard)
    img = structured_image(rng, SH * N, W)
    y0 = shard * SH
    slab = slab_of(img, y0, SH)
    for pos_base in (0, W):
        got = tfused.fused_keys_slab_plain(torch.from_numpy(slab), tm, THR,
                                           pos_base, SENTINEL_BASE, y0,
                                           SH * N)
        want = jfused.fused_keys_slab(slab, jm, THR, pos_base, SENTINEL_BASE,
                                      y0, SH * N, interpret=True)
        assert got.dtype == torch.int32 and got.shape == (SH, W)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got < SENTINEL_BASE).any()
    # the pair's key image against the jnp slab twin
    right = slab_of(structured_image(rng, SH * N, W), y0, SH)
    settings = pt.InferenceSettings(gradient_threshold=THR)
    got = tinfer._key_image_slab(torch.from_numpy(slab),
                                 torch.from_numpy(right), tm, settings, y0,
                                 SH * N)
    want = jinfer._key_image_jnp_slab(slab, right, jm, settings, y0, SH * N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shard", [0, 1, 2])
def test_key_image_slab_pair_matches_jnp(shard):
    """``_key_image_slab`` on the two slabs of one contiguous (2, sh + 28,
    W) tensor, as ``parallel._slab_keys`` builds them (one slab-mode launch
    on the card), and on (B, sh + 28, W) batches of left and right slabs,
    equals JAX's ``_key_image_jnp_slab`` for the top, middle and bottom
    shards."""
    jm, tm = masks("tau")
    rng = np.random.default_rng(40 + shard)
    y0 = shard * SH
    slabs = np.stack([slab_of(structured_image(rng, SH * N, W), y0, SH)
                      for _ in range(4)])
    settings = pt.InferenceSettings(gradient_threshold=THR)
    pair = torch.from_numpy(slabs[:2])
    before = tfused.fused_keys_slab.launches
    got = tinfer._key_image_slab(pair[0], pair[1], tm, settings, y0, SH * N)
    want = jinfer._key_image_jnp_slab(slabs[0], slabs[1], jm, settings, y0,
                                      SH * N)
    assert got.shape == (SH, 2 * W) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lefts, rights = (torch.from_numpy(slabs[k::2]) for k in (0, 1))
    batch = tinfer._key_image_slab(lefts, rights, tm, settings, y0, SH * N)
    assert batch.shape == (2, SH, 2 * W)
    for i in range(2):
        np.testing.assert_array_equal(batch[i].numpy(), np.asarray(
            jinfer._key_image_jnp_slab(slabs[2 * i], slabs[2 * i + 1], jm,
                                       settings, y0, SH * N)))
    assert tfused.fused_keys_slab.launches == before == 0


@pytest.mark.parametrize("n, sh", [(1, 50), (2, 33), (4, 27), (8, 14)])
def test_slabs_join_to_the_whole_frame(n, sh):
    """Every shard's keys, joined, equal the whole frame's: top and bottom
    shards see zero halos, inner ones their neighbours' rows."""
    _, tm = masks("zero")
    img = structured_image(np.random.default_rng(n), n * sh, W)
    whole = tfused.fused_keys_plain(torch.from_numpy(img), tm, THR, W,
                                    SENTINEL_BASE)
    joined = torch.cat([
        tfused.fused_keys_slab(torch.from_numpy(slab_of(img, i * sh, sh)),
                               tm, THR, W, SENTINEL_BASE, i * sh, n * sh)
        for i in range(n)])
    assert torch.equal(joined, whole)


def test_slab_wrapper_on_cpu_runs_twin_and_counts_no_launch():
    _, tm = masks("zero")
    slab = torch.from_numpy(slab_of(structured_image(
        np.random.default_rng(0), 60, W), 20, 20))
    before = tfused.fused_keys_slab.launches
    out = torch.full((20, 2 * W), -1, dtype=torch.int32)
    tfused.fused_keys_slab_into(slab, out, W, tm, THR, W, SENTINEL_BASE, 20,
                                60)
    assert tfused.fused_keys_slab.launches == before == 0
    assert (out[:, :W] == -1).all()
    assert torch.equal(out[:, W:], tfused.fused_keys_slab_plain(
        slab, tm, THR, W, SENTINEL_BASE, 20, 60))


def test_slab_guards():
    _, tm = masks("zero")
    slab = torch.zeros((20 + 2 * PAD, W), dtype=torch.uint8)
    for y0, h_total in ((0, 19), (-1, 40), (30, 40)):
        with pytest.raises(ValueError, match="does not fit"):
            tfused.fused_keys_slab(slab, tm, THR, 0, SENTINEL_BASE, y0,
                                   h_total)
    with pytest.raises(ValueError, match="does not fit"):
        tfused.fused_keys_slab(slab[:2 * PAD], tm, THR, 0, SENTINEL_BASE, 0,
                               40)
    with pytest.raises(ValueError, match="uint8"):
        tfused.fused_keys_slab(slab.float(), tm, THR, 0, SENTINEL_BASE, 0, 40)
    with pytest.raises(ValueError, match="cannot hold"):
        tfused.fused_keys_slab_into(slab, torch.zeros((20, W - 1),
                                                      dtype=torch.int32),
                                    0, tm, THR, 0, SENTINEL_BASE, 0, 40)
    with pytest.raises(ValueError, match="differ"):
        tinfer._key_image_slab(slab, slab[:, :-1], tm,
                               pt.InferenceSettings(), 0, 40)
