"""The device input generator: the same seed gives the same pool on any
device, the textured share, the disparities and the vertical offsets
follow the traffic, and a traffic without ``vertical`` gives the pools it
gave before the key existed."""

import hashlib

import numpy as np
import pytest
import torch

from gpcbench import generator, registry
from gpcbench.reference import gpc

BIG = 2**31 + 2**40 + 12345  # past 32 signed bits, as the driver's seeds are


@pytest.mark.parametrize("seed", [0, 7, BIG])
def test_same_seed_same_pool(seed):
    a = generator.make_pool(seed, 5, 48, 160, 0.15, (4, 96))
    b = generator.make_pool(seed, 5, 48, 160, 0.15, (4, 96), chunk=2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_seeds_differ():
    a = generator.make_pool(1, 2, 48, 160, 0.15, (4, 96))[0]
    b = generator.make_pool(2, 2, 48, 160, 0.15, (4, 96))[0]
    assert not torch.equal(a, b)


def test_hash_matches_python_ints():
    x = torch.arange(0, 5000, 37, dtype=torch.int64)
    assert generator._hash(x).tolist() == [generator._mix(int(v))
                                           for v in x]


@pytest.mark.parametrize("density", [0.05, 0.15, 0.3])
def test_candidate_share_near_density(density):
    lefts, rights, _ = generator.make_pool(BIG, 4, 240, 480, density,
                                           (4, 96))
    for imgs in (lefts, rights):
        cand = gpc.candidates(imgs.numpy(), 5)[:, 13:-13, 13:-13]
        assert 0.6 * density <= cand.mean() <= 1.2 * density


@pytest.mark.parametrize("lo,hi", [(4, 96), (8, 128), (5, 5)])
def test_disparity_follows_traffic(lo, hi):
    lefts, rights, ds = generator.make_pool(3, 16, 32, 300, 0.15, (lo, hi))
    assert ds.min() >= lo and ds.max() <= hi
    if hi > lo:
        assert len(set(ds.tolist())) > 4
    for left, right, d in zip(lefts, rights, ds.tolist()):
        # left(x) == right(x - d): the right image is the scene shifted
        assert torch.equal(left[:, d:], right[:, :right.shape[1] - d])


# sha256 of lefts, rights and ds of each cell's traffic (its density and
# disparity range, its pool cut to ``pairs`` pairs of h x w) as the
# generator made them before the ``vertical`` key existed
POOLS = {
    ("b32_inflight2_card", 3_000_000_017, 8, 96, 256):
        "eb01b47664607b2a8da8036fff97a64d598309d9e4a24027ebcc0083df08149a",
    ("b32_inflight2_card", 2**33 + 9, 8, 96, 256):
        "a2953ef576f5cb269618963c0da910b8b03774dc1595d96cf68db468a9e68753",
    ("b1_inflight1_card", 3_000_000_017, 3, 120, 320):
        "f2160051a28839fb93e2c6567bf028c72dfa116cf45ad1d939a3bee2138a162d",
    ("b1_inflight1_card", 2**33 + 9, 3, 120, 320):
        "e23c98cc215a56ee3345c316f03c7b8a152a447e2c81c9462a3978c900056c7e",
}


@pytest.mark.parametrize("key", sorted(POOLS, key=str))
def test_pools_without_vertical_are_unchanged(key):
    name, seed, pairs, h, w = key
    tr = registry.traffic(name)
    assert "vertical" not in tr
    pool = generator.make_pool(seed, pairs, h, w, tr["density"],
                               tr["disparity"], vertical=tr.get("vertical"))
    digest = hashlib.sha256(b"".join(t.numpy().tobytes() for t in pool))
    assert digest.hexdigest() == POOLS[key]


@pytest.mark.parametrize("lo,hi", [(-1, 1), (0, 2), (-3, -1)])
def test_vertical_offset_follows_traffic(lo, hi):
    lefts, rights, ds = generator.make_pool(BIG, 12, 40, 200, 0.15, (4, 96),
                                            vertical=(lo, hi))
    dys = generator.vertical_offsets(BIG, 12, lo, hi)
    assert dys.min() >= lo and dys.max() <= hi and len(set(dys.tolist())) > 1
    h, w = lefts.shape[1:]
    for left, right, d, dy in zip(lefts, rights, ds.tolist(), dys.tolist()):
        # left(y, x) == right(y - dy, x - d)
        a, b = max(0, dy), max(0, -dy)
        assert torch.equal(left[a:h - b, d:], right[b:h - a, :w - d])
    # the disparities are drawn as without the key
    assert torch.equal(ds, generator.disparities(BIG, 12, 4, 96))


def test_background_is_below_threshold():
    lefts, _, _ = generator.make_pool(11, 2, 96, 256, 0.0, (4, 96))
    assert not gpc.candidates(lefts.numpy(), 5).any()


@pytest.mark.card
def test_pool_equal_on_card_and_cpu(card):
    a = generator.make_pool(BIG, 6, 64, 200, 0.15, (4, 96), "cpu")
    b = generator.make_pool(BIG, 6, 64, 200, 0.15, (4, 96), card)
    assert all(torch.equal(x, y.cpu()) for x, y in zip(a, b))
    assert np.array_equal(a[2].numpy(), b[2].cpu().numpy())
