"""The device input generator: the same seed gives the same pool on any
device, the textured share and the disparities follow the traffic."""

import numpy as np
import pytest
import torch

from gpcbench import generator
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


def test_background_is_below_threshold():
    lefts, _, _ = generator.make_pool(11, 2, 96, 256, 0.0, (4, 96))
    assert not gpc.candidates(lefts.numpy(), 5).any()


@pytest.mark.card
def test_pool_equal_on_card_and_cpu(card):
    a = generator.make_pool(BIG, 6, 64, 200, 0.15, (4, 96), "cpu")
    b = generator.make_pool(BIG, 6, 64, 200, 0.15, (4, 96), card)
    assert all(torch.equal(x, y.cpu()) for x, y in zip(a, b))
    assert np.array_equal(a[2].numpy(), b[2].cpu().numpy())
