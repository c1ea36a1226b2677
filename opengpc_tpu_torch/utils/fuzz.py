"""Random valid forests for the port's fuzz tests and the chip smoke run.

A numpy copy of ``opengpc_tpu.utils.fuzz``: the same draws in the same
order, so one ``np.random.Generator`` seed gives the same forest text in
both packages."""

from __future__ import annotations

import numpy as np

from opengpc_tpu_torch.forest import SCALE_HALF, Fern, Forest, Test


def random_forest(rng: np.random.Generator,
                  max_ferns: int = 4,
                  max_tests_per_fern: int = 12) -> Forest:
    """A random valid forest: 1..max_ferns ferns of random scales, test
    offsets spanning each scale's half-width (the reference trainer's
    candidate domain), and either all-zero taus (zero type) or taus drawn
    from the tau optimizer's [-10, 10) range.  Total test counts can cross
    both routing boundaries: past 30 tests the sentinel-packed contracts
    give way to the flat matcher, past 32 the filter mask's file-order cap
    applies."""
    zero = bool(rng.integers(0, 2))
    ferns = []
    for _ in range(int(rng.integers(1, max_ferns + 1))):
        scale = int(rng.choice(list(SCALE_HALF)))
        half = SCALE_HALF[scale]
        tests = tuple(
            Test(ix=int(rng.integers(-half, half + 1)),
                 iy=int(rng.integers(-half, half + 1)),
                 jx=int(rng.integers(-half, half + 1)),
                 jy=int(rng.integers(-half, half + 1)),
                 tau=0 if zero else int(rng.integers(-10, 10)))
            for _ in range(int(rng.integers(1, max_tests_per_fern + 1))))
        ferns.append(Fern(scale, tests))
    return Forest(tuple(ferns))
