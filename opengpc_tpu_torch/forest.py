"""GPC forest model and its persistent text format (numpy only).

The port's copy of ``opengpc_tpu.forest``: the same dataclasses, parser,
writer and filter-mask rules, kept here so that the PyTorch package never
imports the JAX one.  A *forest* is an ordered list of *ferns*; each fern
has a patch scale and an ordered list of binary tests
``img[p + (ix, iy)] > img[p + (jx, jy)] - tau`` on the box-blurred image.

Text layout (the reference writer/reader's)::

    numFerns
    fernId scaleChar numTests
    level ix iy jx jy tau     # numTests lines per fern

Inference flattens the forest to at most 32 tests in file order.  A forest
whose parsed tests all have tau == 0 is a "zero forest" (type 0), otherwise
a "tau forest" (type 1); the type counts every parsed test, including the
ones past the 32-test cap.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

# scale codes (s -> 2, m -> 1, l -> 0)
SCALE_S, SCALE_M, SCALE_L = 2, 1, 0

_SCALE_TO_CHAR = {SCALE_S: "s", SCALE_M: "m", SCALE_L: "l"}
_CHAR_TO_SCALE = {v: k for k, v in _SCALE_TO_CHAR.items()}

MAX_TESTS = 32   # inference filter-mask cap
PATCH = 27       # patch side length
PATCH_HALF = 13  # tests reach +-13 px: a 27x27 patch

# sub-window half-sizes per scale: the 7x7, 17x17 and 27x27 windows
SCALE_HALF = {SCALE_S: 3, SCALE_M: 8, SCALE_L: 13}


@dataclasses.dataclass(frozen=True)
class Test:
    """One binary test: img[p + (ix, iy)] > img[p + (jx, jy)] - tau, with
    ix the column and iy the row offset."""

    __test__ = False  # keep pytest from collecting this dataclass

    ix: int
    iy: int
    jx: int
    jy: int
    tau: int = 0


@dataclasses.dataclass(frozen=True)
class Fern:
    scale: int  # SCALE_S / SCALE_M / SCALE_L
    tests: Tuple[Test, ...]

    def __post_init__(self):
        if self.scale not in _SCALE_TO_CHAR:
            raise ValueError(f"bad fern scale {self.scale}")


@dataclasses.dataclass(frozen=True)
class Forest:
    ferns: Tuple[Fern, ...]

    @property
    def num_tests(self) -> int:
        return sum(len(f.tests) for f in self.ferns)

    @property
    def is_zero(self) -> bool:
        """True iff every test (in every fern) has tau == 0."""
        return all(t.tau == 0 for f in self.ferns for t in f.tests)

    def flat_tests(self, max_tests: int = MAX_TESTS) -> Tuple[Test, ...]:
        """Tests in file order, capped like the reference filter mask."""
        out: List[Test] = []
        for f in self.ferns:
            for t in f.tests:
                if len(out) < max_tests:
                    out.append(t)
        return tuple(out)


def parse_forest(text: str) -> Forest:
    """Parse the text forest format."""
    toks = text.split()
    pos = 0

    def nxt() -> str:
        nonlocal pos
        if pos >= len(toks):
            raise ValueError("truncated forest file")
        tok = toks[pos]
        pos += 1
        return tok

    num_ferns = int(nxt())
    ferns: List[Fern] = []
    for _ in range(num_ferns):
        _fern_id = int(nxt())
        scale_char = nxt()
        if scale_char not in _CHAR_TO_SCALE:
            raise ValueError(f"bad fern scale char {scale_char!r}")
        scale = _CHAR_TO_SCALE[scale_char]
        num_tests = int(nxt())
        tests = []
        for _ in range(num_tests):
            _level = int(nxt())
            ix, iy, jx, jy, tau = (int(nxt()) for _ in range(5))
            tests.append(Test(ix, iy, jx, jy, tau))
        ferns.append(Fern(scale, tuple(tests)))
    return Forest(tuple(ferns))


def load_forest(path: str) -> Forest:
    with open(path, "r") as f:
        return parse_forest(f.read())


def serialize_forest(forest: Forest) -> str:
    """Serialize to the reference writer's byte layout: values separated by
    single spaces, one record per line, trailing newline."""
    lines = [f"{len(forest.ferns)}"]
    for f_id, fern in enumerate(forest.ferns):
        lines.append(f"{f_id} {_SCALE_TO_CHAR[fern.scale]} {len(fern.tests)}")
        for lvl, t in enumerate(fern.tests):
            lines.append(f"{lvl} {t.ix} {t.iy} {t.jx} {t.jy} {t.tau}")
    return "\n".join(lines) + "\n"


def save_forest(forest: Forest, path: str) -> None:
    with open(path, "w") as f:
        f.write(serialize_forest(forest))


@dataclasses.dataclass(frozen=True)
class FilterMask:
    """Flattened forest ready for the key kernel.

    ``i_off``/``j_off`` have shape (T, 2) with rows (dy, dx); ``tau`` has
    shape (T,); ``type`` is 0 for a zero forest and 1 for a tau forest.
    """

    i_off: np.ndarray
    j_off: np.ndarray
    tau: np.ndarray
    type: int

    @property
    def num_tests(self) -> int:
        return int(self.i_off.shape[0])


def filter_mask_from_numpy(i_off, j_off, tau, type) -> FilterMask:
    """A mask from raw arrays, e.g. the fields of an ``opengpc_tpu``
    ``FilterMask``: (T, 2) (dy, dx) offsets, (T,) taus and the forest type.
    Applies the same checks as :func:`make_filter_mask`."""
    i_off = np.array(i_off, dtype=np.int32).reshape(-1, 2)
    j_off = np.array(j_off, dtype=np.int32).reshape(-1, 2)
    tau = np.array(tau, dtype=np.int32).reshape(-1)
    t = i_off.shape[0]
    if t == 0:
        raise ValueError("forest has no tests")
    if j_off.shape[0] != t or tau.shape[0] != t:
        raise ValueError(
            f"mask arrays disagree on the test count: i_off {i_off.shape}, "
            f"j_off {j_off.shape}, tau {tau.shape}")
    if t > MAX_TESTS:
        raise ValueError(f"a filter mask holds at most {MAX_TESTS} tests, "
                         f"got {t}")
    if int(type) not in (0, 1):
        raise ValueError(f"mask type must be 0 or 1, got {type}")
    _check_offsets(i_off, j_off)
    return FilterMask(i_off=i_off, j_off=j_off, tau=tau, type=int(type))


def _check_offsets(i_off: np.ndarray, j_off: np.ndarray) -> None:
    # every consumer assumes offsets inside the 27x27 patch window: the key
    # kernel stages a fixed PATCH_HALF halo per tile and would read the
    # wrong pixels otherwise, so a corrupt forest is rejected loudly
    if max(int(np.abs(i_off).max()), int(np.abs(j_off).max())) > PATCH_HALF:
        raise ValueError(
            f"forest test offsets exceed the {2*PATCH_HALF+1}x"
            f"{2*PATCH_HALF+1} patch window (|offset| > {PATCH_HALF}); "
            "corrupt or incompatible forest file")


def make_filter_mask(forest: Forest, max_tests: int = MAX_TESTS) -> FilterMask:
    tests = forest.flat_tests(max_tests)
    if not tests:
        raise ValueError("forest has no tests")
    i_off = np.array([(t.iy, t.ix) for t in tests], dtype=np.int32)
    j_off = np.array([(t.jy, t.jx) for t in tests], dtype=np.int32)
    _check_offsets(i_off, j_off)
    tau = np.array([t.tau for t in tests], dtype=np.int32)
    ftype = 0 if forest.is_zero else 1
    return FilterMask(i_off=i_off, j_off=j_off, tau=tau, type=ftype)


def truncate_forest(forest: Forest, max_tests: int) -> Forest:
    """A forest containing exactly ``forest.flat_tests(max_tests)``: whole
    ferns in file order, the boundary fern cut level-wise, empty trailing
    ferns dropped, so the result serializes and round-trips like any other
    forest.  It gives the same filter mask as ``make_filter_mask(forest,
    max_tests)`` except that a tau forest whose kept prefix is all-zero
    derives type 0 (the match results are the same: a tau test with tau
    == 0 is the zero test)."""
    if max_tests < 1:
        raise ValueError(f"max_tests must be >= 1, got {max_tests}")
    ferns: List[Fern] = []
    left = max_tests
    for f in forest.ferns:
        if left <= 0:
            break
        take = f.tests[:left]
        if take:
            ferns.append(Fern(scale=f.scale, tests=tuple(take)))
            left -= len(take)
    return Forest(ferns=tuple(ferns))


def patch_linear_index(ix: int, iy: int) -> int:
    """Linear index of offset (ix, iy) inside a stored 27x27 training
    patch.  Patches are stored transposed relative to image axes (byte
    ``27*a + b`` holds image pixel (y + b - 13, x + a - 13)), and training
    reads element ``(ix+13) + 27*(iy+13)`` for a test offset (ix, iy), so
    the binary triplet format and trained forests stay interchangeable
    with the reference."""
    return (ix + PATCH_HALF) + PATCH * (iy + PATCH_HALF)
