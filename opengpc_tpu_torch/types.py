"""Core value types (numpy only; the port's copy of
``opengpc_tpu.types``).

Python equivalents of the reference's small structs (buffer.hpp:41-139).
The device pipelines use plain tensors (struct of arrays); these types are
the host-side API surface and interop helpers.

The reference's ``ConfidentSupport``/``InvalidMatch``/``Triangle``/
``Edge``/``Span`` structs (buffer.hpp:104-139) are declared-but-unused
refinement hooks with no behavior; they are intentionally not carried
over (see PARITY.md).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass(frozen=True, order=True)
class Point:
    """Integer pixel coordinate (buffer.hpp:52-56)."""

    x: int
    y: int


@dataclasses.dataclass(frozen=True)
class Support:
    """Sparse disparity support: left-image (x, y) and disparity d
    (buffer.hpp:91-97)."""

    x: int
    y: int
    d: int


@dataclasses.dataclass(frozen=True)
class Correspondence:
    """A matched point pair (buffer.hpp:99-102)."""

    src: Point
    tar: Point


@dataclasses.dataclass(frozen=True, order=True)
class Descriptor:
    """A leaf-code descriptor: 64-bit state + location (buffer.hpp:58-87).

    Ordering/equality are by state, like the reference's operator< and
    operator== (buffer.hpp:73-80).
    """

    state: int
    point: Point = dataclasses.field(compare=False, default=Point(0, 0))
    src: bool = dataclasses.field(compare=False, default=True)


def supports_from_array(arr: np.ndarray) -> List[Support]:
    """(n, 3) int array of (x, y, d) rows -> list of Support."""
    return [Support(int(x), int(y), int(d)) for x, y, d in np.asarray(arr)]


def supports_to_array(supports: List[Support]) -> np.ndarray:
    """List of Support -> (n, 3) int32 array."""
    return np.array([(s.x, s.y, s.d) for s in supports], np.int32).reshape(-1, 3)


def correspondences_from_supports(arr: np.ndarray) -> List[Correspondence]:
    """Supports (x, y, d) -> correspondences ((x, y) -> (x - d, y)), the
    inverse of rectifiedMatch's d = srcX - tarX (inference.hpp:384-391)."""
    return [
        Correspondence(Point(int(x), int(y)), Point(int(x - d), int(y)))
        for x, y, d in np.asarray(arr)
    ]
