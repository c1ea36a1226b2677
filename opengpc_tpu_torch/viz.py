"""Disparity visualization (KITTI colormap overlay; numpy only, the port's
copy of ``opengpc_tpu.viz``, byte for byte the same images).

Equivalent of the reference's ``getDisparityVisualization``
(buffer.hpp:876-1014): overlay sparse disparity
supports on the grayscale source image, colored with Andreas Geiger's
8-bin KITTI colormap, disparity normalized to [0, 128] and clamped at 0.8.

Vectorized numpy throughout (host-side output path, not device compute).

Deliberate deviation, with an opt-out: the reference's Support overload
(buffer.hpp:949-1014) uses a colormap table rotated by one entry relative
to its index-based overload and the published KITTI devkit (first bin
{0,0,1} instead of {0,0,0}) — almost certainly an editing slip.  The
default is the canonical KITTI table (buffer.hpp:891-894);
``compat="reference"`` reproduces the rotated table with the reference's
exact float32 arithmetic, byte-identical to the PNG the reference binary
writes (pinned for the JAX package in tests/test_reference_binary.py,
and the port against it in tests/test_torch_viz.py).
"""

from __future__ import annotations

import numpy as np

# Canonical KITTI colormap: (r, g, b, weight) per bin (buffer.hpp:891-894).
_MAP = np.array(
    [
        [0, 0, 0, 114],
        [0, 0, 1, 185],
        [1, 0, 0, 114],
        [1, 0, 1, 174],
        [0, 1, 0, 114],
        [0, 1, 1, 185],
        [1, 1, 0, 114],
        [1, 1, 1, 0],
    ],
    dtype=np.float32,
)

# The reference Support-overload's table, rotated by one entry
# (buffer.hpp:960-963) — kept for byte-compatible output only.
_MAP_REFERENCE = np.roll(_MAP, -1, axis=0)


def _tables(map_arr: np.ndarray):
    """(cumsum[0..7], weights[0..6]) in the reference's float32 evaluation
    order: per-bin weight divided first, THEN accumulated
    (buffer.hpp:901-910) — the rounding order matters for byte-identity."""
    s = np.float32(map_arr[:, 3].sum(dtype=np.float32))
    cumsum = np.concatenate(
        [[np.float32(0.0)],
         np.cumsum((map_arr[:7, 3] / s).astype(np.float32), dtype=np.float32)]
    ).astype(np.float32)
    with np.errstate(divide="ignore"):
        weights = (s / map_arr[:7, 3]).astype(np.float32)
    return cumsum, weights


_CUMSUM, _WEIGHTS = _tables(_MAP)
_CUMSUM_REF, _WEIGHTS_REF = _tables(_MAP_REFERENCE)


def kitti_disparity_colors(
    d: np.ndarray, min_disparity: float = 0.0, max_disparity: float = 128.0,
    compat: str = "canonical",
) -> np.ndarray:
    """Map disparities to (n, 3) uint8 RGB via the KITTI colormap.

    value = clamp((d - min) / (max - min), 0, 0.8); piecewise-linear
    interpolation between bin colors (buffer.hpp:920-944).
    ``compat="reference"`` uses the reference Support-overload's
    rotated-by-one table (see module docstring).
    """
    if compat == "reference":
        cmap, cumsum, weights = _MAP_REFERENCE, _CUMSUM_REF, _WEIGHTS_REF
    elif compat == "canonical":
        cmap, cumsum, weights = _MAP, _CUMSUM, _WEIGHTS
    else:
        raise ValueError(f"unknown viz compat mode {compat!r}")
    d = np.asarray(d, dtype=np.float32)
    value = np.clip(
        (d - np.float32(min_disparity))
        / np.float32(max_disparity - min_disparity),
        np.float32(0.0), np.float32(0.8),
    ).astype(np.float32)
    bin_idx = np.clip(np.searchsorted(cumsum[1:8], value, side="right"), 0, 6)
    w = (np.float32(1.0) - (value - cumsum[bin_idx]) * weights[bin_idx]).astype(
        np.float32
    )
    w = w[..., None]
    rgb = (w * cmap[bin_idx, :3]
           + (np.float32(1.0) - w) * cmap[bin_idx + 1, :3]) * np.float32(255.0)
    # C truncation cast (static_cast<uint8_t>), matching the reference
    return rgb.astype(np.uint8)


def disparity_visualization(
    gray: np.ndarray,
    supports: np.ndarray,
    min_disparity: float = 0.0,
    max_disparity: float = 128.0,
    compat: str = "canonical",
) -> np.ndarray:
    """Overlay (n, 3) int supports (x, y, d) on a (h, w) uint8 gray image.

    Returns an (h, w, 3) uint8 RGB image (buffer.hpp:949-1014 semantics;
    ``compat="reference"`` reproduces the reference binary's bytes with its
    rotated colormap table — see module docstring).
    """
    gray = np.asarray(gray, dtype=np.uint8)
    out = np.repeat(gray[:, :, None], 3, axis=2)
    supports = np.asarray(supports)
    if supports.size == 0:
        return out
    x, y, d = supports[:, 0], supports[:, 1], supports[:, 2]
    out[y, x] = kitti_disparity_colors(d, min_disparity, max_disparity,
                                       compat=compat)
    return out


def dense_disparity_visualization(
    gray: np.ndarray,
    disparity: np.ndarray,
    valid: np.ndarray,
    min_disparity: float = 0.0,
    max_disparity: float = 128.0,
) -> np.ndarray:
    """Overlay a dense (h, w) disparity map where ``valid`` is set.

    Equivalent of the reference's index-list getDisparityVisualization
    overload (buffer.hpp:876-948)."""
    gray = np.asarray(gray, dtype=np.uint8)
    out = np.repeat(gray[:, :, None], 3, axis=2)
    yy, xx = np.nonzero(np.asarray(valid))
    if len(yy):
        out[yy, xx] = kitti_disparity_colors(
            np.asarray(disparity)[yy, xx], min_disparity, max_disparity
        )
    return out


def draw_line(img: np.ndarray, x0: int, y0: int, x1: int, y1: int,
              color) -> None:
    """Draw a line segment in-place on an (h, w, 3) uint8 image.

    Host-side equivalent of the reference's Buffer line rasterizer
    (buffer.hpp:555-628); vectorized sampling instead of an incremental
    scalar loop."""
    h, w = img.shape[:2]
    n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    xs = np.rint(np.linspace(x0, x1, n)).astype(int)
    ys = np.rint(np.linspace(y0, y1, n)).astype(int)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = color


def draw_triangle(img: np.ndarray, pts, color) -> None:
    """Fill a triangle in-place on an (h, w, 3) uint8 image.

    Host-side equivalent of the reference Buffer's triangle rasterizer
    (buffer.hpp:655-752 — dead code there, kept as a supported viz
    primitive here); barycentric point-in-triangle test over the bounding
    box instead of a scanline span walker."""
    (x0, y0), (x1, y1), (x2, y2) = pts
    h, w = img.shape[:2]
    xmin = max(0, min(x0, x1, x2))
    xmax = min(w - 1, max(x0, x1, x2))
    ymin = max(0, min(y0, y1, y2))
    ymax = min(h - 1, max(y0, y1, y2))
    if xmin > xmax or ymin > ymax:
        return
    xs = np.arange(xmin, xmax + 1)
    ys = np.arange(ymin, ymax + 1)
    px, py = np.meshgrid(xs, ys)

    def edge(ax, ay, bx, by):
        return (px - ax) * (by - ay) - (py - ay) * (bx - ax)

    e0 = edge(x0, y0, x1, y1)
    e1 = edge(x1, y1, x2, y2)
    e2 = edge(x2, y2, x0, y0)
    inside = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | (
        (e0 <= 0) & (e1 <= 0) & (e2 <= 0)
    )
    img[py[inside], px[inside]] = color


def draw_correspondences(
    gray_src: np.ndarray,
    supports: np.ndarray,
    max_disparity: float = 128.0,
    stride: int = 1,
) -> np.ndarray:
    """Visualize supports as short disparity vectors on the source image:
    a line from (x, y) to the matched (x - d, y), colored by d."""
    gray = np.asarray(gray_src, dtype=np.uint8)
    out = np.repeat(gray[:, :, None], 3, axis=2)
    supports = np.asarray(supports)
    if supports.size == 0:
        return out
    colors = kitti_disparity_colors(supports[:, 2], 0.0, max_disparity)
    for (x, y, d), c in zip(supports[::stride], colors[::stride]):
        draw_line(out, int(x), int(y), int(x - d), int(y), c)
    return out
