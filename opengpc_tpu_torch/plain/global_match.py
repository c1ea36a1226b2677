"""Global-mode sparse matching in plain PyTorch: the library's default
``InferenceSettings`` mode, computed the long way round for the tests.

It shares no code with the port's key kernel, matchers or routes
(``ops``, ``match``, ``infer``): the box blur, the Sobel test, the
candidates and the leaf codes are whole-image tensor arithmetic, and a
code's uniqueness is counted with ``torch.unique`` over both images'
candidates rather than read from sort windows.

* box: the 3 x 3 mean of the uint8 image, floored, on rows 1 .. h-3 and
  columns 2 .. w-2, zero elsewhere (openGPC's filter border);
* textured: Sobel x and y numerators each divided by 9 with truncation
  toward zero, sx^2 + sy^2 > threshold^2, on rows and columns 1 .. dim-2;
* candidates: textured pixels at least 13 px from every border;
* leaf code: the forest's first 32 tests in file order, test 0 the most
  significant bit, each ``box[p + (iy, ix)] > box[p + (jy, jx)] - tau``;
* a support: a code that occurs exactly twice among both images'
  candidates, once in each, kept when |d| <= disp_high and |y_l - y_r| <=
  vertical_tolerance, with d = x_l - x_r.
"""

from __future__ import annotations

import torch

MARGIN = 13


def _box(img: torch.Tensor) -> torch.Tensor:
    x = img.to(torch.int64)
    h, w = x.shape
    total = sum(x[1 + dy:h - 2 + dy, 2 + dx:w - 1 + dx]
                for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    out = torch.zeros_like(x)
    out[1:h - 2, 2:w - 1] = torch.div(total, 9, rounding_mode="floor")
    return out


def _candidates(img: torch.Tensor, threshold: int) -> torch.Tensor:
    x = img.to(torch.int64)
    h, w = x.shape

    def at(dy, dx):
        return x[1 + dy:h - 1 + dy, 1 + dx:w - 1 + dx]

    sx = (at(-1, -1) + at(1, -1) + 2 * at(0, -1)
          - at(-1, 1) - 2 * at(0, 1) - at(1, 1))
    sy = (at(-1, -1) + at(-1, 1) + 2 * at(-1, 0)
          - at(1, -1) - 2 * at(1, 0) - at(1, 1))
    sx = torch.div(sx, 9, rounding_mode="trunc")
    sy = torch.div(sy, 9, rounding_mode="trunc")
    tex = torch.zeros((h, w), dtype=torch.bool)
    tex[1:h - 1, 1:w - 1] = sx * sx + sy * sy > threshold * threshold
    inner = torch.zeros_like(tex)
    inner[MARGIN:h - MARGIN, MARGIN:w - MARGIN] = True
    return tex & inner


def _codes(img: torch.Tensor, tests, ys, xs) -> torch.Tensor:
    """int64 leaf codes of the pixels (ys, xs) of one image."""
    box = _box(img)
    code = torch.zeros(len(ys), dtype=torch.int64)
    for t in tests:
        a = box[ys + t.iy, xs + t.ix]
        b = box[ys + t.jy, xs + t.jx]
        code = (code << 1) | (a > b - t.tau).to(torch.int64)
    return code


def global_supports(left, right, forest, gradient_threshold: int,
                    disp_high: int, vertical_tolerance: int):
    """The global-mode supports of one rectified pair of (H, W) uint8
    images (arrays or tensors) under ``forest`` (a
    ``opengpc_tpu_torch.Forest``): (ys, xs, ds) int64 tensors, the left
    image's row and column and d = x_l - x_r, ordered by (y, x)."""
    tests = forest.flat_tests()
    sides = []
    for img in (left, right):
        img = torch.as_tensor(img).cpu()
        ys, xs = torch.nonzero(_candidates(img, gradient_threshold),
                               as_tuple=True)
        sides.append((ys, xs, _codes(img, tests, ys, xs)))
    (yl, xl, cl), (yr, xr, cr) = sides
    codes, inverse, counts = torch.unique(torch.cat([cl, cr]),
                                          return_inverse=True,
                                          return_counts=True)
    in_left = torch.bincount(inverse[:len(cl)], minlength=len(codes))
    paired = (counts == 2) & (in_left == 1)
    # one left and one right candidate of each paired code, in code order
    il = torch.nonzero(paired[inverse[:len(cl)]]).flatten()
    ir = torch.nonzero(paired[inverse[len(cl):]]).flatten()
    il = il[torch.argsort(cl[il])]
    ir = ir[torch.argsort(cr[ir])]
    d = xl[il] - xr[ir]
    keep = (d.abs() <= disp_high) & ((yl[il] - yr[ir]).abs()
                                     <= vertical_tolerance)
    ys, xs, ds = yl[il][keep], xl[il][keep], d[keep]
    order = torch.argsort(ys * (xs.max() + 1 if len(xs) else 1) + xs)
    return ys[order], xs[order], ds[order]
