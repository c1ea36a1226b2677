"""The key kernel's roofline: the work the algorithm needs for one launch,
counted from the shapes and the inputs whatever implements it, and the
H100's peaks.

Bytes: both uint8 images read once (with a slab's halo rows, which the
rank needs) and the (pairs, rows, 2W) int32 key image written once.

Operations, in the narrowest lanes that hold their values:

* per output pixel of each image, 16-bit: the 3 x 3 box as two separable
  sums (4 adds) and its division (1); the Sobel test as two separable
  [1, 2, 1] smoothings (3 each), two differences (2), two divisions (2),
  two squares and their sum (3) and the compare with the threshold (1):
  19 in all; 32-bit: the key's select (1);
* per candidate and test, 16-bit: the subtract of tau and the compare (2);
  32-bit: the code's shift and or (2).

Peaks of one H100 SXM at its 700 W limit: HBM 3.35 TB/s (NVIDIA's data
sheet); INT32 132 SMs x 64 lanes x 1.98 GHz = 16.73 T op/s (the Hopper
SM's 64 INT32 lanes at the boost clock); 16-bit lanes, which hold every
value of the box and the Sobel test (|sx|, |sy| <= 113, sx^2 + sy^2 <=
25,538), at twice the INT32 rate.  A kernel that packs its arithmetic
tighter still cannot read past 100 %.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
INT16_OPS_PER_S = 2 * INT32_OPS_PER_S
PIXEL_OPS16 = 19
PIXEL_OPS32 = 1
TEST_OPS16 = 2
TEST_OPS32 = 2
MARGIN = 13


def candidate_rows(imgs: torch.Tensor, threshold: int) -> torch.Tensor:
    """(P, H) int64 candidates a row of a (P, H, W) uint8 batch: the
    Sobel test (numerators divided by 9 toward zero) on rows and columns
    1..dim-2, at least 13 px from every border."""
    x = imgs.to(torch.int32)
    h, w = x.shape[-2:]

    def at(dy, dx):
        return x[..., 1 + dy:h - 1 + dy, 1 + dx:w - 1 + dx]

    sx = (at(-1, -1) + at(1, -1) + 2 * at(0, -1) - at(-1, 1) - 2 * at(0, 1)
          - at(1, 1)).div(9, rounding_mode="trunc")
    sy = (at(-1, -1) + at(-1, 1) + 2 * at(-1, 0) - at(1, -1) - 2 * at(1, 0)
          - at(1, 1)).div(9, rounding_mode="trunc")
    grad = sx * sx + sy * sy > threshold * threshold  # rows/cols 1..dim-2
    m = MARGIN - 1
    inner = grad[..., m:h - 2 - m, m:w - 2 - m]
    rows = torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    rows[:, MARGIN:h - MARGIN] = inner.sum(-1)
    return rows


def least_s(pairs: int, rows_read: int, rows_out: int, width: int,
            candidates: int, tests: int):
    """(seconds, bound) of one key launch over ``pairs`` pairs: both images'
    ``rows_read`` x ``width`` uint8 rows read, ``rows_out`` rows of keys
    written (2 x width int32 a row), ``candidates`` in both images."""
    pixels = 2 * pairs * rows_out * width
    nbytes = 2 * pairs * rows_read * width + 4 * pairs * rows_out * 2 * width
    ops16 = PIXEL_OPS16 * pixels + TEST_OPS16 * tests * candidates
    ops32 = PIXEL_OPS32 * pixels + TEST_OPS32 * tests * candidates
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops16 / INT16_OPS_PER_S + ops32 / INT32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
