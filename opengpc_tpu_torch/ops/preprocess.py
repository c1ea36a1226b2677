"""Image preprocessing ops on whole-image tensors.

Pixel for pixel the same as ``opengpc_tpu.ops.preprocess``:

* box:   3x3 mean with floor division by 9, valid on y in [1, h-3],
  x in [2, w-2], zero elsewhere;
* sobel: per-axis kernels, each sum divided by 9 with C truncation, then
  binarized by (sx^2 + sy^2) > threshold^2;
* candidates: gradient pixels with a 13-px interior margin.

They take (H, W) tensors on any device; ``ops.fused`` fuses all three with
the leaf codes into one CUDA kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# The candidate interior margin: ops.fused and infer._interior_rows derive
# from it, so the kernel mask and the interior-row slice cannot disagree.
CANDIDATE_MARGIN = 13


def require_u8(img) -> None:
    """Reject anything but uint8 images: a float image (imread returns
    float64 in [0, 1]) would silently give zero candidates, because box and
    Sobel carry the reference's uint8 semantics."""
    if img.dtype not in (torch.uint8, np.uint8):
        raise ValueError(
            f"expected uint8 grayscale image(s), got {img.dtype}; convert "
            "explicitly (e.g. (img * 255).astype(np.uint8) for float "
            "images in [0, 1])")


def _shifted(padded: torch.Tensor, dy: int, dx: int, h: int, w: int,
             pad: int) -> torch.Tensor:
    """Window of a pad-`pad` image shifted by (dy, dx)."""
    return padded[..., pad + dy:pad + dy + h, pad + dx:pad + dx + w]


def _grid(h: int, w: int, device):
    ys = torch.arange(h, dtype=torch.int32, device=device)[:, None]
    xs = torch.arange(w, dtype=torch.int32, device=device)[None, :]
    return ys, xs


def box3(img: torch.Tensor) -> torch.Tensor:
    """3x3 box blur, uint8 -> uint8: floor(sum / 9) on
    1 <= y <= h-3, 2 <= x <= w-2, 0 elsewhere."""
    require_u8(img)
    h, w = img.shape[-2:]
    padded = F.pad(img.to(torch.int32), (1, 1, 1, 1))
    total = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            total += _shifted(padded, dy, dx, h, w, 1)
    blurred = torch.div(total, 9, rounding_mode="floor").to(torch.uint8)
    ys, xs = _grid(h, w, img.device)
    valid = (ys >= 1) & (ys <= h - 3) & (xs >= 2) & (xs <= w - 2)
    return torch.where(valid, blurred, torch.zeros_like(blurred))


def _sobel_nums(raw):
    """(sx, sy) Sobel numerators from ``raw(dy, dx)`` windows, each divided
    by 9 with C truncation (torch's ``//`` floors)."""
    sx_num = (raw(-1, -1) + raw(1, -1) + 2 * raw(0, -1)
              - raw(-1, 1) - 2 * raw(0, 1) - raw(1, 1))
    sy_num = (raw(-1, -1) + raw(-1, 1) + 2 * raw(-1, 0)
              - raw(1, -1) - 2 * raw(1, 0) - raw(1, 1))
    return (torch.div(sx_num, 9, rounding_mode="trunc"),
            torch.div(sy_num, 9, rounding_mode="trunc"))


def sobel3(img: torch.Tensor, threshold: int) -> torch.Tensor:
    """Binary 3x3 Sobel gradient mask, uint8 -> uint8 (0 / 255), valid on
    y, x in [1, dim-2]."""
    require_u8(img)
    h, w = img.shape[-2:]
    padded = F.pad(img.to(torch.int32), (1, 1, 1, 1))
    sx, sy = _sobel_nums(lambda dy, dx: _shifted(padded, dy, dx, h, w, 1))
    mask = sx * sx + sy * sy > int(threshold) * int(threshold)
    ys, xs = _grid(h, w, img.device)
    interior = (ys >= 1) & (ys <= h - 2) & (xs >= 1) & (xs <= w - 2)
    out = (mask & interior).to(torch.uint8) * 255
    return out


def candidate_mask(grad: torch.Tensor,
                   margin: int = CANDIDATE_MARGIN) -> torch.Tensor:
    """Bool mask of candidate pixels: gradient nonzero with an interior
    margin."""
    h, w = grad.shape[-2:]
    ys, xs = _grid(h, w, grad.device)
    interior = (ys >= margin) & (ys < h - margin) & (xs >= margin) & (xs < w - margin)
    return (grad != 0) & interior
