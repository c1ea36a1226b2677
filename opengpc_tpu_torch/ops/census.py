"""Dense 5x5 census transform, the port of ``opengpc_tpu.ops.census``.

24-bit codes: bit i is set iff the i-th neighbour is brighter than the
centre, the neighbours walked x-major (px = -2..2, then py = -2..2)
without the centre.  Codes are zero outside 2 <= y <= h-4, 2 <= x <= w-3.
``ops.fused.fused_census`` is the kernel; this is its plain twin.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from opengpc_tpu_torch.ops.preprocess import _grid, require_u8


def census5x5(img: torch.Tensor) -> torch.Tensor:
    """(H, W) int32 census codes of an (H, W) uint8 image."""
    require_u8(img)
    if img.dim() != 2:
        raise ValueError(f"expected an (H, W) image, got {tuple(img.shape)}")
    h, w = img.shape
    padded = F.pad(img.to(torch.int16), (2, 2, 2, 2))
    center = img.to(torch.int16)
    code = torch.zeros((h, w), dtype=torch.int32, device=img.device)
    bit = 0
    for px in range(-2, 3):
        for py in range(-2, 3):
            if px == 0 and py == 0:
                continue
            nb = padded[2 + py:2 + py + h, 2 + px:2 + px + w]
            code |= (nb > center).to(torch.int32) << bit
            bit += 1
    ys, xs = _grid(h, w, img.device)
    valid = (ys >= 2) & (ys <= h - 4) & (xs >= 2) & (xs <= w - 3)
    return torch.where(valid, code, 0)
