"""Dense leaf-code extraction on whole-image tensors.

Same as ``opengpc_tpu.ops.codes.leaf_codes``: each of the <= 32 tests is
the signed ``smooth[p+i] > smooth[p+j] - tau``, and codes are built
MSB-first (``code*2 + bit``), so test 0 lands at the most significant bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from opengpc_tpu_torch.forest import PATCH_HALF, FilterMask


def leaf_codes(smooth: torch.Tensor, mask: FilterMask) -> torch.Tensor:
    """The (h, w) int32 leaf-code image of a smoothed uint8 image.

    Codes are meaningful where the 27x27 patch fits (margin >= 13);
    callers combine them with :func:`ops.preprocess.candidate_mask`.
    """
    h, w = smooth.shape[-2:]
    pad = PATCH_HALF
    padded = F.pad(smooth.to(torch.int32), (pad, pad, pad, pad))

    def window(dy: int, dx: int) -> torch.Tensor:
        return padded[..., pad + dy:pad + dy + h, pad + dx:pad + dx + w]

    code = torch.zeros(smooth.shape, dtype=torch.int32, device=smooth.device)
    for t in range(mask.num_tests):
        a = window(int(mask.i_off[t, 0]), int(mask.i_off[t, 1]))
        b = window(int(mask.j_off[t, 0]), int(mask.j_off[t, 1]))
        code = code * 2 + (a > b - int(mask.tau[t])).to(torch.int32)
    return code
