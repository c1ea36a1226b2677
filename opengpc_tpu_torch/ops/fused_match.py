"""Fully fused epipolar match: codes, candidates, sentinel keys, a per-row
bitonic sort and unique-pair detection in one kernel, from the two raw
uint8 images to per-row (keep, src_x, d).  The port of
``opengpc_tpu.ops.fused_match.fused_sparsematch_rows``.

``fused_sparsematch_rows`` calls the custom op
``ogpc::fused_sparsematch_rows`` (``ops.library``), which launches the
kernel of ``csrc/fused_match.cu`` on CUDA tensors and raises on any
failure, and on CPU tensors runs ``fused_sparsematch_rows_plain``, which
composes the code twin, the sentinel and pad keys, ``torch.sort`` and the
split pipeline's detection.
(keep, src_x, d) do not depend on the order within a run of equal keys (a
run of two is normalized by lo/hi position, longer runs never keep), so the
two agree bit for bit whatever sort the plain version uses.

Limits: at most 30 tests (codes must stay below the sentinels) and
W <= 8192, i.e. padded rows of N2 <= 16384 keys, which one block of the
kernel holds (16 keys a thread, at most 1024 threads).  The wrapper
raises ``ValueError`` beyond them; there is no fallback to the split
pipeline.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from opengpc_tpu_torch.forest import FilterMask
from opengpc_tpu_torch.match import (PAD_KEY_BASE, SENTINEL_BASE,
                                     _detect_pairs_packed)
from opengpc_tpu_torch.ops.fused import (_require_kernel, check_mask,
                                         fused_codes_plain, op_tests)
from opengpc_tpu_torch.ops.preprocess import require_u8
from opengpc_tpu_torch.ops.sort import MAX_N, padded_row_length

MAX_TESTS = 30
MAX_WIDTH = MAX_N // 2


def _check(left, right, mask: FilterMask, disp_high: int) -> None:
    require_u8(left)
    require_u8(right)
    if left.dim() != 2 or left.shape != right.shape:
        raise ValueError(f"expected two (H, W) images, got "
                         f"{tuple(left.shape)} and {tuple(right.shape)}")
    if left.device != right.device:
        raise ValueError(f"images on {left.device} and {right.device}")
    check_mask(mask)
    if mask.num_tests > MAX_TESTS:
        raise ValueError(f"the fused match takes at most {MAX_TESTS} tests, "
                         f"got {mask.num_tests}")
    if left.shape[1] > MAX_WIDTH:
        raise ValueError(f"the fused match takes W <= {MAX_WIDTH} (sorted "
                         f"rows of N2 <= {MAX_N} keys in one block), got "
                         f"W = {left.shape[1]}")
    if disp_high < 0:
        raise ValueError(f"disp_high must be >= 0, got {disp_high}")


def _plain(left, right, tests, gradient_threshold: int, disp_high: int):
    """The plain twin's body, the CPU implementation of
    ``ogpc::fused_sparsematch_rows``: ``tests`` a FilterMask or the ops'
    flat test list."""
    h, w = left.shape
    n2 = padded_row_length(w)
    code, cand = fused_codes_plain(torch.stack([left, right]), tests,
                                   gradient_threshold)
    lane = torch.arange(n2, dtype=torch.int32, device=left.device)
    key = torch.where(torch.cat([cand[0], cand[1]], dim=1),
                      torch.cat([code[0], code[1]], dim=1),
                      SENTINEL_BASE + lane[:2 * w])
    key = torch.cat([key, (PAD_KEY_BASE + lane[2 * w:]).expand(h, -1)], dim=1)
    key_s, pos_s = torch.sort(key, dim=1, stable=False)
    keep, src_x, d = _detect_pairs_packed(key_s, pos_s.to(torch.int32), w,
                                          disp_high)
    zero = torch.zeros((), dtype=torch.int32, device=left.device)
    # the last lane has no right neighbour and never keeps
    return (F.pad(keep, (0, 1)), F.pad(torch.where(keep, src_x, zero), (0, 1)),
            F.pad(torch.where(keep, d, zero), (0, 1)))


def fused_sparsematch_rows_plain(left, right, mask: FilterMask,
                                 gradient_threshold: int, disp_high: int):
    """Plain-PyTorch twin: (keep bool, src_x int32, d int32), each
    (H, N2)."""
    _check(left, right, mask, disp_high)
    return _plain(left, right, mask, gradient_threshold, disp_high)


def _launch(left, right, tests, gradient_threshold: int, disp_high: int):
    """One launch of the fused match kernel on two (H, W) uint8 CUDA
    images: the CUDA implementation of ``ogpc::fused_sparsematch_rows``."""
    from opengpc_tpu_torch.ops._build import check_launch, load_library

    h, w = left.shape
    n2 = padded_row_length(w)
    left, right = left.contiguous(), right.contiguous()
    keep = torch.empty((h, n2), dtype=torch.bool, device=left.device)
    src_x = torch.empty((h, n2), dtype=torch.int32, device=left.device)
    d = torch.empty((h, n2), dtype=torch.int32, device=left.device)
    tests = np.asarray(tests, dtype=np.int32)
    lib = load_library()
    with torch.cuda.device(left.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ogpc_fused_sparsematch_rows(
            left.data_ptr(), right.data_ptr(), keep.data_ptr(),
            src_x.data_ptr(), d.data_ptr(), h, w, n2, tests.ctypes.data,
            tests.size // 5, int(gradient_threshold) ** 2, int(disp_high),
            stream)
    check_launch("fused_sparsematch_rows", rc)
    fused_sparsematch_rows.launches += 1
    return keep, src_x, d


def fused_sparsematch_rows(left, right, mask: FilterMask,
                           gradient_threshold: int, disp_high: int):
    """(keep bool (H, N2), src_x int32, d int32) per-row match windows of
    two (H, W) uint8 images in one fused pass, N2 = max(256, pow2 >= 2W):
    window i of row y is a support (src_x, y, d) where ``keep`` holds;
    src_x and d are 0 elsewhere.  The op ``ogpc::fused_sparsematch_rows``:
    the kernel on CUDA tensors, the plain twin on CPU ones."""
    from opengpc_tpu_torch.ops import library

    _check(left, right, mask, disp_high)
    _require_kernel("fused_sparsematch_rows", left)
    return library.fused_sparsematch_rows(left, right, op_tests(mask),
                                          int(gradient_threshold),
                                          int(disp_high))


fused_sparsematch_rows.launches = 0
