"""The kernels as ``torch.library`` custom ops, in the namespace ``ogpc``.

Every form in which a wrapper of ``ops.fused``, ``ops.sort`` and
``ops.fused_match`` launches a kernel is one functional op with three
implementations:

* CUDA: the hand-written kernel's ``ctypes`` launch (``csrc/``, built at
  first use by ``ops._build``), the one place that counts in the
  wrapper's ``launches``.  A build or launch error raises; there is no
  fallback to the twin.
* CPU: the kernel's plain-PyTorch twin.
* fake: empty outputs of the right shapes and dtypes, through which
  ``torch.export`` and ``torch.compile`` trace; it never launches.

The forest's tests are an ``int[]`` argument, T * 5 ints (iy, ix, jy, jx,
tau for each test, ``ops.fused.op_tests``), read by value on the host as
the kernels take them: under ``torch.export`` the list is a constant of
the graph, the forest burned into the program.  The public wrappers keep
their argument checks and call these ops; a tensor on another device than
the CPU or a CUDA card has no kernel.  Importing this module registers
the ops and builds nothing; ``import opengpc_tpu_torch.ops`` imports it,
which is what a loaded ``torch.export`` program needs to resolve them.

    torch.ops.ogpc.fused_keys(img, tests, 5, 0, SENTINEL_BASE, 0)
"""

from __future__ import annotations

import torch
from torch import Tensor
from torch.library import custom_op

from opengpc_tpu_torch.forest import PATCH_HALF
from opengpc_tpu_torch.ops.sort import padded_row_length

NAMESPACE = "ogpc"
PAD = PATCH_HALF + 1  # a slab's halo rows on each side (ops.fused.PAD)


def _op(name):
    return custom_op(f"{NAMESPACE}::{name}", mutates_args=(),
                     device_types="cuda")


# -- the key kernel (csrc/fused_keys.cu) -------------------------------------


@_op("fused_key_image")
def fused_key_image(lefts: Tensor, rights: Tensor, tests: list[int],
                    thr: int, sentinel_base: int) -> Tensor:
    """(B, H, 2W) int32 key images of two (B, H, W) uint8 batches: one
    launch of the key kernel."""
    from opengpc_tpu_torch.ops import fused

    b, h, w = lefts.shape
    out = lefts.new_empty((b, h, 2 * w), dtype=torch.int32)
    fused._launch([(lefts.contiguous(), 0, 0), (rights.contiguous(), w, w)],
                  out, tests, thr, sentinel_base, 0)
    return out


@fused_key_image.register_kernel("cpu")
def _(lefts, rights, tests, thr, sentinel_base):
    from opengpc_tpu_torch.ops import fused

    return fused._pair_keys_plain(lefts, rights, tests, thr, sentinel_base)


@fused_key_image.register_fake
def _(lefts, rights, tests, thr, sentinel_base):
    b, h, w = lefts.shape
    return lefts.new_empty((b, h, 2 * w), dtype=torch.int32)


@_op("fused_key_image_slab")
def fused_key_image_slab(lefts: Tensor, rights: Tensor, tests: list[int],
                         thr: int, sentinel_base: int, y0: int,
                         h_total: int) -> Tensor:
    """(B, sh, 2W) int32 key images of two (B, sh + 28, W) uint8 batches of
    row slabs at frame row ``y0``: one slab-mode launch."""
    from opengpc_tpu_torch.ops import fused

    b, r, w = lefts.shape
    out = lefts.new_empty((b, r - 2 * PAD, 2 * w), dtype=torch.int32)
    fused._launch([(lefts.contiguous(), 0, 0), (rights.contiguous(), w, w)],
                  out, tests, thr, sentinel_base, 0, (y0, h_total))
    return out


@fused_key_image_slab.register_kernel("cpu")
def _(lefts, rights, tests, thr, sentinel_base, y0, h_total):
    from opengpc_tpu_torch.ops import fused

    return fused._pair_keys_plain(lefts, rights, tests, thr, sentinel_base,
                                  (y0, h_total))


@fused_key_image_slab.register_fake
def _(lefts, rights, tests, thr, sentinel_base, y0, h_total):
    b, r, w = lefts.shape
    return lefts.new_empty((b, r - 2 * PAD, 2 * w), dtype=torch.int32)


@_op("fused_keys")
def fused_keys(img: Tensor, tests: list[int], thr: int, pos_base: int,
               sentinel_base: int, pack_bits: int) -> Tensor:
    """(H, W) int32 keys of one (H, W) uint8 image: one side of the key
    kernel's launch."""
    from opengpc_tpu_torch.ops import fused

    out = img.new_empty(img.shape, dtype=torch.int32)
    fused._launch([(img.contiguous()[None], 0, pos_base)], out[None], tests,
                  thr, sentinel_base, pack_bits)
    return out


@fused_keys.register_kernel("cpu")
def _(img, tests, thr, pos_base, sentinel_base, pack_bits):
    from opengpc_tpu_torch.ops import fused

    return fused.fused_keys_plain(img, tests, thr, pos_base, sentinel_base,
                                  pack_bits)


@fused_keys.register_fake
def _(img, tests, thr, pos_base, sentinel_base, pack_bits):
    return img.new_empty(img.shape, dtype=torch.int32)


@_op("fused_keys_slab")
def fused_keys_slab(slab: Tensor, tests: list[int], thr: int, pos_base: int,
                    sentinel_base: int, y0: int, h_total: int) -> Tensor:
    """(sh, W) int32 keys of one (sh + 28, W) uint8 row slab at frame row
    ``y0``: one side of the key kernel's slab-mode launch."""
    from opengpc_tpu_torch.ops import fused

    r, w = slab.shape
    out = slab.new_empty((r - 2 * PAD, w), dtype=torch.int32)
    fused._launch([(slab.contiguous()[None], 0, pos_base)], out[None], tests,
                  thr, sentinel_base, 0, (y0, h_total))
    return out


@fused_keys_slab.register_kernel("cpu")
def _(slab, tests, thr, pos_base, sentinel_base, y0, h_total):
    from opengpc_tpu_torch.ops import fused

    return fused.fused_keys_slab_plain(slab, tests, thr, pos_base,
                                       sentinel_base, y0, h_total)


@fused_keys_slab.register_fake
def _(slab, tests, thr, pos_base, sentinel_base, y0, h_total):
    r, w = slab.shape
    return slab.new_empty((r - 2 * PAD, w), dtype=torch.int32)


# -- the code kernel (csrc/fused_codes.cu) -----------------------------------


def _codes_fake(img):
    return (img.new_empty(img.shape, dtype=torch.int32),
            img.new_empty(img.shape, dtype=torch.bool))


@_op("fused_codes")
def fused_codes(img: Tensor, tests: list[int],
                thr: int) -> tuple[Tensor, Tensor]:
    """(int32 codes, bool candidates) of an (H, W) or (B, H, W) uint8
    image: one launch of the code kernel."""
    from opengpc_tpu_torch.ops import fused

    return fused._codes_launch([img], tests, thr)[0]


@fused_codes.register_kernel("cpu")
def _(img, tests, thr):
    from opengpc_tpu_torch.ops import fused

    return fused.fused_codes_plain(img, tests, thr)


@fused_codes.register_fake
def _(img, tests, thr):
    return _codes_fake(img)


@_op("fused_codes_pair")
def fused_codes_pair(left: Tensor, right: Tensor, tests: list[int],
                     thr: int) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """(codes, candidates) of ``left`` then of ``right``, two uint8 images
    (or batches) of one shape: one launch of the code kernel."""
    from opengpc_tpu_torch.ops import fused

    (cl, vl), (cr, vr) = fused._codes_launch([left, right], tests, thr)
    return cl, vl, cr, vr


@fused_codes_pair.register_kernel("cpu")
def _(left, right, tests, thr):
    from opengpc_tpu_torch.ops import fused

    return (fused.fused_codes_plain(left, tests, thr)
            + fused.fused_codes_plain(right, tests, thr))


@fused_codes_pair.register_fake
def _(left, right, tests, thr):
    return _codes_fake(left) + _codes_fake(right)


# -- the census kernel (csrc/fused_census.cu) --------------------------------


@_op("fused_census")
def fused_census(img: Tensor) -> Tensor:
    """(H, W) int32 5x5 census codes of an (H, W) uint8 image."""
    from opengpc_tpu_torch.ops import fused

    return fused._census_launch(img)


@fused_census.register_kernel("cpu")
def _(img):
    from opengpc_tpu_torch.ops.census import census5x5

    return census5x5(img)


@fused_census.register_fake
def _(img):
    return img.new_empty(img.shape, dtype=torch.int32)


# -- the row sort (csrc/bitonic_sort.cu) -------------------------------------


@_op("bitonic_sort_rows")
def bitonic_sort_rows(key: Tensor, payload: Tensor) -> tuple[Tensor, Tensor]:
    """Each row of the (R, N) int32 ``key`` sorted by key alone, the int32
    ``payload`` permuted alongside."""
    from opengpc_tpu_torch.ops import sort

    return sort._launch(key, payload)


@bitonic_sort_rows.register_kernel("cpu")
def _(key, payload):
    from opengpc_tpu_torch.ops import sort

    return sort.bitonic_sort_rows_plain(key, payload)


@bitonic_sort_rows.register_fake
def _(key, payload):
    return torch.empty_like(key), torch.empty_like(payload)


# -- the matcher's row sort (csrc/row_sort.cu) -------------------------------


@_op("row_sort")
def row_sort(key: Tensor) -> tuple[Tensor, Tensor]:
    """Each row of the (R, N) int32 ``key`` sorted by (key, column): int32
    (keys, columns)."""
    from opengpc_tpu_torch.ops import sort

    return sort._row_sort_launch(key)


@row_sort.register_kernel("cpu")
def _(key):
    from opengpc_tpu_torch.ops import sort

    return sort.row_sort_plain(key)


@row_sort.register_fake
def _(key):
    return torch.empty_like(key), torch.empty_like(key)


# -- the fused match (csrc/fused_match.cu) -----------------------------------


@_op("fused_sparsematch_rows")
def fused_sparsematch_rows(left: Tensor, right: Tensor, tests: list[int],
                           thr: int, disp_high: int
                           ) -> tuple[Tensor, Tensor, Tensor]:
    """(keep bool, src_x int32, d int32), each (H, N2), of two (H, W)
    uint8 images."""
    from opengpc_tpu_torch.ops import fused_match

    return fused_match._launch(left, right, tests, thr, disp_high)


@fused_sparsematch_rows.register_kernel("cpu")
def _(left, right, tests, thr, disp_high):
    from opengpc_tpu_torch.ops import fused_match

    return fused_match._plain(left, right, tests, thr, disp_high)


@fused_sparsematch_rows.register_fake
def _(left, right, tests, thr, disp_high):
    h, w = left.shape
    shape = (h, padded_row_length(w))
    return (left.new_empty(shape, dtype=torch.bool),
            left.new_empty(shape, dtype=torch.int32),
            left.new_empty(shape, dtype=torch.int32))


OPS = {"fused_key_image": fused_key_image,
       "fused_key_image_slab": fused_key_image_slab,
       "fused_keys": fused_keys, "fused_keys_slab": fused_keys_slab,
       "fused_codes": fused_codes, "fused_codes_pair": fused_codes_pair,
       "fused_census": fused_census, "bitonic_sort_rows": bitonic_sort_rows,
       "row_sort": row_sort,
       "fused_sparsematch_rows": fused_sparsematch_rows}
