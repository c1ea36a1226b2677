"""The fused code kernels: box blur, leaf codes and Sobel candidates in one
pass, emitting the matcher's sentinel-packed sort keys of a whole image
(``fused_keys``), of both images of a batch of pairs in one launch
(``fused_key_image``), of a row slab of a larger frame (``fused_keys_slab``)
or of both slabs of a shard in one launch (``fused_key_image_slab``, the
sharded frame's), or the codes and candidates as two images
(``fused_codes``, or ``fused_codes_pair`` for both images of a pair in
one launch); and the 5x5 census (``fused_census``).

Each wrapper checks its arguments and calls its custom op
(``ops.library``, namespace ``ogpc``), whose CUDA implementation launches
the kernel (``csrc/fused_keys.cu``, whose slab mode makes the slab keys,
``csrc/fused_codes.cu``, ``csrc/fused_census.cu``; built at first use by
``ops._build``) and raises on any failure, and whose CPU implementation is
the plain twin (``fused_keys_plain``, ``fused_keys_slab_plain``,
``fused_codes_plain``, ``ops.census.census5x5``).  The code twins share
one body, the same math as whole-window tensor ops, written after
``opengpc_tpu.ops.fused``'s ``tile_codes_and_cand`` with the image or slab
as one tile; the code kernels share ``csrc/tile_codes.cuh``.  Each
wrapper's ``launches`` attribute counts its kernel launches
(``fused_keys_slab.launches`` the key kernel's slab-mode ones), so a run
can show that it went through the kernels.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from opengpc_tpu_torch.forest import MAX_TESTS, PATCH_HALF, FilterMask
from opengpc_tpu_torch.ops import library
from opengpc_tpu_torch.ops.preprocess import (CANDIDATE_MARGIN, _sobel_nums,
                                              require_u8)
from opengpc_tpu_torch.utils.timing import span

PAD = PATCH_HALF + 1       # 13-px code halo + 1-px box/Sobel halo
MARGIN = CANDIDATE_MARGIN  # candidate interior margin


def _tests_array(mask: FilterMask) -> np.ndarray:
    """(T, 5) int32 rows of (iy, ix, jy, jx, tau): what the kernel's
    launcher reads and passes to the kernel by value."""
    return np.ascontiguousarray(np.concatenate(
        [mask.i_off, mask.j_off, mask.tau[:, None]], axis=1), dtype=np.int32)


def mask_tests(mask: FilterMask):
    """The forest's tests as a tuple of python ints (iy, ix, jy, jx, tau)."""
    return tuple(map(tuple, _tests_array(mask).tolist()))


def op_tests(mask: FilterMask) -> list:
    """The forest's tests as the ops' ``int[]`` argument: T * 5 python
    ints, (iy, ix, jy, jx, tau) for each test (``ops.library``)."""
    return _tests_array(mask).ravel().tolist()


def _test_rows(tests):
    """(iy, ix, jy, jx, tau) tuples of a FilterMask or of the ops' flat
    test list."""
    if isinstance(tests, FilterMask):
        return mask_tests(tests)
    return tuple(tuple(tests[i:i + 5]) for i in range(0, len(tests), 5))


def _require_kernel(name: str, t: torch.Tensor) -> None:
    """Only CPU tensors (the twins) and CUDA tensors (the kernels) have an
    implementation of the ops."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {t.device} tensors")


def _codes_body(x32: torch.Tensor, y0: int, h: int, mask,
                gradient_threshold: int):
    """The twins' one body: (int32 leaf codes, bool candidates) of image
    rows [y0, y0 + th) of an image of height ``h``, from the (..., th + 28,
    w + 28) int32 window ``x32`` that holds image rows [y0 - 14, y0 + th +
    14) and columns [-14, w + 14), zeros outside the image.  The box border
    and the candidate margin are taken in image rows, so a slab's rows are
    those of the whole image.  At 32 tests a code fills all 32 bits and
    wraps as JAX's int32 ``code*2+bit`` does.  ``mask`` is a FilterMask or
    the ops' flat test list."""
    th, w = x32.shape[-2] - 2 * PAD, x32.shape[-1] - 2 * PAD
    dev = x32.device
    hc, wc = th + 26, w + 26  # code-support region: rows y0-13 .. y0+th+12

    # box 3x3 on the code-support region; region (r, c) = image
    # (y0 + r - 13, c - 13) = window (r + 1, c + 1)
    total = torch.zeros(x32.shape[:-2] + (hc, wc), dtype=torch.int32,
                        device=dev)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            total += x32[..., 1 + dy:1 + dy + hc, 1 + dx:1 + dx + wc]
    blurred = torch.div(total, 9, rounding_mode="floor")
    rr = torch.arange(hc, dtype=torch.int32, device=dev)[:, None] + y0
    cc = torch.arange(wc, dtype=torch.int32, device=dev)[None, :]
    # valid box region 1 <= y <= h-3, 2 <= x <= w-2, in region coordinates
    box_valid = (rr >= 14) & (rr <= h + 10) & (cc >= 15) & (cc <= w + 11)
    smooth = torch.where(box_valid, blurred, torch.zeros_like(blurred))

    code = torch.zeros(x32.shape[:-2] + (th, w), dtype=torch.int32, device=dev)
    for iy, ix, jy, jx, tau in _test_rows(mask):
        a = smooth[..., 13 + iy:13 + iy + th, 13 + ix:13 + ix + w]
        b = smooth[..., 13 + jy:13 + jy + th, 13 + jx:13 + jx + w]
        code = code * 2 + (a > b - tau).to(torch.int32)

    sx, sy = _sobel_nums(
        lambda dy, dx: x32[..., PAD + dy:PAD + dy + th, PAD + dx:PAD + dx + w])
    grad = sx * sx + sy * sy > int(gradient_threshold) ** 2
    yy = torch.arange(th, dtype=torch.int32, device=dev)[:, None] + y0
    xx = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    interior = (yy >= MARGIN) & (yy < h - MARGIN) & (xx >= MARGIN) & (xx < w - MARGIN)
    return code, grad & interior


def fused_codes_plain(img: torch.Tensor, mask, gradient_threshold: int):
    """Plain-PyTorch twin of the code kernel, and the body of the key
    kernel's twin: (int32 leaf codes, bool candidates) of a (..., H, W)
    uint8 image."""
    require_u8(img)
    x32 = F.pad(img.to(torch.int32), (PAD, PAD, PAD, PAD))
    return _codes_body(x32, 0, img.shape[-2], mask, gradient_threshold)


def _keys(code, cand, pos_base, sentinel_base, pack_bits=0):
    w = code.shape[-1]
    pos = torch.arange(w, dtype=torch.int32, device=code.device) + int(pos_base)
    cand_key = (code << int(pack_bits)) | pos if pack_bits else code
    return torch.where(cand, cand_key, pos + int(sentinel_base))


def fused_keys_plain(img: torch.Tensor, mask, gradient_threshold: int,
                     pos_base: int, sentinel_base: int,
                     pack_bits: int = 0) -> torch.Tensor:
    """Plain-PyTorch twin of the key kernel on (..., H, W) uint8 -> int32:
    ``candidate ? code : sentinel_base + pos_base + x``, or
    ``(code << pack_bits) | (pos_base + x)`` for candidates when
    ``pack_bits > 0``."""
    code, cand = fused_codes_plain(img, mask, gradient_threshold)
    return _keys(code, cand, pos_base, sentinel_base, pack_bits)


def _slab_rows(slab: torch.Tensor, y0: int, h_total: int,
               batch: bool = False) -> int:
    """The output rows sh of a (sh + 28, W) slab (or, with ``batch``, a
    (B, sh + 28, W) batch of them) at image row ``y0`` of an image of
    ``h_total`` rows; raises on a slab that does not fit."""
    require_u8(slab)
    if slab.dim() not in ((2, 3) if batch else (2,)):
        raise ValueError(f"expected an (sh + {2 * PAD}, W) slab, got "
                         f"{tuple(slab.shape)}")
    sh = slab.shape[-2] - 2 * PAD
    if sh < 1 or not 0 <= y0 <= h_total - sh:
        raise ValueError(f"a slab of {tuple(slab.shape)} (halo {PAD} rows "
                         f"each side) at row {y0} does not fit an image of "
                         f"{h_total} rows")
    return sh


def fused_keys_slab_plain(slab: torch.Tensor, mask, gradient_threshold: int,
                          pos_base: int, sentinel_base: int, y0: int,
                          h_total: int) -> torch.Tensor:
    """Plain-PyTorch twin of the slab key kernel: the (sh, W) keys of a
    (sh + 28, W) uint8 slab holding image rows [y0 - 14, y0 + sh + 14) of
    an image of ``h_total`` rows (zeros outside the image), equal to rows
    [y0, y0 + sh) of ``fused_keys_plain`` on the whole image (a (B, sh +
    28, W) batch of slabs at the same rows gives (B, sh, W)).  The slab
    carries its halo rows, so only the columns are zero-padded."""
    _slab_rows(slab, y0, h_total, batch=True)
    x32 = F.pad(slab.to(torch.int32), (PAD, PAD))
    code, cand = _codes_body(x32, int(y0), int(h_total), mask,
                             gradient_threshold)
    return _keys(code, cand, pos_base, sentinel_base)


def check_mask(mask: FilterMask) -> None:
    """Reject what no code kernel takes: a test count outside 1..32 or an
    offset beyond the 13-px halo."""
    if not 1 <= mask.num_tests <= MAX_TESTS:
        raise ValueError(f"the code kernels take 1..{MAX_TESTS} tests, got "
                         f"{mask.num_tests}")
    if max(np.abs(mask.i_off).max(), np.abs(mask.j_off).max()) > PATCH_HALF:
        raise ValueError(f"test offsets beyond +-{PATCH_HALF} px")


def _check_args(mask: FilterMask, pack_bits: int) -> None:
    check_mask(mask)
    if not 0 <= pack_bits <= 30:
        raise ValueError(f"pack_bits must be in 0..30, got {pack_bits}")


def _launch(sides, out: torch.Tensor, tests, gradient_threshold: int,
            sentinel_base: int, pack_bits: int, slab=None) -> None:
    """One launch of the key kernel for one or two ``sides``, each a
    (B, R, W) CUDA batch, its first column in the (B, rows, Wout) int32
    ``out`` and its position base; on the current stream, without
    synchronizing.  ``tests`` is the ops' flat test list.  Whole images
    (``slab`` None, R = rows) count in ``fused_keys.launches``; slab mode
    (``slab = (y0, h_total)``: each image holds frame rows [y0 - 14, y0 +
    rows + 14) of an h_total-row frame, R = rows + 28) in
    ``fused_keys_slab.launches``.  The CUDA implementation of the key
    ops (``ops.library``)."""
    from opengpc_tpu_torch.ops._build import check_launch, load_library

    name = "fused_keys_slab" if slab else "fused_keys"
    imgs = [img for img, _, _ in sides]
    if not all(img.is_cuda for img in imgs):
        raise ValueError(f"{name}: no kernel for {imgs[0].device} tensors")
    if not (all(img.is_contiguous() for img in imgs) and out.is_contiguous()):
        raise ValueError(f"{name}: images and output must be contiguous")
    if out.dtype != torch.int32 or out.dim() != 3:
        raise ValueError(f"{name}: output must be a (B, rows, Wout) int32 "
                         "tensor")
    b, rows = out.shape[:2]
    y0, h_total = slab if slab else (0, rows)
    halo = PAD if slab else 0
    w = imgs[0].shape[2]
    for img, col, _ in sides:
        if img.shape != (b, rows + 2 * halo, w) or col + w > out.shape[2]:
            raise ValueError(f"{name}: output {tuple(out.shape)} cannot "
                             f"hold {tuple(img.shape)} at column {col}")
    img0, col0, pos0 = sides[0]
    img1, col1, pos1 = sides[1] if len(sides) > 1 else (None, 0, 0)
    tests = np.asarray(tests, dtype=np.int32)
    lib = load_library()
    with torch.cuda.device(img0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ogpc_fused_keys(
            img0.data_ptr(), img1.data_ptr() if img1 is not None else None,
            out.data_ptr(), b, rows, w, int(y0), int(h_total), halo,
            out.shape[2], rows * out.shape[2], col0, col1, int(pos0),
            int(pos1), tests.ctypes.data, tests.size // 5,
            int(gradient_threshold) ** 2, int(sentinel_base), int(pack_bits),
            stream)
    check_launch(name, rc)
    (fused_keys_slab if slab else fused_keys).launches += 1


def _pair_keys_plain(lefts: torch.Tensor, rights: torch.Tensor, mask,
                     gradient_threshold: int, sentinel_base: int, slab=None):
    """The plain twin of the pair key ops: the key images of two (B, R, W)
    uint8 batches, (B, rows, 2W) int32, the left keys (positions x) in
    columns [0, W), the right keys (positions W + x) in [W, 2W); slab mode
    for ``slab = (y0, h_total)``, rows = R - 28."""
    b, r, w = lefts.shape
    rows = r - 2 * PAD if slab else r
    out = torch.empty((b, rows, 2 * w), dtype=torch.int32,
                      device=lefts.device)
    for img, col in ((lefts, 0), (rights, w)):
        out[..., col:col + w] = (
            fused_keys_slab_plain(img, mask, gradient_threshold, col,
                                  sentinel_base, *slab) if slab else
            fused_keys_plain(img, mask, gradient_threshold, col,
                             sentinel_base))
    return out


def fused_key_image(lefts: torch.Tensor, rights: torch.Tensor,
                    mask: FilterMask, gradient_threshold: int,
                    sentinel_base: int) -> torch.Tensor:
    """(B, H, 2W) int32 key images of a (B, H, W) batch of uint8 pairs:
    the left keys (positions x) in columns [0, W), the right keys
    (positions W + x) in [W, 2W).  The op ``ogpc::fused_key_image``: one
    launch of the key kernel for the whole batch on CUDA tensors (counted
    in ``fused_keys.launches``), two calls of the plain twin on CPU
    tensors."""
    require_u8(lefts)
    require_u8(rights)
    check_mask(mask)
    if (lefts.dim() != 3 or lefts.shape != rights.shape
            or lefts.device != rights.device):
        raise ValueError(f"fused_key_image: expected two (B, H, W) batches "
                         f"on one device, got {tuple(lefts.shape)} on "
                         f"{lefts.device} and {tuple(rights.shape)} on "
                         f"{rights.device}")
    _require_kernel("fused_key_image", lefts)
    with span("ogpc.keys"):
        return library.fused_key_image(lefts, rights, op_tests(mask),
                                       int(gradient_threshold),
                                       int(sentinel_base))


def fused_keys(img: torch.Tensor, mask: FilterMask, gradient_threshold: int,
               pos_base: int, sentinel_base: int,
               pack_bits: int = 0) -> torch.Tensor:
    """(H, W) int32 sentinel-packed matcher sort keys of an (H, W) uint8
    image in one fused pass:
    ``candidate ? leaf_code : sentinel_base + pos_base + x``.

    ``pos_base`` is 0 for the source image and W for the target, so the
    concatenated (H, 2W) key image has unique per-row sentinels.
    ``pack_bits > 0`` emits candidates already pos-packed for the
    single-operand sort (``match._pack_keypos``'s layout; the caller must
    satisfy ``match._pack_ok``).  The op ``ogpc::fused_keys``: one side of
    the key kernel's launch on a CUDA tensor, ``fused_keys_plain`` on a CPU
    one."""
    require_u8(img)
    if img.dim() != 2:
        raise ValueError(f"expected an (H, W) image, got {tuple(img.shape)}")
    _check_args(mask, pack_bits)
    _require_kernel("fused_keys", img)
    return library.fused_keys(img, op_tests(mask), int(gradient_threshold),
                              int(pos_base), int(sentinel_base),
                              int(pack_bits))


fused_keys.launches = 0


def _codes_launch(imgs, tests, gradient_threshold: int):
    """[(codes int32, candidates bool)] of one or two uint8 CUDA images of
    one (H, W) or (B, H, W) shape: one launch of the code kernel on the
    current stream, without synchronizing.  The CUDA implementation of the
    code ops (``ops.library``)."""
    from opengpc_tpu_torch.ops._build import check_launch, load_library

    first = imgs[0]
    batch_shape = (-1,) + tuple(first.shape[-2:])
    sides = []
    for img in imgs:
        batch = img.contiguous().reshape(batch_shape)
        sides.append((batch, torch.empty(batch.shape, dtype=torch.int32,
                                         device=first.device),
                      torch.empty(batch.shape, dtype=torch.bool,
                                  device=first.device)))
    ptrs = [t.data_ptr() for side in sides for t in side]
    img0, codes0, cand0, img1, codes1, cand1 = ptrs + [None] * (6 - len(ptrs))
    tests = np.asarray(tests, dtype=np.int32)
    lib = load_library()
    with torch.cuda.device(first.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ogpc_fused_codes(
            img0, img1, codes0, cand0, codes1, cand1, *sides[0][0].shape,
            tests.ctypes.data, tests.size // 5, int(gradient_threshold) ** 2,
            stream)
    check_launch("fused_codes", rc)
    fused_codes.launches += 1
    return [(codes.reshape(first.shape), cand.reshape(first.shape))
            for _, codes, cand in sides]


def _check_codes_args(imgs, mask: FilterMask) -> None:
    """The code wrappers' checks: uint8 images of one (H, W) or (B, H, W)
    shape on one device that has a kernel, and a mask the kernel takes."""
    for img in imgs:
        require_u8(img)
    check_mask(mask)
    first = imgs[0]
    if first.dim() not in (2, 3):
        raise ValueError(f"expected an (H, W) image or a (B, H, W) batch, "
                         f"got {tuple(first.shape)}")
    for img in imgs[1:]:
        if img.shape != first.shape or img.device != first.device:
            raise ValueError(f"fused_codes: expected two images of one shape "
                             f"on one device, got {tuple(first.shape)} on "
                             f"{first.device} and {tuple(img.shape)} on "
                             f"{img.device}")
    _require_kernel("fused_codes", first)


def fused_codes(img: torch.Tensor, mask: FilterMask,
                gradient_threshold: int):
    """(codes int32, candidates bool) of an (H, W) or (B, H, W) uint8
    image in one fused pass: the op ``ogpc::fused_codes``, the kernel of
    ``csrc/fused_codes.cu`` for a CUDA tensor, ``fused_codes_plain`` for a
    CPU one."""
    _check_codes_args([img], mask)
    return library.fused_codes(img, op_tests(mask), int(gradient_threshold))


def fused_codes_pair(left: torch.Tensor, right: torch.Tensor,
                     mask: FilterMask, gradient_threshold: int):
    """((codes, candidates) of ``left``, (codes, candidates) of ``right``)
    for two uint8 images (or batches) of one shape: the op
    ``ogpc::fused_codes_pair``, one launch of the code kernel for both on
    CUDA tensors (counted in ``fused_codes.launches``), two calls of
    ``fused_codes_plain`` on CPU tensors."""
    _check_codes_args([left, right], mask)
    cl, vl, cr, vr = library.fused_codes_pair(left, right, op_tests(mask),
                                              int(gradient_threshold))
    return (cl, vl), (cr, vr)


fused_codes.launches = 0


def fused_keys_slab_into(slab: torch.Tensor, out: torch.Tensor,
                         col_offset: int, mask: FilterMask,
                         gradient_threshold: int, pos_base: int,
                         sentinel_base: int, y0: int, h_total: int) -> None:
    """Write the keys of a (sh + 28, W) uint8 slab (see
    :func:`fused_keys_slab_plain`) into columns [col_offset, col_offset +
    W) of the (sh, Wout) int32 ``out``: :func:`fused_keys_slab`'s result
    copied in."""
    sh = _slab_rows(slab, y0, h_total)
    check_mask(mask)
    w = slab.shape[1]
    if (out.dtype != torch.int32 or out.dim() != 2 or out.shape[0] != sh
            or col_offset + w > out.shape[1]):
        raise ValueError(f"fused_keys_slab: output {out.dtype} "
                         f"{tuple(out.shape)} cannot hold ({sh}, {w}) keys "
                         f"at column {col_offset}")
    if out.device != slab.device:
        raise ValueError(f"fused_keys_slab: slab on {slab.device}, output "
                         f"on {out.device}")
    out[:, col_offset:col_offset + w] = fused_keys_slab(
        slab, mask, gradient_threshold, pos_base, sentinel_base, y0, h_total)


def fused_keys_slab(slab: torch.Tensor, mask: FilterMask,
                    gradient_threshold: int, pos_base: int,
                    sentinel_base: int, y0: int,
                    h_total: int) -> torch.Tensor:
    """(sh, W) int32 sentinel-packed matcher keys of a row slab: the (sh +
    28, W) uint8 ``slab`` holds image rows [y0 - 14, y0 + sh + 14) of an
    image of ``h_total`` rows, zeros outside the image.  Equal to rows
    [y0, y0 + sh) of :func:`fused_keys` on the whole image: the box border
    and the candidate margin are taken in image rows.  ``y0`` is a host
    int, the kernel's row offset.  The op ``ogpc::fused_keys_slab``: one
    side of the key kernel's slab-mode launch (``csrc/fused_keys.cu``) for
    a CUDA tensor, the plain twin for a CPU one."""
    _slab_rows(slab, y0, h_total)
    check_mask(mask)
    _require_kernel("fused_keys_slab", slab)
    return library.fused_keys_slab(slab, op_tests(mask),
                                   int(gradient_threshold), int(pos_base),
                                   int(sentinel_base), int(y0), int(h_total))


fused_keys_slab.launches = 0


def fused_key_image_slab(lefts: torch.Tensor, rights: torch.Tensor,
                         mask: FilterMask, gradient_threshold: int,
                         sentinel_base: int, y0: int,
                         h_total: int) -> torch.Tensor:
    """The (sh, 2W) key image of one row slab of a frame, both images at
    once: ``lefts`` and ``rights`` are (sh + 28, W) uint8 slabs (or (B,
    sh + 28, W) batches of slabs at the same rows, giving (B, sh, 2W))
    holding frame rows [y0 - 14, y0 + sh + 14) of an ``h_total``-row
    frame, zeros outside it.  The left keys (positions x) go to columns
    [0, W), the right keys (positions W + x) to [W, 2W): rows [y0, y0 +
    sh) of :func:`fused_key_image` on the whole frame.  The op
    ``ogpc::fused_key_image_slab``: one slab-mode launch of the key kernel
    for all of them on CUDA tensors (counted in
    ``fused_keys_slab.launches``); the plain twin of each side on CPU
    tensors."""
    if lefts.shape != rights.shape or lefts.device != rights.device:
        raise ValueError(f"slab shapes differ: {tuple(lefts.shape)} on "
                         f"{lefts.device} vs {tuple(rights.shape)} on "
                         f"{rights.device}")
    _slab_rows(lefts, y0, h_total, batch=True)
    require_u8(rights)
    check_mask(mask)
    _require_kernel("fused_key_image_slab", lefts)
    batch = (-1,) + tuple(lefts.shape[-2:])
    with span("ogpc.keys"):
        keys = library.fused_key_image_slab(
            lefts.reshape(batch), rights.reshape(batch), op_tests(mask),
            int(gradient_threshold), int(sentinel_base), int(y0),
            int(h_total))
    return keys.reshape(lefts.shape[:-2] + keys.shape[-2:])


def _census_launch(img: torch.Tensor) -> torch.Tensor:
    """One launch of the census kernel on an (H, W) uint8 CUDA image: the
    CUDA implementation of ``ogpc::fused_census``."""
    from opengpc_tpu_torch.ops._build import check_launch, load_library

    img = img.contiguous()
    out = torch.empty(img.shape, dtype=torch.int32, device=img.device)
    lib = load_library()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ogpc_fused_census(img.data_ptr(), out.data_ptr(),
                                   *img.shape, stream)
    check_launch("fused_census", rc)
    fused_census.launches += 1
    return out


def fused_census(img: torch.Tensor) -> torch.Tensor:
    """(H, W) int32 5x5 census codes of an (H, W) uint8 image in one
    pass: the op ``ogpc::fused_census``, the kernel of
    ``csrc/fused_census.cu`` for a CUDA tensor, ``ops.census.census5x5``
    (its plain twin) for a CPU one."""
    require_u8(img)
    if img.dim() != 2:
        raise ValueError(f"expected an (H, W) image, got {tuple(img.shape)}")
    _require_kernel("fused_census", img)
    return library.fused_census(img)


fused_census.launches = 0
