"""PNG image I/O and the native masked-buffer decode: the port's copy of
``opengpc_tpu.io.png``, the same semantics.

Two implementations of the codec:

* the native libpng codec (``cpp/io.cc``, loaded with ``ctypes``), the
  fast path;
* a pure numpy+zlib codec, used where the host library has no codec.

The host library is built from ``cpp/`` at first use (``io._host``), not
loaded prebuilt; where libpng does not link it holds only
``cpp/decode.cc``, so the masked decode (``masked_decode_native``) is
native wherever a C++ compiler is.

The public API works in (height, width[, channel]) numpy arrays.
Grayscale conversion follows the reference: RGB is reduced by the integer
channel mean ``(r + g + b) / 3`` and 16-bit samples are assembled
big-endian, then truncated to their low byte.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib
from typing import Optional, Tuple

import numpy as np

_MAGIC = b"\x89PNG\r\n\x1a\n"

# ---------------------------------------------------------------------------
# the host library via ctypes
# ---------------------------------------------------------------------------

_NATIVE = None
_NATIVE_TRIED = False
_NATIVE_LOCK = threading.Lock()


def _native_lib() -> Optional[ctypes.CDLL]:
    """The host library, built and loaded at the first call; None where it
    cannot be built."""
    global _NATIVE, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE
    with _NATIVE_LOCK:
        # _NATIVE_TRIED is set last, so a concurrent first call (the
        # read_gray_batch pool) never sees tried-but-not-loaded
        if not _NATIVE_TRIED:
            _NATIVE, _NATIVE_TRIED = _native_lib_load(), True
    return _NATIVE


_I32P = ctypes.POINTER(ctypes.c_int32)
_I64, _I32 = ctypes.c_int64, ctypes.c_int32
_SIGNATURES = {  # name -> (argument types, result type)
    "ogpc_png_read": ([ctypes.c_char_p] + [ctypes.POINTER(ctypes.c_int)] * 4,
                      ctypes.POINTER(ctypes.c_uint8)),
    "ogpc_png_write": ([ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
                        ctypes.c_int, ctypes.c_int, ctypes.c_int],
                       ctypes.c_int),
    "ogpc_free": ([ctypes.c_void_p], None),
    # buf, h, w2, disp_high, sentinel, out (x, y, d triples), max_out
    "ogpc_masked_decode": ([_I32P, _I64, _I64, _I32, _I32, _I32P, _I64],
                           _I64),
    # ... row_counts (h,) before out, nthreads last
    "ogpc_masked_decode_par": ([_I32P, _I64, _I64, _I32, _I32, _I32P, _I32P,
                                _I64, _I32], _I64),
    # path, (n, 3) int32 rows, n; the threaded writer takes nthreads last
    "ogpc_write_supports": ([ctypes.c_char_p, _I32P, _I64], ctypes.c_int),
    "ogpc_write_supports_par": ([ctypes.c_char_p, _I32P, _I64, _I32],
                                ctypes.c_int),
}


def _native_lib_load() -> Optional[ctypes.CDLL]:
    from opengpc_tpu_torch.io import _host

    path = _host.build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    for name, (args, res) in _SIGNATURES.items():
        if hasattr(lib, name):  # the codec's three only where libpng linked
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
    return lib


def _codec_lib() -> Optional[ctypes.CDLL]:
    """The host library when it holds the libpng codec, else None."""
    lib = _native_lib()
    return lib if lib is not None and hasattr(lib, "ogpc_png_read") else None


def png_reader() -> str:
    """Which PNG reader ``read_png`` takes here: "libpng" or "numpy"."""
    return "libpng" if _codec_lib() is not None else "numpy"


# threads for the parallel masked decode: the scan is memory-bound host
# work, diminishing past the physical core count
_DECODE_THREADS = min(8, os.cpu_count() or 1)
# below this buffer size the thread spawns (~25 us a thread) eat the win;
# the sequential scan is already < 100 us there
_DECODE_PAR_MIN_ELEMS = 1 << 18


def masked_decode_native(buf: np.ndarray, n: int, disp_high: int,
                         sentinel: int,
                         row_counts: Optional[np.ndarray] = None,
                         ) -> Optional[np.ndarray]:
    """Native scan of a masked sorted-order support buffer
    (``cpp/decode.cc``): (H, 2W) int32 -> (n, 3) int32 (x, y, d) in scan
    order, or None where the host library cannot be built (callers take
    the numpy decode).

    With ``row_counts`` (the matcher's (H,) per-row counts) and a buffer of
    at least 2^18 elements the scan runs on ``min(8, cpu_count)`` threads
    over row ranges, each row's output offset a prefix sum of the counts
    (``ogpc_masked_decode_par``); the output equals the sequential scan's.
    Raises ``ValueError`` when the buffer disagrees with the counts."""
    lib = _native_lib()
    if lib is None:
        return None
    buf = np.ascontiguousarray(buf, dtype=np.int32)
    out = np.empty((n + 1, 3), dtype=np.int32)  # slot n: scratch (see .cc)
    if (row_counts is not None and _DECODE_THREADS > 1
            and buf.size >= _DECODE_PAR_MIN_ELEMS):
        counts = np.ascontiguousarray(row_counts, dtype=np.int32)
        if counts.shape == (buf.shape[0],):
            got = lib.ogpc_masked_decode_par(
                buf.ctypes.data_as(_I32P), buf.shape[0], buf.shape[1],
                disp_high, sentinel, counts.ctypes.data_as(_I32P),
                out.ctypes.data_as(_I32P), n, _DECODE_THREADS)
            if got < 0:
                # -1: some row's hits differ from its count (even if the
                # totals cancel); the parallel placement depends on them
                raise ValueError("masked buffer disagrees with per-row counts")
            if got != n:
                raise ValueError(
                    f"masked buffer holds {got} supports, row counts say {n}")
            return out[:n]
    got = lib.ogpc_masked_decode(
        buf.ctypes.data_as(_I32P), buf.shape[0], buf.shape[1], disp_high,
        sentinel, out.ctypes.data_as(_I32P), n)
    if got != n:
        raise ValueError(
            f"masked buffer holds {got} supports, row counts say {n}")
    return out[:n]


def _read_native(path: str) -> Optional[Tuple[np.ndarray, int]]:
    lib = _codec_lib()
    if lib is None:
        return None
    w, h, ch, depth = (ctypes.c_int() for _ in range(4))
    ptr = lib.ogpc_png_read(path.encode(), ctypes.byref(w), ctypes.byref(h),
                            ctypes.byref(ch), ctypes.byref(depth))
    if not ptr:
        raise IOError(f"native PNG read failed: {path}")
    nbytes = w.value * h.value * ch.value * (depth.value // 8)
    buf = ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8 * nbytes)).contents
    data = np.frombuffer(bytearray(buf), dtype=np.uint8).copy()
    lib.ogpc_free(ptr)
    if depth.value == 16:
        # libpng hands over big-endian sample pairs
        arr = (data[0::2].astype(np.uint16) << 8) | data[1::2].astype(np.uint16)
        arr = arr.reshape(h.value, w.value, ch.value)
    else:
        arr = data.reshape(h.value, w.value, ch.value)
    if ch.value == 1:
        arr = arr[:, :, 0]
    return arr, depth.value


# ---------------------------------------------------------------------------
# the numpy+zlib codec
# ---------------------------------------------------------------------------


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    if pb <= pc:
        return b
    return c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((height, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    pos = 0
    for y in range(height):
        ftype = raw[pos]
        pos += 1
        line = np.frombuffer(raw[pos:pos + stride], dtype=np.uint8).copy()
        pos += stride
        if ftype == 0:
            rec = line
        elif ftype == 2:  # Up
            rec = (line.astype(np.int32) + prev).astype(np.uint8)
        elif ftype == 1:  # Sub: per-lane cumulative sum
            rec = line.reshape(-1, bpp).astype(np.int64)
            rec = np.cumsum(rec, axis=0).astype(np.uint8).reshape(-1)
        elif ftype == 3:  # Average
            rec = np.empty(stride, dtype=np.uint8)
            for i in range(stride):
                left = int(rec[i - bpp]) if i >= bpp else 0
                rec[i] = (int(line[i]) + ((left + int(prev[i])) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            rec = np.empty(stride, dtype=np.uint8)
            for i in range(stride):
                left = int(rec[i - bpp]) if i >= bpp else 0
                ul = int(prev[i - bpp]) if i >= bpp else 0
                rec[i] = (int(line[i]) + _paeth(left, int(prev[i]), ul)) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = rec
        prev = rec
    return out


# Adam7 pass grid: (x0, y0, dx, dy) per pass (PNG spec 8.2)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _pass_pixels(raw: bytes, pos: int, pw: int, ph: int, bit_depth: int,
                 channels: int) -> Tuple[np.ndarray, int]:
    """Decode one filtered (sub-)image of ``ph`` rows x ``pw`` pixels
    starting at ``pos`` in the decompressed stream.  Returns raw samples,
    (ph, pw) uint8 levels for sub-byte depths (unscaled), else (ph, pw,
    channels) uint8/uint16, and the new stream offset."""
    if bit_depth < 8:
        stride = (pw * bit_depth + 7) // 8
        rows = _unfilter(raw[pos:pos + ph * (stride + 1)], ph, stride, 1)
        pos += ph * (stride + 1)
        bits = np.unpackbits(rows, axis=1)[:, :pw * bit_depth]
        vals = bits.reshape(ph, pw, bit_depth)
        weights = (1 << np.arange(bit_depth - 1, -1, -1)).astype(np.uint16)
        return (vals * weights).sum(axis=2).astype(np.uint8), pos
    sample_bytes = 2 if bit_depth == 16 else 1
    bpp = channels * sample_bytes
    stride = pw * bpp
    rows = _unfilter(raw[pos:pos + ph * (stride + 1)], ph, stride, bpp)
    pos += ph * (stride + 1)
    if bit_depth == 16:
        arr16 = (rows[:, 0::2].astype(np.uint16) << 8) | rows[:, 1::2]
        return arr16.reshape(ph, pw, channels), pos
    return rows.reshape(ph, pw, channels), pos


def _decode_adam7(raw: bytes, width: int, height: int, bit_depth: int,
                  channels: int) -> np.ndarray:
    """Deinterlace: decode the seven independently filtered passes and
    scatter each into its strided pixel positions.  Returns the same raw
    sample layout as ``_pass_pixels`` at full size."""
    if bit_depth < 8:
        out = np.zeros((height, width), dtype=np.uint8)
    else:
        out = np.zeros((height, width, channels),
                       dtype=np.uint16 if bit_depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw = (width - x0 + dx - 1) // dx
        ph = (height - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:
            continue
        pix, pos = _pass_pixels(raw, pos, pw, ph, bit_depth, channels)
        out[y0::dy, x0::dx] = pix
    return out


def _read_python(path: str) -> Tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _MAGIC:
        raise IOError(f"{path} is not a PNG file")
    pos = 8
    width = height = bit_depth = color_type = None
    idat = []
    palette = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            (width, height, bit_depth, color_type, _comp, _filt,
             interlace) = struct.unpack(">IIBBBBB", body)
            if interlace not in (0, 1):
                raise IOError(f"{path}: bad interlace method {interlace}")
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, dtype=np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if width is None:
        raise IOError(f"{path}: missing IHDR")
    if color_type not in (0, 2, 3, 4, 6):
        raise IOError(f"{path}: bad PNG color type {color_type}")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        # a truncated or bit-flipped IDAT raises the codec's IOError
        raise IOError(f"{path}: corrupt PNG data ({e})") from e
    if bit_depth < 8 and color_type not in (0, 3):
        raise NotImplementedError("sub-byte depth only for gray/palette")
    if interlace == 1:
        arr = _decode_adam7(raw, width, height, bit_depth, channels)
    else:
        arr, _ = _pass_pixels(raw, 0, width, height, bit_depth, channels)
    if bit_depth < 8:
        if color_type == 0:
            arr = (arr.astype(np.uint32) * 255
                   // ((1 << bit_depth) - 1)).astype(np.uint8)
        depth_out = 8
    else:
        if channels == 1:
            arr = arr[:, :, 0]
        depth_out = bit_depth
    if color_type == 3:
        if palette is None:
            raise IOError(f"{path}: palette image without PLTE")
        arr = palette[arr]
    return arr, depth_out


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def read_png(path: str) -> Tuple[np.ndarray, int]:
    """Read a PNG; returns (array, bit_depth).

    The array is (H, W) for grayscale or (H, W, C) for color, uint8
    (depth <= 8) or uint16 (depth 16)."""
    res = _read_native(path)
    if res is not None:
        return res
    return _read_python(path)


def read_gray(path: str) -> np.ndarray:
    """Read a PNG as 8-bit grayscale with the reference's semantics: RGB
    reduces by the integer mean (r+g+b)/3, 16-bit grayscale samples are
    assembled big-endian and truncated to their low byte."""
    arr, _depth = read_png(path)
    if arr.ndim == 3:
        if arr.shape[2] == 4:
            raise IOError(f"{path}: RGBA unsupported (the reference rejects "
                          "it too)")
        arr = (arr[:, :, 0].astype(np.uint32) + arr[:, :, 1].astype(np.uint32)
               + arr[:, :, 2].astype(np.uint32)) // 3
    return arr.astype(np.uint8)


def read_rgb(path: str) -> np.ndarray:
    """Read an 8-bit RGB PNG as (H, W, 3) uint8."""
    arr, depth = read_png(path)
    if depth != 8 or arr.ndim != 3 or arr.shape[2] < 3:
        raise IOError(f"{path}: expected 8-bit RGB")
    return arr[:, :, :3].astype(np.uint8)


def read_gray_batch(paths, max_workers: int = 8):
    """Read many grayscale PNGs, in the order of ``paths``: on a thread
    pool where the libpng codec is loaded (its decode releases the
    interpreter lock during the foreign call, so the threads decode in
    parallel), one after another with the numpy codec, whose per-row
    Python work only contends for the lock on a pool (4 frames took 3x
    the time of 4 reads in turn on the H100's host, PERF.md)."""
    import concurrent.futures

    if _codec_lib() is None:
        return [read_gray(p) for p in paths]
    with concurrent.futures.ThreadPoolExecutor(max_workers=max_workers) as ex:
        return list(ex.map(read_gray, paths))


def write_png(path: str, arr: np.ndarray) -> None:
    """Write a uint8 grayscale (H, W) or RGB (H, W, 3) PNG."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim == 2:
        channels = 1
    elif arr.ndim == 3 and arr.shape[2] == 3:
        channels = 3
    else:
        raise ValueError(f"bad image shape {arr.shape}")
    lib = _codec_lib()
    if lib is not None:
        rc = lib.ogpc_png_write(
            path.encode(), arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            int(arr.shape[1]), int(arr.shape[0]), channels)
        if rc != 0:
            raise IOError(f"native PNG write failed: {path}")
        return
    _write_python(path, arr, channels)


def _write_python(path: str, arr: np.ndarray, channels: int) -> None:
    height, width = arr.shape[:2]
    color_type = 0 if channels == 1 else 2
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(height))
    compressed = zlib.compress(raw, 6)

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", width, height, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", compressed))
        f.write(chunk(b"IEND", b""))
