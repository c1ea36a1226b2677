"""The port's PNG reader and native masked decode against the JAX
package's on the CPU: ``read_gray`` on 8- and 16-bit, palette, RGB,
interlaced and sub-byte files through both of the port's readers (libpng
and numpy), the native decode against the numpy decode (sequential and
threaded, and its refusals), the one-call ``sparsematch`` on PNG paths and
on a list of four, and a first build of the host library from two
processes at once."""

import ctypes
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

import opengpc_tpu as jt
import opengpc_tpu.io.png as jpng

import opengpc_tpu_torch as pt
import opengpc_tpu_torch.io.png as tpng
from opengpc_tpu_torch.infer import _masked_decode_numpy
from opengpc_tpu_torch.io import _host
from opengpc_tpu_torch.match import MASKED_SENTINEL
from opengpc_tpu_torch.utils import make_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZERO = os.path.join(REPO, "forests", "defaultZeroForest.txt")
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def png_bytes(width, height, bit_depth, color_type, scanlines, palette=None,
              interlace=0):
    """A PNG file built by hand, as ``tests/test_formats.py`` builds its
    fixtures."""
    def chunk(typ, body):
        c = struct.pack(">I", len(body)) + typ + body
        return c + struct.pack(">I", zlib.crc32(typ + body) & 0xFFFFFFFF)

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", width, height, bit_depth, color_type, 0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette)
    return out + chunk(b"IDAT", zlib.compress(scanlines)) + chunk(b"IEND", b"")


def row_bytes(row, bit_depth):
    if bit_depth == 16:
        return row.astype(">u2").tobytes()
    if bit_depth < 8:
        bits = np.unpackbits(row.astype(np.uint8)[:, None], axis=1)
        return np.packbits(bits[:, 8 - bit_depth:].reshape(-1)).tobytes()
    return row.astype(np.uint8).tobytes()


def scanlines(arr, bit_depth, interlace, filt=0):
    subs = ([arr[y0::dy, x0::dx] for x0, y0, dx, dy in ADAM7] if interlace
            else [arr])
    out = b""
    for sub in subs:
        if sub.shape[0] and sub.shape[1]:
            for row in sub:
                data = row_bytes(row, bit_depth)
                if filt == 1:  # Sub, one byte a pixel
                    raw = np.frombuffer(data, np.uint8).astype(np.int32)
                    data = ((raw - np.concatenate([[0], raw[:-1]])) % 256
                            ).astype(np.uint8).tobytes()
                out += bytes([filt]) + data
    return out


def fixtures():
    rng = np.random.default_rng(21)
    g8 = rng.integers(0, 256, (13, 21)).astype(np.uint8)
    rgb = rng.integers(0, 256, (9, 14, 3)).astype(np.uint8)
    g16 = rng.integers(0, 1 << 16, (6, 11)).astype(np.uint16)
    pal = rng.integers(0, 3, (5, 7)).astype(np.uint8)
    out = {
        "gray8": (g8, 8, 0, None, 0, 0),
        "gray8-sub-filter": (g8, 8, 0, None, 0, 1),
        "rgb8": (rgb, 8, 2, None, 0, 0),
        "gray16": (g16, 16, 0, None, 0, 0),
        "palette": (pal, 8, 3, bytes([10, 20, 30, 200, 100, 0, 7, 8, 9]), 0,
                    0),
        "gray8-interlaced": (g8, 8, 0, None, 1, 0),
        "rgb8-interlaced": (rgb, 8, 2, None, 1, 0),
        "gray16-interlaced": (g16, 16, 0, None, 1, 0),
    }
    for bits in (1, 2, 4):
        lv = rng.integers(0, 1 << bits, (5, 9)).astype(np.uint8)
        out[f"gray{bits}"] = (lv, bits, 0, None, 0, 0)
        out[f"gray{bits}-interlaced"] = (lv, bits, 0, None, 1, 0)
    return out


FIXTURES = fixtures()


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_read_gray_matches_jax(name, tmp_path):
    arr, bits, color, palette, interlace, filt = FIXTURES[name]
    path = str(tmp_path / f"{name}.png")
    with open(path, "wb") as f:
        f.write(png_bytes(arr.shape[1], arr.shape[0], bits, color,
                          scanlines(arr, bits, interlace, filt), palette,
                          interlace))
    want = jpng.read_gray(path)
    got = tpng.read_gray(path)
    assert got.dtype == np.uint8 and got.shape == arr.shape[:2]
    np.testing.assert_array_equal(got, want)
    for reader in (tpng._read_python, tpng._read_native):
        got_raw, depth = reader(path)
        want_raw, want_depth = jpng._read_python(path)
        assert depth == want_depth and got_raw.dtype == want_raw.dtype
        np.testing.assert_array_equal(got_raw, want_raw)


def test_write_read_roundtrip_and_batch(tmp_path, monkeypatch):
    """Round trips, and a batch read on the pool (libpng) and in turn (the
    numpy codec)."""
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (20 + i, 30)).astype(np.uint8)
            for i in range(5)]
    paths = []
    for i, img in enumerate(imgs):
        paths.append(str(tmp_path / f"im{i}.png"))
        tpng.write_png(paths[-1], img)
    for got, want in zip(tpng.read_gray_batch(paths, max_workers=3), imgs):
        np.testing.assert_array_equal(got, want)
    with monkeypatch.context() as m:
        m.setattr(tpng, "_codec_lib", lambda: None)
        assert tpng.png_reader() == "numpy"
        for got, want in zip(tpng.read_gray_batch(paths), imgs):
            np.testing.assert_array_equal(got, want)
    rgb = rng.integers(0, 256, (10, 16, 3)).astype(np.uint8)
    path = str(tmp_path / "c.png")
    tpng._write_python(path, rgb, 3)
    np.testing.assert_array_equal(tpng.read_rgb(path), rgb)
    np.testing.assert_array_equal(tpng.read_gray(path), jpng.read_gray(path))
    assert tpng.png_reader() == "libpng"  # g++ and libpng are here


def masked_buffer(rng, h, w2, disp_high=128, density=0.1):
    bd = int(2 * disp_high).bit_length()
    hit = rng.random((h, w2)) < density
    vals = (rng.integers(0, w2 // 2, (h, w2)) << bd) | rng.integers(
        0, 2 * disp_high + 1, (h, w2))
    buf = np.where(hit, vals, MASKED_SENTINEL).astype(np.int32)
    return buf, hit.sum(axis=1).astype(np.int32)


@pytest.mark.parametrize("h,w2", [(37, 200), (256, 2048)])
def test_native_decode_matches_numpy(h, w2):
    """(37, 200) scans sequentially; (256, 2048) holds 2^19 elements and
    takes the threaded scan."""
    buf, rc = masked_buffer(np.random.default_rng(h), h, w2)
    n = int(rc.sum())
    want = _masked_decode_numpy(buf, n, 128)
    got = tpng.masked_decode_native(buf, n, 128, MASKED_SENTINEL,
                                    row_counts=rc)
    assert got.dtype == np.int32 and len(got) == n > 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jpng.masked_decode_native(buf, n, 128, MASKED_SENTINEL,
                                       row_counts=rc))
    np.testing.assert_array_equal(pt.masked_supports_to_numpy(buf, rc, 128),
                                  want)


def test_native_decode_refusals():
    buf, rc = masked_buffer(np.random.default_rng(5), 256, 2048)
    n = int(rc.sum())
    with pytest.raises(ValueError, match="row counts say"):
        tpng.masked_decode_native(buf[:10, :100], n, 128, MASKED_SENTINEL)
    shifted = rc.copy()  # totals agree, two rows do not
    shifted[0] += 1
    shifted[1] -= 1
    with pytest.raises(ValueError, match="disagrees"):
        tpng.masked_decode_native(buf, n, 128, MASKED_SENTINEL,
                                  row_counts=shifted)
    with pytest.raises(ValueError, match="row counts say"):
        _masked_decode_numpy(buf, n + 1, 128)


def test_one_call_on_png_paths_matches_jax(tmp_path):
    """A pair of paths, and lists of 4 paths (the thread-pool decode) and of
    2 paths, against JAX's one-call and the array call."""
    js = jt.InferenceSettings(gradient_threshold=5, epipolar_mode=True)
    ts = pt.InferenceSettings(gradient_threshold=5, epipolar_mode=True)
    pairs = [make_pair(64, 128, 6, seed=s) for s in range(4)]
    paths = []
    for i, (left, right) in enumerate(pairs):
        lp, rp = str(tmp_path / f"l{i}.png"), str(tmp_path / f"r{i}.png")
        tpng.write_png(lp, left)
        tpng.write_png(rp, right)
        paths.append((lp, rp))
    got = pt.sparsematch(*paths[0], ZERO, ts, device="cpu")
    np.testing.assert_array_equal(got, jt.sparsematch(*paths[0], ZERO, js))
    np.testing.assert_array_equal(
        got, pt.sparsematch(*pairs[0], ZERO, ts, device="cpu"))
    for k in (4, 2):
        lps, rps = [p[0] for p in paths[:k]], [p[1] for p in paths[:k]]
        got_b = pt.sparsematch(lps, rps, ZERO, ts, device="cpu")
        want_b = jt.sparsematch(lps, rps, ZERO, js)
        assert len(got_b) == len(want_b) == k
        for g, w in zip(got_b, want_b):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="differing shapes"):
        pt.sparsematch([paths[0][0], pairs[0][0][:40]],
                       [paths[0][1], pairs[0][1][:40]], ZERO, ts,
                       device="cpu")


_BUILD = """
import sys
from opengpc_tpu_torch.io import _host
path = _host.build(build_dir=sys.argv[1])
print(path, _host.build_info.get("compiled", False),
      _host.build_info.get("codec"))
"""


def test_concurrent_first_build_from_two_processes(tmp_path):
    """Two processes build the host library into an empty directory at
    once: one compiles, the other waits on the lock and loads its
    library; no temporary file is left."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    lines = [o[0].split() for o in outs]
    assert lines[0][0] == lines[1][0] == _host.library_path(
        build_dir=str(tmp_path))
    assert sorted(ln[1] for ln in lines) == ["False", "True"]
    name = os.path.basename(lines[0][0])
    assert sorted(os.listdir(tmp_path)) == [name, name + ".lock"]
    lib = ctypes.CDLL(lines[0][0])
    assert hasattr(lib, "ogpc_masked_decode_par") and hasattr(
        lib, "ogpc_png_read")
