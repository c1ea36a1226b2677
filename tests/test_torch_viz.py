"""The port's value types, visualisations and supports files against the
JAX package's.

The cases of ``tests/test_types_viz.py`` run on ``opengpc_tpu_torch.types``
and ``opengpc_tpu_torch.viz`` with their own checks, and every image must
equal the JAX package's array byte for byte (the ``compat="reference"``
colormap too, whose bytes rest on the float32 operation order).  The
supports text round-trips through ``write_supports``/``read_supports``
and equals the JAX writer's bytes and ``np.savetxt``'s.
"""

import numpy as np
import pytest

import opengpc_tpu.io.supports as jsup
import opengpc_tpu.types as jtypes
import opengpc_tpu.viz as jviz
import opengpc_tpu_torch.io.png as tpng
from opengpc_tpu_torch.io import read_supports, write_supports
from opengpc_tpu_torch.types import (Correspondence, Descriptor, Point,
                                     Support, correspondences_from_supports,
                                     supports_from_array, supports_to_array)
from opengpc_tpu_torch.viz import (dense_disparity_visualization,
                                   disparity_visualization,
                                   draw_correspondences, draw_line,
                                   draw_triangle, kitti_disparity_colors)


def same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_support_roundtrip():
    arr = np.array([[10, 20, 5], [3, 4, -2]], np.int32)
    sup = supports_from_array(arr)
    assert sup[0] == Support(10, 20, 5)
    np.testing.assert_array_equal(supports_to_array(sup), arr)
    same(supports_to_array(sup),
         jtypes.supports_to_array(jtypes.supports_from_array(arr)))
    same(supports_to_array([]), jtypes.supports_to_array([]))


def test_correspondences_from_supports():
    c = correspondences_from_supports(np.array([[10, 20, 4]]))
    assert c[0] == Correspondence(Point(10, 20), Point(6, 20))
    j = jtypes.correspondences_from_supports(np.array([[10, 20, 4]]))
    assert (c[0].src.x, c[0].src.y, c[0].tar.x, c[0].tar.y) == \
        (j[0].src.x, j[0].src.y, j[0].tar.x, j[0].tar.y)


def test_descriptor_ordering_by_state():
    a = Descriptor(5, Point(0, 0))
    b = Descriptor(7, Point(9, 9))
    assert a < b and a == Descriptor(5, Point(1, 1))


def test_kitti_colors_shape_and_range():
    d = np.array([0, 32, 64, 128, 300])
    c = kitti_disparity_colors(d)
    assert c.shape == (5, 3) and c.dtype == np.uint8
    assert tuple(c[0]) != tuple(c[3])
    same(c, jviz.kitti_disparity_colors(d))
    ramp = np.linspace(-20, 200, 4001, dtype=np.float32)
    for compat in ("canonical", "reference"):
        for lo, hi in ((0.0, 128.0), (0.0, 32.0), (-16.0, 48.0)):
            same(kitti_disparity_colors(ramp, lo, hi, compat=compat),
                 jviz.kitti_disparity_colors(ramp, lo, hi, compat=compat))


def test_disparity_visualization_overlays():
    gray = np.zeros((20, 30), np.uint8)
    sup = np.array([[5, 6, 10]])
    out = disparity_visualization(gray, sup)
    assert out.shape == (20, 30, 3)
    assert tuple(out[6, 5]) != (0, 0, 0)
    assert tuple(out[0, 0]) == (0, 0, 0)
    same(out, jviz.disparity_visualization(gray, sup))
    rng = np.random.default_rng(1)
    gray = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    sup = np.stack([rng.integers(0, 64, 300), rng.integers(0, 48, 300),
                    rng.integers(-8, 140, 300)], axis=1)
    for compat in ("canonical", "reference"):
        same(disparity_visualization(gray, sup, 0.0, 128.0, compat=compat),
             jviz.disparity_visualization(gray, sup, 0.0, 128.0,
                                          compat=compat))
    same(disparity_visualization(gray, np.zeros((0, 3))),
         jviz.disparity_visualization(gray, np.zeros((0, 3))))


def test_dense_disparity_visualization():
    gray = np.zeros((10, 10), np.uint8)
    disp = np.full((10, 10), 64.0)
    valid = np.zeros((10, 10), bool)
    valid[3, 4] = True
    out = dense_disparity_visualization(gray, disp, valid)
    assert tuple(out[3, 4]) != (0, 0, 0) and tuple(out[0, 0]) == (0, 0, 0)
    same(out, jviz.dense_disparity_visualization(gray, disp, valid))
    rng = np.random.default_rng(2)
    disp = rng.uniform(-5, 40, (30, 40)).astype(np.float32)
    valid = rng.random((30, 40)) < 0.7
    gray = rng.integers(0, 256, (30, 40), dtype=np.uint8)
    same(dense_disparity_visualization(gray, disp, valid, max_disparity=32),
         jviz.dense_disparity_visualization(gray, disp, valid,
                                            max_disparity=32))


def test_draw_line_clips():
    img = np.zeros((10, 10, 3), np.uint8)
    draw_line(img, -5, 2, 15, 2, (255, 0, 0))
    assert (img[2, :, 0] == 255).all()
    assert img[3].sum() == 0
    jimg = np.zeros((10, 10, 3), np.uint8)
    jviz.draw_line(jimg, -5, 2, 15, 2, (255, 0, 0))
    for args in ((0, 0, 9, 7), (8, 1, -3, 12), (4, 4, 4, 4)):
        draw_line(img, *args, (0, 255, 9))
        jviz.draw_line(jimg, *args, (0, 255, 9))
    same(img, jimg)


def test_draw_correspondences():
    gray = np.zeros((20, 40), np.uint8)
    sup = np.array([[30, 10, 8]])
    out = draw_correspondences(gray, sup)
    assert (out[10, 22:31].sum(axis=1) > 0).all()
    same(out, jviz.draw_correspondences(gray, sup))
    rng = np.random.default_rng(3)
    sup = np.stack([rng.integers(0, 40, 30), rng.integers(0, 20, 30),
                    rng.integers(-10, 30, 30)], axis=1)
    same(draw_correspondences(gray, sup, 32.0, stride=2),
         jviz.draw_correspondences(gray, sup, 32.0, stride=2))


def test_draw_triangle():
    img = np.zeros((20, 20, 3), np.uint8)
    draw_triangle(img, [(2, 2), (16, 2), (2, 16)], (0, 255, 0))
    assert tuple(img[3, 3]) == (0, 255, 0)
    assert tuple(img[15, 15]) == (0, 0, 0)
    assert tuple(img[2, 2]) == (0, 255, 0)
    draw_triangle(img, [(-5, -5), (25, 0), (0, 25)], (255, 0, 0))
    jimg = np.zeros((20, 20, 3), np.uint8)
    jviz.draw_triangle(jimg, [(2, 2), (16, 2), (2, 16)], (0, 255, 0))
    jviz.draw_triangle(jimg, [(-5, -5), (25, 0), (0, 25)], (255, 0, 0))
    same(img, jimg)


def test_kitti_colors_reference_compat_mode():
    d = np.array([0.0])
    canon = kitti_disparity_colors(d)
    ref = kitti_disparity_colors(d, compat="reference")
    assert tuple(canon[0]) == (0, 0, 0)
    assert tuple(ref[0]) == (0, 0, 255)
    with pytest.raises(ValueError):
        kitti_disparity_colors(d, compat="bogus")


@pytest.mark.parametrize("n", [0, 1, 1000, 60000],
                         ids=["empty", "one", "sequential", "threaded"])
def test_supports_text_roundtrip(n, tmp_path):
    """The writer's bytes equal np.savetxt's and the JAX writer's (the
    threaded host writer from 50,000 rows), and read back exactly."""
    rng = np.random.default_rng(n)
    a = np.stack([rng.integers(0, 4096, n), rng.integers(0, 2160, n),
                  rng.integers(-(1 << 20), 1 << 20, n)], axis=1)
    write_supports(str(tmp_path / "t.txt"), a)
    jsup.write_supports(str(tmp_path / "j.txt"), a)
    np.savetxt(str(tmp_path / "n.txt"), a.astype(np.int32), fmt="%d")
    got = (tmp_path / "t.txt").read_bytes()
    assert got == (tmp_path / "j.txt").read_bytes()
    assert got == (tmp_path / "n.txt").read_bytes()
    back = read_supports(str(tmp_path / "t.txt"))
    assert back.dtype == np.int64 and back.shape == (n, 3)
    np.testing.assert_array_equal(back, a)
    np.testing.assert_array_equal(
        back, jsup.read_supports(str(tmp_path / "t.txt")))


def test_supports_writer_without_host_library(tmp_path, monkeypatch):
    """Where the host library cannot be built the writer falls back to
    np.savetxt: the same bytes."""
    a = np.random.default_rng(7).integers(-50, 50, (40, 3))
    write_supports(str(tmp_path / "native.txt"), a)
    monkeypatch.setattr(tpng, "_NATIVE", None)
    monkeypatch.setattr(tpng, "_NATIVE_TRIED", True)
    write_supports(str(tmp_path / "plain.txt"), a)
    assert (tmp_path / "native.txt").read_bytes() == \
        (tmp_path / "plain.txt").read_bytes()
