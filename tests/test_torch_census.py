"""The port's 5x5 census (``ops.census.census5x5``, the plain twin of the
census kernel) and ``ops.fused.fused_census`` on CPU tensors against the
JAX package's ``census5x5`` and ``fused_census`` (Pallas interpret mode)
on odd shapes, and against the native oracle's census, bit for bit."""

import subprocess

import numpy as np
import pytest
import torch

from opengpc_tpu.io.raw import read_raw, write_raw
from opengpc_tpu.ops import fused as jfused
from opengpc_tpu.ops.census import census5x5 as jcensus

from opengpc_tpu_torch.ops import fused as tfused
from opengpc_tpu_torch.ops.census import census5x5
from test_torch_flat import structured_image

SHAPES = [(5, 6), (48, 64), (61, 97), (37, 130), (128, 160)]


@pytest.mark.parametrize("shape", SHAPES)
def test_census_matches_jax(shape):
    img = structured_image(np.random.default_rng(sum(shape)), *shape)
    got = census5x5(torch.from_numpy(img))
    assert got.dtype == torch.int32 and got.shape == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcensus(img)))
    np.testing.assert_array_equal(
        tfused.fused_census(torch.from_numpy(img)).numpy(),
        np.asarray(jfused.fused_census(img, interpret=True)))
    assert shape[0] < 6 or got.any()


@pytest.mark.parametrize("shape", [(48, 64), (61, 97), (128, 160)])
def test_census_matches_oracle(shape, oracle_path, tmp_path):
    img = structured_image(np.random.default_rng(sum(shape)), *shape)
    inp, out = str(tmp_path / "in.raw"), str(tmp_path / "out.raw")
    write_raw(inp, img)
    subprocess.run([oracle_path, "census", inp, out], check=True)
    got = tfused.fused_census(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), read_raw(out))


def test_census_cpu_counts_no_launch_and_guards():
    img = torch.from_numpy(structured_image(np.random.default_rng(0), 30, 40))
    before = tfused.fused_census.launches
    assert torch.equal(tfused.fused_census(img), census5x5(img))
    assert tfused.fused_census.launches == before == 0
    with pytest.raises(ValueError, match="uint8"):
        tfused.fused_census(img.float())
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        tfused.fused_census(img[None])
    # the asymmetric valid box: y <= h-4 but x <= w-3
    code = census5x5(img)
    assert not code[-3:].any() and not code[:, -2:].any()
    assert code[-4].any() and code[:, -3].any()
