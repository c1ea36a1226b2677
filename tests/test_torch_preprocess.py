"""``infer.preprocess`` of the port against the JAX package's: the same
smoothed image and candidate mask, exactly, on seeded images at several
gradient thresholds, from numpy arrays and from tensors; a float image
raises in both."""

import numpy as np
import pytest
import torch

import opengpc_tpu.infer as jinfer
import opengpc_tpu_torch.infer as tinfer
from test_parity import random_image


@pytest.mark.parametrize("shape", [(48, 64), (61, 97)])
@pytest.mark.parametrize("threshold", [1, 5, 10, 29])
def test_preprocess_matches_jax(shape, threshold):
    img = random_image(np.random.default_rng(sum(shape) + threshold), *shape)
    jsmooth, jcand = jinfer.preprocess(img, threshold)
    for arg in (img, torch.from_numpy(img)):
        smooth, cand = tinfer.preprocess(arg, threshold, device="cpu")
        assert smooth.dtype == torch.uint8 and cand.dtype == torch.bool
        assert smooth.device.type == cand.device.type == "cpu"
        np.testing.assert_array_equal(smooth.numpy(), np.asarray(jsmooth))
        np.testing.assert_array_equal(cand.numpy(), np.asarray(jcand))
    assert cand.any() and not cand.all()


def test_preprocess_rejects_float_images():
    img = np.random.default_rng(0).random((32, 48))
    with pytest.raises(ValueError, match="uint8"):
        jinfer.preprocess(img, 5)
    for arg in (img, torch.from_numpy(img).float()):
        with pytest.raises(ValueError, match="uint8"):
            tinfer.preprocess(arg, 5, device="cpu")
