"""PyTorch/CUDA port of opengpc_tpu: GPC sparse stereo matching on an
NVIDIA H100.

So far the port runs the masked epipolar contract end to end: the fused
key kernel (CUDA C++, ``csrc/fused_keys.cu``), the per-row sort, pair
detection and masked emit, and the host decode.  It imports torch and
numpy and never JAX; importing it builds and loads no kernel.

>>> from opengpc_tpu_torch import InferenceSettings, sparsematch
>>> supports = sparsematch(left, right, "forests/defaultZeroForest.txt",
...                        InferenceSettings(gradient_threshold=5,
...                                          epipolar_mode=True))
"""

from opengpc_tpu_torch.config import InferenceSettings
from opengpc_tpu_torch.forest import (filter_mask_from_numpy, load_forest,
                                      make_filter_mask)
from opengpc_tpu_torch.infer import (build_sparsematch_masked,
                                     masked_supports_to_numpy, sparsematch)

__all__ = [
    "InferenceSettings",
    "build_sparsematch_masked",
    "filter_mask_from_numpy",
    "load_forest",
    "make_filter_mask",
    "masked_supports_to_numpy",
    "sparsematch",
]
