"""Preprocessing, leaf codes, the fused kernels and their custom ops
(``ops.library``, registered on import)."""

from opengpc_tpu_torch.ops import library  # noqa: F401
