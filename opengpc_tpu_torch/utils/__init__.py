"""Synthetic scenes for tests and the chip smoke run."""

from opengpc_tpu_torch.utils.scenes import make_pair, make_scene, make_sparse_pair

__all__ = ["make_pair", "make_scene", "make_sparse_pair"]
