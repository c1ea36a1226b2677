"""Synthetic scenes for tests and the chip smoke run, random forests,
phase timing and profiler traces."""

from opengpc_tpu_torch.utils.fuzz import random_forest
from opengpc_tpu_torch.utils.scenes import make_pair, make_scene, make_sparse_pair
from opengpc_tpu_torch.utils.timing import PhaseTimer, trace

__all__ = ["PhaseTimer", "make_pair", "make_scene", "make_sparse_pair",
           "random_forest", "trace"]
