"""What every entry asks of the port: its settings object for a
configuration, and its kernel library built or loaded before the first
call (the port's fixed in-checkout cache, ``opengpc_tpu_torch/_build/``)."""

from __future__ import annotations

import torch


def settings(cfg: dict):
    from opengpc_tpu_torch.config import InferenceSettings
    return InferenceSettings(
        gradient_threshold=cfg["gradient_threshold"],
        disp_high=cfg["disp_high"],
        vertical_tolerance=cfg["vertical_tolerance"],
        epipolar_mode=cfg["epipolar_mode"])


def load_kernels(device) -> None:
    if torch.device(device).type == "cuda":
        from opengpc_tpu_torch.ops._build import load_library
        load_library()
