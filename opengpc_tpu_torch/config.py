"""Inference settings: the same fields, defaults and validation as
``opengpc_tpu.config.InferenceSettings``."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class InferenceSettings:
    """Settings for sparse matching.

    ``capacity`` sizes the flat contract's support buffer; the masked and
    global-rows contracts do not read it.
    """

    gradient_threshold: int = 10
    disp_high: int = 128
    vertical_tolerance: int = 1
    epipolar_mode: bool = False
    capacity: int = 32768

    def __post_init__(self):
        if not (0 <= self.gradient_threshold <= 255):
            raise ValueError("gradient_threshold needs to be within 0...255")
