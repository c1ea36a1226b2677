"""Inference and training settings: the same fields, defaults and
validation as ``opengpc_tpu.config``'s dataclasses and factories."""

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


@dataclasses.dataclass(frozen=True)
class OptimizerSettings:
    """Greedy fern-split optimizer settings.

    ``tau_lo``/``tau_hi`` bound the intercept line search (a zero fern is
    tau_lo=0, tau_hi=1 which forces tau=0); ``w1`` weights the harmonic
    mean of precision/recall.
    """

    tau_lo: int = 0
    tau_hi: int = 1
    num_resamples: int = 10
    only_score_non_split_samples: bool = False
    w1: float = 0.5


def zero_optimizer(num_resamples: int = 10, only_score_non_split_samples: bool = False,
                   w1: float = 0.5) -> OptimizerSettings:
    """The zero optimizer: tau forced to 0."""
    return OptimizerSettings(0, 1, num_resamples, only_score_non_split_samples, w1)


def tau_optimizer(tau_lo: int = -10, tau_hi: int = 10, num_resamples: int = 10,
                  only_score_non_split_samples: bool = False,
                  w1: float = 0.5) -> OptimizerSettings:
    """The tau optimizer: tau searched in [tau_lo, tau_hi)."""
    return OptimizerSettings(tau_lo, tau_hi, num_resamples, only_score_non_split_samples, w1)


@dataclasses.dataclass(frozen=True)
class ForestSettings:
    """Forest training settings: ``ferns`` is a tuple of scales (one entry
    per fern), ``max_depth`` the number of tests per fern,
    ``sample_fraction`` the bootstrap fraction per fern."""

    ferns: tuple  # tuple of scale ints (forest.SCALE_S/M/L)
    max_depth: int = 5
    sample_fraction: float = 0.7


def fern_factory(num_s: int, num_m: int, num_l: int, max_depth: int) -> ForestSettings:
    """num_s 7x7 + num_m 17x17 + num_l 27x27 ferns of ``max_depth`` tests."""
    from opengpc_tpu_torch.forest import SCALE_S, SCALE_M, SCALE_L

    scales = (SCALE_S,) * num_s + (SCALE_M,) * num_m + (SCALE_L,) * num_l
    return ForestSettings(ferns=scales, max_depth=max_depth)
