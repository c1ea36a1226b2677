"""MPI-Sintel dataset catalogs (optical flow + stereo layouts).

Equivalent of the reference datasources' path handling
(SintelOpticalFlow.hpp:63-125,282-300 and
SintelStereo.hpp:58-120): directory layouts, ``frame_%04d`` naming
(1-based), grayscale conversion by RGB channel mean, and the stereo
disparity encoding ``d = 4*R + G/64`` (SintelStereo.hpp:421-422).

Deviation: the reference hardcodes 23 scene names and uses the first 20
(SintelOpticalFlow.hpp:194-200,126); we discover scene directories by
listing, sorted, optionally capped — same data, no baked-in list.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from opengpc_tpu_torch.io.flo import read_flo
from opengpc_tpu_torch.io.png import read_gray, read_rgb


def decode_stereo_disparity(rgb: np.ndarray) -> np.ndarray:
    """Sintel stereo disparity from an RGB image: d = 4*R + G/64
    (integer semantics, SintelStereo.hpp:421-422).  Returns (h, w) int32."""
    r = rgb[..., 0].astype(np.int32)
    g = rgb[..., 1].astype(np.int32)
    return 4 * r + g // 64


def _frame(dirpath: str, scene: str, idx: int, ext: str) -> str:
    return os.path.join(dirpath, scene, f"frame_{idx:04d}.{ext}")


class SintelFlow:
    """Optical-flow training layout: training/{clean,final,flow,occlusions,
    invalid}/<scene>/frame_%04d.{png,flo}."""

    def __init__(self, root: str, image_pass: str = "clean"):
        base = os.path.join(root, "training")
        self.image_dir = os.path.join(base, image_pass)
        self.flow_dir = os.path.join(base, "flow")
        self.occ_dir = os.path.join(base, "occlusions")
        self.inv_dir = os.path.join(base, "invalid")
        for d in (self.image_dir, self.flow_dir, self.occ_dir, self.inv_dir):
            if not os.path.isdir(d):
                raise FileNotFoundError(
                    f"{d}: not found — does not look like the Sintel optical "
                    f"flow dataset"
                )

    def scenes(self, limit: Optional[int] = None) -> List[str]:
        out = sorted(
            d for d in os.listdir(self.image_dir)
            if os.path.isdir(os.path.join(self.image_dir, d))
        )
        return out[:limit] if limit else out

    def num_frames(self, scene: str) -> int:
        d = os.path.join(self.image_dir, scene)
        return sum(1 for f in os.listdir(d) if f.endswith(".png"))

    def images(self, scene: str, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """Gray frames (t, t+1); 1-based idx (SintelOpticalFlow.hpp:345-358)."""
        return (
            read_gray(_frame(self.image_dir, scene, idx, "png")),
            read_gray(_frame(self.image_dir, scene, idx + 1, "png")),
        )

    def flow(self, scene: str, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """(u, v) float arrays (h, w) for frame idx -> idx+1."""
        return read_flo(_frame(self.flow_dir, scene, idx, "flo"))

    def occlusion(self, scene: str, idx: int) -> np.ndarray:
        return read_gray(_frame(self.occ_dir, scene, idx, "png"))

    def invalid(self, scene: str, idx: int) -> np.ndarray:
        return read_gray(_frame(self.inv_dir, scene, idx, "png"))


class SintelStereo:
    """Stereo training layout: training/{clean_left,clean_right,disparities,
    occlusions,outofframe}/<scene>/frame_%04d.png (SintelStereo.hpp:83-87)."""

    def __init__(self, root: str):
        base = os.path.join(root, "training")
        self.left_dir = os.path.join(base, "clean_left")
        self.right_dir = os.path.join(base, "clean_right")
        self.disp_dir = os.path.join(base, "disparities")
        self.occ_dir = os.path.join(base, "occlusions")
        self.oof_dir = os.path.join(base, "outofframe")
        for d in (self.left_dir, self.right_dir, self.disp_dir, self.occ_dir,
                  self.oof_dir):
            if not os.path.isdir(d):
                raise FileNotFoundError(
                    f"{d}: not found — does not look like the Sintel stereo "
                    f"dataset"
                )

    def scenes(self, limit: Optional[int] = None) -> List[str]:
        out = sorted(
            d for d in os.listdir(self.left_dir)
            if os.path.isdir(os.path.join(self.left_dir, d))
        )
        return out[:limit] if limit else out

    def num_frames(self, scene: str) -> int:
        d = os.path.join(self.left_dir, scene)
        return sum(1 for f in os.listdir(d) if f.endswith(".png"))

    def images(self, scene: str, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        return (
            read_gray(_frame(self.left_dir, scene, idx, "png")),
            read_gray(_frame(self.right_dir, scene, idx, "png")),
        )

    def disparity(self, scene: str, idx: int) -> np.ndarray:
        return decode_stereo_disparity(
            read_rgb(_frame(self.disp_dir, scene, idx, "png"))
        )

    def occlusion(self, scene: str, idx: int) -> np.ndarray:
        return read_gray(_frame(self.occ_dir, scene, idx, "png"))

    def outofframe(self, scene: str, idx: int) -> np.ndarray:
        return read_gray(_frame(self.oof_dir, scene, idx, "png"))
