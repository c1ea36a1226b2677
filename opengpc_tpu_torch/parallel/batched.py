"""Batch data-parallel matching on ``torch.distributed``: the JAX
package's ``build_batched_sparsematch*`` and ``build_batched_pyramid``.

Per-pair work is independent, so each rank of a process group takes its
contiguous block of B/N pairs (``groups.split_batch``, JAX's ``P("data")``
block split) and runs the single-device module of its contract on it; no
collective runs inside, and the blocks gathered in rank order are the
(B, ...) layout.  Within a rank the contract decides as on one device:
masked, masked-compact and rows fold the rank's pairs into one key-kernel
launch and one row sort, the flat and global contracts run pair by pair
(JAX's ``lax.map``), and the pyramid folds each level where the rows
pyramid applies.  Overflow flags follow JAX: masked-compact gives one flag
a rank ((N,) gathered), global-compact one a pair ((B,)).
"""

from __future__ import annotations

import torch

from opengpc_tpu_torch.config import InferenceSettings
from opengpc_tpu_torch.infer import (_as_mask, build_sparsematch,
                                     build_sparsematch_global_compact,
                                     build_sparsematch_global_rows,
                                     build_sparsematch_masked,
                                     build_sparsematch_masked_compact,
                                     build_sparsematch_rows)
from opengpc_tpu_torch.parallel.frame import _grid_1d
from opengpc_tpu_torch.parallel.groups import _leaves, _Parallel, split_batch
from opengpc_tpu_torch.pyramid import build_pyramid_sparsematch

BATCHED_CONTRACTS = ("flat", "rows", "masked", "masked-compact",
                     "global-rows", "global-compact")


class BatchedSparsematch(_Parallel):
    """One rank's part of a batch data-parallel matcher:
    ``forward(lefts, rights)`` takes the rank's (b, H, W) block of pairs
    and returns the single-device module's outputs for them (the
    masked-compact flag as (1,))."""

    def __init__(self, mask, settings: InferenceSettings, device, group,
                 contract, local):
        super().__init__(mask, settings, device)
        self._place(_grid_1d(group, "data"))
        self.contract, self.local = contract, local

    def _specs(self, out):
        return [(0, None)] * len(_leaves(out))

    def forward(self, lefts: torch.Tensor, rights: torch.Tensor):
        if lefts.dim() != 3:
            raise ValueError(f"batched matching takes (b, H, W) blocks; got "
                             f"shape {tuple(lefts.shape)}")
        out = self.local(lefts, rights)
        if self.contract == "masked-compact":
            return out[:2] + (out[2].reshape(1),)
        return out

    def _in_one_process(self, left, right, n: int):
        return self.gather([self(l, r) for l, r in zip(
            split_batch(left, n), split_batch(right, n))], n, 1)


def _batched(contract, build, forest_or_mask, settings, group, device,
             **kw) -> BatchedSparsematch:
    mask = _as_mask(forest_or_mask)
    return BatchedSparsematch(mask, settings, torch.device(device), group,
                              contract, build(mask, settings, device=device,
                                              **kw))


def build_batched_sparsematch(forest_or_mask, settings: InferenceSettings,
                              group=None, device="cuda"):
    """The flat contract batch-split over ``group``'s ranks (``None``:
    this process alone): (xs, ys, ds) (B, capacity) and counts (B,)
    whole, pair by pair on each rank."""
    return _batched("flat", build_sparsematch, forest_or_mask, settings,
                    group, device)


def build_batched_sparsematch_rows(forest_or_mask, settings: InferenceSettings,
                                   group=None, device="cuda"):
    """The row form batch-split over ``group``: ((xs, ds) (B, H, W) each,
    row_counts (B, H)), each rank's pairs folded into one row sort."""
    return _batched("rows", build_sparsematch_rows, forest_or_mask, settings,
                    group, device)


def build_batched_sparsematch_masked(forest_or_mask,
                                     settings: InferenceSettings, group=None,
                                     device="cuda"):
    """The masked contract batch-split over ``group``: (buf (B, H, 2W),
    row_counts (B, H)), each rank's pairs folded into one row sort."""
    return _batched("masked", build_sparsematch_masked, forest_or_mask,
                    settings, group, device)


def build_batched_sparsematch_masked_compact(forest_or_mask,
                                             settings: InferenceSettings,
                                             group=None, chunk=None, k=None,
                                             device="cuda"):
    """The chunk-compacted masked contract batch-split over ``group``:
    (buf (B, H, C), row_counts (B, H), overflow (N,) bool), one folded
    compacted sort and one flag a rank; re-run the full-width masked
    matcher when any flag is set."""
    return _batched("masked-compact", build_sparsematch_masked_compact,
                    forest_or_mask, settings, group, device, chunk=chunk,
                    k=k)


def build_batched_sparsematch_global_rows(forest_or_mask,
                                          settings: InferenceSettings,
                                          group=None, device="cuda"):
    """The segmented global contract batch-split over ``group``: ((xs, ys,
    ds) (B, R, C) each, counts (B, R)), pair by pair on each rank."""
    return _batched("global-rows", build_sparsematch_global_rows,
                    forest_or_mask, settings, group, device)


def build_batched_sparsematch_global_compact(forest_or_mask,
                                             settings: InferenceSettings,
                                             group=None, chunk=None, k=None,
                                             device="cuda"):
    """The chunk-compacted global contract batch-split over ``group``:
    ((xs, ys, ds) (B, R, C) each, counts (B, R), overflow (B,) bool), pair
    by pair with a flag a pair; re-run flagged pairs through the
    full-width global matcher."""
    return _batched("global-compact", build_sparsematch_global_compact,
                    forest_or_mask, settings, group, device, chunk=chunk,
                    k=k)


def build_batched_pyramid(forest_or_mask, settings: InferenceSettings,
                          group=None, num_levels: int = 3, device="cuda"):
    """(B, H, W) pyramids batch-split over ``group``: each rank runs the
    single-device pyramid on its block, each level folded into one
    key-kernel launch and one row sort where the rows pyramid applies,
    pair by pair on the flat fallback otherwise.  (xs, ys, ds, lv) (B, K)
    and counts (B, L) whole."""
    return _batched("pyramid", build_pyramid_sparsematch, forest_or_mask,
                    settings, group, device, num_levels=num_levels)
