"""Multi-device matching and training on ``torch.distributed``: the port
of ``opengpc_tpu.parallel``.

A process group takes the place of JAX's mesh: ``group=None`` is this
process alone, ``make_mesh()`` the world (1-D), ``make_mesh_2d(n_data,
n_rows)`` a grid of frame groups (2-D), under the JAX package's names.  Every builder returns one rank's
``nn.Module``: ``forward`` takes the rank's block of the inputs and
returns its blocks of the outputs; ``shard`` cuts that block from whole
inputs, ``collect`` gathers the whole result on every rank and
``run_whole`` does both.  The builders, under JAX's names:

* ``frame``: the row-sharded single frame (four contracts, halo exchange,
  the global contract as a distributed bucket sort) and the 2-D batch of
  row-sharded frames (``build_batched_sharded_frame_sparsematch``);
* ``batched``: the six batch data-parallel contracts and
  ``build_batched_pyramid`` (no collective inside);
* ``pyramid``: the row-sharded pyramid, one frame and the 2-D batch;
* ``sharded_train_fern``, and ``group=`` of ``train.train_fern`` /
  ``train_forest``: the triplet axis split over the ranks, each level's
  counts summed by ``all_reduce``;
* ``step.sharded_sparsematch_step``: a dry run of all of them at tiny
  shapes, each against the single-device module.

The modules are stages glued by collectives; ``_run_in_one_process``
glues the same stages by slicing, for n ranks in one process on one
device (n a pair (n_data, n_rows) for the 2-D builders).  Tests and
``chip_smoke.py`` use it to drive n > 1 on one card; it is never chosen
implicitly.  A multi-rank run starts one rank a GPU under ``torchrun``
(``init_distributed``; gloo with CPU tensors).
"""

from __future__ import annotations

import numpy as np

from opengpc_tpu_torch.parallel.batched import (
    BATCHED_CONTRACTS, build_batched_pyramid, build_batched_sparsematch,
    build_batched_sparsematch_global_compact,
    build_batched_sparsematch_global_rows, build_batched_sparsematch_masked,
    build_batched_sparsematch_masked_compact, build_batched_sparsematch_rows)
from opengpc_tpu_torch.parallel.frame import (
    CONTRACTS, build_batched_sharded_frame_sparsematch,
    build_sharded_frame_sparsematch)
from opengpc_tpu_torch.parallel.groups import (Grid, all_gather_outputs,
                                               init_distributed, make_mesh,
                                               make_mesh_2d, split_batch,
                                               split_frame)
from opengpc_tpu_torch.parallel.pyramid import (
    build_batched_sharded_frame_pyramid, build_sharded_frame_pyramid)
from opengpc_tpu_torch.parallel.step import sharded_sparsematch_step


def _run_in_one_process(mod, left, right, n):
    """The whole result of ``mod`` for n ranks, every rank's stages run in
    this process on one device: halos are cut from the neighbour blocks,
    the all-to-all is done by slicing, flags and counts are combined as
    the collectives would.  It equals ``mod.gather`` of the n ranks'
    outputs in rank order.  ``n`` is the group size, (n_data, n_rows) for the 2-D
    builders."""
    return mod._in_one_process(left, right, n)


def sharded_train_fern(triplets, scale, optimizer, max_depth, group=None,
                       seed: int = 0, verbose: bool = False, device="cuda"):
    """Train one fern with the triplet axis split over ``group``'s ranks:
    each level's TP/FP/FN counts are one ``all_reduce(SUM)``; the splits
    chosen are the one-device trainer's (integer counts are exact however
    they are split)."""
    from opengpc_tpu_torch.train import train_fern

    return train_fern(triplets, scale, optimizer, max_depth,
                      rng=np.random.default_rng(seed), verbose=verbose,
                      device=device, group=group)


__all__ = [
    "BATCHED_CONTRACTS", "CONTRACTS", "Grid", "all_gather_outputs",
    "build_batched_pyramid", "build_batched_sharded_frame_pyramid",
    "build_batched_sharded_frame_sparsematch", "build_batched_sparsematch",
    "build_batched_sparsematch_global_compact",
    "build_batched_sparsematch_global_rows",
    "build_batched_sparsematch_masked",
    "build_batched_sparsematch_masked_compact",
    "build_batched_sparsematch_rows", "build_sharded_frame_pyramid",
    "build_sharded_frame_sparsematch", "init_distributed", "make_mesh",
    "make_mesh_2d",
    "sharded_sparsematch_step", "sharded_train_fern", "split_batch",
    "split_frame",
]
