"""One rank of a gloo process group for tests/test_torch_parallel.py.

    python tests/torch_gloo_worker.py STORE WORLD RANK DATA.npz OUT.npz

Joins the group through the file store STORE and, on the inputs in
DATA.npz, runs every multi-device builder of the port over the group:

* the row-sharded single frame, every contract: the rank's row blocks,
  named ``<contract>/<i>``, one array per output leaf;
* the six batched contracts and the batched pyramid, the row-sharded
  pyramid, the 2-D frame (three contracts) and 2-D pyramid on every grid
  the world makes: the whole result the rank gathered (``run_whole``),
  named ``batched/<contract>/<i>``, ``pyramid/<i>``,
  ``2d/<n_data>x<n_rows>/<contract>/<i>`` and
  ``2dpyr/<n_data>x<n_rows>/<i>``;
* ``train_forest`` with ``group=`` (zero and tau optimizers, batched and
  fern at a time) and ``sharded_train_fern``: the forest texts,
  ``train/<kind>/<batched>`` and ``fern``;
* ``sharded_sparsematch_step`` on the group (``step``).

Writes them to OUT.npz.  Imports torch and the port only.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from opengpc_tpu_torch import (InferenceSettings, fern_factory, load_forest,
                               make_filter_mask, serialize_forest,
                               tau_optimizer, train_forest, zero_optimizer)
from opengpc_tpu_torch import parallel as par
from opengpc_tpu_torch.forest import SCALE_L, Forest

BATCHED = {"flat": par.build_batched_sparsematch,
           "rows": par.build_batched_sparsematch_rows,
           "masked": par.build_batched_sparsematch_masked,
           "masked-compact": par.build_batched_sparsematch_masked_compact,
           "global-rows": par.build_batched_sparsematch_global_rows,
           "global-compact": par.build_batched_sparsematch_global_compact}
GRIDS = {2: [(1, 2), (2, 1)], 4: [(2, 2), (1, 4), (4, 1)]}


def leaves(out):
    if isinstance(out, tuple):
        return [leaf for o in out for leaf in leaves(o)]
    return [out]


def settings(global_mode=False):
    return InferenceSettings(gradient_threshold=5, disp_high=64,
                             epipolar_mode=not global_mode)


def main(store, world, rank, data, out):
    torch.set_num_threads(1)
    size = par.init_distributed("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank)
    if size != world:
        raise SystemExit(f"joined a group of {size}, not {world}")
    d = np.load(data)
    mask = make_filter_mask(load_forest(str(d["forest"])))
    group = dist.group.WORLD
    blocks = {}

    def keep(name, result):
        for i, leaf in enumerate(leaves(result)):
            blocks[f"{name}/{i}"] = leaf.numpy()

    for contract in par.CONTRACTS:
        mod = par.build_sharded_frame_sparsematch(
            mask, settings(contract == "global-compact"), group=group,
            contract=contract, device="cpu")
        left = par.split_frame(torch.from_numpy(d["left"]), world)[rank]
        right = par.split_frame(torch.from_numpy(d["right"]), world)[rank]
        keep(contract, mod(left, right))

    lefts, rights = torch.from_numpy(d["lefts"]), torch.from_numpy(d["rights"])
    for contract, build in BATCHED.items():
        mod = build(mask, settings(contract.startswith("global")), group,
                    device="cpu")
        keep(f"batched/{contract}", mod.run_whole(lefts, rights))
    keep("batched/pyramid", par.build_batched_pyramid(
        mask, settings(), group, 2, device="cpu").run_whole(lefts, rights))
    keep("pyramid", par.build_sharded_frame_pyramid(
        mask, settings(), group, 2, device="cpu").run_whole(
        torch.from_numpy(d["pleft"]), torch.from_numpy(d["pright"])))
    for grid in GRIDS[world]:
        g = par.make_mesh_2d(*grid)
        tag = f"{grid[0]}x{grid[1]}"
        for contract in par.CONTRACTS[:3]:
            keep(f"2d/{tag}/{contract}",
                 par.build_batched_sharded_frame_sparsematch(
                     mask, settings(), g, contract,
                     device="cpu").run_whole(lefts, rights))
        keep(f"2dpyr/{tag}", par.build_batched_sharded_frame_pyramid(
            mask, settings(), g, 2, device="cpu").run_whole(lefts, rights))

    trips = d["triplets"]
    for kind, make in (("zero", zero_optimizer), ("tau", tau_optimizer)):
        for batched in (True, False):
            forest = train_forest(trips, fern_factory(1, 1, 1, 3),
                                  make(num_resamples=4), seed=3,
                                  verbose=False, batch_ferns=batched,
                                  device="cpu", group=group)
            blocks[f"train/{kind}/{batched}"] = np.array(
                serialize_forest(forest))
    fern, _ = par.sharded_train_fern(trips, SCALE_L,
                                     tau_optimizer(num_resamples=4), 3,
                                     group, seed=5, device="cpu")
    blocks["fern"] = np.array(serialize_forest(Forest((fern,))))
    par.sharded_sparsematch_step(group, device="cpu")
    blocks["step"] = np.array(1)
    np.savez(out, **blocks)
    dist.destroy_process_group()


if __name__ == "__main__":
    store, world, rank, data, out = sys.argv[1:]
    main(store, int(world), int(rank), data, out)
