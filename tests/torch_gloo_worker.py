"""One rank of a gloo process group for tests/test_torch_parallel.py.

    python tests/torch_gloo_worker.py STORE WORLD RANK DATA.npz OUT.npz [aot]

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

With ``aot`` (for tests/test_torch_aot.py) it runs the sharded AOT
exports instead: the row-sharded frame (masked, global-compact, a 2-level
pyramid) and the 2-D frame and pyramid on every grid the world makes, each
exported by every rank and loaded again over groups made afresh (other
group names than the export's), named ``aot/<contract>/<i>`` and
``aot2d/<n_data>x<n_rows>/<contract>/<i>``; a world-1 artifact served on
the first rank of the world (``first/<i>``, ``first_served``); and the
masked artifact saved by rank 0 and loaded by every rank through the
container (``container``, the decoded supports).  Rank 0 also writes the
masked blob (``blob``).

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


def aot_jobs(world, rank, d, mask, keep, blocks, out):
    """The sharded AOT exports over the world: see the module docstring."""
    from opengpc_tpu_torch import aot

    left, right = d["left"], d["right"]
    serve = dist.new_group(list(range(world)))  # named unlike the world
    for contract, frame, levels in (
            ("masked", (left, right), 3),
            ("global-compact", (left, right), 3),
            ("pyramid", (d["pleft"], d["pright"]), 2)):
        blob = aot.export_sharded_frame(
            mask, settings(contract == "global-compact"), frame[0].shape,
            dist.group.WORLD, contract, device="cpu", num_levels=levels)
        keep(f"aot/{contract}", aot.load_sharded_frame(blob, serve)(*frame))
        if contract == "masked":
            masked = blob
    lefts, rights = d["lefts"], d["rights"]
    for grid in GRIDS[world]:
        g = par.make_mesh_2d(*grid)
        for contract in ("masked", "pyramid"):
            blob = aot.export_batched_sharded_frame(
                mask, settings(), lefts.shape[0], lefts.shape[1:], g,
                contract, device="cpu", num_levels=2)
            keep(f"aot2d/{grid[0]}x{grid[1]}/{contract}",
                 aot.load_batched_sharded_frame(blob, grid)(lefts, rights))
    first = dist.new_group([0])
    blob = [aot.export_sharded_frame(mask, settings(), left.shape, first,
                                     device="cpu") if rank == 0 else None]
    dist.broadcast_object_list(blob, 0)
    call = aot.load_sharded_frame(blob[0])
    blocks["first_served"] = np.array(call is not None)
    if call is not None:
        keep("first", call(left, right))
    path = out + ".ogpcx"
    if rank == 0:
        blocks["blob"] = np.frombuffer(masked, np.uint8)
        aot.save_artifact(path, masked, contract="masked",
                          settings=settings(), shape=left.shape,
                          device="cpu", extra={"n_devices": world})
    dist.barrier()
    path = [path]
    dist.broadcast_object_list(path, 0)
    call, meta = aot.load_artifact(path[0])
    blocks["container"] = aot.decode_outputs(meta, call(left, right))


def main(store, world, rank, data, out, mode=""):
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

    if mode == "aot":
        aot_jobs(world, rank, d, mask, keep, blocks, out)
        np.savez(out, **blocks)
        dist.destroy_process_group()
        return
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
    store, world, rank, data, out = sys.argv[1:6]
    main(store, int(world), int(rank), data, out, *sys.argv[6:])
