"""One rank of a gloo process group for tests/test_torch_parallel.py.

    python tests/torch_gloo_worker.py STORE WORLD RANK DATA.npz OUT.npz

Joins the group through the file store STORE, runs the port's row-sharded
single-frame matcher on its rows of the pair in DATA.npz for every
contract, and writes its row blocks to OUT.npz, one array per output leaf
named ``<contract>/<i>``.  Imports torch and the port only.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from opengpc_tpu_torch import InferenceSettings, load_forest, make_filter_mask
from opengpc_tpu_torch.parallel import (CONTRACTS,
                                        build_sharded_frame_sparsematch,
                                        init_distributed, split_frame)


def leaves(out):
    if isinstance(out, tuple):
        return [leaf for o in out for leaf in leaves(o)]
    return [out]


def main(store, world, rank, data, out):
    torch.set_num_threads(1)
    size = init_distributed("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    if size != world:
        raise SystemExit(f"joined a group of {size}, not {world}")
    d = np.load(data)
    mask = make_filter_mask(load_forest(str(d["forest"])))
    blocks = {}
    for contract in CONTRACTS:
        settings = InferenceSettings(
            gradient_threshold=5, disp_high=64,
            epipolar_mode=contract != "global-compact")
        mod = build_sharded_frame_sparsematch(mask, settings,
                                              group=dist.group.WORLD,
                                              contract=contract,
                                              device="cpu")
        left = split_frame(torch.from_numpy(d["left"]), world)[rank]
        right = split_frame(torch.from_numpy(d["right"]), world)[rank]
        for i, leaf in enumerate(leaves(mod(left, right))):
            blocks[f"{contract}/{i}"] = leaf.numpy()
    np.savez(out, **blocks)
    dist.destroy_process_group()


if __name__ == "__main__":
    store, world, rank, data, out = sys.argv[1:]
    main(store, int(world), int(rank), data, out)
