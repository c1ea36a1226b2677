"""Entry points of the PyTorch/CUDA port, the counterparts of
``__graft_entry__.py``'s.

``entry()``             — the single-card forward step: the flat-contract
                          matcher with defaultZeroForest as an
                          ``nn.Module``, and a stereo pair to call it on.
``dryrun_multichip(n)`` — every multi-device builder of
                          ``opengpc_tpu_torch.parallel`` once on an n-rank
                          process group at tiny shapes, each held to its
                          single-device module.

    python3 entry_torch.py                 # on the card
    python3 entry_torch.py --device cpu    # the CPU twins
    torchrun --nproc-per-node 4 entry_torch.py   # one rank a card, NCCL

Under ``torchrun`` every rank joins the launch's group first (NCCL on
``cuda:LOCAL_RANK``, gloo with ``--device cpu``), so the dry run spans the
launch's ranks.
"""

import os

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def _forest():
    from opengpc_tpu_torch.forest import load_forest

    return load_forest(os.path.join(REPO, "forests", "defaultZeroForest.txt"))


def entry(device="cuda"):
    """(module, example_args): the flat-contract matcher on ``device`` (one
    stereo pair in, fixed-capacity supports out: ``(xs, ys, ds, count)``)
    and a 128x256 pair on the same device."""
    import torch

    from opengpc_tpu_torch.config import InferenceSettings
    from opengpc_tpu_torch.infer import build_sparsematch

    settings = InferenceSettings(
        gradient_threshold=5, vertical_tolerance=0, disp_high=128,
        epipolar_mode=True, capacity=8192,
    )
    module = build_sparsematch(_forest(), settings, device=device)
    rng = np.random.default_rng(0)
    h, w = 128, 256
    left = rng.integers(0, 256, (h, w)).astype(np.uint8)
    right = np.roll(left, -4, axis=1)
    return module, tuple(torch.from_numpy(a).to(device)
                         for a in (left, right))


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run ``parallel.step.sharded_sparsematch_step`` on ``n_devices``
    ranks: this process alone for 1, else the initialized default process
    group, which must have ``n_devices`` ranks (launch one process a rank,
    e.g. with ``torchrun --nproc-per-node n``).  Raises on the first
    result that differs from its single-device module."""
    import torch.distributed as dist

    from opengpc_tpu_torch.parallel.step import sharded_sparsematch_step

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_devices:
        raise ValueError(
            f"dryrun_multichip({n_devices}) needs a process group of "
            f"{n_devices} ranks; this process has {world} (start one "
            "process a rank, e.g. torchrun --nproc-per-node "
            f"{n_devices}, and initialize the group first)")
    sharded_sparsematch_step(dist.group.WORLD if dist.is_initialized()
                             else None, device=device)


def main(argv=None):
    import argparse

    import torch.distributed as dist

    from opengpc_tpu_torch.parallel.groups import in_launch, join_launch

    p = argparse.ArgumentParser(description="The port's entry points.")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: the CPU twins")
    args = p.parse_args(argv)
    device = args.device
    if in_launch():
        _, device = join_launch(args.device)
    module, example = entry(device)
    out = module(*example)
    print("entry ok:", int(out[3]), "matches")
    world = dist.get_world_size() if dist.is_initialized() else 1
    dryrun_multichip(world, device=device)
    print(f"dryrun_multichip ok: {world} rank(s)")
    if in_launch():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
