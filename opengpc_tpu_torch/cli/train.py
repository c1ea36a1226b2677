"""Forest training CLI.

Load a binary triplet dataset, train a fern forest with the greedy split
optimizer on the card, export the text forest, as ``opengpc_tpu.cli.train``
does (the same arguments, log lines and forest file, byte for byte for the
same seed and dataset):

    python -m opengpc_tpu_torch.cli.train <triplets.bin> <forest.txt>

Defaults mirror the reference ``train`` sample: zero optimizer with 10
resamples and w1=0.5, FernFactory(2, 2, 2, 5), sample fraction 0.7.
Training takes an explicit ``--seed`` and is fully reproducible.
``--device cpu`` trains on the CPU instead of the card.

``--data-parallel N`` splits the triplet axis over the N ranks of a
``torchrun`` launch, one rank a device (NCCL on ``cuda:LOCAL_RANK``, gloo
with ``--device cpu``):

    torchrun --nproc-per-node N -m opengpc_tpu_torch.cli.train \
        <triplets.bin> <forest.txt> --data-parallel N

Every rank loads the same dataset and sums each level's counts with the
others; rank 0 alone prints and writes the forest, which is the one-device
trainer's byte for byte.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import torch.distributed as dist

from opengpc_tpu_torch.cli._errors import report_input_errors
from opengpc_tpu_torch.config import (fern_factory, tau_optimizer,
                                      zero_optimizer)
from opengpc_tpu_torch.forest import save_forest
from opengpc_tpu_torch.io.triplets import load_triplets
from opengpc_tpu_torch.train import train_forest


@report_input_errors
def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="opengpc-train", description=__doc__.splitlines()[0]
    )
    from opengpc_tpu_torch import __version__
    p.add_argument("--version", action="version",
                   version=f"%(prog)s {__version__}")
    p.add_argument("dataset", help="binary triplet dataset (extract output)")
    p.add_argument("forest_out", help="output text forest path")
    p.add_argument("--fern-type", choices=["zero", "tau"], default="zero",
                   help="zero: tau fixed to 0; tau: tau searched in [-10,10)")
    p.add_argument("--num-s", type=int, default=2, help="ferns at 7x7 scale")
    p.add_argument("--num-m", type=int, default=2, help="ferns at 17x17 scale")
    p.add_argument("--num-l", type=int, default=2, help="ferns at 27x27 scale")
    p.add_argument("--depth", type=int, default=5, help="tests per fern")
    p.add_argument("--num-resamples", type=int, default=10)
    p.add_argument("--sample-fraction", type=float, default=0.7)
    p.add_argument("--w1", type=float, default=0.5,
                   help="precision weight in the harmonic-mean score")
    p.add_argument("--only-score-non-split", action="store_true",
                   help="exclude already-true-positive triplets per level")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint", default=None,
                   help="write the partial forest here after each fern")
    p.add_argument("--no-batch-ferns", action="store_true",
                   help="force the fern-at-a-time training loop instead of "
                   "the level-synchronous batched trainer (same forest "
                   "byte-for-byte; batched is the multi-fern default when "
                   "the bootstrap stack fits its cap)")
    p.add_argument("--data-parallel", type=int, default=0, metavar="N",
                   help="split the triplet axis over the N ranks of a "
                   "torchrun launch (each level's TP/FP/FN counts become "
                   "one all_reduce; the selected splits are IDENTICAL, "
                   "integer counts being exact however they are split)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: cuda)")
    args = p.parse_args(argv)

    from opengpc_tpu_torch.parallel.groups import in_launch, join_launch

    group, device, lead = None, args.device, True
    if in_launch():
        world = int(os.environ["WORLD_SIZE"])
        if max(args.data_parallel, 1) != world:
            print(f"--data-parallel {max(args.data_parallel, 1)} is not this "
                  f"launch's WORLD_SIZE={world}", file=sys.stderr)
            return 1
        if args.data_parallel:
            rank, device = join_launch(args.device)
            group, lead = dist.group.WORLD, rank == 0
    elif args.data_parallel > 1:
        print(f"--data-parallel {args.data_parallel}: one rank a device, so "
              f"launch it as torchrun --nproc-per-node {args.data_parallel} "
              "-m opengpc_tpu_torch.cli.train ... --data-parallel "
              f"{args.data_parallel}", file=sys.stderr)
        return 1
    try:
        with contextlib.ExitStack() as quiet:
            if not lead:  # rank 0 alone prints and writes
                null = quiet.enter_context(open(os.devnull, "w"))
                quiet.enter_context(contextlib.redirect_stdout(null))
            return _train(args, group, device, lead)
    finally:
        if group is not None:
            dist.destroy_process_group()


def _train(args, group, device, lead: bool) -> int:
    triplets = load_triplets(args.dataset)
    print(f"Loaded {triplets.shape[0]} triplets from {args.dataset}")

    make_opt = zero_optimizer if args.fern_type == "zero" else tau_optimizer
    optimizer = make_opt(
        num_resamples=args.num_resamples,
        only_score_non_split_samples=args.only_score_non_split,
        w1=args.w1,
    )
    settings = fern_factory(args.num_s, args.num_m, args.num_l, args.depth)
    settings = type(settings)(
        ferns=settings.ferns,
        max_depth=settings.max_depth,
        sample_fraction=args.sample_fraction,
    )
    # a checkpoint trains fern at a time on every rank; rank 0 writes it
    forest = train_forest(triplets, settings, optimizer, seed=args.seed,
                          checkpoint_path=args.checkpoint if lead else None,
                          batch_ferns=(False if args.no_batch_ferns
                                       or args.checkpoint else None),
                          device=device, group=group)
    if lead:
        save_forest(forest, args.forest_out)
    print(f"Exported forest to {args.forest_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
