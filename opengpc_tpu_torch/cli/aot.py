"""AOT artifact CLI: export a frozen matcher program, run one for serving.

``export`` freezes forest + settings + frame shape + output contract into
one self-describing ``torch.export`` artifact on ``--device`` (see
``opengpc_tpu_torch.aot``): a CUDA artifact launches the hand-written
kernels, a CPU one runs their plain twins.  ``run`` is the serving side:
load, execute, decode, write supports; no forest file, no re-trace.  The
port of ``opengpc_tpu.cli.aot``, with JAX's flags, refusals and exit
codes; ``--device`` takes the place of JAX's lowering options
``--platforms`` and ``--pallas``, which are refused.

    python -m opengpc_tpu_torch.cli.aot export forest.txt matcher.ogpcx \\
        --height 436 --width 1024 --contract masked --disp-high 128
    python -m opengpc_tpu_torch.cli.aot run matcher.ogpcx left.png \\
        right.png --supports-out supports.txt

``--shard-frame N`` (with ``--data-parallel D`` / ``--batch B`` the 2-D
grid) exports one program a rank and runs one rank a device under
``torchrun``, as the other CLIs do:

    torchrun --nproc-per-node N -m opengpc_tpu_torch.cli.aot export \\
        forest.txt pod.ogpcx --height 436 --width 1024 --shard-frame N
    torchrun --nproc-per-node N -m opengpc_tpu_torch.cli.aot run \\
        pod.ogpcx left.png right.png
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import torch

from opengpc_tpu_torch.aot import (CONTRACTS, decode_outputs,
                                   export_sparsematch, load_artifact,
                                   peek_artifact_meta, save_artifact)
from opengpc_tpu_torch.cli._errors import report_input_errors
from opengpc_tpu_torch.config import InferenceSettings
from opengpc_tpu_torch.parallel.groups import in_launch, join_launch

_NO_LOWERING = ("{flag} is a JAX lowering option; the port picks its "
                "kernels by --device (cuda launches the hand-written "
                "kernels, cpu runs their plain twins)")


def _parser():
    p = argparse.ArgumentParser(
        prog="opengpc-aot", description=__doc__.splitlines()[0]
    )
    from opengpc_tpu_torch import __version__
    p.add_argument("--version", action="version",
                   version=f"%(prog)s {__version__}")
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("export", help="freeze a matcher into an artifact")
    pe.add_argument("forest", help="text forest path")
    pe.add_argument("artifact", help="output artifact path (.ogpcx)")
    pe.add_argument("--height", type=int, required=True)
    pe.add_argument("--width", type=int, required=True)
    pe.add_argument("--contract", choices=CONTRACTS, default="masked")
    pe.add_argument("--gradient-threshold", type=int, default=5)
    pe.add_argument("--disp-high", type=int, default=128)
    pe.add_argument("--vertical-tolerance", type=int, default=0)
    pe.add_argument("--global-mode", action="store_true")
    pe.add_argument("--capacity", type=int, default=65536,
                    help="flat-contract support capacity")
    pe.add_argument("--device", default="cuda",
                    help="the device the program runs on: cuda (the "
                    "hand-written kernels, default) or cpu (their plain "
                    "twins)")
    pe.add_argument("--platforms", default=None,
                    help="refused: a JAX lowering option (use --device)")
    pe.add_argument("--pallas", default=None,
                    help="refused: a JAX lowering option (use --device)")
    pe.add_argument("--shard-frame", type=int, default=0, metavar="N",
                    help="freeze the ROW-SHARDED matcher over N ranks of a "
                    "torchrun launch (one program a rank; one pair's rows "
                    "across the ranks, 14-row halo; masked/rows/"
                    "masked-compact/global-compact/pyramid).  With "
                    "--data-parallel/--batch, freezes the 2-D (data x "
                    "rows) batched variant instead")
    pe.add_argument("--data-parallel", type=int, default=0, metavar="D",
                    help="with --shard-frame: frame groups of the 2-D grid "
                    "(a launch of D*N ranks, and --batch)")
    pe.add_argument("--batch", type=int, default=0, metavar="B",
                    help="with --shard-frame: freeze a (B, H, W) stacked "
                    "input (required when --data-parallel > 1; B must "
                    "divide by D)")
    pe.add_argument("--levels", type=int, default=3, metavar="L",
                    help="pyramid levels for the pyramid contracts "
                    "(default 3)")
    pe.add_argument("--max-tests", type=int, default=None, metavar="T",
                    help="truncate the forest to its first T tests (file "
                    "order) before freezing")

    pr = sub.add_parser("run", help="serve one pair from an artifact")
    pr.add_argument("artifact")
    pr.add_argument("left")
    pr.add_argument("right")
    pr.add_argument("--supports-out", default=None,
                    help="write (x, y, d) supports here")
    pr.add_argument("--repeats", type=int, default=1,
                    help="re-run the call N times, report the best")
    return p


@report_input_errors
def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    return _export(args) if args.cmd == "export" else _run(args)


@contextlib.contextmanager
def _quiet(rank: int):
    """Rank 0 alone prints: the other ranks' stdout and stderr go
    nowhere."""
    if rank == 0:
        yield
        return
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null), \
            contextlib.redirect_stderr(null):
        yield


def _export(args) -> int:
    from opengpc_tpu_torch.forest import load_forest, truncate_forest

    for flag, value in (("--platforms", args.platforms),
                        ("--pallas", args.pallas)):
        if value is not None:
            print(_NO_LOWERING.format(flag=flag), file=sys.stderr)
            return 1
    forest = load_forest(args.forest)
    if args.max_tests is not None:
        if not 1 <= args.max_tests <= forest.num_tests:
            print(f"--max-tests must be in [1, {forest.num_tests}] for "
                  "this forest", file=sys.stderr)
            return 1
        forest = truncate_forest(forest, args.max_tests)
    settings = InferenceSettings(
        gradient_threshold=args.gradient_threshold,
        disp_high=args.disp_high,
        vertical_tolerance=args.vertical_tolerance,
        epipolar_mode=not args.global_mode,
        capacity=args.capacity,
    )
    shape = (args.height, args.width)
    sf, dp, batch = args.shard_frame, args.data_parallel, args.batch
    if sf > 1:
        return _export_sharded(args, forest, settings, shape)
    if dp > 1 or batch >= 1:
        # any explicit --batch (even 1) without --shard-frame errors, as
        # the JAX CLI does: the stacked artifact is the sharded one's
        print("--data-parallel/--batch exports need --shard-frame "
              "(batch-axis scale-out has no frozen artifact; the live "
              "parallel.build_batched_sparsematch_* builders cover it)",
              file=sys.stderr)
        return 1
    try:
        blob = export_sparsematch(forest, settings, shape,
                                  contract=args.contract, device=args.device,
                                  num_levels=args.levels)
    except ValueError as e:
        print(f"export failed: {e}", file=sys.stderr)
        return 1
    extra = ({"num_levels": args.levels}
             if args.contract.startswith("pyramid") else None)
    save_artifact(args.artifact, blob, contract=args.contract,
                  settings=settings, shape=shape, device=args.device,
                  extra=extra)
    print(f"wrote {args.artifact} ({len(blob)} byte program, contract "
          f"{args.contract}, shape {shape}, device {args.device})")
    return 0


def _export_sharded(args, forest, settings, shape) -> int:
    """--shard-frame N (> 1): every rank of a torchrun launch of N ranks
    (D * N with --data-parallel D) exports its program; rank 0 writes
    the artifact."""
    import torch.distributed as dist

    from opengpc_tpu_torch.aot import (export_batched_sharded_frame,
                                       export_sharded_frame)
    from opengpc_tpu_torch.parallel import make_mesh_2d

    sf, dp, batch = args.shard_frame, args.data_parallel, args.batch
    nd = max(dp, 1)
    stacked = dp > 1 or batch >= 1
    if stacked and (batch < 1 or batch % nd):
        print(f"--batch {batch} must be a positive multiple of "
              f"--data-parallel {nd}", file=sys.stderr)
        return 1
    if not in_launch():
        flags = (f"--shard-frame {sf}"
                 + (f" --data-parallel {dp}" if dp else ""))
        print(f"{flags}: one program a rank, so launch it as torchrun "
              f"--nproc-per-node {nd * sf} -m opengpc_tpu_torch.cli.aot "
              f"export ... {flags}", file=sys.stderr)
        return 1
    world = int(os.environ["WORLD_SIZE"])
    if world != nd * sf:
        print(f"--shard-frame {sf} x --data-parallel {nd}: {nd * sf} ranks, "
              f"but this launch has WORLD_SIZE={world}", file=sys.stderr)
        return 1
    rank, device = join_launch(args.device)
    try:
        with _quiet(rank):
            try:
                if stacked:
                    blob = export_batched_sharded_frame(
                        forest, settings, batch, shape, make_mesh_2d(nd, sf),
                        contract=args.contract, device=device,
                        num_levels=args.levels)
                    extra = {"mesh_shape": [nd, sf], "batch": batch,
                             "n_devices": nd * sf}
                else:
                    blob = export_sharded_frame(
                        forest, settings, shape, dist.group.WORLD,
                        contract=args.contract, device=device,
                        num_levels=args.levels)
                    extra = {"n_devices": sf}
            except ValueError as e:
                print(f"export failed: {e}", file=sys.stderr)
                return 1
            if args.contract == "pyramid":
                extra["num_levels"] = args.levels
            if rank == 0:
                save_artifact(args.artifact, blob, contract=args.contract,
                              settings=settings, shape=shape,
                              device=args.device, extra=extra)
                print(f"wrote {args.artifact} ({len(blob)} bytes, one "
                      f"program a rank of {nd * sf}, contract "
                      f"{args.contract}, shape {shape}, device "
                      f"{args.device})")
            return 0
    finally:
        dist.destroy_process_group()


def _run(args) -> int:
    # route on the header BEFORE loading: a stacked artifact, a sharded
    # one outside a launch of its size, or a CUDA one on a host without
    # CUDA gets the friendly message, not a traceback
    meta = peek_artifact_meta(args.artifact)
    if meta.get("package") != "opengpc_tpu_torch":
        print(f"{args.artifact} was written by the JAX package; serve it "
              "with python -m opengpc_tpu.cli.aot run", file=sys.stderr)
        return 1
    if meta.get("mesh_shape"):
        print("this artifact freezes a (B, H, W) STACKED input over a "
              f"{meta['mesh_shape']} (data, rows) grid — serve it with "
              "opengpc_tpu_torch.aot.load_artifact in Python under torchrun "
              "(see examples/serve_torch.py) rather than the single-pair run "
              "command", file=sys.stderr)
        return 1
    if meta.get("device") == "cuda" and not torch.cuda.is_available():
        print(f"{args.artifact} was exported for a CUDA device and this "
              "host has no CUDA; export one with --device cpu",
              file=sys.stderr)
        return 1
    n = meta.get("n_devices", 1)
    world = int(os.environ["WORLD_SIZE"]) if in_launch() else 1
    if n > 1 and world < n:
        print(f"this artifact row-shards one frame over {n} ranks; this "
              f"launch has {world} (torchrun --nproc-per-node {n} -m "
              "opengpc_tpu_torch.cli.aot run ...)", file=sys.stderr)
        return 1
    if n == 1 or not in_launch():
        return _serve(args, 0)
    import torch.distributed as dist

    rank, _ = join_launch(meta["device"])
    try:
        with _quiet(rank):
            return _serve(args, rank)
    finally:
        dist.destroy_process_group()


def _serve(args, rank: int) -> int:
    from opengpc_tpu_torch.io.png import read_gray
    from opengpc_tpu_torch.io.supports import write_supports

    left = read_gray(args.left)
    right = read_gray(args.right)
    call, meta = load_artifact(args.artifact)
    want = tuple(meta["shape"])
    if left.shape != want or right.shape != want:
        print(f"artifact is frozen for shape {want}; got "
              f"{left.shape} / {right.shape}", file=sys.stderr)
        return 1
    if call is None:  # a rank past the artifact's first N
        return 0
    try:
        t0 = time.perf_counter()
        supports = decode_outputs(meta, call(left, right))
        t_first = time.perf_counter() - t0
        best = t_first
        for _ in range(max(0, args.repeats - 1)):
            t0 = time.perf_counter()
            supports = decode_outputs(meta, call(left, right))
            best = min(best, time.perf_counter() - t0)
    except OverflowError as e:
        print(f"{e}", file=sys.stderr)
        return 1
    print(f"tTotal: {best * 1e3:.2f} ms (first call: {t_first * 1e3:.1f} "
          f"ms; incl. host decode), num matches: {len(supports)} "
          f"(contract {meta['contract']})")
    if args.supports_out and rank == 0:
        # pyramid contracts decode to (n, 4) [x, y, d, level]; the text
        # format is the 3-column 'x y d' one (level-0 units)
        write_supports(args.supports_out, supports[:, :3])
        print(f"wrote {args.supports_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
