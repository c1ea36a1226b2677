"""Sparse stereo matching CLI.

The port of ``opengpc_tpu.cli.sparsematch``, with the same arguments,
report lines and output files: load a text forest and a rectified stereo
pair, run the matcher on the card, print timing and counters, write
``disparity.png`` and (optionally) a ``supports.txt`` with one ``x y d``
line per support:

    python -m opengpc_tpu_torch.cli.sparsematch <forest> <left.png> <right.png>

Given two directories it matches every frame pair of a sequence and writes
``supports_NNNN.txt`` next to ``--out``.  Defaults mirror the reference
sample (sparsematch.cpp:29-34): gradient threshold 5, vertical tolerance
0, dispHigh 128, epipolar mode on.  ``--device cpu`` runs on the CPU
instead of the card.

``--shard-frame N`` (one pair's rows over N ranks) and ``--data-parallel
D`` (a sequence's dispatch groups over D ranks; with ``--shard-frame``, a
D x N grid) run one rank a device under ``torchrun``:

    torchrun --nproc-per-node N -m opengpc_tpu_torch.cli.sparsematch \
        <forest> <left.png> <right.png> --shard-frame N

D x N must equal the launch's WORLD_SIZE (an unset flag counts as 1), and
a one-rank launch with either flag at 1 takes the process-group path.  The
ranks join NCCL on ``cuda:LOCAL_RANK``, or gloo with ``--device cpu``.
Every rank reads the same frames; rank 0 alone probes, decides the
overflow hysteresis, runs the single-device dispatches, prints and writes
every file, so the files equal a one-device run's byte for byte.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from opengpc_tpu_torch.cli._errors import report_input_errors
from opengpc_tpu_torch.config import InferenceSettings
from opengpc_tpu_torch.forest import load_forest, make_filter_mask
from opengpc_tpu_torch.infer import (_global_rows_ok, _numpy, _rows_ok,
                                     build_sparsematch,
                                     build_sparsematch_global_compact,
                                     build_sparsematch_global_rows,
                                     build_sparsematch_masked,
                                     build_sparsematch_masked_compact,
                                     build_sparsematch_rows,
                                     global_row_supports_to_numpy,
                                     masked_supports_to_numpy,
                                     row_supports_to_numpy, supports_to_numpy)
from opengpc_tpu_torch.io.png import read_gray, write_png
from opengpc_tpu_torch.io.supports import write_supports
from opengpc_tpu_torch.parallel.groups import in_launch, join_launch
from opengpc_tpu_torch.viz import disparity_visualization


# auto-contract density cutoff, as a fraction of the chosen contract's
# chunk capacity ratio K/S (masked: 64/128 -> cutoff 0.30; wide-row global:
# 128/512 -> 0.15).  A misprediction is still exact either way: the
# overflow guard re-runs the dispatch full-width.
_AUTO_COMPACT_FRACTION = 0.6


def _auto_compact_threshold(masked: bool, width: int) -> float:
    """Density at or below which auto mode rides the chunk-compacted
    contract for this frame width (see _AUTO_COMPACT_FRACTION)."""
    from opengpc_tpu_torch.match import (MASKED_COMPACT_CHUNKS,
                                         global_compact_chunks)

    chunk, k = (MASKED_COMPACT_CHUNKS if masked
                else global_compact_chunks(2 * width))
    return _AUTO_COMPACT_FRACTION * (k / chunk)


def _upload(img, device):
    """A host frame (or stack of frames) as a uint8 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(img)).to(device)


def _sync(device) -> None:
    """Wait for the card's queued work, so a clock read after it times the
    device pipeline."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _probe_density(settings, left, right, device) -> float:
    """Candidate density of one pair under ``gradient_threshold``: the
    larger of the two images' candidate shares, counted on ``device``
    (``ops.preprocess.sobel3`` and ``candidate_mask``).  The share is
    float32(count) * float32(1 / (H * W)): the JAX package's float32 mean,
    whose division by the constant pixel count XLA turns into that
    product, so the value and the route are the same bits.  Drives the
    density-adaptive auto contract."""
    from opengpc_tpu_torch.ops.preprocess import candidate_mask, sobel3

    gt = settings.gradient_threshold
    counts = torch.stack([
        candidate_mask(sobel3(_upload(img, device), gt)).sum()
        for img in (left, right)]).cpu().numpy()
    inv = np.float32(1) / np.float32(left.shape[-2] * left.shape[-1])
    return float(max(np.float32(c) * inv for c in counts))


def _flag(t) -> bool:
    """True where an overflow flag (a scalar, or one a pair) is set."""
    return bool(torch.as_tensor(t).any())


class _Launch:
    """This process's place in a ``torchrun`` launch: its rank, the world
    group and the device it matches on (``cuda:LOCAL_RANK``, or the CPU
    over gloo)."""

    def __init__(self, args):
        self.rank, self.device = join_launch(args.device)
        self.group = dist.group.WORLD

    @property
    def lead(self) -> bool:
        return self.rank == 0


def _launch(args):
    """(launch, error): this process's :class:`_Launch` under a torchrun
    environment with --data-parallel or --shard-frame set, else None; the
    error when D x N is not the launch's WORLD_SIZE."""
    if not in_launch():
        return None, None
    world = int(os.environ["WORLD_SIZE"])
    d, n = max(args.data_parallel, 1), max(args.shard_frame, 1)
    if d * n != world:
        return None, (f"--data-parallel {d} x --shard-frame {n} is {d * n} "
                      f"ranks, but this launch has WORLD_SIZE={world}")
    if not (args.data_parallel or args.shard_frame):
        return None, None
    return _Launch(args), None


def _no_launch(args) -> str:
    """The refusal of --data-parallel / --shard-frame above 1 outside a
    torchrun launch, naming the launch that runs it."""
    flags = " ".join(f"{name} {n}" for name, n in (
        ("--data-parallel", args.data_parallel),
        ("--shard-frame", args.shard_frame)) if n)
    ranks = max(args.data_parallel, 1) * max(args.shard_frame, 1)
    return (f"{flags}: one rank a device, so launch it as torchrun "
            f"--nproc-per-node {ranks} -m opengpc_tpu_torch.cli.sparsematch "
            f"... {flags}")


def _agreed(launch, decide) -> float:
    """``decide()`` as rank 0 computes it, on every rank: one broadcast.
    Every branch that decides whether a collective runs takes it from
    here, so the ranks never part ways."""
    if launch is None:
        return float(decide())
    t = torch.tensor([float(decide()) if launch.lead else 0.0],
                     dtype=torch.float64, device=launch.device)
    dist.broadcast(t, 0, group=launch.group)
    return float(t[0])


class _OverflowGuard:
    """Exactness guard shared by every chunk-compacted call site: the
    compacted matchers return ``(*outputs, overflow)``, and a True flag
    (any chunk held more candidates than its capacity: a dense frame)
    means the compacted outputs must be discarded and the dispatch re-run
    through the full-width builder.  The fallback builder is made lazily
    (only on a misprediction) and kept for the run."""

    def __init__(self, make_fallback, notice: str):
        self._make = make_fallback
        self._fb = None
        self.notice = notice

    def fallback(self):
        if self._fb is None:
            self._fb = self._make()
        return self._fb

    def wrap(self, fast_match):
        """``(l, r) -> outputs`` that transparently re-runs overflows."""

        def match(l, r):
            out = fast_match(l, r)
            if _flag(out[-1]):
                print(self.notice, file=sys.stderr)
                return self.fallback()(l, r)
            return out[:-1]

        return match


# a compacted mode's full-width fallback: the mode of its outputs, and what
# the overflow notice names
_FALLBACK = {"masked-compact": ("masked", "full-width masked matcher"),
             "global-compact": ("global_rows", "full-width global matcher"),
             "pyramid-compact": ("pyramid", "rows pyramid")}


def _global_ok(fmask, shape, settings) -> bool:
    """Whether frames of ``shape`` ride the segmented global contracts."""
    return (not settings.epipolar_mode
            and _global_rows_ok(fmask, shape, settings))


def _select_matcher(contract, forest, fmask, settings, levels, shape,
                    density, dev, sequence=False, parallel=False):
    """The matcher of ``contract`` for frames of ``shape``: ``(match, mode,
    guard)``.  ``mode`` names the layout of the outputs (``_supports``).  A
    compacted mode's ``match`` returns ``(*outputs, overflow)`` and
    ``guard``, an :class:`_OverflowGuard`, makes its full-width fallback;
    ``guard`` is None otherwise.  ``"auto"`` rides the fast contracts where
    the frames are eligible, and the compacted ones where ``density()``
    (called at most once) is at or under ``_auto_compact_threshold``.  The
    caller refuses an explicit contract the frames are not eligible for;
    ``sequence`` picks the sequence mode's overflow notices.  ``parallel``
    (a sequence over ranks) keeps the pyramid on the rows pyramid, the one
    the multi-device pyramid builders run."""
    def guard(name, mode, make):
        dense = "" if sequence else "dense frame, "
        return _OverflowGuard(make, f"{name} overflow: {dense}re-ran the "
                              f"{_FALLBACK[mode][1]}")

    def auto_notice(what, dens):
        print(f"auto contract: candidate density {dens:.2f} — riding the "
              f"chunk-compacted {what} (overflow-guarded)", file=sys.stderr)

    if levels > 1:
        from opengpc_tpu_torch.pyramid import (
            _rows_eligible, build_pyramid_sparsematch,
            build_pyramid_sparsematch_compact)

        def rows_pyramid():
            return build_pyramid_sparsematch(forest, settings, levels,
                                             device=dev)

        name = "masked-compact" if contract == "masked-compact" else None
        if contract == "auto" and settings.epipolar_mode \
                and settings.disp_high >= 1 and not parallel \
                and _rows_eligible(fmask, settings, shape[0], shape[1],
                                   levels):
            # density-adaptive: sparse frames ride the chunk-compacted
            # pyramid, dense mispredictions re-run on the rows pyramid
            dens = density()
            if dens <= _auto_compact_threshold(True, shape[1]):
                name = "pyramid-compact"
                auto_notice("pyramid", dens)
        if name is None:
            return rows_pyramid(), "pyramid", None
        return (build_pyramid_sparsematch_compact(forest, settings, levels,
                                                  device=dev),
                "pyramid-compact",
                guard(name, "pyramid-compact", rows_pyramid))
    eligible = _rows_ok(fmask, shape, settings)
    geligible = _global_ok(fmask, shape, settings)
    if contract == "auto" and (eligible or geligible):
        # sparse frames ride the chunk-compacted contracts; the overflow
        # guard re-runs a dense misprediction full-width, exact either way
        dens = density()
        if dens <= _auto_compact_threshold(eligible, shape[1]):
            contract = "masked-compact" if eligible else "global-compact"
            auto_notice(f"{'masked' if eligible else 'global'} contract",
                        dens)
    if eligible and contract == "masked-compact":
        return (build_sparsematch_masked_compact(fmask, settings, device=dev),
                contract, guard(contract, contract,
                                lambda: build_sparsematch_masked(
                                    fmask, settings, device=dev)))
    if eligible and contract == "masked":
        return build_sparsematch_masked(fmask, settings, device=dev), \
            "masked", None
    if eligible and contract in ("auto", "rows"):
        return build_sparsematch_rows(fmask, settings, device=dev), \
            "rows", None
    if geligible and contract == "global-compact":
        return (build_sparsematch_global_compact(fmask, settings, device=dev),
                contract, guard(contract, contract,
                                lambda: build_sparsematch_global_rows(
                                    fmask, settings, device=dev)))
    if geligible and contract in ("auto", "global-rows"):
        return build_sparsematch_global_rows(fmask, settings, device=dev), \
            "global_rows", None
    return build_sparsematch(fmask, settings, device=dev), "flat", None


def _supports(mode, out, disp_high: int, j=None) -> np.ndarray:
    """One frame's (n, 3) int32 supports from the host copies ``out`` of a
    matcher's outputs in ``mode``: frame ``j`` of a stacked dispatch, or
    the one frame where ``j`` is None."""
    def pick(a):
        return a if j is None else a[j]

    if mode == "masked":
        return masked_supports_to_numpy(pick(out[0]), pick(out[1]),
                                        disp_high)
    if mode == "rows":
        (xs, ds), counts = out
        return row_supports_to_numpy(pick(xs), pick(ds), pick(counts))
    if mode == "global_rows":
        (xs, ys, ds), counts = out
        return global_row_supports_to_numpy(pick(xs), pick(ys), pick(ds),
                                            pick(counts))
    if mode == "pyramid":
        from opengpc_tpu_torch.pyramid import pyramid_supports_to_numpy

        # 3-column x/y/d in level-0 units, like the other contracts
        return pyramid_supports_to_numpy(*(pick(a) for a in out))[:, :3]
    return supports_to_numpy(*out)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="opengpc-sparsematch", description=__doc__.splitlines()[0]
    )
    from opengpc_tpu_torch import __version__
    p.add_argument("--version", action="version",
                   version=f"%(prog)s {__version__}")
    p.add_argument("forest", help="text forest file")
    p.add_argument("left", help="left (source) image PNG")
    p.add_argument("right", help="right (target) image PNG")
    p.add_argument("--gradient-threshold", type=int, default=5)
    p.add_argument("--vertical-tolerance", type=int, default=0)
    p.add_argument("--disp-high", type=int, default=128)
    p.add_argument(
        "--global-mode",
        action="store_true",
        help="match codes globally instead of per-epipolar-line",
    )
    p.add_argument("--capacity", type=int, default=65536,
                   help="fixed support-buffer capacity")
    p.add_argument("--out", default="disparity.png", help="visualization PNG")
    p.add_argument("--supports-out", default=None,
                   help="optional text output, one 'x y d' line per support")
    p.add_argument("--repeats", type=int, default=1,
                   help="re-run the matcher N times and report the best")
    p.add_argument("--batch", type=int, default=None, metavar="B",
                   help="sequence mode: stack B same-shape frame pairs per "
                   "dispatch (folded into one (B*H, 2W) row sort where the "
                   "contract folds); identical per-frame outputs.  Default "
                   "4 on the fast contracts (1 disables)")
    p.add_argument("--data-parallel", type=int, default=0, metavar="N",
                   help="sequence mode: split each --batch dispatch "
                   "group's frames over N ranks of a torchrun launch "
                   "(parallel.build_batched_sparsematch_* builders; any "
                   "contract but flat).  --batch must divide by N (the "
                   "default batch rounds itself up); partial groups and "
                   "mid-sequence shape changes dispatch singly on rank 0")
    p.add_argument("--trace", default=None, metavar="LOGDIR",
                   help="capture a torch.profiler trace (LOGDIR/trace.json) "
                   "of the repeated runs")
    p.add_argument("--pyramid", type=int, default=1, metavar="LEVELS",
                   help="multi-scale matching over LEVELS pyramid levels. "
                   "Sequence mode rides the batched rows pyramid "
                   "(--contract auto, epipolar); single-pair mode also "
                   "composes with --contract masked-compact")
    p.add_argument("--densify", default=None, metavar="PNG",
                   help="also write a diffusion-densified disparity PNG "
                   "(sequence mode: a directory of dense_NNNN.png)")
    p.add_argument(
        "--viz-compat", choices=("canonical", "reference"),
        default="canonical",
        help="disparity.png colormap: canonical KITTI table (default) or "
        "the reference binary's rotated-by-one table + hardcoded [0,128] "
        "range (byte-identical to its output; buffer.hpp:960-963)",
    )
    p.add_argument(
        "--contract",
        choices=("auto", "flat", "rows", "masked", "masked-compact",
                 "global-rows", "global-compact"),
        default="auto",
        help="output contract for the on-device matcher: auto (default; "
        "row-form / segmented-global when eligible, and a candidate-"
        "density probe rides the chunk-compacted contracts on sparse "
        "frames), flat fixed-capacity buffers, row-form per-row packed "
        "buffers, the masked sorted-order buffer (decode moves to the "
        "host), masked-compact (chunk-compacted masked), global-rows "
        "(explicit full-width segmented global; needs --global-mode), or "
        "global-compact (chunk-compacted global mode; needs "
        "--global-mode).  The compacted contracts re-run full-width "
        "automatically when the overflow guard trips.  Identical support "
        "sets; rows/masked/masked-compact are epipolar-only; sequence "
        "mode supports everything but flat; --pyramid supports "
        "auto/masked-compact",
    )
    p.add_argument(
        "--shard-frame", type=int, default=0, metavar="N",
        help="shard each pair's ROWS over N ranks of a torchrun launch "
        "(epipolar only, image height must divide by N and give each "
        "shard >= 14 rows).  Single-pair mode: "
        "parallel.build_sharded_frame_sparsematch; with --pyramid L the "
        "sharded multi-scale matcher (height must divide by N*2^(L-1)).  "
        "Sequence mode: composes with --data-parallel over a D x N grid "
        "(build_batched_sharded_frame_sparsematch; masked/rows/"
        "masked-compact contracts).  0 (default) = off",
    )
    p.add_argument(
        "--matcher", choices=("sort", "quirk", "hashmatch"), default="sort",
        help="sort: on-device clean unique-collision matcher (default); "
        "quirk: host-side bit-exact reference sweep incl. its edge quirks "
        "(useHashtable=false); hashmatch: host-side bit-exact reference "
        "hash-table matcher (useHashtable=true)",
    )
    p.add_argument(
        "--max-tests", type=int, default=None, metavar="N",
        help="truncate the forest to its first N tests in file order (the "
        "reference's own filter-mask cap rule applied at N instead of 32). "
        "N + bit_length(2W-1) <= 30 (17 at W=1024) rides the "
        "single-operand packed row sort, for fewer supports",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device to match on (default: cuda)")
    return p


@report_input_errors
def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    launch, err = _launch(args)
    if err:
        print(err, file=sys.stderr)
        return 1
    try:
        with _quiet(launch):
            return _main(args, launch)
    finally:
        if launch is not None:
            dist.destroy_process_group()


@contextlib.contextmanager
def _quiet(launch):
    """Rank 0 alone prints: the other ranks' stdout and stderr go
    nowhere."""
    if launch is None or launch.lead:
        yield
        return
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null), \
            contextlib.redirect_stderr(null):
        yield


def _main(args, launch) -> int:
    dev = launch.device if launch is not None else torch.device(args.device)

    # single-pair host latency: for large frames both decodes start on a
    # 2-thread pool right away and the forest parse overlaps them; at
    # Sintel size the pool costs more than it saves.  Joined where the
    # serial reads would happen, so errors surface the same way.
    rd_futs = None
    if (not os.path.isdir(args.left) and os.path.isfile(args.left)
            and os.path.isfile(args.right)
            and min(os.path.getsize(args.left),
                    os.path.getsize(args.right)) > (512 << 10)):
        from concurrent.futures import ThreadPoolExecutor

        _rdpool = ThreadPoolExecutor(max_workers=2)
        rd_futs = (_rdpool.submit(read_gray, args.left),
                   _rdpool.submit(read_gray, args.right))
        _rdpool.shutdown(wait=False)

    forest = load_forest(args.forest)
    if args.max_tests is not None:
        from opengpc_tpu_torch.forest import truncate_forest

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
    # the native PNG writer does not create directories; make every output
    # parent up front so a missing dir fails here, not mid-run
    for out in (args.out, args.densify, args.supports_out):
        if out:
            os.makedirs(os.path.dirname(os.path.abspath(out)) or ".",
                        exist_ok=True)

    if os.path.isdir(args.left):
        if args.contract == "flat":
            print("--contract flat is not supported in sequence "
                  "(directory) mode — auto falls back to the flat "
                  "pipeline per frame only when no fast contract is "
                  "eligible", file=sys.stderr)
            return 1
        # explicitly requested single-pair-only features error out instead
        # of being silently ignored
        if args.pyramid > 1 and (args.contract != "auto"
                                 or args.global_mode):
            print("sequence --pyramid rides the batched rows pyramid "
                  "(--contract auto, epipolar mode only; the compact "
                  "pyramid engages via the auto density probe)",
                  file=sys.stderr)
            return 1
        unsupported = [name for name, on in (
            (f"--matcher {args.matcher}", args.matcher != "sort"),
            ("--repeats", args.repeats > 1),
            ("--trace", bool(args.trace)),
        ) if on]
        if unsupported:
            print("sequence (directory) mode does not support: "
                  f"{', '.join(unsupported)}", file=sys.stderr)
            return 1
        if args.supports_out:
            print("sequence mode writes per-frame supports_NNNN.txt next "
                  "to --out; --supports-out is ignored", file=sys.stderr)
        return _run_sequence(args, forest, settings, dev, launch)
    if args.batch is not None and args.batch > 1:
        print("--batch applies to sequence (directory) mode only",
              file=sys.stderr)
        return 1
    if args.data_parallel > 1:
        print("--data-parallel applies to sequence (directory) mode only "
              "(single-pair multi-chip is --shard-frame)", file=sys.stderr)
        return 1
    if rd_futs is not None:
        left = rd_futs[0].result()
        right = rd_futs[1].result()
    else:
        left = read_gray(args.left)
        right = read_gray(args.right)
    if left.shape != right.shape:
        print(f"image shapes differ: {left.shape} vs {right.shape}", file=sys.stderr)
        return 1

    if args.contract != "auto" and args.matcher != "sort":
        print("--contract applies to the on-device matcher only "
              "(not host --matcher modes)", file=sys.stderr)
        return 1
    if args.pyramid > 1 and args.contract not in ("auto", "masked-compact"):
        # masked-compact lifts to the pyramid (chunk-compacted per-level
        # matchers + rows-pyramid overflow fallback); the other contracts
        # describe single-scale output layouts
        print("--pyramid supports --contract auto (rows when eligible) or "
              "masked-compact only", file=sys.stderr)
        return 1
    if args.matcher != "sort":
        dropped = [
            name for name, on in (
                ("--pyramid", args.pyramid > 1),
                ("--densify", bool(args.densify)),
                ("--trace", bool(args.trace)),
                ("--repeats", args.repeats > 1),
            ) if on
        ]
        if dropped:
            print(
                f"--matcher {args.matcher} (host-side reference matcher) "
                f"does not support: {', '.join(dropped)}",
                file=sys.stderr,
            )
            return 1
        return _run_host_matcher(args, forest, settings, left, right, dev)

    tl, tr = _upload(left, dev), _upload(right, dev)
    fmask = make_filter_mask(forest)
    if args.shard_frame > 1 or (launch is not None and args.shard_frame):
        picked = _sharded_single(args, fmask, settings, left.shape, launch,
                                 dev)
        if isinstance(picked, int):
            return picked
        match, mode = picked
    # fast output contracts when available (<=30-test forests, packable
    # keys): epipolar rides the masked/row-form matchers, global mode the
    # segmented global contract; --contract forces one (--pyramid: auto or
    # masked-compact)
    elif args.contract in ("rows", "masked", "masked-compact") \
            and not _rows_ok(fmask, left.shape, settings):
        print(f"--contract {args.contract} needs epipolar mode, a "
              "<=30-test forest and packable (x, d) keys for this "
              "image size", file=sys.stderr)
        return 1
    elif args.contract in ("global-rows", "global-compact") \
            and not _global_ok(fmask, left.shape, settings):
        print(f"--contract {args.contract} needs --global-mode, a "
              "<=30-test forest and packable (y, x, d) keys for this "
              "image size", file=sys.stderr)
        return 1
    else:
        match, mode, guard = _select_matcher(
            args.contract, forest, fmask, settings, args.pyramid, left.shape,
            lambda: _probe_density(settings, left, right, dev), dev)
        if guard is not None:
            # a dense frame re-runs full-width inside the call, exact
            # either way
            match, mode = guard.wrap(match), _FALLBACK[mode][0]

    def run():
        out = match(tl, tr)
        _sync(dev)
        return out

    _sync(dev)
    t0 = time.perf_counter()
    result = run()
    t_first = time.perf_counter() - t0

    from opengpc_tpu_torch.utils.timing import PhaseTimer, trace

    best = t_first
    lead = launch is None or launch.lead
    with trace(args.trace if lead else None):
        for _ in range(max(0, args.repeats - 1)):
            t0 = time.perf_counter()
            result = run()
            best = min(best, time.perf_counter() - t0)
    if not lead:
        return 0  # rank 0 alone reports and writes

    pt = PhaseTimer()
    pt.totals["match"] = best  # device pipeline (preprocess+match)
    with pt.phase("assemble"):
        supports = _supports(mode, _numpy(result), settings.disp_high)
        count = supports.shape[0]
        if mode == "flat":
            xs, count = result[0], int(result[3])
            if count > xs.shape[0]:
                print(
                    f"WARNING: support buffer overflow — {count} matches, "
                    f"capacity {xs.shape[0]}; {count - xs.shape[0]} dropped. "
                    f"Re-run with --capacity {1 << (count - 1).bit_length()}",
                    file=sys.stderr,
                )
        elif mode != "pyramid":
            # honor --capacity like the flat contract (first `capacity`
            # supports in output order), with the same overflow warning
            supports = _trim(supports, args.capacity)
    h, w = left.shape
    mpix_s = (2 * h * w / 1e6) / best if best > 0 else float("inf")
    print(
        f"tTotal: {best * 1e3:.2f} ms (first call incl. compile: "
        f"{t_first * 1e3:.1f} ms), num matches: {len(supports)}"
        f" (count={int(count)}), throughput: {mpix_s:.1f} Mpix/s"
    )

    with pt.phase("visualize"):
        write_png(args.out, _viz(left, supports, args))
    # per-phase report, the analog of the reference's tPreprocess/tMatch
    # lines (samples/sparsematch.cpp:53-57): preprocess and match are one
    # device pipeline, so the split here is device/host instead
    print(pt.report())
    print(f"wrote {args.out}")
    if args.densify:
        from opengpc_tpu_torch.densify import (densify_from_masked,
                                               densify_supports)
        from opengpc_tpu_torch.viz import dense_disparity_visualization

        if mode == "masked" and count <= args.capacity:
            # masked contract: densify on the device from the packed
            # buffer (no decode and re-upload; bit-identical to the host
            # path).  A capacity-trimmed support list takes the supports
            # path, so --capacity means the same on every contract
            dense_d, filled_d = densify_from_masked(
                *result, settings.disp_high, width=w, device=dev)
            dense, filled = dense_d.cpu().numpy(), filled_d.cpu().numpy()
        else:
            dense, filled = densify_supports(supports, left.shape,
                                             device=dev)
        write_png(args.densify,
                  dense_disparity_visualization(left, dense, filled,
                                                max_disparity=args.disp_high))
        print(f"wrote {args.densify}")
    if args.supports_out:
        write_supports(args.supports_out, supports)
        print(f"wrote {args.supports_out}")
    return 0


def _sharded_single(args, fmask, settings, shape, launch, dev):
    """Single-pair ``--shard-frame``: ``(match, mode)`` of the pair's rows
    over the launch's ranks, or the exit code of a refusal (the JAX CLI's
    checks and wording).  ``match`` takes the whole pair on every rank and
    returns the whole result on every rank."""
    from opengpc_tpu_torch import parallel as par
    from opengpc_tpu_torch.ops.fused import PAD

    n = args.shard_frame
    gmode = args.global_mode
    ok_contracts = (("auto", "global-compact") if gmode
                    else ("auto", "rows", "masked", "masked-compact"))
    bad = [name for name, on in (
        ("--pyramid (with --global-mode)", args.pyramid > 1 and gmode),
        ("--pyramid (with an explicit --contract)",
         args.pyramid > 1 and args.contract != "auto"),
        (f"--matcher {args.matcher}", args.matcher != "sort"),
        (f"--contract {args.contract} (with "
         + ("--global-mode" if gmode else "epipolar mode") + ")",
         args.contract not in ok_contracts),
    ) if on]
    if bad:
        print(f"--shard-frame does not support: {', '.join(bad)}",
              file=sys.stderr)
        return 1
    if launch is None:
        print(_no_launch(args), file=sys.stderr)
        return 1
    eligible = (_global_rows_ok if gmode else _rows_ok)(fmask, shape,
                                                        settings)
    if not eligible or shape[0] % n or shape[0] // n < PAD:
        print(f"--shard-frame {n} needs a <=30-test forest, packable "
              f"{'(y, x, d)' if gmode else '(x, d)'} keys, and an "
              f"image height divisible by {n} with >= {PAD} rows per "
              f"shard (got {shape})", file=sys.stderr)
        return 1
    group = launch.group
    if args.pyramid > 1:
        from opengpc_tpu_torch.pyramid import _rows_eligible

        align = n << (args.pyramid - 1)
        if shape[0] % align or (shape[0] // n) >> (args.pyramid - 1) < PAD:
            print(f"--shard-frame {n} --pyramid {args.pyramid} needs "
                  f"an image height divisible by {align} with the "
                  f"coarsest slab >= {PAD} rows (got {shape}); "
                  "pad the pair or reduce levels", file=sys.stderr)
            return 1
        if _rows_eligible(fmask, settings, shape[0], shape[1],
                          args.pyramid) is None:
            print(f"--shard-frame {n} --pyramid {args.pyramid}: the "
                  f"finest-wins dedup key for {shape[0]}x{shape[1]} x "
                  f"{args.pyramid} levels exceeds int32 packing; reduce "
                  "levels or the image size", file=sys.stderr)
            return 1
        return par.build_sharded_frame_pyramid(
            fmask, settings, group, args.pyramid,
            device=dev).run_whole, "pyramid"
    if gmode:
        # the distributed bucket sort; a dense frame trips the flag and
        # re-runs on one device at full width
        smatch = par.build_sharded_frame_sparsematch(
            fmask, settings, group, "global-compact", device=dev)
        return _OverflowGuard(
            lambda: build_sparsematch_global_rows(fmask, settings,
                                                  device=dev),
            "global-compact overflow: dense frame, re-ran the "
            "single-device full-width global matcher").wrap(
            smatch.run_whole), "global_rows"
    contract = (args.contract if args.contract in ("rows", "masked-compact")
                else "masked")
    smatch = par.build_sharded_frame_sparsematch(fmask, settings, group,
                                                 contract, device=dev)
    if contract != "masked-compact":
        return smatch.run_whole, contract
    # any shard's dense chunk sets the flag on every rank
    return _OverflowGuard(
        lambda: par.build_sharded_frame_sparsematch(
            fmask, settings, group, "masked", device=dev).run_whole,
        "masked-compact overflow: dense frame, re-ran the sharded "
        "full-width masked matcher").wrap(smatch.run_whole), "masked"


def _trim(supports, capacity: int):
    """The first ``capacity`` supports in output order, with the flat
    contract's overflow warning when some are dropped."""
    count = supports.shape[0]
    if count > capacity:
        print(
            f"WARNING: {count} matches exceed --capacity "
            f"{capacity}; {count - capacity} dropped",
            file=sys.stderr,
        )
        return supports[:capacity]
    return supports


def _viz(left, supports, args):
    """disparity.png pixels per --viz-compat: canonical KITTI colors scaled
    to --disp-high, or the reference binary's exact bytes (rotated table,
    hardcoded [0, 128] range; buffer.hpp:949-1014)."""
    if args.viz_compat == "reference":
        return disparity_visualization(left, supports, 0.0, 128.0,
                                       compat="reference")
    return disparity_visualization(left, supports,
                                   max_disparity=args.disp_high)


def _run_host_matcher(args, forest, settings, left, right, dev) -> int:
    """Bit-exact reference matcher modes: descriptors are extracted on
    ``dev`` (one code-kernel launch an image on the card), matched on the
    host with the reference's exact sweep (``--matcher quirk``;
    inference.hpp:227-254) or its hash-table matcher (``--matcher
    hashmatch``; hashmatch.hpp:42-273), then filtered like rectifiedMatch
    (inference.hpp:384-391)."""
    from opengpc_tpu_torch.infer import extract_descriptors
    from opengpc_tpu_torch.match import match_hashmatch, match_reference_quirk

    t0 = time.perf_counter()
    desc_l = extract_descriptors(left, forest, settings, device=dev)
    desc_r = extract_descriptors(right, forest, settings, device=dev)
    matcher = (
        match_reference_quirk if args.matcher == "quirk" else match_hashmatch
    )
    pairs = matcher(desc_l, desc_r, epipolar=settings.epipolar_mode)
    dt = time.perf_counter() - t0
    if len(pairs):
        d = pairs[:, 0] - pairs[:, 2]
        keep = (np.abs(pairs[:, 1] - pairs[:, 3]) <= settings.vertical_tolerance) & (
            np.abs(d) <= settings.disp_high
        )
        supports = np.stack(
            [pairs[keep, 0], pairs[keep, 1], d[keep]], axis=1
        ).astype(np.int32)
    else:
        supports = np.zeros((0, 3), np.int32)
    print(
        f"tTotal: {dt * 1e3:.2f} ms (host-side {args.matcher} matcher, "
        f"incl. compile), num matches: {len(supports)}"
    )
    write_png(args.out, _viz(left, supports, args))
    print(f"wrote {args.out}")
    if args.supports_out:
        write_supports(args.supports_out, supports)
        print(f"wrote {args.supports_out}")
    return 0


def _parallel_sequence(args, fmask, settings, shape, mode, fast, batch,
                       launch, dev):
    """Sequence ``--data-parallel`` / ``--shard-frame``:
    ``(match_batched, batch, sf_single)``, the stacked dispatch over the
    launch's ranks (a D x N grid with --shard-frame), or the exit code of a
    refusal (the JAX CLI's checks and wording)."""
    from opengpc_tpu_torch import parallel as par

    if not fast:
        print("--data-parallel/--shard-frame need a fast stacked "
              "contract (rows/masked/masked-compact/global) — this "
              "forest/shape only supports the flat pipeline",
              file=sys.stderr)
        return 1
    dp, sf = args.data_parallel, args.shard_frame
    sharded = sf > 1 or (launch is not None and sf >= 1)
    if sharded:
        # frames over a "data" axis and each frame's rows over a "rows"
        # axis: the 2-D grid builders
        if mode not in ("masked", "rows", "masked-compact", "pyramid"):
            print(f"--shard-frame with the {mode} contract is not "
                  "supported in sequence mode (the global distributed "
                  "bucket sort is single-pair only — use the "
                  "single-pair CLI for one big global frame, or "
                  "--data-parallel to scale global sequences over "
                  "the batch axis)", file=sys.stderr)
            return 1
        if launch is None:
            print(_no_launch(args), file=sys.stderr)
            return 1
        lv = args.pyramid - 1 if mode == "pyramid" else 0
        if shape[0] % (sf << lv) or (shape[0] // sf) >> lv < 14:
            print(f"--shard-frame {sf}: frame height {shape[0]} "
                  f"must divide by {sf << lv} with >= 14 rows per "
                  "shard at the coarsest level", file=sys.stderr)
            return 1
        if mode == "pyramid":
            from opengpc_tpu_torch.pyramid import _rows_eligible

            if _rows_eligible(fmask, settings, shape[0], shape[1],
                              args.pyramid) is None:
                print(f"--shard-frame {sf} --pyramid {args.pyramid}: "
                      f"the finest-wins dedup key for {shape[0]}x"
                      f"{shape[1]} x {args.pyramid} levels exceeds int32 "
                      "packing; reduce levels or the frame size",
                      file=sys.stderr)
                return 1
    elif launch is None:
        print(_no_launch(args), file=sys.stderr)
        return 1
    if dp > 1:
        if args.batch is not None and batch % dp:
            print(f"--batch {batch} must divide by --data-parallel "
                  f"{dp} (shard_map splits the stacked batch axis "
                  "evenly)", file=sys.stderr)
            return 1
        batch = -(-batch // dp) * dp  # round the default batch up
    if sharded:
        grid = par.make_mesh_2d(max(dp, 1), sf)
        if mode == "pyramid":
            mod = par.build_batched_sharded_frame_pyramid(
                fmask, settings, grid, args.pyramid, device=dev)
        else:
            mod = par.build_batched_sharded_frame_sparsematch(
                fmask, settings, grid, mode, device=dev)
        return mod.run_whole, batch, dp <= 1
    if mode == "pyramid":
        mod = par.build_batched_pyramid(fmask, settings, launch.group,
                                        args.pyramid, device=dev)
    else:
        mod = {"rows": par.build_batched_sparsematch_rows,
               "masked": par.build_batched_sparsematch_masked,
               "masked-compact": par.build_batched_sparsematch_masked_compact,
               "global_rows": par.build_batched_sparsematch_global_rows,
               "global-compact": par.build_batched_sparsematch_global_compact,
               }[mode](fmask, settings, launch.group, device=dev)
    return mod.run_whole, batch, False


def _run_sequence(args, forest, settings, dev, launch) -> int:
    """Directory mode: match every left/right frame pair of a rectified
    stereo sequence on ``dev``, write per-frame supports next to ``--out``,
    report aggregate throughput.  Under a ``launch`` the full dispatch
    groups run over its ranks; rank 0 alone decides, runs the single
    dispatches and writes."""
    import glob

    lefts = sorted(glob.glob(os.path.join(args.left, "*.png")))
    rights = sorted(glob.glob(os.path.join(args.right, "*.png")))
    if len(lefts) != len(rights) or not lefts:
        print(f"sequence mismatch: {len(lefts)} left vs {len(rights)} right",
              file=sys.stderr)
        return 1
    probe = read_gray(lefts[0])
    fmask = make_filter_mask(forest)
    if args.contract in ("rows", "masked", "masked-compact") \
            and not _rows_ok(fmask, probe.shape, settings):
        # honor an explicit contract choice instead of silently riding the
        # flat fallback (auto mode still falls back per frame)
        print(f"--contract {args.contract} needs epipolar mode, a <=30-test "
              f"forest and packable (x, d) keys for frame shape "
              f"{probe.shape}", file=sys.stderr)
        return 1
    if args.contract in ("global-rows", "global-compact") \
            and not _global_ok(fmask, probe.shape, settings):
        print(f"--contract {args.contract} needs --global-mode, a <=30-test "
              "forest and packable (y, x, d) keys for frame shape "
              f"{probe.shape}", file=sys.stderr)
        return 1
    first = []  # pair 0, where the density probe decoded it

    def density():
        # density-adaptive auto: probe frame 0's candidate density and ride
        # the chunk-compacted contracts on sparse sequences
        first.append((probe, read_gray(rights[0])))
        return _agreed(launch, lambda: _probe_density(settings, *first[0],
                                                      dev))

    # --pyramid: every full dispatch group rides the batched rows pyramid
    # fold; ineligible shapes fall back inside the builder to the flat
    # per-level path, so any frame shape works
    match, mode, guard = _select_matcher(
        args.contract, forest, fmask, settings, args.pyramid, probe.shape,
        density, dev, sequence=True,
        parallel=(launch is not None or args.data_parallel > 1
                  or args.shard_frame > 1))
    pyramid_mode = mode in ("pyramid", "pyramid-compact")
    # the rows pyramid takes frames of another shape than frame 0's
    rows_pyr = (guard.fallback() if guard else match) if pyramid_mode \
        else None
    out_dir = os.path.dirname(os.path.abspath(args.out)) or "."
    os.makedirs(out_dir, exist_ok=True)
    total_px = 0
    total_matches = 0
    fast = mode != "flat"
    # sequence --densify: per-frame dense_{NNNN}.png into this directory
    # (single-pair mode's PNG path becomes a directory here)
    dense_dir = args.densify or None
    if dense_dir:
        os.makedirs(dense_dir, exist_ok=True)
    # host frames are kept for overflow re-runs and the densify overlays
    keep_frames = guard is not None or dense_dir is not None
    flat_match = match if mode == "flat" else None
    # default: stack 4 frames per dispatch on the fast contracts (folded
    # batches are exact); an explicit --batch 1 disables
    batch = max(1, args.batch if args.batch is not None else 4) \
        if fast else 1
    if args.batch is not None and args.batch > 1 and not fast:
        print(
            f"--batch {args.batch} ignored: batched dispatch needs the "
            "row-form/masked/global-rows contracts (<=30-test forest, "
            "packable keys for this image size); frames dispatch singly",
            file=sys.stderr,
        )

    # --data-parallel / --shard-frame: full dispatch groups run over the
    # launch's ranks (the builders give the single-device batch fold's
    # stacked outputs, so assembly is unchanged); partial groups,
    # shape-change singles and overflow re-runs stay on one device
    match_batched = match
    sf_single = False  # --shard-frame alone: a 1-frame group still shards
    if launch is not None or args.data_parallel > 1 or args.shard_frame > 1:
        picked = _parallel_sequence(args, fmask, settings, probe.shape, mode,
                                    fast, batch, launch, dev)
        if isinstance(picked, int):
            return picked
        match_batched, batch, sf_single = picked
    # the ranks of a launch all run the stacked dispatches; rank 0 alone
    # runs the rest and writes
    lead = launch is None or launch.lead

    # Mid-sequence density hysteresis: the auto probe runs on frame 0
    # only, so a sequence that drifts dense would pay compact + full-width
    # on every dense dispatch.  The first overflow trips this flag; while
    # it is tripped each incoming frame is density-probed and dense frames
    # dispatch straight through the full-width builder; the first sparse
    # probe clears it and compact grouping resumes.  Exactness never
    # depends on this: the overflow flag remains the guard either way.
    ovf_state = {"tripped": False}
    fallback_mode = _FALLBACK[mode][0] if guard else None

    def write_frame(i, supports, gray=None):
        nonlocal total_matches
        total_matches += len(supports)
        write_supports(
            os.path.join(out_dir, f"supports_{i:04d}.txt"), supports
        )
        if dense_dir is not None and gray is not None:
            from opengpc_tpu_torch.densify import densify_supports
            from opengpc_tpu_torch.viz import dense_disparity_visualization

            dense, filled = densify_supports(supports, gray.shape,
                                             device=dev)
            write_png(os.path.join(dense_dir, f"dense_{i:04d}.png"),
                      dense_disparity_visualization(
                          gray, dense, filled,
                          max_disparity=args.disp_high))

    def rerun(frames):
        """The overflow fallback on a dispatch's host frames."""
        return guard.fallback()(*(_upload(f, dev) for f in frames))

    def assemble(pending):
        """Fetch one dispatch's device outputs (one frame, or a --batch
        stack of frames) and write the per-frame supports files."""
        # ``stacked``: outputs carry a leading batch axis
        i0, dmode, out, k, frames, stacked = pending

        def gray(j):
            if frames is None:
                return None
            return frames[0][j] if stacked else frames[0]

        if dmode in _FALLBACK:
            # overflow guard: a dense dispatch (any frame of the stack)
            # trips its flag and the whole dispatch re-runs through the
            # full-width builder (exact either way)
            if _flag(out[-1]):
                print(f"{guard.notice} (frames {i0}..{i0 + k - 1})",
                      file=sys.stderr)
                ovf_state["tripped"] = True
                out = rerun(frames)
            else:
                out = out[:-1]
            dmode = fallback_mode
        out = _numpy(out)
        for j in range(k):
            write_frame(i0 + j, _supports(dmode, out, settings.disp_high,
                                          j if stacked else None), gray(j))

    def dispatch(i0, dmode, fn, l, r, k=1, stacked=False, ranks=False):
        """Queue one matcher call on the device (its outputs stay there)
        as the pending work of frames i0..i0+k-1; None on a rank other
        than 0 unless every rank of the launch takes part (``ranks``)."""
        if not (lead or ranks):
            return None
        return (i0, dmode, fn(_upload(l, dev), _upload(r, dev)), k,
                (l, r) if keep_frames else None, stacked)

    def dispatch_group(group):
        """One dispatch for a full same-shape group: a stacked (B, H, W)
        batch folds into one (B*H, 2W) row sort on the folding contracts,
        with per-frame outputs identical to single-frame dispatches."""
        i0, l, r = group[0]
        if len(group) == 1 and not sf_single:
            return dispatch(i0, mode, match, l, r)
        lb = np.stack([g[1] for g in group])
        rb = np.stack([g[2] for g in group])
        return dispatch(i0, mode, match_batched, lb, rb, len(group), True,
                        ranks=launch is not None)

    def flush_group(group):
        """Dispatch a partial (flushed or leftover) group as single frames:
        the single-frame path is the one every partial group shares."""
        for i, l, r in group:
            submit(dispatch(i, mode, match, l, r))

    def dense_stretch(i, left, right) -> bool:
        """While the hysteresis is tripped, whether frame i is dense (a
        straight full-width dispatch); a sparse frame clears it."""
        if not ovf_state["tripped"]:
            return False
        dens = _probe_density(settings, left, right, dev)
        if dens > _auto_compact_threshold(
                mode in ("masked-compact", "pyramid-compact"),
                left.shape[1]):
            return True
        print(f"frame {i}: density {dens:.2f} back under the compact "
              "threshold — resuming the compact contract", file=sys.stderr)
        ovf_state["tripped"] = False
        return False

    # software pipeline: the device runs ahead of the host; assembly
    # (device-to-host copies, decode, supports and PNG writes) runs on its
    # own worker thread, and frame reads run on a read-ahead pool, so PNG
    # decode, device work and output writes overlap.  A copy to the host
    # waits for the stream up to the work it reads; the pending tuple
    # holds every tensor and frame it reads, so no later dispatch reuses
    # their memory.
    import collections
    from concurrent.futures import Future, ThreadPoolExecutor

    ex = ThreadPoolExecutor(max_workers=1)
    futures = collections.deque()

    def submit(pending):
        if not lead:  # rank 0 alone writes
            return
        futures.append(ex.submit(assemble, pending))
        while len(futures) > 2:  # bound in-flight device output buffers
            futures.popleft().result()

    # bounded read-ahead: decode the next PREFETCH pairs on worker threads
    # while the current pair dispatches
    PREFETCH = 4
    rd = ThreadPoolExecutor(max_workers=2)
    pairs = list(zip(lefts, rights))
    reads = collections.deque()
    if first:
        # the density probe already decoded pair 0
        f0 = Future()
        f0.set_result(first[0])
        reads.append(f0)
    reads.extend(
        rd.submit(lambda l, r: (read_gray(l), read_gray(r)), lp, rp)
        for lp, rp in pairs[len(reads):PREFETCH]
    )

    group = []
    _sync(dev)
    t0 = time.perf_counter()
    t_half = None
    px_half = 0
    try:
        for i in range(len(pairs)):
            if i == len(pairs) // 2 and i > 0:
                # steady-state marker: by mid-sequence the first dispatch's
                # one-time costs (kernel build and load) are long done
                t_half = time.perf_counter()
                px_half = total_px
            left, right = reads.popleft().result()
            if i + PREFETCH < len(pairs):
                reads.append(rd.submit(
                    lambda l, r: (read_gray(l), read_gray(r)),
                    *pairs[i + PREFETCH]))
            total_px += 2 * left.size
            if guard is not None and left.shape == probe.shape and _agreed(
                    launch, lambda: dense_stretch(i, left, right)):
                # dense stretch: skip the compact attempt entirely
                if group:
                    # the pending group is partial (k < batch): route it
                    # through the single-frame path like every other flush
                    flush_group(group)
                    group = []
                submit(dispatch(i, fallback_mode, guard.fallback(), left,
                                right))
                continue
            if fast and left.shape == probe.shape:
                group.append((i, left, right))
                if len(group) < batch:
                    continue
                submit(dispatch_group(group))
                group = []
            else:
                # shape change mid-sequence: flush any batched group first
                if group:
                    flush_group(group)
                    group = []
                if pyramid_mode:
                    # the rows pyramid builder handles any frame shape
                    # (flat fallback inside when not packable); the compact
                    # pyramid would raise on ineligible shapes
                    submit(dispatch(i, "pyramid", rows_pyr, left, right))
                    continue
                if fast and args.contract != "auto":
                    # an explicit fast contract: honor it for the new shape
                    # or error out, never downgrade to the capacity-bounded
                    # flat pipeline the user did not ask for.  Eligibility
                    # is the contract's own rule: the global contracts need
                    # (y, x) in 30 bits (the messages keep the JAX CLI's
                    # words)
                    if args.contract in ("global-rows", "global-compact"):
                        ok = _global_rows_ok(fmask, left.shape, settings)
                        keyname = "(y, x, d)"
                    else:
                        ok = _rows_ok(fmask, left.shape, settings)
                        keyname = "(x, d)"
                    if ok:
                        submit(dispatch(i, mode, match, left, right))
                        continue
                    print(
                        f"--contract {args.contract}: frame {i} shape "
                        f"{left.shape} has no packable {keyname} key — "
                        "cannot honor the explicit contract; re-run with "
                        "--contract auto to allow the flat fallback",
                        file=sys.stderr,
                    )
                    # drain pending assembles so worker-thread failures on
                    # already-dispatched frames surface
                    while futures:
                        futures.popleft().result()
                    return 1
                # auto mode: fall back to the flat pipeline (eligibility
                # was probed on the first frame); one flat matcher, made
                # lazily and reused
                if flat_match is None:
                    flat_match = build_sparsematch(fmask, settings,
                                                   device=dev)
                submit(dispatch(i, "flat", flat_match, left, right))
        if group:
            flush_group(group)
        while futures:
            futures.popleft().result()
    finally:
        rd.shutdown(wait=False, cancel_futures=True)
        ex.shutdown(wait=True)
    t_end = time.perf_counter()
    dt = t_end - t0
    print(
        f"{len(lefts)} pairs, {total_matches} supports, "
        f"{dt * 1e3:.1f} ms total (incl. first-call compile + host IO), "
        f"{total_px / 1e6 / dt:.1f} Mpix/s end-to-end"
    )
    if t_half is not None and t_end > t_half:
        sdt = t_end - t_half
        spx = total_px - px_half
        print(
            f"steady-state (2nd half, compile excluded): {sdt * 1e3:.1f} ms, "
            f"{spx / 1e6 / sdt:.1f} Mpix/s end-to-end"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
