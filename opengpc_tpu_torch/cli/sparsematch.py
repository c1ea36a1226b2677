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
instead of the card; ``--data-parallel`` and ``--shard-frame`` above 1
exit 1 (their multi-device builders are not in this package yet).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

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
from opengpc_tpu_torch.viz import disparity_visualization


# auto-contract density cutoff, as a fraction of the chosen contract's
# chunk capacity ratio K/S (masked: 64/128 -> cutoff 0.30; wide-row global:
# 128/512 -> 0.15).  A misprediction is still exact either way: the
# overflow guard re-runs the dispatch full-width.
_AUTO_COMPACT_FRACTION = 0.6

# the multi-device builders a CLI over several ranks would drive
_UNPORTED = {
    "--data-parallel": "the batched data-parallel builders "
                       "(parallel.build_batched_sparsematch_rows, _masked, "
                       "_masked_compact, _global_rows, _global_compact and "
                       "build_batched_pyramid)",
    "--shard-frame": "the CLI's multi-rank sharded frame and the 2-D and "
                     "pyramid sharded builders "
                     "(parallel.build_batched_sharded_frame_sparsematch, "
                     "build_sharded_frame_pyramid, "
                     "build_batched_sharded_frame_pyramid)",
}


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
                    density, dev, sequence=False):
    """The matcher of ``contract`` for frames of ``shape``: ``(match, mode,
    guard)``.  ``mode`` names the layout of the outputs (``_supports``).  A
    compacted mode's ``match`` returns ``(*outputs, overflow)`` and
    ``guard``, an :class:`_OverflowGuard`, makes its full-width fallback;
    ``guard`` is None otherwise.  ``"auto"`` rides the fast contracts where
    the frames are eligible, and the compacted ones where ``density()``
    (called at most once) is at or under ``_auto_compact_threshold``.  The
    caller refuses an explicit contract the frames are not eligible for;
    ``sequence`` picks the sequence mode's overflow notices."""
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
                and settings.disp_high >= 1 \
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
                   help="sequence mode: shard each --batch group's frames "
                   "over N devices (not in this package yet: N > 1 exits "
                   "1)")
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
        help="shard each pair's rows over N devices (not in this package "
        "yet: N > 1 exits 1).  0 (default) = off",
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

    for flag, n in (("--data-parallel", args.data_parallel),
                    ("--shard-frame", args.shard_frame)):
        if n > 1:
            print(f"{flag} {n}: {_UNPORTED[flag]} are not ported to "
                  "opengpc_tpu_torch yet; match on one device",
                  file=sys.stderr)
            return 1
    dev = torch.device(args.device)

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
        return _run_sequence(args, forest, settings, dev)
    if args.batch is not None and args.batch > 1:
        print("--batch applies to sequence (directory) mode only",
              file=sys.stderr)
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
    # fast output contracts when available (<=30-test forests, packable
    # keys): epipolar rides the masked/row-form matchers, global mode the
    # segmented global contract; --contract forces one (--pyramid: auto or
    # masked-compact)
    if args.contract in ("rows", "masked", "masked-compact") \
            and not _rows_ok(fmask, left.shape, settings):
        print(f"--contract {args.contract} needs epipolar mode, a "
              "<=30-test forest and packable (x, d) keys for this "
              "image size", file=sys.stderr)
        return 1
    if args.contract in ("global-rows", "global-compact") \
            and not _global_ok(fmask, left.shape, settings):
        print(f"--contract {args.contract} needs --global-mode, a "
              "<=30-test forest and packable (y, x, d) keys for this "
              "image size", file=sys.stderr)
        return 1
    match, mode, guard = _select_matcher(
        args.contract, forest, fmask, settings, args.pyramid, left.shape,
        lambda: _probe_density(settings, left, right, dev), dev)
    if guard is not None:
        # a dense frame re-runs full-width inside the call, exact either way
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
    with trace(args.trace):
        for _ in range(max(0, args.repeats - 1)):
            t0 = time.perf_counter()
            result = run()
            best = min(best, time.perf_counter() - t0)

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


def _run_sequence(args, forest, settings, dev) -> int:
    """Directory mode: match every left/right frame pair of a rectified
    stereo sequence on ``dev``, write per-frame supports next to ``--out``,
    report aggregate throughput."""
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
        return _probe_density(settings, *first[0], dev)

    # --pyramid: every full dispatch group rides the batched rows pyramid
    # fold; ineligible shapes fall back inside the builder to the flat
    # per-level path, so any frame shape works
    match, mode, guard = _select_matcher(
        args.contract, forest, fmask, settings, args.pyramid, probe.shape,
        density, dev, sequence=True)
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

    def dispatch(i0, dmode, fn, l, r, k=1, stacked=False):
        """Queue one matcher call on the device (its outputs stay there)
        as the pending work of frames i0..i0+k-1."""
        return (i0, dmode, fn(_upload(l, dev), _upload(r, dev)), k,
                (l, r) if keep_frames else None, stacked)

    def dispatch_group(group):
        """One dispatch for a full same-shape group: a stacked (B, H, W)
        batch folds into one (B*H, 2W) row sort on the folding contracts,
        with per-frame outputs identical to single-frame dispatches."""
        i0, l, r = group[0]
        if len(group) == 1:
            return dispatch(i0, mode, match, l, r)
        lb = np.stack([g[1] for g in group])
        rb = np.stack([g[2] for g in group])
        return dispatch(i0, mode, match, lb, rb, len(group), True)

    def flush_group(group):
        """Dispatch a partial (flushed or leftover) group as single frames:
        the single-frame path is the one every partial group shares."""
        for i, l, r in group:
            submit(dispatch(i, mode, match, l, r))

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
            if (guard is not None and ovf_state["tripped"]
                    and left.shape == probe.shape):
                dens = _probe_density(settings, left, right, dev)
                if dens > _auto_compact_threshold(
                        mode in ("masked-compact", "pyramid-compact"),
                        left.shape[1]):
                    # dense stretch: skip the compact attempt entirely
                    if group:
                        # the pending group is partial (k < batch): route
                        # it through the single-frame path like every other
                        # flush
                        flush_group(group)
                        group = []
                    submit(dispatch(i, fallback_mode, guard.fallback(),
                                    left, right))
                    continue
                print(f"frame {i}: density {dens:.2f} back under the "
                      "compact threshold — resuming the compact contract",
                      file=sys.stderr)
                ovf_state["tripped"] = False
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
                    # packable (y, x, d) keys
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
