"""Quality/speed evaluation harness of the PyTorch port: the fast-preset
tradeoff table.

The port of examples/evaluate.py.  Over a ground-truth synthetic scene
(``utils.scenes.make_scene``: a textured warp with an occlusion map) it
measures what truncating a forest to its first N tests (``truncate_forest``
/ the CLI's ``--max-tests``) costs in support density and precision, and,
with ``--device-time``, what the masked matcher takes on the card a pair.
Small forests (num_tests + bit_length(2W-1) <= 30) ride the
single-operand packed row sort ("1-op").

Usage:
    python examples/evaluate_torch.py [forest.txt] [--height H] [--width W]
        [--tests 30,20,17,15] [--device-time] [--seed S] [--device cuda|cpu]

``--device-time`` times one call of the masked module (its outputs reduced
on the card inside the timed window) with CUDA events and reports the
median over REPEATS calls; it needs a CUDA device and exits 1 on the
CPU.  Omit it for a quality-only table.
"""

import argparse
import os
import sys

# importable from any cwd, like examples/evaluate.py
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("forest", nargs="?", default="forests/defaultZeroForest.txt")
    p.add_argument("--height", type=int, default=436)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--tests", default="30,20,17,15,10",
                   help="comma-separated max-tests truncation points")
    p.add_argument("--disp-high", type=int, default=128)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default="cuda",
                   help="where the matcher runs: cuda (the hand-written "
                   "kernels, default) or cpu")
    p.add_argument("--device-time", action="store_true",
                   help="also time the masked matcher per point with CUDA "
                   "events (needs --device cuda)")
    args = p.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if args.device_time and device.type != "cuda":
        print("evaluate_torch: --device-time times the card with CUDA "
              f"events; it needs --device cuda, got {args.device}",
              file=sys.stderr)
        return 1

    from opengpc_tpu_torch.config import InferenceSettings
    from opengpc_tpu_torch.forest import load_forest, make_filter_mask
    from opengpc_tpu_torch.infer import (build_sparsematch_masked,
                                         masked_supports_to_numpy)
    from opengpc_tpu_torch.match import _pack_ok
    from opengpc_tpu_torch.metrics import support_precision
    from opengpc_tpu_torch.utils.scenes import make_scene

    rng = np.random.default_rng(args.seed)
    h, w = args.height, args.width
    left, right, disp, occ = make_scene(rng, h, w)
    settings = InferenceSettings(
        gradient_threshold=5, vertical_tolerance=0,
        disp_high=args.disp_high, epipolar_mode=True, capacity=1 << 19)
    forest = load_forest(args.forest)
    points = [int(t) for t in args.tests.split(",")]
    lt, rt = (torch.from_numpy(a).to(device) for a in (left, right))

    print(f"scene {h}x{w} seed={args.seed}  forest={args.forest} "
          f"({forest.num_tests} tests)  device={device}")
    hdr = "| tests | sort | supports | density | prec tol0 | prec tol1 |"
    if args.device_time:
        hdr += " ms/pair | Mpix/s |"
    print(hdr)
    print("|" + "---|" * (len(hdr.split("|")) - 2))

    # density is "supports relative to the least-truncated run", so rows
    # are processed largest-n first whatever the --tests order
    base_n = None
    for n in sorted(set(points), reverse=True):
        if n > forest.num_tests:
            continue
        mask = make_filter_mask(forest, max_tests=n)
        mfn = build_sparsematch_masked(mask, settings, device=device)
        buf, counts = mfn(lt, rt)
        supp = masked_supports_to_numpy(buf, counts, settings.disp_high)
        if base_n is None:
            base_n = max(1, len(supp))
        p0, _ = support_precision(supp, disp, valid=(occ == 0), tol=0)
        p1, _ = support_precision(supp, disp, valid=(occ == 0), tol=1)
        sort = "1-op" if _pack_ok(mask.num_tests, 2 * w) else "2-op"
        row = (f"| {n} | {sort} | {len(supp)} | {len(supp)/base_n:.3f} "
               f"| {p0:.4f} | {p1:.4f} |")
        if args.device_time:
            ms = masked_ms(mfn, lt, rt)
            row += f" {ms:.3f} | {2*h*w/1e3/ms:.0f} |"
        print(row, flush=True)
    return 0


REPEATS, WARMUP = 50, 5


def masked_ms(mfn, left, right):
    """Median CUDA-events ms of one call of the masked module, its buffer
    and row counts reduced on the card inside the timed window, so the
    window ends only when every output exists."""
    import torch

    def step():
        buf, counts = mfn(left, right)
        return buf.sum(dtype=torch.int64) + counts.sum(dtype=torch.int64)

    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


if __name__ == "__main__":
    sys.exit(main())
