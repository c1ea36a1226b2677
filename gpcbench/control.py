"""The readings that the limits of ``gpcbench.check`` are set from, on the
card at a cell's own size:

    python3 -m gpcbench.control --workload NAME --seeds N --control-seeds M

One process (or one launch of the cell's ranks) sets the cell up once.
Then, for each of ``--seeds`` seeds, it makes that seed's pool, runs a
short window of the cell's own traffic and compares its sampled calls with
the reference, as a run does: the lower readings.  For each of
``--control-seeds`` further seeds it runs the window again and puts each
control of the configuration's matching mode (``gpcbench.check.CONTROLS``
and ``control_outputs``: the reference with one guarantee broken) in the
program's place for the sampled calls: the upper readings.  One JSON line
a reading on standard output.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_000_000_017)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--rank-worker", action="store_true")
    args = p.parse_args(argv)

    from gpcbench import registry
    from gpcbench.run import cache_dirs, launch
    cache_dirs()
    bench = registry.benchmark()
    cell_def = registry.cell(bench, args.workload)
    cfg = registry.config(cell_def["config"])
    tr = registry.traffic(cell_def["traffic"])
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if tr["ranks"] > 1 and not args.rank_worker:
        rc, out = launch("gpcbench.control", [
            a for a in (argv if argv is not None else sys.argv[1:])],
            tr["ranks"], 3000)
        sys.stdout.write(out)
        return rc

    from gpcbench import cell, check, trace
    from gpcbench.reference import gpc
    torch.set_num_threads(2)
    if args.rank_worker:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        ranks = cell.Ranks(device)
    else:
        device, ranks = torch.device("cuda", 0), cell.One()
    r = cell.Run(cfg, tr, device, ranks, cell.Split())
    seeds = [args.first_seed + 7919 * i
             for i in range(args.seeds + args.control_seeds)]
    r.setup(seeds[0])
    tests = gpc.parse_forest(open(cfg["forest_path"]).read())
    bsz = tr["batch"]
    for n, seed in enumerate(seeds):
        if n:
            r.make_inputs(seed)
            r.warm()
        w = r.window(args.seconds, seed, trace.Spans(False))
        line = {"workload": args.workload, "seed": seed, "calls": w.calls}
        if n < args.seeds:
            t = time.perf_counter()
            readings = r.compare(w.samples)
            line.update(kind="program", readings=readings,
                        compare_s=time.perf_counter() - t)
            if ranks.rank == 0:
                print(json.dumps(line), flush=True)
            continue
        picked = sorted({b * bsz + j for _, b, j, _ in filter(None,
                                                             w.samples)})
        w.samples = None
        if ranks.rank != 0:
            continue
        for kind in check.CONTROLS[cfg["epipolar_mode"]]:
            readings = {}
            for p in picked:
                lefts = r.lefts[p:p + 1].cpu().numpy()
                rights = r.rights[p:p + 1].cpu().numpy()
                buf, counts = check.control_outputs(lefts, rights, tests,
                                                    cfg, kind)
                check.add(readings, check.compare(buf, counts, lefts, rights,
                                                  tests, cfg))
            print(json.dumps(dict(line, kind=kind, readings=readings,
                                  correct=check.verdict(
                                      readings, w.strata))),
                  flush=True)
    ranks.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
