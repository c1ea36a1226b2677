"""The per-layer numbers that read the program's stage spans, and a
command that prints them with the span table a call.

``gpcbench.trace.reduce`` carries each rank's table of the program's
``ogpc.*`` spans as ``spans`` (``trace.summarize_spans``), so the readers
below reach every traced run's result line through their one-line files
under ``metrics/``.  This module's command runs a one-card cell traced as
``gpcbench.run --trace 1`` does and prints as the last line of standard
output the table a call and the readings::

    python3 -m gpcbench.spans --workload NAME --seed N --seconds S
"""

from __future__ import annotations

import argparse
import json
import sys
import types

STAGES = ("sort", "detect", "emit", "fold")


# --- readers: ``read(ctx)`` over the ranks' summaries, as metrics_common's

def _tables(ctx):
    """Each rank's span table, or None where a rank has none."""
    tables = [(s or {}).get("spans") for s in ctx.ranks or [None]]
    return tables if all(tables) else None


def _stage_ms(ctx, *names):
    """Device ms a pair under the spans ``names``, summed over the ranks;
    None where no rank's program marked any of them."""
    tables = _tables(ctx)
    if tables is None or not any(n in t for t in tables for n in names):
        return None
    total = sum(t[n]["device_s"] for t in tables for n in names if n in t)
    return total * 1e3 / ctx.ranks[0]["pairs"]


def sort_ms(ctx):
    """Device ms a pair launched under ``ogpc.sort`` (``match._sort_key_pos``:
    the row-sort kernel, ``torch.sort`` past 16,384 columns), summed over
    the ranks."""
    return _stage_ms(ctx, "ogpc.sort")


def detect_ms(ctx):
    """Device ms a pair under ``ogpc.detect``
    (``match._detect_pairs_packed``)."""
    return _stage_ms(ctx, "ogpc.detect")


def emit_ms(ctx):
    """Device ms a pair under ``ogpc.emit`` (``match._masked_emit``)."""
    return _stage_ms(ctx, "ogpc.emit")


def fold_ms(ctx):
    """Device ms a pair under ``ogpc.fold`` and ``ogpc.unfold``
    (``infer._folded_key_rows``' slice and reshape, ``infer._unfold``)."""
    return _stage_ms(ctx, "ogpc.fold", "ogpc.unfold")


def launches_per_call(ctx):
    """Device activities launched under ``ogpc.forward`` (the matcher's
    ``forward``, its stages included) a call, mean over the ranks."""
    tables = _tables(ctx)
    if tables is None or not all("ogpc.forward" in t for t in tables):
        return None
    per = [t["ogpc.forward"]["all_launches"] / t["ogpc.forward"]["calls"]
           for t in tables]
    return sum(per) / len(per)


READERS = {"sort_ms.per_pair": sort_ms, "detect_ms.per_pair": detect_ms,
           "emit_ms.per_pair": emit_ms, "fold_ms.per_pair": fold_ms,
           "launches.per_call": launches_per_call}


def per_call(summary) -> dict:
    """The span table of one summary in ms and launches a call of the
    window."""
    n = summary["calls"]
    return {name: {"calls": row["calls"] / n,
                   "host_ms": row["host_s"] * 1e3 / n,
                   "self_host_ms": row["self_host_s"] * 1e3 / n,
                   "device_ms": row["device_s"] * 1e3 / n,
                   "launches": row["launches"] / n,
                   "idle_ms": row["idle_s"] * 1e3 / n}
            for name, row in summary["spans"].items()}


class _Tee:
    """A stream that writes through to ``out`` and keeps what it wrote."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, text):
        self.text.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def main(argv=None) -> int:
    from gpcbench import metrics_common, registry, run
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    if registry.cell(registry.benchmark(), args.workload)["chips"] != 1:
        print("gpcbench.spans runs one-card cells", file=sys.stderr)
        return 2
    log = _Tee(sys.stderr)
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"], log=log)
    made = [json.loads(ln.split(" ", 1)[1])
            for ln in "".join(log.text).splitlines()
            if ln.startswith("trace_summary ")]
    if rc or not made:
        return rc or 1
    ctx = types.SimpleNamespace(ranks=made)
    readings = {k: f(ctx) for k, f in READERS.items()}
    match = metrics_common.match_ms(ctx)
    stages = [readings[f"{s}_ms.per_pair"] for s in STAGES]
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "per_call": per_call(made[0]), "readings": readings,
        "match_ms.per_pair": match,
        "stages_over_match": (sum(stages) / match
                              if match and None not in stages else None)}),
        flush=True)
    return 0


if __name__ == "__main__":
    from gpcbench import run  # noqa: F401  first: its clock starts here
    sys.exit(main())
