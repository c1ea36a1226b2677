"""The program's stage spans in a traced window, and the per-layer numbers
that read them.

While a profiler runs, the port marks its stages with ``ogpc.*`` ranges
(``opengpc_tpu_torch.utils.timing.span``, ``cpu_op`` events of the
trace): ``ogpc.forward`` around a call of a matcher and, inside it,
``ogpc.keys``, ``ogpc.fold``, ``ogpc.sort``, ``ogpc.detect``,
``ogpc.emit``, ``ogpc.unfold`` and, on the row-sharded modules,
``ogpc.halo``.  :func:`summarize` reduces one rank's kineto events to a
table, by span name:

* ``calls``, ``host_s``, and ``self_host_s``: ``host_s`` less the time
  its child spans cover;
* ``device_s`` and ``launches``: every kernel, copy and fill of the window
  charged to the innermost span whose host interval holds its launch (the
  launch found through the correlation id, as ``trace.reduce`` finds the
  match layer's); ``all_launches`` counts them over the span and every
  span inside it;
* ``idle_s``: each idle gap of the device charged to the innermost span
  the host was in at the gap's middle.

``trace.reduce`` does not join this table to its summary, so no cell's
result line carries the readers below.  This module's command runs a
one-card cell traced as ``gpcbench.run --trace 1`` does, with the table
joined to each summary as ``spans`` (``trace_summary`` on standard error
prints it), and prints as the last line of standard output the table a
call and the readings::

    python3 -m gpcbench.spans --workload NAME --seed N --seconds S
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import sys
import types

from gpcbench import trace

PREFIX = "ogpc."
STAGES = ("sort", "detect", "emit", "fold")


def _pieces(spans):
    """Nested (start, end) host intervals, by index, as the pieces of time
    each covers innermost: sorted [(start, end, index)], and each span's
    parent index (None at the top).  A child that overruns its parent is
    cut at the parent's end."""
    pieces, stack, parent, t = [], [], [None] * len(spans), None
    for i in sorted(range(len(spans)), key=lambda i: (spans[i][0],
                                                      -spans[i][1])):
        s, e = spans[i]
        while stack and stack[-1][0] <= s:
            end, j = stack.pop()
            if end > t:
                pieces.append((t, end, j))
                t = end
        if stack:
            if s > t:
                pieces.append((t, s, stack[-1][1]))
            parent[i] = stack[-1][1]
            e = min(e, stack[-1][0])
        stack.append((e, i))
        t = s
    while stack:
        end, j = stack.pop()
        if end > t:
            pieces.append((t, end, j))
            t = end
    return pieces, parent


def summarize(events) -> dict:
    """{span name: seconds and counts} of one rank's traced window from
    the profiler's kineto events; empty where the program marked no
    span."""
    window, spans, names, launches, device = None, [], [], {}, []
    for e in events:
        kind, name = trace._kind(e), e.name()
        s, d = e.start_ns(), e.duration_ns()
        if kind in trace.DEVICE_KINDS:
            device.append((s, s + d, e.correlation_id()))
        elif kind in trace.LAUNCH_KINDS:
            launches[e.correlation_id()] = s
        elif kind == "user_annotation" and name == "window":
            window = (s, s + d)
        elif kind == "cpu_op" and name.startswith(PREFIX):
            spans.append((s, s + d))
            names.append(name)
    if window is None:
        raise RuntimeError("the traced window has no 'window' span")
    out = {}
    for n, (s, e) in zip(names, spans):
        row = out.setdefault(n, dict(calls=0, host_s=0.0, self_host_s=0.0,
                                     device_s=0.0, launches=0,
                                     all_launches=0, idle_s=0.0))
        row["calls"] += 1
        row["host_s"] += (e - s) / 1e9
    pieces, parent = _pieces(spans)
    starts = [p[0] for p in pieces]

    def innermost(t):
        i = bisect.bisect_right(starts, t) - 1
        return pieces[i][2] if i >= 0 and t < pieces[i][1] else None

    for s, e, i in pieces:
        out[names[i]]["self_host_s"] += (e - s) / 1e9
    w0, w1 = window
    device = [x for x in device if x[0] >= w0 and x[1] <= w1]
    for s, e, corr in device:
        t = launches.get(corr)
        i = innermost(t) if t is not None else None
        if i is None:
            continue
        out[names[i]]["device_s"] += (e - s) / 1e9
        out[names[i]]["launches"] += 1
        while i is not None:
            out[names[i]]["all_launches"] += 1
            i = parent[i]
    _, gaps = trace._union([(s, e) for s, e, _ in device])
    if device:
        gaps = ([(w0, min(s for s, _, _ in device))] + gaps
                + [(max(e for _, e, _ in device), w1)])
    else:
        gaps = [(w0, w1)]
    for gs, ge in gaps:
        i = innermost((gs + ge) // 2) if ge > gs else None
        if i is not None:
            out[names[i]]["idle_s"] += (ge - gs) / 1e9
    return out


@contextlib.contextmanager
def joined():
    """Within the block ``trace.reduce`` adds :func:`summarize`'s table to
    its summary as ``spans``; yields the list of the summaries it made."""
    base, made = trace.reduce, []

    def reduce(events, key_op="fused_key_image"):
        summary = base(events, key_op)
        summary["spans"] = summarize(events)
        made.append(summary)
        return summary

    trace.reduce = reduce
    try:
        yield made
    finally:
        trace.reduce = base


# --- readers: ``read(ctx)`` over the ranks' summaries, as metrics_common's

def _tables(ctx):
    """Each rank's span table, or None where a rank has none."""
    tables = [(s or {}).get("spans") for s in ctx.ranks or [None]]
    return tables if all(tables) else None


def _stage_ms(ctx, *names):
    tables = _tables(ctx)
    if tables is None:
        return None
    total = sum(t[n]["device_s"] for t in tables for n in names if n in t)
    return total * 1e3 / ctx.ranks[0]["pairs"]


def sort_ms(ctx):
    """Device ms a pair launched under ``ogpc.sort`` (``match._sort_key_pos``:
    pack, ``torch.sort``, unpack), summed over the ranks."""
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
    with joined() as made:
        rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                       "--seconds", str(args.seconds), "--trace", "1"])
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
