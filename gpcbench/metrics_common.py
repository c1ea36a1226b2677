"""The per-layer readers' arithmetic over the ranks' traced summaries
(``gpcbench.trace.reduce``).  A reader under ``metrics/`` is one of these
functions under its metric's name; a reader that finds nothing to read
returns None.  The metric's layer, what it moves and its cells are in
``BENCHMARK.json`` alone."""

from __future__ import annotations


def enqueue_ms(ctx):
    """The host clock around each call of the entry, with no synchronise,
    mean over the traced calls and over the ranks: what dispatching a call
    costs the host (the module's ``forward``, its custom ops and
    launches)."""
    per = [sum(s["enqueue_ms"]) / len(s["enqueue_ms"]) for s in ctx.ranks
           if s["enqueue_ms"]]
    return sum(per) / len(per) if per else None


def key_roofline(ctx):
    """The key kernel's least time (``gpcbench.roofline``: bytes at 3.35
    TB/s or operations at the integer peak, from the shapes and the
    candidates of the rows it keys) over its profiler time: 100 x (least
    seconds a traced call, over all its key launches) / (profiler seconds
    a key launch x key launches a call), mean over the ranks; None where
    no key launch was seen.  The same work reads the same share whether a
    call keys its batch in one launch or pair by pair."""
    per = [100 * (s["key_least_s"] / s["calls"])
           / (s["key_s"] / s["key_launches"] * s["key_launches_per_call"])
           for s in ctx.ranks if s["key_launches"] and s["calls"]]
    return sum(per) / len(per) if len(per) == len(ctx.ranks) else None


def match_ms(ctx):
    """Profiler device ms, summed over the ranks, of every kernel, copy and
    fill that a call launched after its key op returned (the row sort,
    detection, emit and unfold of ``match.py``), per pair of the traced
    window."""
    total = sum(s["match_s"] for s in ctx.ranks)
    pairs = ctx.ranks[0]["pairs"]
    return total * 1e3 / pairs if total > 0 and pairs else None


def idle_share(ctx):
    """1 - the union of kernel, copy and fill intervals over the traced
    window, from the profiler's timeline, in %, mean over the ranks.  The
    window opens within the process's first minute."""
    per = [100 * (1 - s["busy_s"] / s["window_s"]) for s in ctx.ranks
           if s["busy_s"] > 0]
    return sum(per) / len(per) if len(per) == len(ctx.ranks) else None
