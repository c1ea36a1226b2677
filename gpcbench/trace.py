"""Spans around the calls into the program, and the reduction of a
``torch.profiler`` window to what the per-layer metrics read.

The harness marks its own steps with ``torch.profiler.record_function``:
``window`` around the measured window, ``enqueue`` around each call of the
entry (the dispatch layer: the module's ``forward``, its custom ops and
launches), ``consume`` around the consumer's add of the row counts,
``wait`` where the client waits on the card and ``control`` where the
ranks agree to stop.  The reduction links each device activity to the
launch that made it through the profiler's correlation ids, and each
launch to the span it was made in:

* the key kernel is any kernel whose name holds ``fused_keys``;
* the match layer is every other non-NCCL kernel, copy or fill that an
  ``enqueue`` span launched after its key op (``ogpc::fused_key_image*``)
  returned;
* NCCL kernels are the collectives;
* busy time is the union of all kernel, copy and fill intervals inside
  the window, and each idle gap is charged to the span the host was in
  at the gap's middle (``other`` outside every span).

The summary also carries the program's own stage spans as ``spans``
(:func:`summarize_spans`): while a profiler runs, the port marks its
stages with ``ogpc.*`` ranges (``opengpc_tpu_torch.utils.timing.span``,
``cpu_op`` events of the trace): ``ogpc.forward`` around a call of a
matcher and, inside it, ``ogpc.keys``, ``ogpc.fold``, ``ogpc.sort``,
``ogpc.detect``, ``ogpc.emit``, ``ogpc.unfold`` and, on the row-sharded
modules, ``ogpc.halo``.  The readers of ``gpcbench.spans`` read them.
"""

from __future__ import annotations

import bisect
import contextlib

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
HOST_SPANS = ("enqueue", "consume", "wait", "control")
SPAN_NAMES = HOST_SPANS + ("window",)
SPAN_PREFIX = "ogpc."  # the program's stage spans
TOP = 10


class Spans:
    """The harness's spans: ``record_function`` ranges when a profiler
    runs, nothing otherwise."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)


def _union(intervals):
    """Total length of the union of (start, end) intervals, and the gaps
    between them as (start, end)."""
    total, gaps, cur_s, cur_e = 0, [], None, None
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            total += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


def _kind(e) -> str:
    """The event's kineto activity type; where this torch's events do not
    carry it, told from the device, the name and the correlation id."""
    try:
        return e.activity_type()
    except AttributeError:
        pass
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        if name in SPAN_NAMES or name.startswith(("nccl:", SPAN_PREFIX)):
            return "gpu_user_annotation"
        return "kernel"
    if name in SPAN_NAMES:
        return "user_annotation"
    if name.startswith(SPAN_PREFIX):
        return "cpu_op"
    if name.startswith("cu") and e.correlation_id():
        return "cuda_runtime"
    return "cpu_op"


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


def summarize_spans(events) -> dict:
    """{span name: seconds and counts} of the program's ``ogpc.*`` spans
    in one rank's traced window, from the profiler's kineto events; empty
    where the program marked no span:

    * ``calls``, ``host_s``, and ``self_host_s``: ``host_s`` less the time
      its child spans cover;
    * ``device_s`` and ``launches``: every kernel, copy and fill of the
      window charged to the innermost span whose host interval holds its
      launch (found through the correlation id, as :func:`reduce` finds
      the match layer's); ``all_launches`` counts them over the span and
      every span inside it;
    * ``idle_s``: each idle gap of the device charged to the innermost
      span the host was in at the gap's middle."""
    window, spans, names, launches, device = None, [], [], {}, []
    for e in events:
        kind, name = _kind(e), e.name()
        s, d = e.start_ns(), e.duration_ns()
        if kind in DEVICE_KINDS:
            device.append((s, s + d, e.correlation_id()))
        elif kind in LAUNCH_KINDS:
            launches[e.correlation_id()] = s
        elif kind == "user_annotation" and name == "window":
            window = (s, s + d)
        elif kind == "cpu_op" and name.startswith(SPAN_PREFIX):
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
    _, gaps = _union([(s, e) for s, e, _ in device])
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


def reduce(events, key_op: str = "fused_key_image") -> dict:
    """The summary of one rank's traced window from the profiler's kineto
    events (``prof.profiler.kineto_results.events()``): seconds and counts,
    small enough to gather across ranks."""
    window = None
    spans = {n: [] for n in HOST_SPANS}
    key_ops, launches, device = [], {}, []
    kinds = {}
    for e in events:
        kind, name = _kind(e), e.name()
        kinds[kind] = kinds.get(kind, 0) + 1
        s, d = e.start_ns(), e.duration_ns()
        if kind in DEVICE_KINDS:
            device.append((s, s + d, name, kind, e.correlation_id()))
        elif kind in LAUNCH_KINDS:
            launches[e.correlation_id()] = s
        elif kind == "user_annotation" and name == "window":
            window = (s, s + d)
        elif kind == "user_annotation" and name in spans:
            spans[name].append((s, s + d))
        elif key_op in name and kind == "cpu_op":
            key_ops.append((s, s + d))
    if window is None:
        raise RuntimeError(f"the traced window has no 'window' span; "
                           f"events by kind: {kinds}")
    w0, w1 = window
    device = [x for x in device if x[0] >= w0 and x[1] <= w1]
    enq = sorted(spans["enqueue"])
    enq_starts = [s for s, _ in enq]
    key_ops.sort()
    key_starts = [s for s, _ in key_ops]

    def key_end_in(span):
        i = bisect.bisect_left(key_starts, span[0])
        if i < len(key_ops) and key_ops[i][1] <= span[1]:
            return key_ops[i][1]
        return None

    key_ends = [key_end_in(sp) for sp in enq]
    key_ns = key_n = match_ns = nccl_ns = 0
    ops = {}
    for s, e, name, kind, corr in device:
        ops[name] = ops.get(name, 0) + (e - s)
        if kind == "kernel" and "fused_keys" in name:
            key_ns += e - s
            key_n += 1
        elif kind == "kernel" and name.lower().startswith("nccl"):
            nccl_ns += e - s
        else:
            t = launches.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(enq_starts, t) - 1
            if i >= 0 and t <= enq[i][1] and key_ends[i] is not None \
                    and t >= key_ends[i]:
                match_ns += e - s
    busy, gaps = _union([(s, e) for s, e, *_ in device])
    host = sorted((s, e, n) for n, v in spans.items() for s, e in v)
    host_starts = [s for s, _, _ in host]
    idle = {}
    if device:
        gaps = ([(w0, min(s for s, *_ in device))] + gaps
                + [(max(e for _, e, *_ in device), w1)])
    else:
        gaps = [(w0, w1)]
    for gs, ge in gaps:
        if ge <= gs:
            continue
        mid = (gs + ge) // 2
        i = bisect.bisect_right(host_starts, mid) - 1
        # spans do not nest, except a wait inside nothing: take the last
        label = host[i][2] if i >= 0 and host[i][1] >= mid else "other"
        idle[label] = idle.get(label, 0) + (ge - gs)
    return dict(
        window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
        calls=len(enq),
        enqueue_ms=[(e - s) / 1e6 for s, e in enq],
        key_s=key_ns / 1e9, key_launches=key_n,
        key_ops_seen=sum(k is not None for k in key_ends),
        match_s=match_ns / 1e9, nccl_s=nccl_ns / 1e9,
        launches_seen=len(launches), kinds=kinds,
        device_ops={k: v / 1e9 for k, v in ops.items()},
        idle_by_host={k: v / 1e9 for k, v in idle.items()},
        spans=summarize_spans(events))


def top(d: dict, n: int = TOP, width: int = 64):
    """The ``n`` largest entries of {name: seconds} as [[name, seconds]],
    names cut to ``width`` characters."""
    return [[k[:width], v] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def merge(summaries):
    """Sum {name: seconds} maps of several ranks, divided by their count."""
    out = {}
    for s in summaries:
        for k, v in s.items():
            out[k] = out.get(k, 0) + v / len(summaries)
    return out
