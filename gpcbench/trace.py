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
"""

from __future__ import annotations

import bisect
import contextlib

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
HOST_SPANS = ("enqueue", "consume", "wait", "control")
SPAN_NAMES = HOST_SPANS + ("window",)
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
        if name in SPAN_NAMES or name.startswith("nccl:"):
            return "gpu_user_annotation"
        return "kernel"
    if name in SPAN_NAMES:
        return "user_annotation"
    if name.startswith("cu") and e.correlation_id():
        return "cuda_runtime"
    return "cpu_op"


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
        idle_by_host={k: v / 1e9 for k, v in idle.items()})


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
