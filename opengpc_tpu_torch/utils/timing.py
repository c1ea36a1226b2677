"""Phase timing and profiling.

The reference's chrono tick helpers (``sysTick``/``tickToMs``,
inference.hpp:62-70) and a profiler capture, as ``opengpc_tpu.utils.timing``
has them:

* :class:`PhaseTimer` — named wall-clock phases, printable as the same
  style of per-phase ms report the reference prints (a copy).
* :func:`trace` — a ``torch.profiler`` capture (host and, where a CUDA
  device is present, device activity) written as a Chrome trace into a
  directory.
* :func:`span` — the program's stage spans (``ogpc.forward``,
  ``ogpc.keys``, ``ogpc.fold``, ``ogpc.sort``, ``ogpc.detect``,
  ``ogpc.emit``, ``ogpc.unfold``, ``ogpc.halo``): profiler ranges while
  a profiler runs, a shared no-op otherwise.

and the card's step timers, which ``bench_torch.py`` and ``chip_smoke.py``
share:

* :func:`events_ms_per_step` — CUDA events around back-to-back steps: what
  a caller's loop on the card sustains, the host's launch overhead
  included.
* :func:`graph_ms_per_step` — the same steps captured in one CUDA graph,
  events around its replay: the device time a step takes with the launch
  overhead removed (the counterpart of ``opengpc_tpu``'s
  ``device_time_per_iter``, which chained steps in one compiled loop).
* :func:`device_profile` — a ``torch.profiler`` window: each kernel's
  device time, the host's wall time and the device's busy share.
* :func:`host_ms_per_step` — the host clock, for CPU tensors, whose
  operations finish before they return.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List, Optional

import torch

_NO_SPAN = contextlib.nullcontext()


class PhaseTimer:
    """Accumulates named wall-clock phases.

    >>> t = PhaseTimer()
    >>> with t.phase("preprocess"): ...
    >>> with t.phase("match"): ...
    >>> print(t.report())   # tPreprocess: 1.2 ms, tMatch: 3.4 ms
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def ms(self, name: str) -> float:
        return self.totals.get(name, 0.0) * 1e3

    def report(self) -> str:
        return ", ".join(
            f"t{k[:1].upper()}{k[1:]}: {v * 1e3:.2f} ms"
            for k, v in self.totals.items()
        )


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace of the block into
    ``log_dir/trace.json`` (Chrome trace format: chrome://tracing,
    Perfetto).  No-op when ``log_dir`` is None, so callers can thread a
    CLI flag straight through."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def span(name: str):
    """A profiler range called ``name`` (one of the ``ogpc.*`` stages)
    while a torch profiler runs: the profiler puts it on the clock of the
    device's activities, so a trace charges each kernel to the stage that
    launched it.  Otherwise, and always while ``torch.export`` or
    ``torch.compile`` trace (a traced program never depends on whether
    someone profiled while it was traced), one shared ``nullcontext``: a
    span costs a check when no profiler runs.

    The range is an op-scope one (``_RecordFunctionFast``, with which
    torch's compiled code marks its calls), a ``cpu_op`` event in the
    trace, not a ``record_function`` user annotation: the profiler copies
    a user annotation onto the device's timeline over the kernels it
    launched, and a reader that cannot tell that copy from a kernel (a
    torch whose kineto events carry no activity type) would count it as
    device work.  It also costs a tenth of one."""
    if torch.autograd._profiler_enabled() and \
            not torch.compiler.is_compiling():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


def host_ms_per_step(step: Callable, steps: int,
                     repeats: int = 1) -> List[float]:
    """Host-clock ms a step over ``steps`` back-to-back calls of ``step``,
    once a repeat.  Only for work that is done when it returns (CPU
    tensors): a CUDA step returns before the card has run it."""
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        out.append((time.perf_counter() - t0) * 1e3 / steps)
    return out


def events_ms_per_step(step: Callable, steps: int,
                       repeats: int = 1) -> List[float]:
    """Ms a step from CUDA events around ``steps`` back-to-back calls of
    ``step`` on the current stream, once a repeat: device work plus
    whatever gaps the host's launches leave between kernels.  Warm up
    first: a first call may build kernels or grow the allocator's pool."""
    out = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            step()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / steps)
    return out


def graph_ms_per_step(step: Callable, steps: int,
                      repeats: int = 1) -> List[float]:
    """Device ms a step with the host's launch overhead removed: ``steps``
    calls of ``step`` captured in one CUDA graph, CUDA events around each
    of ``repeats`` replays.  The kernels of a replay follow one another
    without the host, so what remains between them is the card's own gap
    (a few tenths of a microsecond a kernel on the H100).

    The step must be capturable: it may not synchronize with the host or
    copy from host memory (capture raises on either), and each replay
    runs the kernels it launched while captured, on the tensors it held
    then."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()  # capture wants a step already run on a side stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(steps):
            step()
    try:
        graph.replay()  # warm
        out = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / steps)
        return out
    finally:
        graph.reset()


def device_profile(fn: Callable, iters: int, tries: int = 3,
                   warm: bool = True) -> dict:
    """``torch.profiler`` over ``iters`` calls of ``fn``: the window's
    host ms a call, device ms a call summed over kernels, the device's
    busy share, and the kernels by device time (us a call).  Every call
    launches the same kernels, so a kernel counted a fractional number of
    times a call means the profiler lost events (``whole`` false).  A lost
    event or two leave a kernel's count within 10% of a whole number of
    launches a call; its time a call is then its mean launch's times that
    number, still the call's (``usable``).  Most events lost, or none
    recorded, is not usable: the window is taken again, up to ``tries``
    times.  ``lost_windows`` counts the windows that lost events.  With
    ``warm`` false the first window is the first call.  ``collective_ms``
    is the NCCL kernels' part of ``device_ms``: a collective's kernel runs
    until every rank has joined, so it holds the wait for the slowest
    rank as well as the transfer.

    On the H100 the profiler loses events in more windows the older the
    process: windows taken in the first two minutes of a process come
    whole, one taken after seven minutes kept about half of its kernels
    whatever the host waited around the calls.  Take the windows whose
    times are reported early."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
        torch.cuda.synchronize()
    for lost in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / iters
        kernels, whole, usable = {}, True, True
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0)
            # NCCL's op annotations ("nccl:all_to_all") span their kernels
            # on the device timeline: not kernels, and counted once already
            if (e.device_type == DeviceType.CUDA and us > 0
                    and not e.key.startswith("nccl:")):
                n = e.count / iters
                r = round(n)
                whole = whole and e.count % iters == 0
                usable = usable and r >= 1 and abs(n - r) <= 0.1 * r
                kernels[e.key] = (us / e.count * r if r else us / iters, n)
        whole, usable = whole and bool(kernels), usable and bool(kernels)
        if usable:
            break
    device_ms = sum(us for us, _ in kernels.values()) / 1e3
    collective_ms = sum(us for k, (us, _) in kernels.items()
                        if k.startswith("nccl")) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                collective_ms=collective_ms,
                busy_share=device_ms / wall_ms,
                launches=sum(n for _, n in kernels.values()),
                kernels=[[k[:70], us, n] for k, (us, n) in top[:12]],
                whole=whole, usable=usable, lost_windows=lost + (not whole))
