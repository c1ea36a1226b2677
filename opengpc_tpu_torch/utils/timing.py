"""Phase timing and profiling.

The reference's chrono tick helpers (``sysTick``/``tickToMs``,
inference.hpp:62-70) and a profiler capture, as ``opengpc_tpu.utils.timing``
has them:

* :class:`PhaseTimer` — named wall-clock phases, printable as the same
  style of per-phase ms report the reference prints (a copy).
* :func:`trace` — a ``torch.profiler`` capture (host and, where a CUDA
  device is present, device activity) written as a Chrome trace into a
  directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional


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
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
