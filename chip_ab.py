"""Time the slab key step and the census kernel of two checkouts of the
port on one GPU, in turns.

    python3 chip_ab.py DIR_A DIR_B

Each DIR is the root of a checkout (for example a ``git archive`` of a
commit).  One process a turn, in the order A, B, B, A, imports
``opengpc_tpu_torch`` from its DIR, so it builds and runs that tree's
kernels, and prints one JSON line: for each case, the device
microseconds a call (``torch.profiler``, summed over the call's kernels,
with their launches a call) and the CUDA-event milliseconds a call.  The
cases are both slabs of the n = 1 sharded frame's key step at 436x1024
(``infer._key_image_slab`` on the dense ``make_pair``, zero forest) and
the census (``ops.fused.fused_census``) at 436x1024 and 2160x3840.  The
card's ``nvidia-smi`` name and power limit come first.  Exits non-zero
without a CUDA device or when a turn fails.
"""

import json
import os
import subprocess
import sys

CASES_ITERS = {"slab_pair_436x1024": 200, "census_436x1024": 200,
               "census_2160x3840": 50}


def profile_us(fn, iters):
    """Device us a call of ``fn`` summed over its kernels, and the kernels'
    launches a call, from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and getattr(e, "self_device_time_total", 0) > 0]
    return (sum(e.self_device_time_total for e in events) / iters,
            sum(e.count for e in events) / iters)


def events_ms(fn, iters):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def turn(tree):
    """One process's measurements of the port in ``tree``."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import torch.nn.functional as F

    import opengpc_tpu_torch
    from opengpc_tpu_torch import (InferenceSettings, load_forest,
                                   make_filter_mask)
    from opengpc_tpu_torch.infer import _key_image_slab
    from opengpc_tpu_torch.ops.fused import PAD, fused_census
    from opengpc_tpu_torch.utils import make_pair

    if not opengpc_tpu_torch.__file__.startswith(tree + os.sep):
        raise SystemExit(f"imported {opengpc_tpu_torch.__file__}, not {tree}")
    mask = make_filter_mask(load_forest(
        os.path.join(tree, "forests", "defaultZeroForest.txt")))
    settings = InferenceSettings(gradient_threshold=5, epipolar_mode=True)
    pair = torch.from_numpy(np.stack(make_pair(436, 1024, 16))).cuda()
    slabs = F.pad(pair, (0, 0, PAD, PAD))
    rng = np.random.default_rng(3)
    small, big = (torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8))
                  .cuda() for s in ((436, 1024), (2160, 3840)))
    fns = {"slab_pair_436x1024": lambda: _key_image_slab(
               slabs[0], slabs[1], mask, settings, 0, 436),
           "census_436x1024": lambda: fused_census(small),
           "census_2160x3840": lambda: fused_census(big)}
    out = {"tree": tree}
    for name, fn in fns.items():
        us, launches = profile_us(fn, CASES_ITERS[name] // 4)
        out[name] = dict(device_us=us, launches=launches,
                         events_ms=events_ms(fn, CASES_ITERS[name]))
    print(json.dumps(out), flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--turn":
        turn(sys.argv[2])
        return
    import torch

    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("chip_ab: no CUDA device visible")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    a, b = (os.path.abspath(t) for t in sys.argv[1:])
    for tree in (a, b, b, a):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--turn",
                        tree], check=True, cwd=tree)


if __name__ == "__main__":
    main()
