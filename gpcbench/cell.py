"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the traced window's reduction.

The window is a closed loop.  Call i takes the pool's batch i mod n, and
the client keeps ``in_flight`` calls dispatched: after dispatching a
call it waits on the oldest once that many are outstanding.  Each call's
row counts are added into one device total, the consumer on the card,
read once after the window.  The window runs from the first call's
dispatch to the final synchronise after the last call, and the loop
dispatches no call after ``seconds`` have passed.  On a launch of several
ranks, rank 0's clock decides when to stop and the ranks agree on it
over a gloo group every ``Ranks.every`` calls, so every rank makes the
same calls.

``checked_pairs`` (k) pairs of the window are drawn from the seed,
stratified so that sample s is slot floor(s B / k) mod B of a call that
took batch s mod n: the checked pairs spread over the slots of a call and
over as many of the pool's batches as there are samples.  Within its stratum each sample's call is
drawn uniformly over the window by reservoir sampling.  Those calls'
outputs are kept on the card and compared with the reference after the
window closes and the memory peak is read.
"""

from __future__ import annotations

import collections
import contextlib
import json
import random
import sys
import time
import types

import numpy as np
import torch

from gpcbench import (check, forbidden_modules, generator, registry,
                      roofline, trace)
from gpcbench.reference import gpc


class Split:
    """Named set-up phases in seconds, in order."""

    def __init__(self):
        self.s = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.s[name] = self.s.get(name, 0.0) + time.perf_counter() - t


class Ranks:
    """This process's place in a launch of ranks (``gpcbench.run.launch``
    or ``torchrun``): the program's process group (NCCL on the card, gloo
    on the CPU) and a gloo group for the harness's own agreement, which
    never touches a card's stream."""

    def __init__(self, device):
        import torch.distributed as dist
        self.dist = dist
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device))
            dist.init_process_group("nccl", device_id=torch.device(device))
        else:
            dist.init_process_group("gloo")
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.ctl = dist.new_group(backend="gloo")

    every = 8  # calls between two agreements to stop

    def stop(self, flag: bool) -> bool:
        t = torch.tensor([int(flag)], dtype=torch.int32)
        self.dist.broadcast(t, 0, group=self.ctl)
        return bool(t.item())

    def barrier(self):
        self.dist.barrier(group=self.ctl)

    def gather(self, obj):
        out = [None] * self.world
        self.dist.all_gather_object(out, obj, group=self.ctl)
        return out

    def close(self):
        self.dist.destroy_process_group()


class One:
    """A single process, for the same calls."""

    rank, world, every = 0, 1, 1

    @staticmethod
    def stop(flag: bool) -> bool:
        return flag

    @staticmethod
    def barrier():
        pass

    @staticmethod
    def gather(obj):
        return [obj]

    @staticmethod
    def close():
        pass


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    """One run of a cell.  ``config`` and ``traffic`` are the parsed files,
    ``device`` the card (or ``cpu`` in tests), ``ranks`` a :class:`Ranks`
    or :class:`One`."""

    def __init__(self, config, traffic, device, ranks, split,
                 root=registry.HERE):
        self.config, self.traffic = config, traffic
        self.device, self.ranks, self.split = torch.device(device), ranks, split
        self.cuda = self.device.type == "cuda"
        self.root = root
        if traffic["delivery"] != "card":
            raise ValueError(f"delivery {traffic['delivery']!r}: this harness "
                             "leaves every output on the card")

    # set-up --------------------------------------------------------------
    def setup(self, seed: int):
        sp = self.split
        with sp("imports"):
            import opengpc_tpu_torch.infer  # noqa: F401  the port's imports
            self.entry_mod = registry.entry(self.traffic["entry"], self.root)
        with sp("cuda_init"):
            if self.cuda:
                torch.cuda.set_device(self.device)
                torch.zeros(1, device=self.device)
                _sync(self.device)
        with sp("library"):
            self.entry_mod.load_kernels(self.device)
        with sp("forest"):
            self.entry = self.entry_mod.build(self)
        self.make_inputs(seed)
        with sp("first_call"):
            self.entry(self.calls[0])
            _sync(self.device)
        with sp("warmup"):
            self.warm()
            self.ranks.barrier()

    def make_inputs(self, seed: int):
        cfg, tr = self.config, self.traffic
        with self.split("inputs"):
            self.lefts, self.rights, _ = generator.make_pool(
                seed, tr["pool_pairs"], cfg["height"], cfg["width"],
                tr["density"], tr["disparity"], self.device,
                vertical=tr.get("vertical"))
            self.calls = self.entry.prepare(self.lefts, self.rights)
            _sync(self.device)

    def warm(self):
        """The window's pattern before the window: as many outputs alive
        at once as it can hold, so the allocator has its blocks."""
        total = torch.zeros((), dtype=torch.int64, device=self.device)
        n = self.traffic["in_flight"] + self.traffic["checked_pairs"] + 1
        outs = []
        for i in range(n):
            outs.append(self.entry(self.calls[i % len(self.calls)]))
            total += self.entry.counts(outs[-1]).sum(dtype=torch.int64)
        _sync(self.device)
        del outs
        total.item()

    # the window ----------------------------------------------------------
    def window(self, seconds: float, seed: int, spans: trace.Spans):
        tr, entry, ranks = self.traffic, self.entry, self.ranks
        in_flight, k = tr["in_flight"], tr["checked_pairs"]
        rng = random.Random(seed ^ 0x5EEDC0DE)
        total = torch.zeros((), dtype=torch.int64, device=self.device)
        pending = collections.deque()
        call_ms, batches = [], []
        n = len(self.calls)
        # sample s: batch s mod n, its slot spread over the batch
        slot = [(s_ * tr["batch"] // k) % tr["batch"] for s_ in range(k)]
        strata = [[] for _ in range(n)]
        for s_ in range(k):
            strata[s_ % n].append(s_)
        samples, seen = [None] * k, [0] * n
        ranks.barrier()
        i = 0
        with spans("window"):
            t_start = time.perf_counter()
            while True:
                if i % ranks.every == 0:
                    with spans("control"):
                        if ranks.stop(time.perf_counter() - t_start
                                      >= seconds):
                            break
                b = i % n
                t_a = time.perf_counter()
                with spans("enqueue"):
                    out = entry(self.calls[b])
                with spans("consume"):
                    total += entry.counts(out).sum(dtype=torch.int64)
                ev = None
                if self.cuda:
                    ev = torch.cuda.Event()
                    ev.record()
                pending.append((ev, t_a))
                batches.append(b)
                seen[b] += 1
                for s_ in strata[b]:
                    if rng.randrange(seen[b]) == 0:
                        samples[s_] = (i, b, slot[s_], out)
                del out
                if len(pending) >= in_flight:
                    ev0, ta0 = pending.popleft()
                    with spans("wait"):
                        if ev0 is not None:
                            ev0.synchronize()
                    call_ms.append((time.perf_counter() - ta0) * 1e3)
                i += 1
            with spans("wait"):
                _sync(self.device)
            ranks.barrier()
            t_end = time.perf_counter()
        return types.SimpleNamespace(
            seconds=t_end - t_start, calls=i,
            pairs=i * tr["batch"], call_ms=call_ms if in_flight == 1 else [],
            batches=batches, total=total, samples=samples,
            strata=len({(s_ % n, slot[s_]) for s_ in range(k)}))

    # after the window ----------------------------------------------------
    def key_least_s(self, batches) -> list:
        """The least seconds of each traced call's key launches, summed
        over the launches of a call (``entry.key_launch()``: one
        ``(pairs, rows read, rows written, first row, first pair)`` a
        launch), each from its shapes and the candidates of the rows it
        keys."""
        thr, bsz = self.config["gradient_threshold"], self.traffic["batch"]
        tests = len(gpc.parse_forest(open(self.config["forest_path"]).read()))
        rows = sum(torch.cat([roofline.candidate_rows(imgs[i:i + 4], thr)
                              for i in range(0, len(imgs), 4)])
                   for imgs in (self.lefts, self.rights))
        least = [0.0] * len(self.calls)
        for pairs, rows_read, rows_out, y0, f0 in self.entry.key_launch():
            cand = rows[:, y0:y0 + rows_out]
            for b in range(len(self.calls)):
                least[b] += roofline.least_s(
                    pairs, rows_read, rows_out, self.config["width"],
                    int(cand[b * bsz + f0:b * bsz + f0 + pairs].sum()),
                    tests)[0]
        return [least[b] for b in batches]

    def compare(self, samples) -> dict:
        """Each sampled pair as its call left it, on rank 0's host, against
        the reference on the pair's inputs; every rank takes part in the
        gathering of the sampled calls, only rank 0 compares."""
        host = {}
        for i, b, j, out in filter(None, samples):
            if i not in host:
                host[i] = self.entry.gather(out)
        picked = sorted({(i, b, j) for i, b, j, _ in filter(None, samples)})
        del samples
        readings = {}
        if self.ranks.rank != 0:
            return readings
        tests = gpc.parse_forest(open(self.config["forest_path"]).read())
        for i, b, j in picked:
            p = b * self.traffic["batch"] + j
            lefts = self.lefts[p:p + 1].cpu().numpy()
            rights = self.rights[p:p + 1].cpu().numpy()
            buf, counts = check.take(host[i], slice(j, j + 1))
            check.add(readings, check.compare(buf, counts, lefts, rights,
                                              tests, self.config))
        return readings


def run(name, config, traffic, seed, seconds, trace_on, device, ranks,
        split, t0, bench, root=registry.HERE, log=sys.stderr):
    """The whole run: returns the result line's dict on rank 0, None on
    the other ranks.  ``t0`` is the process start on ``time.perf_counter``'s
    clock, or a callable that gives the set-up seconds at the first
    call."""
    r = Run(config, traffic, device, ranks, split, root)
    r.setup(seed)
    prof = None
    if trace_on:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if r.cuda:
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    setup_s = t0() if callable(t0) else time.perf_counter() - t0
    w = r.window(seconds, seed, trace.Spans(trace_on))
    summary = None
    if prof is not None:
        prof.__exit__(None, None, None)
        summary = trace.reduce(prof.profiler.kineto_results.events(),
                               r.entry_mod.KEY_OP)
        del prof
    mem = torch.cuda.max_memory_allocated(r.device) if r.cuda else 0
    total = int(w.total.item())
    if summary is not None:
        summary["key_least_s"] = sum(r.key_least_s(w.batches))
        summary["key_launches_per_call"] = len(r.entry.key_launch())
        summary["pairs"] = w.pairs
        print("trace_summary " + json.dumps(
            {k: v for k, v in summary.items()
             if k not in ("device_ops", "enqueue_ms")}), file=log)
    gathered = ranks.gather(dict(mem=mem, total=total, summary=summary))
    t = time.perf_counter()
    readings = r.compare(w.samples)
    readings["compare_s"] = time.perf_counter() - t
    w.samples = None
    bad = forbidden_modules()
    if ranks.rank != 0:
        return None, bad
    min_pairs = w.strata
    ctx = types.SimpleNamespace(
        cell=name, config=config, traffic=traffic, window=w, setup_s=setup_s,
        ranks=[g["summary"] for g in gathered] if trace_on else None)
    section = "per_layer" if trace_on else "end_to_end"
    metrics = {}
    for m in registry.cell_metrics(bench, section, name):
        v = registry.metric(m["name"], root).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if r.cuda else "cpu",
           "kind": (torch.cuda.get_device_name(r.device) if r.cuda
                    else "cpu"),
           "count": ranks.world,
           "memory_peak_bytes": max(g["mem"] for g in gathered)}
    result = {"correct": check.verdict(readings, min_pairs),
              "attempted": w.pairs,
              "failed": readings.get("failed_pairs", 0),
              "metrics": metrics, "device": dev}
    if trace_on:
        sums = ctx.ranks
        dev["busy_s"] = float(np.mean([s["busy_s"] for s in sums]))
        dev["window_s"] = sums[0]["window_s"]
        result["breakdown"] = {
            "device_ops": trace.top(trace.merge([s["device_ops"]
                                                 for s in sums])),
            "idle_gaps": trace.top(trace.merge([s["idle_by_host"]
                                                for s in sums]))}
    print("window " + json.dumps(
        {"seconds": w.seconds, "calls": w.calls,
         "supports_consumed": sum(g["total"] for g in gathered),
         "readings": readings}), file=log)
    print("setup_split " + json.dumps(dict(split.s, setup_s=setup_s)),
          file=log)
    result["checks"] = check.checks(readings, min_pairs)
    return result, bad
