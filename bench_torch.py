"""The benchmark of the PyTorch/CUDA port: ``bench.py``'s 20 records and
every one of its gates, through ``opengpc_tpu_torch`` on one card.

    python3 bench_torch.py                  # on the card (the default)
    python3 bench_torch.py --device cpu     # the CPU twins, host clock

Each record is one configuration of ``bench.py`` (same metric name, unit
and scene) run through its counterpart in the port:

  1. the headline, ``sintel_sparsematch_throughput``: the masked contract
     (``infer._sparsematch_masked_impl``) on the dense ``make_pair(436,
     1024, 16)`` with the zero forest at the CLI's settings, gated on the
     true disparity, the native oracle and a multi-plane scene;
  2. the flat, row-form, low- and mid-density masked and compact, global,
     global-compact, tau-forest and 17-test contracts, each gated on set
     equality with the oracle-gated flat set (the global ones against the
     oracle in global mode);
  3. mining (host numpy) and the trainer's split scorer;
  4. the B = 4 folds, the 3-level pyramids, densify and the batched
     pyramid.

Real MPI-Sintel is not needed: the scenes are synthetic, with known
disparity (``opengpc_tpu_torch.utils.scenes``).

Timing.  A step runs the configuration once and adds every output buffer
into one device accumulator (the counterpart of ``bench.py``'s steps,
which consume every output), read once after the windows.  On the card a
record's ``value`` is the median over ``repeats`` windows of CUDA events
around ``steps`` back-to-back steps (``events_ms``, the quartiles ``q1``
and ``q3`` in the value's unit): what a caller's loop sustains, launch
overhead included.  ``device_ms`` beside it is the device time of a step
without the host's launch overhead: the steps captured in one CUDA graph
and replayed (``ms_source`` "cuda-graph"), or, for a step that copies
from the host, its kernels' sum in a ``torch.profiler`` window
(``ms_source`` "profiler").  ``launches`` counts each kernel of the port
in one step.  With ``--device cpu`` every time is the host clock's
(``timer`` "host", ``host_ms``) and ``device_ms`` is null.
``OGPC_BENCH_SMOKE=1`` runs 1 window of 3 steps (``OGPC_BENCH_FAST=1``: 3
of 10) at the same sizes and with every gate.

Output contract, as ``bench.py``'s: the headline record goes to stdout as
soon as it is measured, the other records to stderr, and the headline is
printed again as the very last line, also when a later record fails; a
failed gate exits non-zero.  The oracle gate (``cpp/build/oracle``, built
with ``make`` when missing) never skips: an oracle that cannot be built
fails the run.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
H, W = 436, 1024        # Sintel frame size
TRUE_DISP = 16
BATCH = 4
HEADLINE = "sintel_sparsematch_throughput"
# the kernels of the port, by their wrappers' launch counters
KERNEL_COUNTERS = {
    "fused_keys": ("opengpc_tpu_torch.ops.fused", "fused_keys"),
    "fused_codes": ("opengpc_tpu_torch.ops.fused", "fused_codes"),
    "fused_keys_slab": ("opengpc_tpu_torch.ops.fused", "fused_keys_slab"),
    "fused_census": ("opengpc_tpu_torch.ops.fused", "fused_census"),
    "fused_sparsematch_rows": ("opengpc_tpu_torch.ops.fused_match",
                               "fused_sparsematch_rows"),
    "bitonic_sort_rows": ("opengpc_tpu_torch.ops.sort", "bitonic_sort_rows"),
    "row_sort": ("opengpc_tpu_torch.ops.sort", "row_sort"),
}


def bench_py_metrics(repo=REPO):
    """``bench.py``'s metric names, read from its source (it imports JAX,
    so it is parsed, never imported): the first argument of every
    ``_aux`` call and the headline record's ``metric``.  This bench prints
    exactly these."""
    import ast

    with open(os.path.join(repo, "bench.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "_aux"):
            names.add(node.args[0].value)
        if isinstance(node, ast.Dict):
            names.update(v.value for k, v in zip(node.keys, node.values)
                         if isinstance(k, ast.Constant) and k.value == "metric"
                         and isinstance(v, ast.Constant))
    return names


def _env_flag(name):
    # tolerant parse: "", "0", "false", "no" are off; anything else
    # (1/true/yes/...) is on, so a typo cannot crash the bench before any
    # output
    return os.environ.get(name, "0").strip().lower() not in (
        "", "0", "false", "no")


def _windows():
    """(steps a window, windows) from the environment: smoke 3 x 1, fast
    10 x 3, else 50 x 9."""
    if _env_flag("OGPC_BENCH_SMOKE"):
        return 3, 1
    if _env_flag("OGPC_BENCH_FAST"):
        return 10, 3
    return 50, 9


class GateError(RuntimeError):
    """A correctness gate failed: the run exits non-zero."""


def _gate(ok, message):
    if not ok:
        raise GateError(message)


def _rows(a):
    """The distinct rows of an (n, k) integer array, sorted."""
    a = np.asarray(a, np.int64)
    return np.unique(a.reshape(len(a), -1), axis=0)


def _same_set(a, b, message):
    _gate(np.array_equal(_rows(a), _rows(b)), message)


def _support_keys(rows):
    """One int64 a distinct (x, y, d) support: x, y < 2^21, |d| < 2^20."""
    r = np.asarray(rows, np.int64).reshape(-1, 3)
    return np.unique((r[:, 0] << 42) | (r[:, 1] << 21) | (r[:, 2] + (1 << 20)))


def oracle_binary(repo=REPO):
    """``cpp/build/oracle`` of ``repo``, built with ``make`` when missing;
    raises ``GateError`` when it cannot be built (the gate never skips)."""
    path = os.path.join(repo, "cpp", "build", "oracle")
    if not os.path.exists(path):
        r = subprocess.run(["make", "-C", os.path.join(repo, "cpp"),
                            "build/oracle"], capture_output=True, text=True)
        if r.returncode != 0 or not os.path.exists(path):
            raise GateError(
                f"the oracle gate cannot run: building {path} failed "
                f"(make exit {r.returncode}): {r.stdout[-400:]}"
                f"{r.stderr[-400:]}")
    return path


def oracle_supports(oracle, left, right, settings, forest_file,
                    epipolar=True):
    """The native oracle's (n, 3) supports of one pair."""
    from opengpc_tpu_torch.io.raw import write_raw

    with tempfile.TemporaryDirectory() as td:
        lp, rp, op = (os.path.join(td, n) for n in ("l.raw", "r.raw", "o.txt"))
        write_raw(lp, left)
        write_raw(rp, right)
        subprocess.run(
            [oracle, "sparsematch", os.path.join(REPO, "forests", forest_file),
             lp, rp, op, str(settings.gradient_threshold),
             str(settings.vertical_tolerance), str(settings.disp_high),
             str(int(epipolar)), "0"], check=True)
        want = np.loadtxt(op, dtype=np.int64, ndmin=2)
    return want.reshape(-1, 3)


def gate_oracle_subset(got, want, capacity, label):
    """``bench.py``'s oracle gate: every support is one of the oracle's,
    and they cover at least 99.9 % of the oracle's (of the capacity, where
    that is smaller)."""
    got, want = _support_keys(got), _support_keys(want)
    foreign = np.setdiff1d(got, want, assume_unique=True).size
    _gate(foreign == 0, f"{label}: {foreign} supports not in the oracle set")
    _gate(got.size >= min(want.size, capacity) * 0.999,
          f"{label}: only {got.size} of {want.size} oracle supports "
          "reproduced")
    print(f"oracle check [{label}]: {got.size}/{want.size} supports, "
          "exact subset", file=sys.stderr, flush=True)


def _accuracy(supp):
    return float((np.asarray(supp)[:, 2] == TRUE_DISP).mean())


def _leaves(out):
    if isinstance(out, (tuple, list)):
        for o in out:
            yield from _leaves(o)
    elif isinstance(out, torch.Tensor):
        yield out


def _device_line(device):
    """The card as ``nvidia-smi`` names it with its power limit, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


class Bench:
    """The run's device, its windows, its step accumulator and how it
    times a step."""

    def __init__(self, device, steps, repeats):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.steps, self.repeats = steps, repeats
        self.acc = torch.zeros((), dtype=torch.int64, device=self.device)

    def put(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def consume(self, out):
        """Add every output buffer of a step into the accumulator."""
        for t in _leaves(out):
            self.acc.add_(t.sum(dtype=torch.int64) if t.dtype != torch.float32
                          else t.sum().to(torch.int64))

    def _launches(self, step):
        """Each kernel's launches in one step (the first, so also the
        warm-up)."""
        import importlib

        wrappers = {name: getattr(importlib.import_module(mod), attr)
                    for name, (mod, attr) in KERNEL_COUNTERS.items()}
        for w in wrappers.values():
            w.launches = 0
        step()
        if self.cuda:
            torch.cuda.synchronize()
        return {name: w.launches for name, w in wrappers.items()}

    def measure(self, fn, graph=True):
        """Time ``fn()``'s step: {launches, ms (a step, each window),
        device_ms, ms_source, timer}.  ``graph`` false: the step copies
        from the host, so its device time is the profiler's kernel sum."""
        from opengpc_tpu_torch.utils.timing import (device_profile,
                                                    events_ms_per_step,
                                                    graph_ms_per_step,
                                                    host_ms_per_step)

        def step():
            self.consume(fn())

        launches = self._launches(step)
        if not self.cuda:
            ms = host_ms_per_step(step, self.steps, self.repeats)
            out = dict(ms=ms, device_ms=None, ms_source="host", timer="host")
        else:
            ms = events_ms_per_step(step, self.steps, self.repeats)
            if graph:
                dev = float(np.median(graph_ms_per_step(step, self.steps,
                                                        self.repeats)))
                src = "cuda-graph"
            else:
                prof = device_profile(step, self.steps)
                dev = prof["device_ms"] if prof["usable"] else None
                src = "profiler"
            out = dict(ms=ms, device_ms=dev, ms_source=src,
                       timer="cuda-events")
        int(self.acc)  # the accumulator, read once after the windows
        return dict(out, launches=launches)

    def host_measure(self, ms):
        """A step timed once on the host clock (host work, no device)."""
        return dict(ms=[ms], device_ms=None, ms_source="host", timer="host",
                    launches=dict.fromkeys(KERNEL_COUNTERS, 0))


def make_record(metric, unit, note, m, work=None):
    """A record from a measurement: ``work`` a step in the unit's
    numerator (Mpix, triplets, G evals) for a rate, None for a time in
    ms.  ``q1`` and ``q3`` are the windows' quartiles in the unit."""
    ms = np.asarray(m["ms"], np.float64)
    vals = ms if work is None else work / (np.maximum(ms, 1e-9) / 1e3)
    q1, med, q3 = np.percentile(vals, [25, 50, 75])
    step_ms = float(np.median(ms))
    host = m["timer"] == "host"
    return {"metric": metric, "value": float(med), "unit": unit,
            "note": note, "events_ms": None if host else step_ms,
            "host_ms": step_ms if host else None, "q1": float(q1),
            "q3": float(q3), "device_ms": m["device_ms"],
            "ms_source": m["ms_source"], "timer": m["timer"],
            "launches": m["launches"], "windows": len(ms)}


def _aux(rec):
    print(json.dumps(rec), file=sys.stderr, flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: the CPU twins on the host "
                   "clock")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench_torch: no CUDA device visible; run with --device cpu "
              "for the CPU twins on the host clock", file=sys.stderr)
        return 1
    steps, repeats = _windows()
    bench = Bench(device, steps, repeats)
    card = _device_line(device)
    headline = {}
    try:
        _run(bench, card, headline)
    finally:
        if headline:
            print(json.dumps(headline), flush=True)
    return 0


def _run(bench, card, headline):
    """Every configuration and gate; fills ``headline`` as soon as it is
    measured (and prints it), so that ``main`` prints it again last."""
    from opengpc_tpu_torch.config import InferenceSettings
    from opengpc_tpu_torch.forest import load_forest, make_filter_mask
    from opengpc_tpu_torch.infer import (
        _sparsematch_global_compact_impl, _sparsematch_global_rows_impl,
        _sparsematch_impl, _sparsematch_masked_compact_impl,
        _sparsematch_masked_impl, _sparsematch_rows_impl, build_sparsematch,
        global_row_supports_to_numpy, masked_supports_to_numpy,
        row_supports_to_numpy, supports_to_numpy)
    from opengpc_tpu_torch.metrics import support_precision
    from opengpc_tpu_torch.ops.preprocess import candidate_mask, sobel3
    from opengpc_tpu_torch.utils.scenes import (make_pair, make_scene,
                                                make_sparse_pair)

    t_start = time.perf_counter()
    dev, put = bench.device, bench.put
    oracle = oracle_binary()
    settings = InferenceSettings(gradient_threshold=5, vertical_tolerance=0,
                                 disp_high=128, epipolar_mode=True,
                                 capacity=1 << 19)
    gsettings = dataclasses.replace(settings, epipolar_mode=False)
    npix = 2 * H * W / 1e6
    left, right = make_pair(H, W, TRUE_DISP)
    l, r = put(left), put(right)

    def check_oracle(lh, rh, supp, s, forest_file, label, epipolar=True):
        gate_oracle_subset(supp, oracle_supports(oracle, lh, rh, s,
                                                 forest_file, epipolar),
                           s.capacity, label)

    # ------------------------------------------------------------------
    # config 1: the zero forest on one pair, gated on the true disparity,
    # the oracle and a multi-plane scene
    # ------------------------------------------------------------------
    forest = load_forest(os.path.join(REPO, "forests",
                                      "defaultZeroForest.txt"))
    mask = make_filter_mask(forest)
    match = build_sparsematch(forest, settings, device=dev)
    supp = supports_to_numpy(*match(l, r))
    _gate(len(supp) > 1000, f"too few supports: {len(supp)}")
    _gate(_accuracy(supp) > 0.99,
          f"support accuracy {_accuracy(supp):.3f} < 0.99")
    check_oracle(left, right, supp, settings, "defaultZeroForest.txt",
                 "config1 zero")

    mp_left, mp_right, mp_disp, mp_occ = make_scene(
        np.random.default_rng(0), H, W)
    mp_supp = supports_to_numpy(*match(put(mp_left), put(mp_right)))
    _gate(len(mp_supp) > 1000, f"multi-plane: too few supports "
          f"{len(mp_supp)}")
    prec, n_valid = support_precision(mp_supp, mp_disp, mp_occ == 0, tol=0.0)
    _gate(prec > 0.97, f"multi-plane precision {prec:.3f} <= 0.97")
    print(f"multi-plane gate: {n_valid} non-occluded supports, "
          f"exact-disparity precision {prec:.4f}", file=sys.stderr)
    check_oracle(mp_left, mp_right, mp_supp, settings,
                 "defaultZeroForest.txt", "config1 multi-plane")

    flat_m = bench.measure(lambda: _sparsematch_impl(l, r, mask, settings))

    # the row-form contract: the same set in per-row buffers
    (rxs, rds), rcounts = _sparsematch_rows_impl(l, r, mask, settings)
    _same_set(row_supports_to_numpy(rxs, rds, rcounts), supp,
              "row-form support set != flat support set")
    rows_m = bench.measure(lambda: _sparsematch_rows_impl(l, r, mask,
                                                          settings))
    _aux(make_record("flat_buffer_throughput", "Mpix/s",
                     "config 1 with the flat fixed-capacity buffer contract "
                     "(infer._sparsematch_impl)", flat_m, npix))
    _aux(make_record("rowform_throughput", "Mpix/s",
                     "config 1 with the row-form contract "
                     "(infer._sparsematch_rows_impl)", rows_m, npix))

    # the masked contract, the headline: decoded set equal to the flat
    # contract's (itself oracle-gated above)
    def masked_set(lt, rt, m=mask):
        buf, counts = _sparsematch_masked_impl(lt, rt, m, settings)
        return masked_supports_to_numpy(buf, counts, settings.disp_high)

    _same_set(masked_set(l, r), supp, "masked support set != flat support "
              "set")
    masked_m = bench.measure(lambda: _sparsematch_masked_impl(l, r, mask,
                                                              settings))
    headline.update(make_record(
        HEADLINE, "Mpix/s", "config 1: the masked contract "
        "(infer._sparsematch_masked_impl), every output buffer consumed, "
        "the decoded set equal to the oracle-gated flat set", masked_m,
        npix), device=card)
    print(json.dumps(headline), flush=True)

    # ------------------------------------------------------------------
    # low density (~15 % candidates) and mid density (~35 %): the masked
    # contract and the chunk-compacted one
    # ------------------------------------------------------------------
    def density(img):
        return float(candidate_mask(sobel3(put(img), 5)).float().mean())

    scenes = {}
    for tag, dens in (("lowdensity", 0.15), ("middensity", 0.35)):
        sl, sr = make_sparse_pair(H, W, TRUE_DISP, density=dens)
        slt, srt = put(sl), put(sr)
        scenes[tag] = (sl, sr, slt, srt)
        sdens = density(sl)
        s_supp = supports_to_numpy(*match(slt, srt))
        _gate(len(s_supp) > 1000, f"{tag}: too few supports {len(s_supp)}")
        _gate(_accuracy(s_supp) > 0.99,
              f"{tag} support accuracy {_accuracy(s_supp):.3f}")
        check_oracle(sl, sr, s_supp, settings, "defaultZeroForest.txt",
                     f"config1 {tag}")
        _same_set(masked_set(slt, srt), s_supp, f"{tag} masked set != flat "
                  "set")
        m_masked = bench.measure(lambda: _sparsematch_masked_impl(
            slt, srt, mask, settings))
        cbuf, ccounts, covf = _sparsematch_masked_compact_impl(
            slt, srt, mask, settings, 128, 64)
        ovf = bool(covf)
        if tag == "lowdensity":
            _gate(not ovf, "low-density scene tripped overflow")
            _same_set(masked_supports_to_numpy(cbuf, ccounts,
                                               settings.disp_high), s_supp,
                      "compact masked set != flat set")
        m_compact = bench.measure(lambda: _sparsematch_masked_compact_impl(
            slt, srt, mask, settings, 128, 64))
        _aux(make_record(
            f"{tag}_sparsematch_throughput", "Mpix/s",
            f"masked contract on a {sdens:.2f}-candidate-density scene "
            f"({len(s_supp)} supports; the headline scene is 0.79-dense), "
            "oracle-gated", m_masked, npix))
        extra = ("" if tag == "lowdensity" else
                 f"; when it overflows this is what a tripped auto policy "
                 f"pays before the full-width re-run (+"
                 f"{100 * np.median(m_compact['ms']) / np.median(m_masked['ms']) - 100:.0f}"
                 f"% of a masked step by events)")
        _aux(make_record(
            f"{tag}_compact_throughput", "Mpix/s",
            f"chunk-compacted masked contract (S=128, K=64) on the "
            f"{sdens:.2f}-density scene (overflow={ovf}), "
            f"{'set-equality gated' if tag == 'lowdensity' else 'timed'}"
            + extra, m_compact, npix))
    sl, sr, slt, srt = scenes["lowdensity"]

    # ------------------------------------------------------------------
    # global (non-epipolar) mode, the reference's default settings path,
    # on the segmented global row-form contract; its compact form on the
    # low-density scene
    # ------------------------------------------------------------------
    (gxs, gys, gds), gcounts = _sparsematch_global_rows_impl(l, r, mask,
                                                             gsettings)
    gsupp = global_row_supports_to_numpy(gxs, gys, gds, gcounts)
    _gate(_accuracy(gsupp) > 0.99,
          f"global support accuracy {_accuracy(gsupp):.3f}")
    check_oracle(left, right, gsupp, gsettings, "defaultZeroForest.txt",
                 "global zero", epipolar=False)
    _aux(make_record(
        "global_sparsematch_throughput", "Mpix/s",
        "global (non-epipolar) mode, segmented row-form contract, "
        "oracle-gated", bench.measure(
            lambda: _sparsematch_global_rows_impl(l, r, mask, gsettings)),
        npix))

    (gcx, gcy, gcd), gcc, gcovf = _sparsematch_global_compact_impl(
        slt, srt, mask, gsettings, 512, 128)
    _gate(not bool(gcovf), "low-density scene tripped the global-compact "
          "overflow")
    (gsx, gsy, gsd), gsc = _sparsematch_global_rows_impl(slt, srt, mask,
                                                         gsettings)
    _same_set(global_row_supports_to_numpy(gcx, gcy, gcd, gcc),
              global_row_supports_to_numpy(gsx, gsy, gsd, gsc),
              "global-compact set != global set")
    _aux(make_record(
        "lowdensity_global_compact_throughput", "Mpix/s",
        "chunk-compacted global contract (S=512, K=128) on the low-density "
        "scene, overflow-guarded, set-equality gated", bench.measure(
            lambda: _sparsematch_global_compact_impl(
                slt, srt, mask, gsettings, 512, 128)), npix))

    # ------------------------------------------------------------------
    # config 2: the tau forest, on the masked contract
    # ------------------------------------------------------------------
    tau_forest = load_forest(os.path.join(REPO, "forests",
                                          "defaultTauForest.txt"))
    tau_mask = make_filter_mask(tau_forest)
    tau_supp = supports_to_numpy(*build_sparsematch(tau_forest, settings,
                                                    device=dev)(l, r))
    _gate(_accuracy(tau_supp) > 0.99,
          f"tau support accuracy {_accuracy(tau_supp):.3f}")
    check_oracle(left, right, tau_supp, settings, "defaultTauForest.txt",
                 "config2 tau")
    _same_set(masked_set(l, r, tau_mask), tau_supp,
              "tau masked support set != tau flat support set")
    _aux(make_record(
        "tau_sparsematch_throughput", "Mpix/s",
        "config 2: defaultTauForest on the masked contract (decode gated "
        "against the oracle-gated flat tau set)", bench.measure(
            lambda: _sparsematch_masked_impl(l, r, tau_mask, settings)),
        npix))

    # ------------------------------------------------------------------
    # the 17-test truncated zero forest: the single-operand packed sort
    # ------------------------------------------------------------------
    mask17 = make_filter_mask(forest, max_tests=17)
    _gate(mask17.num_tests == 17, f"truncated mask has {mask17.num_tests} "
          "tests")
    sf_supp = supports_to_numpy(*build_sparsematch(mask17, settings,
                                                   device=dev)(l, r))
    _gate(_accuracy(sf_supp) > 0.99,
          f"small-forest support accuracy {_accuracy(sf_supp):.3f}")
    _same_set(masked_set(l, r, mask17), sf_supp,
              "small-forest masked set != flat set")
    _aux(make_record(
        "smallforest_sparsematch_throughput", "Mpix/s",
        "17-test truncated zero forest on the masked contract, the "
        "single-operand packed sort, set-equality gated", bench.measure(
            lambda: _sparsematch_masked_impl(l, r, mask17, settings)), npix))

    _mining(bench)
    _training(bench)
    _folds_and_pyramids(bench, settings, forest, mask, (left, right, l, r),
                        (slt, srt), match)
    print(f"bench_torch: {time.perf_counter() - t_start:.1f} s on {card}, "
          f"{bench.steps} steps x {bench.repeats} windows a record",
          file=sys.stderr, flush=True)


def _mining(bench):
    """config 4: ground-truth mining on the host (numpy, as JAX's), gated
    on keypoint correctness against the scene's exact warp."""
    from opengpc_tpu_torch.mine import extract_triplets, mine_stereo_pair
    from opengpc_tpu_torch.utils.scenes import make_scene

    rng = np.random.default_rng(1)
    m_left, m_right, m_disp, m_occ = make_scene(rng, H, W)
    oof = np.zeros((H, W), np.uint8)
    n_trip = 2000
    t0 = time.perf_counter()
    kl, kr, kn = mine_stereo_pair(m_disp.astype(np.float64), m_occ, oof,
                                  n_trip, 10, 20, rng)
    trips = extract_triplets(m_left, m_right, kl, kr, kn)
    mine_ms = (time.perf_counter() - t0) * 1e3
    ok = (m_right[kr[:, 1], kr[:, 0]] == m_left[kl[:, 1], kl[:, 0]]).mean()
    _gate(ok > 0.999, f"mining keypoint correctness {ok:.4f}")
    _gate(len(trips) >= 0.9 * n_trip,
          f"mining gave {len(trips)} of {n_trip} triplets")
    _aux(make_record("mining_triplets_per_s", "triplets/s",
                     "config 4: extract (mine_stereo_pair + 27x27 patch "
                     "crops, host numpy), timed once",
                     bench.host_measure(mine_ms), len(trips)))


def _training(bench):
    """config 5: the trainer's split scorer, gated on every count row
    summing to N."""
    from opengpc_tpu_torch.train import _score_level, sample_candidates

    n_tr, num_taus = 32768, 20
    rng2 = np.random.default_rng(2)
    ref = rng2.integers(0, 256, (n_tr, 729))
    pos = np.clip(ref + rng2.integers(-8, 9, (n_tr, 729)), 0, 255)
    neg = rng2.integers(0, 256, (n_tr, 729))
    patches = bench.put(np.stack([ref, pos, neg], axis=1).astype(np.uint8))
    cand = sample_candidates(rng2, 0, 10).astype(np.int32)
    ones = torch.ones((n_tr,), dtype=torch.bool, device=bench.device)

    def score():
        return _score_level(patches, cand, -10, num_taus, ones, ones, ones)

    counts0 = score().cpu().numpy()
    _gate(bool((counts0.sum(axis=-1) == n_tr).all()), "scored counts != N")
    # the scorer takes its candidates from the host, as the trainer does:
    # a copy from host memory, which a CUDA graph cannot capture
    _aux(make_record(
        "train_split_evals_per_s", "G evals/s",
        "config 5: the split scorer (train._score_level), 32k triplets x "
        "10 resamples x 20 taus", bench.measure(score, graph=False),
        n_tr * 10 * num_taus / 1e9))


def _folds_and_pyramids(bench, settings, forest, mask, dense, sparse, match):
    """config 3: the B = 4 folds, the 3-level pyramids, densify and the
    batched pyramid."""
    from opengpc_tpu_torch.densify import _densify_from_masked
    from opengpc_tpu_torch.infer import (_sparsematch_masked_impl,
                                         _sparsematch_rows_impl,
                                         masked_supports_to_numpy,
                                         row_supports_to_numpy,
                                         supports_to_numpy)
    from opengpc_tpu_torch.pyramid import (build_pyramid_sparsematch,
                                           build_pyramid_sparsematch_compact,
                                           pyramid_supports_to_numpy)
    from opengpc_tpu_torch.utils.scenes import make_pair

    dev, put = bench.device, bench.put
    _, _, l, r = dense
    slt, srt = sparse
    pairs = [make_pair(H, W, TRUE_DISP, seed=100 + b) for b in range(BATCH)]
    lb = put(np.stack([p[0] for p in pairs]))
    rb = put(np.stack([p[1] for p in pairs]))
    bpix = 2 * BATCH * H * W / 1e6

    # the batch folded into one (B*H, 2W) row sort: pair 0 decodes to the
    # single-pair flat set
    (bxs, bds), bcounts = _sparsematch_rows_impl(lb, rb, mask, settings)
    s0 = row_supports_to_numpy(bxs[0], bds[0], bcounts[0])
    flat0 = supports_to_numpy(*match(lb[0], rb[0]))
    _same_set(s0, flat0, "stacked batch supports != single-pair supports")
    _gate(_accuracy(s0) > 0.99,
          f"batched pair-0 accuracy {_accuracy(s0):.3f}")
    _aux(make_record(
        "batched_rows_throughput", "Mpix/s",
        f"config 3: B={BATCH} folded into one (B*H, 2W) row sort, "
        "aggregate per card", bench.measure(
            lambda: _sparsematch_rows_impl(lb, rb, mask, settings)), bpix))

    bmbuf, bmcounts = _sparsematch_masked_impl(lb, rb, mask, settings)
    _same_set(masked_supports_to_numpy(bmbuf[0], bmcounts[0],
                                       settings.disp_high), flat0,
              "batched masked pair-0 supports != single-pair supports")
    _aux(make_record(
        "batched_masked_throughput", "Mpix/s",
        f"config 3: B={BATCH} folded into one (B*H, 2W) masked emit (no "
        "pack sort), aggregate per card", bench.measure(
            lambda: _sparsematch_masked_impl(lb, rb, mask, settings)), bpix))

    # the 3-level pyramid, all levels' pixels counted
    pmatch = build_pyramid_sparsematch(forest, settings, num_levels=3,
                                       device=dev)
    rows = pyramid_supports_to_numpy(*pmatch(l, r))
    lv0 = rows[rows[:, 3] == 0]
    _gate(_accuracy(lv0) > 0.99,
          f"pyramid level-0 accuracy {_accuracy(lv0):.3f}")
    ppix = 2 * H * W * (1 + 0.25 + 0.0625) / 1e6
    _aux(make_record("pyramid_throughput", "Mpix/s",
                     "config 3: 3-level pyramid, all-level pixels counted",
                     bench.measure(lambda: pmatch(l, r)), ppix))

    # the chunk-compacted pyramid on the low-density scene, gated against
    # the rows pyramid on the same scene
    cpmatch = build_pyramid_sparsematch_compact(forest, settings,
                                                num_levels=3, device=dev)
    cp_out = cpmatch(slt, srt)
    _gate(not bool(cp_out[-1]), "low-density scene tripped pyramid compact "
          "overflow")
    _same_set(pyramid_supports_to_numpy(*cp_out[:-1]),
              pyramid_supports_to_numpy(*pmatch(slt, srt)),
              "compact pyramid set != rows pyramid set")
    _aux(make_record("lowdensity_pyramid_rows_throughput", "Mpix/s",
                     "3-level rows pyramid on the 0.15-density scene "
                     "(the compact one's A/B baseline)",
                     bench.measure(lambda: pmatch(slt, srt)), ppix))
    _aux(make_record("lowdensity_pyramid_compact_throughput", "Mpix/s",
                     "3-level chunk-compacted pyramid on the 0.15-density "
                     "scene, overflow-guarded, set-equality gated vs the "
                     "rows pyramid", bench.measure(lambda: cpmatch(slt, srt)),
                     ppix))

    # densify from the masked buffer: every pixel filled, each within 0.5
    # of the constant disparity
    dbuf, _ = _sparsematch_masked_impl(l, r, mask, settings)
    dv, df = _densify_from_masked(dbuf, settings.disp_high, 10, width=W)
    _gate(bool(df.all()), "densify left unfilled pixels")
    derr = float((dv - TRUE_DISP).abs().max())
    _gate(derr < 0.5, f"densify max err {derr} on the constant scene")
    _aux(make_record(
        "densify_ms_per_frame", "ms",
        "multigrid densify from the masked buffer on the device (10 "
        "sweeps a level; exact-fill gated on the constant-disparity scene)",
        bench.measure(lambda: _densify_from_masked(
            dbuf, settings.disp_high, 10, width=W))))

    # the batched pyramid fold: pair 0 equals the single-pair pyramid
    bp_out = pmatch(lb, rb)
    _same_set(pyramid_supports_to_numpy(*(o[0] for o in bp_out)),
              pyramid_supports_to_numpy(*pmatch(lb[0], rb[0])),
              "batched pyramid pair-0 != single-pair pyramid")
    _aux(make_record(
        "batched_pyramid_throughput", "Mpix/s",
        f"config 3: B={BATCH} pyramids, every level's matcher folded into "
        "one (B*hs, 2W) row sort and one (B, K) dedup sort, aggregate per "
        "card", bench.measure(lambda: pmatch(lb, rb)), ppix * BATCH))

    print("methodology note: every step adds all of its output buffers "
          "into one device accumulator, read once after the windows; the "
          "headline contract is the masked buffer, whose host decode is "
          "priced apart (the CLI's wall-clock numbers include it).",
          file=sys.stderr, flush=True)


if __name__ == "__main__":
    sys.exit(main())
