"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the checkout and holds each of them (fused
keys, one image or both images of a batch of pairs in one launch; slab
keys, one slab or both slabs of a shard in one launch of the key kernel's
slab mode; fused codes, census, bitonic row sort at every row length from 256
to 16384 on random, equal, two-valued, sorted, reversed and real padded
matcher rows; the matcher's row sort on the benchmark cells' folded key
images and on rows of every layout up to 16384 keys; fused match) against
its plain-PyTorch twin bit for bit,
and the census also against the native oracle.  Then it drives every
level-1 route of the one-call ``sparsematch`` at 436x1024: the masked
epipolar route, the global-rows route at the library's default settings,
and four cases of the flat route; the selectable variants (fused match,
bitonic sort) and ``extract_descriptors``; the row-sharded single frame
(every contract, n = 1 over a one-rank NCCL process group and n = 4 in
one process) and one census call; the one-call on PNG paths, the
native host decode against the numpy one, the pyramid (``levels`` 2, 3
and 5, the flat fallback, the batched fold, the compact pyramid) and
``build_stereomatch``.  Every kernel is a ``torch.library`` custom op,
and ``opcheck`` holds each on CUDA inputs; matchers exported with
``torch.export`` (``opengpc_tpu_torch.aot``) are saved, loaded and
served on the card against their live modules, through the Python API
and the ``cli.aot`` CLI, the sharded-frame artifact at world 1.  The
offline workflow follows: the device triplet extraction against the
numpy one, forest training on the card at ~10^6 triplets (fern at a time
equal to batched, the card's forest equal to the CPU's on a subset, each
forest held to the pretrained one on a held-out scene), and the
``extract`` and ``train`` CLIs on a Sintel-layout tree
whose fresh forest then matches through the key kernel, with
``data/validate_real_sintel_torch.py`` run on the same tree.  Random
forests (``utils.random_forest``) on random shapes and settings go through
every level-1 route of the one-call, each equal to the oracle and the CPU,
and ``examples/demo_torch.py`` and ``examples/evaluate_torch.py`` run on
the card against their ``--device cpu`` runs; ``entry_torch.entry()``'s
module runs on the card against its CPU module, and ``bench_torch.py``
runs in smoke mode in a fresh process beside the correctness phases
(every gate, the output contract, ``bench.py``'s 20 metric names, the key
kernel in every matcher step).  Then the
``sparsematch`` CLI on PNG pairs (every contract, the pyramid, densify,
both colormaps and the host matchers, each against ``--device cpu``'s
files, the one-call and the oracle), its sequence mode over 32 pairs whose
density switches (``--batch 1``, ``--batch 4``, ``--pyramid 3``) and
densify on the card against the CPU.  Each path runs with every launch
counter at 0 and is read right after, so the run shows which kernels it went through.
Supports are checked against the native oracle (``cpp/build/oracle``;
level by level on downscaled images for the pyramid), the CPU pipeline
or the single-device module and, where the mode allows, the true
disparity.  Early in the run (the profiler loses kernel events late in
a long process, which the ``profiler_late`` phase at the end measures)
it times the kernels against their twins (the bitonic
and matcher row sorts also against ``torch.sort`` on the same rows, in
turns), each
beside its bound, the key kernel at B = 1 and 4 on the dense and sparse
pairs and at 2160x3840, the routes per pair, the sharded module against
the single-device one and the one-call module at levels 1-3 with CUDA
events and ``torch.profiler`` (each kernel also as the replays of a CUDA
graph of many calls, the kernels line's time where no profiler window
was usable).  Every phase prints one JSON line; the last line
is ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; without a CUDA device the script exits non-zero before doing
anything.

    python3 chip_smoke.py --gpus 4

runs instead the multi-device surface on four cards of one host, one rank
a card under ``torchrun --nproc-per-node 4``, NCCL between them (the
``md4_*`` phases): the key, slab and code kernels against their twins on
every rank's card; every builder of ``opengpc_tpu_torch.parallel`` at
full width against the single-device module of its contract, with exact
launches on every rank; the dry run of ``entry_torch``; the sharded
trainer at ~10^6 triplets; the CLIs and a sharded AOT artifact as
four-rank launches against their one-card runs; and the collectives, the
sharded frame and the batched module timed.  It fails with fewer than
four visible cards, and when any rank fails or runs past its time.
"""

import contextlib
import dataclasses
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from opengpc_tpu_torch.utils.timing import (device_profile, events_ms_per_step,
                                            graph_ms_per_step)

REPO = os.path.dirname(os.path.abspath(__file__))
H, W = 436, 1024          # Sintel resolution, the main path's frame
TRUE_DISP = 16
SETTINGS_KW = dict(gradient_threshold=5, epipolar_mode=True)  # CLI defaults
FORESTS = ("defaultZeroForest", "defaultTauForest")
# bench.py's accuracy gate: a forest's rare code collisions give a few
# off-disparity supports, which the oracle emits too
MIN_ACCURACY = 0.99
KERNEL_SHAPES = ((436, 1024), (37, 130), (129, 1023), (1080, 1920),
                 (2160, 3840))
# the fused match's frames: every N2 from 256 to 16384, and row counts
# that are no multiple of a block's rows (37, 129, 437)
MATCH_SHAPES = ((37, 100), (129, 130), (437, 500), (436, 1023), (436, 1024),
                (1080, 1920), (129, 4096), (37, 8192))
# the pyramid's level shapes: 437x1023 and 436x1024 halved down to 27x64
# (the last inside the candidate margin), 2160x3840 halved twice
LEVEL_SHAPES = ((437, 1023), (218, 512), (218, 511), (109, 256), (109, 255),
                (54, 128), (27, 64), (1080, 1920), (540, 960))
# W % 4 = 0, 2, 3, and the level shapes
PAIR_SHAPES = ((436, 1024), (37, 130), (129, 1023)) + LEVEL_SHAPES
KERNELS = {  # name -> (wrapper module, source, the TPU kernel it replaces)
    "fused_keys": ("opengpc_tpu_torch.ops.fused",
                   "opengpc_tpu_torch/csrc/fused_keys.cu",
                   "opengpc_tpu/ops/fused.py:419"),
    "fused_codes": ("opengpc_tpu_torch.ops.fused",
                    "opengpc_tpu_torch/csrc/fused_codes.cu",
                    "opengpc_tpu/ops/fused.py:295"),
    "bitonic_sort_rows": ("opengpc_tpu_torch.ops.sort",
                          "opengpc_tpu_torch/csrc/bitonic_sort.cu",
                          "opengpc_tpu/ops/sort.py:99"),
    "fused_sparsematch_rows": ("opengpc_tpu_torch.ops.fused_match",
                               "opengpc_tpu_torch/csrc/fused_match.cu",
                               "opengpc_tpu/ops/fused_match.py:146"),
    "fused_keys_slab": ("opengpc_tpu_torch.ops.fused",
                        "opengpc_tpu_torch/csrc/fused_keys.cu",
                        "opengpc_tpu/ops/fused.py:495"),
    "fused_census": ("opengpc_tpu_torch.ops.fused",
                     "opengpc_tpu_torch/csrc/fused_census.cu",
                     "opengpc_tpu/ops/fused.py:377"),
}
# the matcher's row sort (ops.sort.row_sort), beside KERNELS: the main
# path pins its launches itself (``phase_main_path``)
ROW_SORT = ("opengpc_tpu_torch.ops.sort", "opengpc_tpu_torch/csrc/row_sort.cu",
            "none: XLA's lax.sort in opengpc_tpu/match.py:174")
# the benchmark cells' row sorts: (pairs, h, w, disparity range) of
# sintel_b32_card (13,120 folded rows of 2,048) and uhd4k_b1_card (2,134 of
# 7,680), as gpcbench/traffic makes them
ROW_SORT_CELLS = {"sintel_b32": (32, 436, 1024, (4, 96)),
                  "uhd4k_b1": (1, 2160, 3840, (8, 128))}
# the H100 SXM's device-memory rate and INT32 instruction rate (132 SMs
# x 64 INT32 lanes x 1.98 GHz), the two sides of every kernel's bound
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# integer operations of the code math, counted in the key kernel's own
# two-lane form (StripTile in csrc/tile_codes.cuh):
# - the box, per 4 columns of a row: 3 byte permutes and 2 funnel shifts
#   widen the bytes to 16-bit lanes, 2 three-input adds make the
#   horizontal and 2 the vertical 3-sums, 2 x 6 the lane-wise /9 and 2
#   the border masks (23);
# - the Sobel, per strip of 4 pixels inside the candidate margin: 6
#   column sums (t + 2m + b and t - b, 3 each), and per pixel 3 for the
#   two gradient sums, 2 x 3 for their truncating /9, 2 for the squared
#   norm, 1 compare, 3 for the column margin and 1 to set the bit (82);
# - the key of every pixel: position, sentinel and select (3);
# - a candidate's code: 1.5 a test (a three-input add, a shift and a
#   merge per word of two lanes) and 7 to turn the lane accumulators
#   into the MSB-first code.
BOX_OPS, SOBEL_OPS, KEY_OPS = 23 / 4, 82 / 4, 3
CODE_OPS, TEST_OPS = 7, 1.5
# integer operations a pixel of the census in its kernel's two-lane form
# (csrc/fused_census.cu), per strip of 4 pixels of one output row:
# - 24 neighbours x 2 words of two lanes, each a three-input add and one
#   logic op that merges the compare bit into its accumulator (96);
# - widening the raw row it adds to the window: 4 byte permutes and 3
#   funnel shifts (7);
# - the codes: 2 byte permutes a pixel (8), and the box mask, 1 a pixel
#   (4).  115 a strip: 28.75 a pixel.
CENSUS_OPS = 115 / 4
SLAB_SHAPES = ((436, 1024), (2160, 3840))
# the one-launch slab pair: (frame h, w, n), W % 4 = 0, 2, 3 and widths
# that are no multiple of 16 (bytes staged one by one), shard heights
# that are no multiple of the 32-row tile
SLAB_PAIR_SHAPES = ((436, 1024, 4), (111, 1000, 3), (222, 1022, 6),
                    (129, 1023, 3), (135, 130, 5))
CENSUS_SHAPES = ((5, 6), (3, 13), (2, 3), (21, 9), (64, 15), (37, 130),
                 (129, 1023), (436, 1024), (61, 1025), (1081, 1919),
                 (2160, 3840), (2160, 3841))


def bound(nbytes, ops):
    """The least time the card could take for work that moves ``nbytes``
    of device memory and makes ``ops`` integer operations: (ms, what sets
    it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def code_ops(images, h, w, candidates, tests):
    """Integer operations of the code math on ``images`` h x w images,
    the codes made for ``candidates`` of their pixels."""
    interior = max(h - 2 * 13, 0) * max(w - 2 * 13, 0)
    return int(images * (h * w * (BOX_OPS + KEY_OPS) + interior * SOBEL_OPS)
               + candidates * (CODE_OPS + tests * TEST_OPS))


def network_ops(rows, n):
    """Integer operations of the bitonic network on (rows, n): n log2(n)
    (log2(n) + 1) / 4 compare-exchanges a row, each a compare, a min, a
    max and two payload selects."""
    lg = n.bit_length() - 1
    return 5 * rows * n * lg * (lg + 1) // 4


def row_sort_ops(key):
    """Integer operations of the row sort on an (R, N) key image: 6 a
    compare-exchange of 64-bit words in the network over each row's
    candidates, padded to max(256, pow2 >= their count), and 8 a key to
    classify, rank and write it."""
    from opengpc_tpu_torch.match import SENTINEL_BASE

    n = (key < SENTINEL_BASE).sum(dim=1).cpu().numpy().astype(np.int64)
    lg = np.where(n > 256, np.ceil(np.log2(np.maximum(n, 1))), 8)
    p = np.where(n > 0, 2 ** lg, 0)
    return int(6 * (p * lg * (lg + 1) // 4).sum() + 8 * key.numel())


_START = time.perf_counter()


def emit(phase, **fields):
    """One phase's JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": time.perf_counter() - _START}), flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def wrapper(name):
    import importlib

    return getattr(importlib.import_module(KERNELS[name][0]), name)


class Launches:
    """Launch counts of the paths: ``run`` sets every kernel's counter to
    0, drives one path, synchronizes and reads the counters, and adds them
    to ``total``.  Launches made elsewhere (kernel vs twin, timing) are
    never counted."""

    def __init__(self):
        self.total = dict.fromkeys(KERNELS, 0)

    def run(self, path, fn, expect):
        """Drive ``fn`` as the path named ``path``; fails unless each kernel
        in ``expect`` launched exactly its count there and every other
        kernel none.  ``expect`` may be a function of ``fn``'s result that
        returns the counts (a count the run's own report sets)."""
        for name in KERNELS:
            wrapper(name).launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {name: wrapper(name).launches for name in KERNELS}
        if callable(expect):
            expect = expect(out)
        for name, n in counts.items():
            self.total[name] += n
        want = {name: expect.get(name, 0) for name in KERNELS}
        if counts != want:
            raise SystemExit(f"{path}: launches {counts}, expected {want}")
        return out, counts


def forest_paths(td):
    """The shipped forests' files, and a 32-test forest written with the
    port's ``save_forest``: the six ferns of defaultTauForest, then the six
    of defaultZeroForest (60 tests, which inference cuts to 32 in file
    order, as the oracle does)."""
    from opengpc_tpu_torch.forest import Forest, load_forest, save_forest

    paths = {f: os.path.join(REPO, "forests", f + ".txt") for f in FORESTS}
    both = Forest(load_forest(paths["defaultTauForest"]).ferns
                  + load_forest(paths["defaultZeroForest"]).ferns)
    paths["tests32"] = os.path.join(td, "tests32.txt")
    save_forest(both, paths["tests32"])
    return paths


def structured_image(rng, h, w):
    small = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2))
    img = np.kron(small, np.ones((4, 4)))[:h, :w]
    return np.clip(img + rng.integers(-12, 13, (h, w)), 0, 255).astype(np.uint8)


def random_masks(seed=1234):
    """Three random filter masks: offsets in +-13, tau in [-10, 10]."""
    from opengpc_tpu_torch.forest import filter_mask_from_numpy

    rng = np.random.default_rng(seed)
    masks = []
    for t in (32, 24, 13):
        masks.append(filter_mask_from_numpy(
            rng.integers(-13, 14, (t, 2)), rng.integers(-13, 14, (t, 2)),
            rng.integers(-10, 11, t), 1))
    return masks


def wide_tau_mask(seed=4321, tests=32):
    """A random mask of ``tests`` tests with tau in [-400, 400]: thresholds
    past the +-255 that two uint8 values can differ by."""
    from opengpc_tpu_torch.forest import filter_mask_from_numpy

    rng = np.random.default_rng(seed)
    return filter_mask_from_numpy(rng.integers(-13, 14, (tests, 2)),
                                  rng.integers(-13, 14, (tests, 2)),
                                  rng.integers(-400, 401, tests), 1)


def fused_match_masks(masks):
    """The fused match's masks (at most 30 tests): both shipped forests,
    random masks of 1, 13, 24 and 30 tests (tau in [-10, 10]) and a
    30-test mask with tau in [-400, 400]."""
    from opengpc_tpu_torch.forest import filter_mask_from_numpy

    rng = np.random.default_rng(2468)
    out = {"zero": masks["zero"], "tau": masks["tau"]}
    for t in (1, 13, 24, 30):
        out[f"random_{t}t"] = filter_mask_from_numpy(
            rng.integers(-13, 14, (t, 2)), rng.integers(-13, 14, (t, 2)),
            rng.integers(-10, 11, t), 1)
    out["random_tau400_30t"] = wide_tau_mask(tests=30)
    return out


def patch_image(rng, h, w):
    """Constant 16x16 patches of four grey levels: at threshold 0 the
    patch edges are candidates, and their many equal neighbourhoods give
    long runs of equal codes in a row."""
    levels = rng.choice(np.array([40, 90, 160, 220], np.uint8),
                        (h // 16 + 1, w // 16 + 1))
    return np.kron(levels, np.ones((16, 16), np.uint8))[:h, :w].copy()


def median_ms(fn, n):
    """Median host-clock ms of ``n`` calls of ``fn``."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def cuda_ms(fn, iters):
    """Mean device ms per call of ``fn`` over ``iters`` calls (events)."""
    fn()
    torch.cuda.synchronize()
    return events_ms_per_step(fn, iters)[0]


def kernel_profile(fn, iters):
    """``device_profile`` for a time the kernels line or PERF.md reports,
    with up to 5 windows.  When the last is not usable its ``device_ms``
    is None (see ``line_times``)."""
    prof = device_profile(fn, iters, tries=5)
    if not prof["usable"]:
        prof["device_ms"] = None
    return prof


def graph_ms(fn, steps):
    """Device ms a call of ``fn`` with no host launch between its kernels:
    ``steps`` calls in one CUDA graph, the median of 5 replays."""
    return float(np.median(graph_ms_per_step(fn, steps, 5)))


def line_times(device, graph):
    """A kernel's times for the kernels line (``ms``, ``plain_ms`` and,
    where there is one, ``library_ms``), all from one source, named in
    ``ms_source``: the profiler's device ms where every one of them had a
    usable window, else the CUDA graph replays' ms of all of them, so that
    no time stands against another source's."""
    if None in device.values():
        return dict(graph, ms_source="cuda-graph")
    return dict(device, ms_source="profiler")


def us_or_none(ms):
    return None if ms is None else ms * 1e3


def phase_device():
    smi = smi_line()
    print(smi, flush=True)
    from opengpc_tpu_torch.ops._build import _nvcc

    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         nvcc=[ln for ln in nvcc.splitlines() if "release" in ln][0],
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    return smi


def phase_build():
    from opengpc_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    ptxas = [ln.strip() for ln in _build.build_info.get("log", "").splitlines()
             if "registers" in ln or "spill" in ln or "entry function" in ln]
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=_build.build_info.get("seconds"), ptxas=ptxas)


def phase_kernel_vs_twin():
    """Kernel vs plain twin on the card, bit for bit; returns the largest
    absolute difference seen (0 when every case agrees)."""
    from opengpc_tpu_torch import load_forest, make_filter_mask
    from opengpc_tpu_torch.match import SENTINEL_BASE, _pack_ok, _pos_bits
    from opengpc_tpu_torch.ops.fused import (fused_key_image, fused_keys,
                                             fused_keys_plain)

    zero = load_forest(os.path.join(REPO, "forests", "defaultZeroForest.txt"))
    tau = load_forest(os.path.join(REPO, "forests", "defaultTauForest.txt"))
    masks = {"zero": make_filter_mask(zero), "tau": make_filter_mask(tau),
             "zero17": make_filter_mask(zero, max_tests=17)}
    for i, m in enumerate(random_masks()):
        masks[f"random{i}_{m.num_tests}t"] = m
    masks["random_tau400"] = wide_tau_mask()
    rng = np.random.default_rng(7)
    worst, cases, failures = 0, 0, []
    for h, w in KERNEL_SHAPES:
        img = torch.from_numpy(structured_image(rng, h, w)).cuda()
        for name, mask in masks.items():
            pbs = [0] + ([_pos_bits(2 * w)]
                         if _pack_ok(mask.num_tests, 2 * w) else [])
            for pos_base in (0, w):
                for pb in pbs:
                    got = fused_keys(img, mask, 5, pos_base, SENTINEL_BASE, pb)
                    want = fused_keys_plain(img, mask, 5, pos_base,
                                            SENTINEL_BASE, pb)
                    err = int((got.long() - want.long()).abs().max())
                    ncand = int((want < SENTINEL_BASE).sum()) if not pb else -1
                    worst = max(worst, err)
                    cases += 1
                    if err or ncand == 0:
                        failures.append((h, w, name, pos_base, pb, err, ncand))
    # the one-launch pair (both images of B pairs) equals two twins side by
    # side, at B = 1 and 4 and odd widths
    for h, w in PAIR_SHAPES:
        for b in (1, 4):
            lefts, rights = (torch.from_numpy(np.stack(
                [structured_image(rng, h, w) for _ in range(b)])).cuda()
                for _ in range(2))
            for name, mask in masks.items():
                got = fused_key_image(lefts, rights, mask, 5, SENTINEL_BASE)
                want = torch.cat([
                    fused_keys_plain(lefts, mask, 5, 0, SENTINEL_BASE),
                    fused_keys_plain(rights, mask, 5, w, SENTINEL_BASE)],
                    dim=2)
                err = max_err(got, want)
                worst = max(worst, err)
                cases += 1
                if err:
                    failures.append(("pair", b, h, w, name, err))
    torch.cuda.synchronize()
    emit("kernel_vs_twin", cases=cases, max_abs_err=worst,
         failures=failures[:10])
    if failures:
        raise SystemExit(f"kernel disagrees with its twin: {failures[:10]}")
    return worst


def build_oracle():
    r = subprocess.run(["make", "-C", os.path.join(REPO, "cpp"),
                        "build/oracle"], capture_output=True, text=True)
    path = os.path.join(REPO, "cpp", "build", "oracle")
    if r.returncode != 0 or not os.path.exists(path):
        raise SystemExit(f"oracle build failed:\n{r.stdout}{r.stderr}")
    return path


_ORACLE_SETS = {}
_D_BIAS = 1 << 21  # |d| < 2^21: the widest frame is 3840 pixels


def support_keys(rows):
    """A support set as sorted unique int64 keys ``x << 43 | y << 22 | (d
    + 2^21)`` of its (n, 3) (x, y, d) rows, so the gates run in numpy; a
    key's pixel is ``key >> 22`` (``x << 21 | y``)."""
    r = np.asarray(rows, np.int64).reshape(-1, 3)
    return np.unique((r[:, 0] << 43) | (r[:, 1] << 22) | (r[:, 2] + _D_BIAS))


def oracle_set(oracle, left, right, forest_file, settings):
    """The native oracle's support set of a pair (``support_keys``), kept
    for the run."""
    from opengpc_tpu_torch.io import write_raw

    # keyed by the oracle's arguments: settings that differ only in what
    # the oracle does not read (the flat capacity) share a run
    key = (hashlib.sha256(left.tobytes() + right.tobytes()).hexdigest(),
           left.shape, forest_file, settings.gradient_threshold,
           settings.vertical_tolerance, settings.disp_high,
           settings.epipolar_mode)
    if key in _ORACLE_SETS:
        return _ORACLE_SETS[key]
    with tempfile.TemporaryDirectory() as td:
        lp, rp, op = (os.path.join(td, n) for n in ("l.raw", "r.raw", "o.txt"))
        write_raw(lp, left)
        write_raw(rp, right)
        subprocess.run(
            [oracle, "sparsematch", forest_file, lp, rp, op,
             str(settings.gradient_threshold),
             str(settings.vertical_tolerance), str(settings.disp_high),
             str(int(settings.epipolar_mode)), "0"], check=True)
        with open(op) as f:
            want = support_keys(np.array(f.read().split(), np.int64))
    _ORACLE_SETS[key] = want
    return want


def oracle_gate(oracle, left, right, forest_file, supports, settings):
    """bench.py's gate: every support is in the oracle's set, and at least
    99.9% of the oracle's supports are reproduced."""
    want = oracle_set(oracle, left, right, forest_file, settings)
    got = support_keys(supports)
    extra = int(np.setdiff1d(got, want, assume_unique=True).size)
    ok = extra == 0 and got.size >= 0.999 * want.size
    return ok, {"supports": int(got.size), "oracle": int(want.size),
                "not_in_oracle": extra}


def accuracy(supports):
    """Share of supports at the true disparity (0 for an empty set)."""
    return float((supports[:, 2] == TRUE_DISP).mean()) if len(supports) else 0.0


def phase_main_path(oracle, launches):
    """The masked route of the one-call sparsematch on the card, driven as
    one path with the launch counters at 0, then checked."""
    from opengpc_tpu_torch import (InferenceSettings, load_forest,
                                   make_filter_mask, sparsematch)
    from opengpc_tpu_torch.utils import make_pair, make_sparse_pair

    settings = InferenceSettings(**SETTINGS_KW)
    paths = {f: os.path.join(REPO, "forests", f + ".txt") for f in FORESTS}
    mask17 = make_filter_mask(load_forest(paths["defaultZeroForest"]),
                              max_tests=17)
    scenes = {"dense": make_pair(H, W, TRUE_DISP),
              "sparse": make_sparse_pair(H, W, TRUE_DISP, density=0.15)}
    batches = {
        "dense": [make_pair(H, W, TRUE_DISP, seed=100 + b) for b in range(4)],
        "sparse": [make_sparse_pair(H, W, TRUE_DISP, density=0.15,
                                    seed=100 + b) for b in range(4)]}

    single, batched, per_pair, small17 = {}, {}, {}, {}

    def drive():
        for scene, (left, right) in scenes.items():
            for f in FORESTS:
                single[scene, f] = sparsematch(left, right, paths[f],
                                               settings, device="cuda")
            small17[scene] = sparsematch(left, right, mask17, settings,
                                         device="cuda")
            pairs = batches[scene]
            batched[scene] = sparsematch(np.stack([p[0] for p in pairs]),
                                         np.stack([p[1] for p in pairs]),
                                         paths["defaultZeroForest"], settings,
                                         device="cuda")
            per_pair[scene] = [sparsematch(l, r, paths["defaultZeroForest"],
                                           settings, device="cuda")
                               for l, r in pairs]

    # one key-kernel launch a module call: per scene two forests, the
    # 17-test mask, the batch of 4 and its 4 pairs one by one; and one
    # row-sort launch a call, none of them too wide
    from opengpc_tpu_torch.ops.sort import row_sort

    row_sort.launches = row_sort.wide_calls = 0
    counts = launches.run("main_path", drive, {"fused_keys": 16})[1]
    sorts = dict(launches=row_sort.launches, wide_calls=row_sort.wide_calls)
    failures, report = [], {}
    if sorts != dict(launches=16, wide_calls=0):
        failures.append(f"row_sort: {sorts}, expected 16 launches, 0 wide")
    for (scene, f), sup in single.items():
        left, right = scenes[scene]
        cpu = sparsematch(left, right, paths[f], settings, device="cpu")
        ok_gate, gate = oracle_gate(oracle, left, right, paths[f], sup,
                                    settings)
        acc = accuracy(sup)
        same_cpu = bool(np.array_equal(sup, cpu))
        report[f"{scene}/{f}"] = dict(
            gate, true_disparity_share=acc,
            off_disparity=int((sup[:, 2] != TRUE_DISP).sum()),
            equals_cpu=same_cpu)
        if not (ok_gate and acc > MIN_ACCURACY and same_cpu):
            failures.append(f"{scene}/{f}: {report[f'{scene}/{f}']}")
    for scene, sup in small17.items():
        left, right = scenes[scene]
        cpu = sparsematch(left, right, mask17, settings, device="cpu")
        report[f"{scene}/zero17"] = dict(supports=len(sup),
                                         equals_cpu=bool(np.array_equal(sup, cpu)))
        if not np.array_equal(sup, cpu) or not len(sup):
            failures.append(f"{scene}/zero17 differs from the CPU pipeline")
    for scene in scenes:
        same = all(np.array_equal(a, b)
                   for a, b in zip(batched[scene], per_pair[scene]))
        accs = [accuracy(s) for s in batched[scene]]
        report[f"{scene}/batch4"] = dict(
            supports=[len(s) for s in batched[scene]],
            equals_single=same, true_disparity_share=accs)
        if not (same and min(accs) > MIN_ACCURACY):
            failures.append(f"{scene}/batch4: {report[f'{scene}/batch4']}")
    emit("main_path", launches=counts, row_sort=sorts, checks=report,
         failures=failures)
    if failures:
        raise SystemExit(f"main path failed: {failures}")
    return sorts["launches"]


def phase_times(smi):
    """Kernel vs twin (both images of one pair), the masked pipeline per
    pair at B=1 and B=4, and the host decode, on the card."""
    from opengpc_tpu_torch import (InferenceSettings, build_sparsematch_masked,
                                   load_forest, make_filter_mask,
                                   masked_supports_to_numpy, sparsematch)
    from opengpc_tpu_torch.infer import _batched_key_images, _key_image
    from opengpc_tpu_torch.match import SENTINEL_BASE
    from opengpc_tpu_torch.ops.fused import fused_keys_plain
    from opengpc_tpu_torch.utils import make_pair

    settings = InferenceSettings(**SETTINGS_KW)
    path = os.path.join(REPO, "forests", "defaultZeroForest.txt")
    mask = make_filter_mask(load_forest(path))
    left, right = make_pair(H, W, TRUE_DISP)
    l_d, r_d = torch.from_numpy(left).cuda(), torch.from_numpy(right).cuda()

    def kernel():
        _key_image(l_d, r_d, mask, settings)

    def plain():
        torch.cat([fused_keys_plain(l_d, mask, 5, 0, SENTINEL_BASE),
                   fused_keys_plain(r_d, mask, 5, W, SENTINEL_BASE)], dim=1)

    # alternate plain, kernel, kernel, plain on one card
    p1 = cuda_ms(plain, 50)
    k1 = cuda_ms(kernel, 500)
    k2 = cuda_ms(kernel, 500)
    p2 = cuda_ms(plain, 50)

    mod = build_sparsematch_masked(mask, settings, device="cuda")
    pairs = [make_pair(H, W, TRUE_DISP, seed=100 + b) for b in range(4)]
    lb = torch.from_numpy(np.stack([p[0] for p in pairs])).cuda()
    rb = torch.from_numpy(np.stack([p[1] for p in pairs])).cuda()
    pipe1 = cuda_ms(lambda: mod(l_d, r_d), 200)
    pipe4 = cuda_ms(lambda: mod(lb, rb), 100) / 4
    # 64 pairs per launch: device-bound, so events see the kernel itself
    l64, r64 = lb.repeat(16, 1, 1), rb.repeat(16, 1, 1)
    k64 = cuda_ms(lambda: _batched_key_images(l64, r64, mask, settings),
                  20) / 64

    buf, rc = mod(l_d, r_d)
    t0 = time.perf_counter()
    for _ in range(20):
        buf_h, rc_h = buf.cpu().numpy(), rc.cpu().numpy()
    d2h = (time.perf_counter() - t0) / 20 * 1e3
    decode = median_ms(lambda: masked_supports_to_numpy(
        buf_h, rc_h, settings.disp_high), 20)
    one_call = median_ms(lambda: sparsematch(left, right, path, settings,
                                             device="cuda"), 20)
    prof_kernel = kernel_profile(kernel, 50)
    prof_plain = kernel_profile(plain, 10)
    prof_b1 = device_profile(lambda: mod(l_d, r_d), 50)
    prof_b4 = device_profile(lambda: mod(lb, rb), 20)
    emit("profile", card=smi, kernel_pair=prof_kernel, plain_pair=prof_plain,
         pipeline_b1=prof_b1, pipeline_b4=prof_b4)
    times = dict(card=smi, shape=[H, W], forest="defaultZeroForest",
                 kernel_pair_ms=[k1, k2], plain_pair_ms=[p1, p2],
                 kernel_ms_per_pair_b64=k64,
                 pipeline_ms_per_pair_b1=pipe1, pipeline_ms_per_pair_b4=pipe4,
                 d2h_ms=d2h, decode_ms_median=decode,
                 one_call_ms_median=one_call)
    emit("times", **times)
    # time of the kernel (both images, one launch) and of the twin per pair
    ncand = int((_key_image(l_d, r_d, mask, settings) < SENTINEL_BASE).sum())
    graph = dict(ms=graph_ms(kernel, 100), plain_ms=graph_ms(plain, 10))
    return with_bound(
        dict(line_times(
            dict(ms=prof_kernel["device_ms"], plain_ms=prof_plain["device_ms"]),
            graph), library_ms=None, events_ms=[k1, k2],
            plain_events_ms=[p1, p2], graph_ms=graph),
        2 * H * W * (1 + 4), code_ops(2, H, W, ncand, mask.num_tests))


def kernel_masks(paths):
    """The kernel-vs-twin masks: both shipped forests, the zero forest cut
    to 17 tests, the 32-test forest and three random masks."""
    from opengpc_tpu_torch import load_forest, make_filter_mask

    masks = {"zero": make_filter_mask(load_forest(paths["defaultZeroForest"])),
             "tau": make_filter_mask(load_forest(paths["defaultTauForest"])),
             "zero17": make_filter_mask(
                 load_forest(paths["defaultZeroForest"]), max_tests=17),
             "tests32": make_filter_mask(load_forest(paths["tests32"]))}
    for i, m in enumerate(random_masks()):
        masks[f"random{i}_{m.num_tests}t"] = m
    return masks


def max_err(got, want):
    """Largest absolute difference of two equally shaped tensors."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return float("inf")
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def finish_vs_twin(name, cases, worst, failures):
    emit(f"{name}_vs_twin", cases=cases, max_abs_err=worst,
         failures=failures[:10])
    if failures:
        raise SystemExit(f"{name} disagrees with its twin: {failures[:10]}")
    return worst


def phase_codes_vs_twin(masks):
    """fused_codes vs its twin on the card: codes and candidates bit for
    bit, at every kernel shape and mask, at thresholds 5 and 10, as a
    (4, H, W) batch, and the one-launch pair (fused_codes_pair) at B = 1
    and 4 and W % 4 = 0, 2, 3 with the 32-test wide-tau mask, the 32-test
    forest and the zero forest."""
    from opengpc_tpu_torch.ops.fused import (fused_codes, fused_codes_pair,
                                             fused_codes_plain)

    rng = np.random.default_rng(8)
    worst, cases, failures = 0, 0, []
    for h, w in KERNEL_SHAPES:
        img = torch.from_numpy(structured_image(rng, h, w)).cuda()
        for name, mask in masks.items():
            for thr in (5, 10):
                codes, cand = fused_codes(img, mask, thr)
                want_c, want_v = fused_codes_plain(img, mask, thr)
                err = max(max_err(codes, want_c), max_err(cand, want_v))
                worst, cases = max(worst, err), cases + 1
                if err or not want_v.any():
                    failures.append((h, w, name, thr, err))
    batch = torch.from_numpy(np.stack(
        [structured_image(rng, H, W) for _ in range(4)])).cuda()
    for name, mask in masks.items():
        codes, cand = fused_codes(batch, mask, 5)
        want_c, want_v = fused_codes_plain(batch, mask, 5)
        err = max(max_err(codes, want_c), max_err(cand, want_v))
        worst, cases = max(worst, err), cases + 1
        if err:
            failures.append(("batch4", name, err))
    pair_masks = {"random_tau400": wide_tau_mask(), "tests32":
                  masks["tests32"], "zero": masks["zero"]}
    for h, w in PAIR_SHAPES:
        for b in (1, 4):
            lefts, rights = (torch.from_numpy(np.stack(
                [structured_image(rng, h, w) for _ in range(b)])).cuda()
                for _ in range(2))
            for name, mask in pair_masks.items():
                got = fused_codes_pair(lefts, rights, mask, 5)
                want = [fused_codes_plain(x, mask, 5) for x in (lefts, rights)]
                err = max(max_err(g, w_) for gs, ws in zip(got, want)
                          for g, w_ in zip(gs, ws))
                worst, cases = max(worst, err), cases + 1
                if err or not want[1][1].any():
                    failures.append(("pair", b, h, w, name, err))
    torch.cuda.synchronize()
    return finish_vs_twin("fused_codes", cases, worst, failures)


def sort_inputs(rng, rows, n):
    """The kinds of rows the sort is held to: random signed keys, all
    equal, two-valued, already sorted and reverse-sorted."""
    rand = rng.integers(-(1 << 31), 1 << 31, (rows, n),
                        dtype=np.int64).astype(np.int32)
    return {"random": rand,
            "equal": np.full((rows, n), 5, np.int32),
            "two-valued": rng.integers(0, 2, (rows, n)).astype(np.int32),
            "sorted": np.sort(rand, axis=1),
            "reversed": np.sort(rand, axis=1)[:, ::-1].copy()}


def phase_sort_vs_twin(masks):
    """bitonic_sort_rows vs its twin on the card: keys and payloads bit
    for bit, for every N from 256 to 16384 crossed with 1, 7 and 410 rows
    of every kind of ``sort_inputs``, and on the real matcher rows of the
    bitonic variant (key images padded with PAD_KEY_BASE lanes to N2) at
    six frame shapes."""
    from opengpc_tpu_torch import InferenceSettings
    from opengpc_tpu_torch.infer import _key_image
    from opengpc_tpu_torch.match import PAD_KEY_BASE
    from opengpc_tpu_torch.ops.sort import (MAX_N, MIN_N, bitonic_sort_rows,
                                            bitonic_sort_rows_plain,
                                            padded_row_length)
    from opengpc_tpu_torch.utils import make_pair

    rng = np.random.default_rng(9)
    inputs = []
    n = MIN_N
    while n <= MAX_N:
        for rows in (1, 7, 410):
            pay = rng.permutation(rows * n).reshape(rows, n).astype(np.int32)
            for kind, key in sort_inputs(rng, rows, n).items():
                inputs.append((f"{kind}_{rows}x{n}", torch.from_numpy(key),
                               torch.from_numpy(pay)))
        n *= 2
    settings = InferenceSettings(**SETTINGS_KW)
    for h, w in ((436, 1024), (436, 1000), (37, 130), (129, 1023),
                 (540, 1920), (64, 5000)):
        left, right = (torch.from_numpy(a).cuda()
                       for a in make_pair(h, w, TRUE_DISP, seed=w))
        key = _key_image(left, right, masks["zero"], settings)
        n2 = padded_row_length(w)
        pos = torch.arange(n2, dtype=torch.int32, device="cuda")
        key = torch.cat([key, (PAD_KEY_BASE + pos[2 * w:]).expand(h, -1)],
                        dim=1)
        inputs.append((f"matcher_{h}x{w}_n{n2}", key,
                       pos.expand(h, -1).contiguous()))
    worst, cases, failures = 0, 0, []
    for name, key, pay in inputs:
        key, pay = key.cuda(), pay.cuda()
        got_k, got_p = bitonic_sort_rows(key, pay)
        want_k, want_p = bitonic_sort_rows_plain(key, pay)
        err = max(max_err(got_k, want_k), max_err(got_p, want_p),
                  max_err(got_k, torch.sort(key, dim=1).values))
        worst, cases = max(worst, err), cases + 1
        if err:
            failures.append((name, err))
    torch.cuda.synchronize()
    return finish_vs_twin("bitonic_sort_rows", cases, worst, failures)


def row_sort_rows(rng, rows, n):
    """(rows, n) int32 key images of every layout the row sort is held
    to: 15 % candidates with duplicated codes among sentinels, every key
    a candidate, only sentinels, negative candidates, and keys >=
    SENTINEL_BASE off their column's sentinel (the row sorted whole)."""
    from opengpc_tpu_torch.match import SENTINEL_BASE

    col = np.arange(n, dtype=np.int64)
    sent = np.tile(SENTINEL_BASE + col, (rows, 1))
    pool = rng.integers(0, 1 << 30, max(1, n // 20))
    codes = pool[rng.integers(0, len(pool), (rows, n))]
    sparse = rng.random((rows, n)) < 0.15
    odd = np.where(sparse, codes, SENTINEL_BASE + col // 2)
    odd[:, 0] = 0x7FFFFFFF
    kinds = {"codes": np.where(sparse, codes, sent), "dense": codes,
             "sentinels": sent,
             "signed": np.where(sparse, codes - (1 << 30), sent),
             "odd": odd}
    return {k: torch.from_numpy(v.astype(np.int32)) for k, v in kinds.items()}


def row_sort_images(masks):
    """The benchmark cells' folded key images (``ROW_SORT_CELLS``) on the
    card: the benchmark generator's pairs (seed 21, density 0.15) and
    dense ``make_pair`` pairs through the key kernel and the fold."""
    from gpcbench.generator import make_pool
    from opengpc_tpu_torch import InferenceSettings
    from opengpc_tpu_torch.infer import _folded_key_rows
    from opengpc_tpu_torch.utils import make_pair

    settings = InferenceSettings(**SETTINGS_KW)
    images = {}
    for cell, (b, h, w, disp) in ROW_SORT_CELLS.items():
        lefts, rights, _ = make_pool(21, b, h, w, 0.15, disp, device="cuda")
        images[f"{cell}/generator"] = _folded_key_rows(
            lefts, rights, masks["zero"], settings)[0]
        pairs = [make_pair(h, w, TRUE_DISP, seed=500 + i) for i in range(b)]
        lefts, rights = (torch.from_numpy(np.stack([p[i] for p in pairs]))
                         .cuda() for i in (0, 1))
        images[f"{cell}/dense"] = _folded_key_rows(
            lefts, rights, masks["zero"], settings)[0]
    return images


def phase_row_sort_vs_twin(masks, images):
    """row_sort vs its twin on the card, keys and columns bit for bit: the
    cells' folded key images (``row_sort_images``), every layout of
    ``row_sort_rows`` at N 130 .. 16384 (N % 4 = 0 and 2 among them) x 1,
    7 and 410 rows; then each cell image's masked buffer and row counts
    against ``torch.sort``'s key-value path, which the cells ran before.
    No call of the phase is too wide."""
    from opengpc_tpu_torch.match import (SENTINEL_BASE, _detect_pairs_packed,
                                         _masked_emit, match_epipolar_masked)
    from opengpc_tpu_torch.ops.sort import row_sort, row_sort_plain

    rng = np.random.default_rng(21)
    inputs = dict(images)
    for n in (130, 256, 2046, 2048, 4100, 7680, 16384):
        for rows in (1, 7, 410):
            for kind, key in row_sort_rows(rng, rows, n).items():
                inputs[f"{kind}_{rows}x{n}"] = key.cuda()
    wide = row_sort.wide_calls
    worst, cases, failures = 0, 0, []
    for name, key in inputs.items():
        got_k, got_p = row_sort(key)
        want_k, want_p = row_sort_plain(key)
        err = max(max_err(got_k, want_k), max_err(got_p, want_p))
        worst, cases = max(worst, err), cases + 1
        if err:
            failures.append((name, err))
    masked = {}
    for name, key in images.items():
        w = key.shape[1] // 2
        got = match_epipolar_masked(None, None, None, None, 128, key=key,
                                    num_tests=masks["zero"].num_tests)
        key_s, idx = torch.sort(key, dim=1, stable=False)
        keep, src_x, d = _detect_pairs_packed(key_s, idx.to(torch.int32), w,
                                              128)
        want = _masked_emit(keep, src_x, d, w, 128)
        same = all(torch.equal(g, t) for g, t in zip(got, want))
        masked[name] = dict(rows=list(key.shape), supports=int(got[1].sum()),
                            candidate_share=float(
                                (key < SENTINEL_BASE).float().mean()),
                            equals_torch_sort=same)
        if not same:
            failures.append((f"{name}/masked", "differs from torch.sort's"))
    torch.cuda.synchronize()
    if row_sort.wide_calls != wide:
        failures.append(("wide_calls", row_sort.wide_calls - wide))
    emit("row_sort_masked", cells=masked, launches=row_sort.launches,
         wide_calls=row_sort.wide_calls)
    return finish_vs_twin("row_sort", cases, worst, failures)


def phase_fused_match_vs_twin(masks):
    """fused_sparsematch_rows vs its twin on the card: keep, src_x and d
    bit for bit.  At every shape of MATCH_SHAPES (every N2 from 256 to
    16384): the seven masks of ``fused_match_masks`` (threshold 5,
    disp_high 128), a flat image (no candidate) and an image of constant
    patches at threshold 0 (long runs of equal codes).  At three shapes,
    thresholds 0, 5, 40 x disp_high 0, 16, 128 with the zero forest.  The
    shipped forests must keep supports in the base cases."""
    from opengpc_tpu_torch.ops.fused_match import (
        fused_sparsematch_rows, fused_sparsematch_rows_plain)
    from opengpc_tpu_torch.utils import make_pair

    fm_masks = fused_match_masks(masks)
    rng = np.random.default_rng(13)
    worst, cases, failures, kept = 0, 0, [], {}

    def case(tag, left, right, mask, thr, disp, need_keep):
        nonlocal worst, cases
        got = fused_sparsematch_rows(left, right, mask, thr, disp)
        want = fused_sparsematch_rows_plain(left, right, mask, thr, disp)
        err = max(max_err(g, w_) for g, w_ in zip(got, want))
        worst, cases = max(worst, err), cases + 1
        kept[tag] = int(want[0].sum())
        if err or (need_keep and not want[0].any()):
            failures.append((tag, err, kept[tag]))

    for h, w in MATCH_SHAPES:
        left, right = (torch.from_numpy(a).cuda()
                       for a in make_pair(h, w, TRUE_DISP, seed=h + w))
        for name, mask in fm_masks.items():
            case(f"{h}x{w}/{name}", left, right, mask, 5, 128,
                 name in ("zero", "tau"))
        flat = torch.full((h, w), 77, dtype=torch.uint8, device="cuda")
        case(f"{h}x{w}/flat", flat, flat, fm_masks["zero"], 5, 128, False)
        patches = torch.from_numpy(patch_image(rng, h, w)).cuda()
        shifted = torch.roll(patches, -TRUE_DISP, dims=1)
        case(f"{h}x{w}/patches-thr0", patches, shifted, fm_masks["zero"], 0,
             128, False)
        if (h, w) in ((129, 130), (436, 1024), (129, 4096)):
            for thr in (0, 5, 40):
                for disp in (0, 16, 128):
                    case(f"{h}x{w}/thr{thr}/disp{disp}", left, right,
                         fm_masks["zero"], thr, disp, False)
    torch.cuda.synchronize()
    emit("fused_match_keeps", kept=kept)
    return finish_vs_twin("fused_sparsematch_rows", cases, worst, failures)


def check_supports(oracle, left, right, forest_file, sup, cpu, settings,
                   gate_disparity):
    """(ok, report) of one route's supports: the oracle gate, equality with
    the CPU pipeline, and, where ``gate_disparity``, the true-disparity
    share > MIN_ACCURACY (reported either way)."""
    ok_gate, gate = oracle_gate(oracle, left, right, forest_file, sup,
                                settings)
    acc = accuracy(sup)
    same_cpu = cpu is None or bool(np.array_equal(sup, cpu))
    ok = ok_gate and same_cpu and (acc > MIN_ACCURACY or not gate_disparity)
    return ok, dict(gate, true_disparity_share=acc, equals_cpu=same_cpu)


def route_cases():
    """The one-call routes at 436x1024: (name, settings, forest, expected
    route, launches of the path, gate on the true disparity).  A path is
    the dense and sparse pairs and a batch of 4, which these routes run
    pair by pair: 6 pairs, each one key-kernel or one code-kernel
    launch."""
    from opengpc_tpu_torch import InferenceSettings

    cap = H * W  # the default 32768 would truncate a dense scene
    keys, codes = {"fused_keys": 6}, {"fused_codes": 6}
    return [
        ("global-rows/zero", InferenceSettings(), "defaultZeroForest",
         "global-rows", keys, False),
        ("global-rows/tau", InferenceSettings(), "defaultTauForest",
         "global-rows", keys, False),
        ("flat/epipolar/32-tests",
         InferenceSettings(capacity=cap, **SETTINGS_KW), "tests32", "flat",
         codes, True),
        ("flat/global/32-tests", InferenceSettings(capacity=cap), "tests32",
         "flat", codes, False),
        ("global-rows/disp_high-1024",
         InferenceSettings(disp_high=1024, capacity=cap),
         "defaultZeroForest", "global-rows", keys, False),
        ("flat/epipolar/disp_high-2^20",
         InferenceSettings(disp_high=1 << 20, capacity=cap, **SETTINGS_KW),
         "defaultZeroForest", "flat", keys, False),
    ]


def phase_routes(oracle, paths, launches):
    """Every level-1 route of the one-call sparsematch at 436x1024 on the
    dense and the sparse scene, each driven as one path with the launch
    counters at 0, then held to the oracle gate and to the same call on
    the CPU.  A (4, H, W) batch of each must equal four single calls."""
    from opengpc_tpu_torch import load_forest, make_filter_mask, sparsematch
    from opengpc_tpu_torch.infer import route
    from opengpc_tpu_torch.utils import make_pair, make_sparse_pair

    scenes = {"dense": make_pair(H, W, TRUE_DISP),
              "sparse": make_sparse_pair(H, W, TRUE_DISP, density=0.15)}
    pairs = [make_pair(H, W, TRUE_DISP, seed=200 + b) for b in range(4)]
    lefts = np.stack([p[0] for p in pairs])
    rights = np.stack([p[1] for p in pairs])
    failures, report, all_counts = [], {}, {}
    for name, settings, forest, want_route, expect, gate_d in route_cases():
        mask = make_filter_mask(load_forest(paths[forest]))
        got_route = route(mask, (H, W), settings)

        def drive():
            out = {s: sparsematch(l, r, paths[forest], settings,
                                  device="cuda")
                   for s, (l, r) in scenes.items()}
            out["batch4"] = sparsematch(lefts, rights, paths[forest],
                                        settings, device="cuda")
            return out

        out, counts = launches.run(name, drive, expect)
        all_counts[name] = counts
        if got_route != want_route:
            failures.append(f"{name}: route {got_route}, not {want_route}")
        for scene, (left, right) in scenes.items():
            cpu = sparsematch(left, right, paths[forest], settings,
                              device="cpu")
            ok, rep = check_supports(oracle, left, right, paths[forest],
                                     out[scene], cpu, settings, gate_d)
            report[f"{name}/{scene}"] = rep
            if not ok:
                failures.append(f"{name}/{scene}: {rep}")
        singles = [sparsematch(l, r, paths[forest], settings, device="cuda")
                   for l, r in pairs]
        same = all(np.array_equal(a, b) for a, b in zip(out["batch4"],
                                                          singles))
        report[f"{name}/batch4"] = dict(
            supports=[len(s) for s in out["batch4"]], equals_single=same)
        if not same:
            failures.append(f"{name}/batch4 differs from single calls")
    emit("routes", launches=all_counts, checks=report, failures=failures)
    if failures:
        raise SystemExit(f"routes failed: {failures}")


def phase_variants(oracle, paths, masks, launches):
    """The selectable variants at 436x1024 with both shipped forests: the
    fused match (``_sparsematch_impl(fused_match=True)``) and the bitonic
    row sort (``match_epipolar(packed=True, sort_impl="bitonic")``) give
    the default flat path's support set and pass the oracle gate; each
    runs as one path with the launch counters at 0."""
    from opengpc_tpu_torch import InferenceSettings, supports_to_numpy
    from opengpc_tpu_torch.infer import _sparsematch_impl
    from opengpc_tpu_torch.match import match_epipolar
    from opengpc_tpu_torch.ops.fused import fused_codes_pair
    from opengpc_tpu_torch.utils import make_pair, make_sparse_pair

    settings = InferenceSettings(capacity=H * W, **SETTINGS_KW)
    scenes = {"dense": make_pair(H, W, TRUE_DISP),
              "sparse": make_sparse_pair(H, W, TRUE_DISP, density=0.15)}

    def bitonic(l, r, mask):
        (cl, vl), (cr, vr) = fused_codes_pair(l, r, mask,
                                              settings.gradient_threshold)
        (xs, ys, ds), count = match_epipolar(
            cl, cr, vl, vr, settings.disp_high, settings.capacity,
            packed=True, sort_impl="bitonic", num_tests=mask.num_tests)
        return xs, ys, ds, count

    variants = {
        "default": lambda l, r, m: _sparsematch_impl(l, r, m, settings),
        "fused_match": lambda l, r, m: _sparsematch_impl(
            l, r, m, settings, fused_match=True),
        "bitonic": bitonic}
    expect = {"default": {"fused_keys": 1},
              "fused_match": {"fused_sparsematch_rows": 1},
              "bitonic": {"fused_codes": 1, "bitonic_sort_rows": 1}}
    failures, report, all_counts = [], {}, {}
    for forest, mname in (("defaultZeroForest", "zero"),
                          ("defaultTauForest", "tau")):
        for scene, (left, right) in scenes.items():
            l_d, r_d = (torch.from_numpy(a).cuda() for a in (left, right))
            sets = {}
            for vname, fn in variants.items():
                key = f"{vname}/{forest}/{scene}"
                out, counts = launches.run(key, lambda: supports_to_numpy(
                    *fn(l_d, r_d, masks[mname])), expect[vname])
                all_counts[key] = counts
                sets[vname] = set(map(tuple, out.tolist()))
                ok, rep = check_supports(oracle, left, right, paths[forest],
                                         out, None, settings, False)
                report[key] = rep
                if not ok:
                    failures.append(f"{key}: {rep}")
                if sets[vname] != sets["default"]:
                    failures.append(f"{key}: support set differs from the "
                                    "default flat path's")
    emit("variants", launches=all_counts, checks=report, failures=failures)
    if failures:
        raise SystemExit(f"variants failed: {failures}")


def phase_descriptors(paths, masks, launches):
    """extract_descriptors at 436x1024 on the card equals its CPU run, for
    the 32-test forest and defaultZeroForest."""
    from opengpc_tpu_torch import InferenceSettings, extract_descriptors
    from opengpc_tpu_torch.utils import make_pair

    left, _ = make_pair(H, W, TRUE_DISP)
    settings = InferenceSettings(gradient_threshold=5)
    failures, report = [], {}
    for name in ("tests32", "zero"):
        got, counts = launches.run(
            f"descriptors/{name}", lambda: extract_descriptors(
                left, masks[name], settings, device="cuda"),
            {"fused_codes": 1})
        want = extract_descriptors(left, masks[name], settings, device="cpu")
        same = bool(np.array_equal(got, want))
        report[name] = dict(descriptors=len(got), equals_cpu=same,
                            launches=counts)
        if not same or not len(got):
            failures.append(f"{name}: {report[name]}")
    emit("descriptors", checks=report, failures=failures)
    if failures:
        raise SystemExit(f"descriptors failed: {failures}")


FUZZ_SEED, FUZZ_DRAWS = 606, 24
FUZZ_CLASSES = ("masked", "global-rows", "flat", "over-30", "over-32", "zero",
                "tau")


def fuzz_draw(rng, forest, epipolar=None):
    """One fuzz draw after its forest, in ``experiments/exp_tpu_fuzz.py``'s
    ranges: h 48-400, w 64-1400, threshold 1-29, disp_high 16, 64 or 128,
    vertical tolerance 0-2, either mode (unless forced); a ``make_scene``
    pair.  Capacity H*W: the flat route never truncates."""
    from opengpc_tpu_torch import InferenceSettings
    from opengpc_tpu_torch.utils import make_scene

    h, w = int(rng.integers(48, 400)), int(rng.integers(64, 1400))
    drawn = bool(rng.integers(0, 2))
    settings = InferenceSettings(
        gradient_threshold=int(rng.integers(1, 30)),
        disp_high=int(rng.choice([16, 64, 128])),
        vertical_tolerance=int(rng.integers(0, 3)),
        epipolar_mode=drawn if epipolar is None else epipolar,
        capacity=h * w)
    left, right, _, _ = make_scene(rng, h, w)
    return forest, settings, left, right


def fuzz_classes(draw):
    """The classes a draw covers: its one-call route, its forest type, and
    a test count past 30 (the flat matcher) and past 32 (the file-order
    cap)."""
    from opengpc_tpu_torch import make_filter_mask
    from opengpc_tpu_torch.infer import route

    forest, settings, left, _ = draw
    out = {route(make_filter_mask(forest), left.shape, settings),
           "zero" if forest.is_zero else "tau"}
    out |= {c for c, n in (("over-30", 30), ("over-32", 32))
            if forest.num_tests > n}
    return out


def fuzz_draws():
    """FUZZ_DRAWS random forests from ``utils.fuzz.random_forest`` with
    their shapes, settings and scenes, then one forced draw for each class
    of FUZZ_CLASSES none of them took, from the same generator: a forest
    past 32 tests (random forests joined until past 32) for the flat route
    and both counts, the first two ferns of a forest in the mode a route
    needs, all taus zero or drawn in [1, 10) for a forest type."""
    import dataclasses

    from opengpc_tpu_torch.forest import Fern, Forest
    from opengpc_tpu_torch.utils import random_forest

    rng = np.random.default_rng(FUZZ_SEED)
    draws = [fuzz_draw(rng, random_forest(rng)) for _ in range(FUZZ_DRAWS)]
    seen = set().union(*map(fuzz_classes, draws))
    for cls in FUZZ_CLASSES:
        if cls in seen:
            continue
        ferns = random_forest(rng).ferns
        while cls in ("flat", "over-30", "over-32") and \
                sum(len(f.tests) for f in ferns) <= 32:
            ferns += random_forest(rng).ferns
        if cls in ("zero", "tau"):
            ferns = tuple(Fern(f.scale, tuple(
                dataclasses.replace(t, tau=0 if cls == "zero"
                                    else int(rng.integers(1, 10)))
                for t in f.tests)) for f in ferns)
        if cls in ("masked", "global-rows"):
            ferns = ferns[:2]  # at most 24 tests
        epipolar = {"masked": True, "global-rows": False}.get(cls)
        draws.append(fuzz_draw(rng, Forest(ferns), epipolar))
        seen |= fuzz_classes(draws[-1])
    return draws, seen


def phase_fuzz(td, oracle, launches):
    """Random forests through every route of the one-call sparsematch on
    the card (the card's counterpart of ``experiments/exp_tpu_fuzz.py`` and
    ``tests/test_parity.py``'s random-forest fuzz).  Each draw's forest is
    written to a file and driven as one path with the launch counters at 0
    (one key-kernel launch on the masked and global-rows routes and where
    the flat route packs keys, else one code-kernel launch); its support
    set must equal the native oracle's and ``device="cpu"``'s exactly, and
    the masked builder's where the draw is eligible.  The draw's filter
    mask then goes through the key or code kernel at the draw's shape
    against its twin, bit for bit.  Returns the largest kernel-vs-twin
    difference by kernel."""
    from collections import Counter

    from opengpc_tpu_torch import (build_sparsematch_masked, make_filter_mask,
                                   masked_supports_to_numpy, save_forest,
                                   sparsematch)
    from opengpc_tpu_torch.infer import _packed_ok, _rows_ok, route
    from opengpc_tpu_torch.match import SENTINEL_BASE
    from opengpc_tpu_torch.ops.fused import (fused_codes_pair,
                                             fused_codes_plain,
                                             fused_key_image, fused_keys_plain)

    t0 = time.perf_counter()
    draws, covered = fuzz_draws()
    failures, routes, by_kernel = [], Counter(), Counter()
    errs = {"fused_keys": 0, "fused_codes": 0}
    supports, tests = 0, []
    for i, (forest, settings, left, right) in enumerate(draws):
        path = os.path.join(td, f"fuzz{i}.txt")
        save_forest(forest, path)
        mask = make_filter_mask(forest)
        shape = left.shape
        r = route(mask, shape, settings)
        keys = r != "flat" or (settings.epipolar_mode
                               and _packed_ok(mask, shape))
        kernel = "fused_keys" if keys else "fused_codes"
        sup, counts = launches.run(
            f"fuzz/{i}", lambda: sparsematch(left, right, path, settings,
                                             device="cuda"), {kernel: 1})
        routes[r] += 1
        by_kernel.update({k: n for k, n in counts.items() if n})
        tests.append(forest.num_tests)
        got = support_keys(sup)
        supports += int(got.size)
        ctx = (f"draw {i}: {r} {forest.num_tests} tests zero={forest.is_zero} "
               f"{shape} {settings}")
        if not np.array_equal(got, oracle_set(oracle, left, right, path,
                                              settings)):
            failures.append(f"{ctx}: differs from the oracle")
        cpu = sparsematch(left, right, path, settings, device="cpu")
        if not np.array_equal(got, support_keys(cpu)):
            failures.append(f"{ctx}: differs from device='cpu'")
        l_d, r_d = (torch.from_numpy(a).cuda() for a in (left, right))
        if settings.epipolar_mode and _rows_ok(mask, shape, settings):
            out, counts = launches.run(
                f"fuzz/{i}/masked", lambda: build_sparsematch_masked(
                    forest, settings, device="cuda")(l_d, r_d),
                {"fused_keys": 1})
            by_kernel.update({k: n for k, n in counts.items() if n})
            if not np.array_equal(got, support_keys(masked_supports_to_numpy(
                    *out, settings.disp_high))):
                failures.append(f"{ctx}: the masked builder differs")
        thr = settings.gradient_threshold
        if keys:
            kernel_out = fused_key_image(l_d[None], r_d[None], mask, thr,
                                         SENTINEL_BASE)
            twin = torch.cat([fused_keys_plain(l_d[None], mask, thr, 0,
                                               SENTINEL_BASE),
                              fused_keys_plain(r_d[None], mask, thr,
                                               shape[1], SENTINEL_BASE)],
                             dim=2)
            err = max_err(kernel_out, twin)
        else:
            got_c = fused_codes_pair(l_d, r_d, mask, thr)
            want_c = [fused_codes_plain(x, mask, thr) for x in (l_d, r_d)]
            err = max(max_err(g, w_) for gs, ws in zip(got_c, want_c)
                      for g, w_ in zip(gs, ws))
        errs[kernel] = max(errs[kernel], err)
        if err:
            failures.append(f"{ctx}: {kernel} differs from its twin by {err}")
    torch.cuda.synchronize()
    missing = sorted(set(FUZZ_CLASSES) - covered)
    if missing:
        failures.append(f"classes not covered: {missing}")
    for k in ("fused_keys", "fused_codes"):
        if not by_kernel[k]:
            failures.append(f"no draw launched {k}")
    emit("fuzz", seed=FUZZ_SEED, draws=len(draws),
         forced=len(draws) - FUZZ_DRAWS, routes=dict(routes),
         tests_range=[min(tests), max(tests)],
         zero_forests=sum(d[0].is_zero for d in draws),
         launches=dict(by_kernel), supports=supports, max_abs_err=errs,
         seconds=time.perf_counter() - t0, failures=failures[:10])
    if failures:
        raise SystemExit(f"fuzz failed: {failures[:10]}")
    return errs


def kernel_vs_plain_times(kernel, plain, k_iters, p_iters, library=None):
    """Events ms per call in turns (plain, kernel, kernel, plain), the
    profiler's device ms per call of each and each one's CUDA graph
    replays, on one card; with ``library`` (one PyTorch call computing the
    same function) its events, device and graph ms too, in turns with the
    kernel (library, kernel, kernel, library)."""
    p1 = cuda_ms(plain, p_iters)
    k1 = cuda_ms(kernel, k_iters)
    k2 = cuda_ms(kernel, k_iters)
    p2 = cuda_ms(plain, p_iters)
    pk = kernel_profile(kernel, max(5, k_iters // 10))
    pp = kernel_profile(plain, max(3, p_iters // 5))
    out = {}
    device = dict(ms=pk["device_ms"], plain_ms=pp["device_ms"])
    events = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2)
    graph = dict(ms=graph_ms(kernel, k_iters // 2),
                 plain_ms=graph_ms(plain, p_iters))
    if library is not None:
        l1 = kernel_profile(library, max(5, k_iters // 10))
        kl = [kernel_profile(kernel, max(5, k_iters // 10))
              for _ in range(2)]
        l2 = kernel_profile(library, max(5, k_iters // 10))
        lib_dev = [l1["device_ms"], l2["device_ms"]]
        lib_events = [cuda_ms(library, k_iters) for _ in range(2)]
        out = dict(library_events_ms=lib_events, library_device_ms=lib_dev,
                   library_kernels=l1["kernels"][:4],
                   turns_device_ms=[kl[0]["device_ms"], kl[1]["device_ms"]])
        device["library_ms"] = None if None in lib_dev else float(
            np.mean(lib_dev))
        events["library_ms"] = float(np.mean(lib_events))
        graph["library_ms"] = graph_ms(library, k_iters // 2)
    return dict(out, events_ms=[k1, k2], plain_events_ms=[p1, p2],
                device_ms=pk["device_ms"], plain_device_ms=pp["device_ms"],
                kernels=pk["kernels"][:4], plain_kernels=pp["kernels"][:4],
                events=events, graph_ms=graph, **line_times(device, graph))


def with_bound(times, nbytes, ops):
    """``times`` with the bound of its work beside it."""
    ms, by = bound(nbytes, ops)
    return dict(times, bound_ms=ms, bound_by=by, bytes=nbytes, ops=ops)


def phase_key_times(smi, masks):
    """Device time of the one-launch key kernel (both images of B pairs)
    with its bound: the dense and sparse 436x1024 pairs at B = 1 and 4,
    and a dense 2160x3840 pair, zero forest."""
    from opengpc_tpu_torch.match import SENTINEL_BASE
    from opengpc_tpu_torch.ops.fused import fused_key_image
    from opengpc_tpu_torch.utils import make_pair, make_sparse_pair

    zero = masks["zero"]
    cases = {}
    for name, (h, w), make in (
            ("dense", (H, W), lambda s: make_pair(H, W, TRUE_DISP, seed=s)),
            ("sparse", (H, W), lambda s: make_sparse_pair(
                H, W, TRUE_DISP, density=0.15, seed=s)),
            ("dense-2160x3840", (2160, 3840),
             lambda s: make_pair(2160, 3840, TRUE_DISP, seed=s))):
        for b in ((1, 4) if h == H else (1,)):
            pairs = [make(400 + i) for i in range(b)]
            lefts, rights = (torch.from_numpy(np.stack([p[i] for p in pairs]))
                             .cuda() for i in (0, 1))
            keys = fused_key_image(lefts, rights, zero, 5, SENTINEL_BASE)
            ncand = int((keys < SENTINEL_BASE).sum())
            prof = [kernel_profile(lambda: fused_key_image(
                lefts, rights, zero, 5, SENTINEL_BASE), 50) for _ in range(2)]
            ms, by = bound(2 * b * h * w * (1 + 4),
                           code_ops(2 * b, h, w, ncand, zero.num_tests))
            cases[f"{name}/B{b}"] = dict(
                device_us=[us_or_none(p["device_ms"]) for p in prof],
                bound_us=ms * 1e3, bound_by=by,
                candidate_share=ncand / (2 * b * h * w),
                launches_per_call=(prof[0]["kernels"][0][2]
                                   if prof[0]["kernels"] else None))
    emit("key_kernel_times", card=smi, forest="defaultZeroForest", **cases)


def phase_new_times(smi, masks, images):
    """The code kernel (both images of a pair in one launch, 32 tests), the
    bitonic sort (against torch.sort on the matcher rows), the matcher's
    row sort on the cells' generator images (``row_sort_images``; against
    torch.sort, the key-value sort it replaced) and the fused
    match (at 436x1024 and 1080x1920, beside the row-sort kernel alone on
    the same padded rows) against their twins, and ms
    per pair of the global-rows route, the flat route (32 tests) and the
    fused-match and bitonic variants (zero forest) at B=1 and B=4."""
    from opengpc_tpu_torch import (InferenceSettings, build_sparsematch,
                                   build_sparsematch_global_rows)
    from opengpc_tpu_torch.infer import (_interior_rows, _key_image,
                                         _sparsematch_impl)
    from opengpc_tpu_torch.match import match_epipolar
    from opengpc_tpu_torch.ops.fused import fused_codes_pair, fused_codes_plain
    from opengpc_tpu_torch.ops.fused_match import (
        fused_sparsematch_rows, fused_sparsematch_rows_plain)
    from opengpc_tpu_torch.match import PAD_KEY_BASE, SENTINEL_BASE
    from opengpc_tpu_torch.ops.sort import (bitonic_sort_rows,
                                            bitonic_sort_rows_plain,
                                            padded_row_length, row_sort,
                                            row_sort_plain)
    from opengpc_tpu_torch.utils import make_pair

    left, right = make_pair(H, W, TRUE_DISP)
    l_d, r_d = torch.from_numpy(left).cuda(), torch.from_numpy(right).cuda()
    zero, t32 = masks["zero"], masks["tests32"]
    epi = InferenceSettings(capacity=H * W, **SETTINGS_KW)
    times = {}
    times["fused_codes"] = with_bound(kernel_vs_plain_times(
        lambda: fused_codes_pair(l_d, r_d, t32, 5),
        lambda: (fused_codes_plain(l_d, t32, 5),
                 fused_codes_plain(r_d, t32, 5)), 200, 20),
        2 * H * W * (1 + 4 + 1),
        code_ops(2, H, W, 2 * H * W, t32.num_tests))
    full_key = _key_image(l_d, r_d, zero, epi)
    key = _interior_rows(full_key)[0].contiguous()
    rows, n = key.shape
    pos = torch.arange(n, dtype=torch.int32,
                       device="cuda").expand(rows, -1).contiguous()
    times["bitonic_sort_rows"] = with_bound(kernel_vs_plain_times(
        lambda: bitonic_sort_rows(key, pos),
        lambda: bitonic_sort_rows_plain(key, pos), 200, 20,
        library=lambda: torch.sort(key, dim=1, stable=False)),
        16 * rows * n, network_ops(rows, n))
    times["bitonic_sort_rows"]["rows"] = [rows, n]
    for name, image in (("row_sort", "sintel_b32/generator"),
                        ("row_sort_uhd4k", "uhd4k_b1/generator")):
        cell = images[image]
        times[name] = with_bound(kernel_vs_plain_times(
            lambda: row_sort(cell), lambda: row_sort_plain(cell), 200, 20,
            library=lambda: torch.sort(cell, dim=1, stable=False)),
            12 * cell.numel(), row_sort_ops(cell))
        times[name]["rows"] = list(cell.shape)
    big = [torch.from_numpy(a).cuda()
           for a in make_pair(1080, 1920, TRUE_DISP)]
    for name, (lm, rm) in (("fused_sparsematch_rows", (l_d, r_d)),
                           ("fused_sparsematch_rows_1080x1920", big)):
        h, w = lm.shape
        n2 = padded_row_length(w)
        ncand = int((_key_image(lm, rm, zero, epi) < SENTINEL_BASE).sum())
        times[name] = with_bound(kernel_vs_plain_times(
            lambda: fused_sparsematch_rows(lm, rm, zero, 5, 128),
            lambda: fused_sparsematch_rows_plain(lm, rm, zero, 5, 128), 200,
            20), 2 * h * w + 9 * h * n2,
            code_ops(2, h, w, ncand, zero.num_tests) + network_ops(h, n2)
            + 10 * h * n2)
        # device us of the row-sort kernel alone on the same padded key
        # rows, the network the fused kernel runs
        lane = torch.arange(n2, dtype=torch.int32, device="cuda")
        rows_key = torch.cat([_key_image(lm, rm, zero, epi),
                              (PAD_KEY_BASE + lane[2 * w:]).expand(h, -1)],
                             dim=1)
        rows_pos = lane.expand(h, -1).contiguous()
        times[name]["sort_alone_device_us"] = [us_or_none(kernel_profile(
            lambda: bitonic_sort_rows(rows_key, rows_pos), 50)["device_ms"])
            for _ in range(2)]
    emit("kernel_times", card=smi, shape=[H, W], **times)

    pairs = [make_pair(H, W, TRUE_DISP, seed=300 + b) for b in range(4)]
    lb = torch.from_numpy(np.stack([p[0] for p in pairs])).cuda()
    rb = torch.from_numpy(np.stack([p[1] for p in pairs])).cuda()
    global_rows = build_sparsematch_global_rows(zero, InferenceSettings(),
                                                device="cuda")
    flat32 = build_sparsematch(t32, epi, device="cuda")
    flat_zero = build_sparsematch(zero, epi, device="cuda")

    def per_pair(fn):
        return lambda l, r: [fn(l[i], r[i]) for i in range(l.shape[0])] \
            if l.dim() == 3 else fn(l, r)

    def bitonic(l, r):
        (cl, vl), (cr, vr) = fused_codes_pair(l, r, zero,
                                              epi.gradient_threshold)
        return match_epipolar(cl, cr, vl, vr, epi.disp_high, epi.capacity,
                              packed=True, sort_impl="bitonic",
                              num_tests=zero.num_tests)

    pipelines = {
        "global_rows/zero": global_rows,
        "flat/epipolar/32-tests": flat32,
        "flat/epipolar/zero": flat_zero,
        "fused_match/zero": per_pair(lambda l, r: _sparsematch_impl(
            l, r, zero, epi, fused_match=True)),
        "bitonic/zero": per_pair(bitonic)}
    route_times, profiles = {}, {}
    for name, fn in pipelines.items():
        route_times[name] = dict(
            ms_per_pair_b1=[cuda_ms(lambda: fn(l_d, r_d), 50)
                            for _ in range(2)],
            ms_per_pair_b4=[cuda_ms(lambda: fn(lb, rb), 20) / 4
                            for _ in range(2)])
        profiles[name] = device_profile(lambda: fn(l_d, r_d), 20)
    emit("route_profile", card=smi, **profiles)
    emit("route_times", card=smi, shape=[H, W], **route_times)
    return {name: dict(t, library_ms=t.get("library_ms"))
            for name, t in times.items()}


def phase_slab_vs_twin(masks):
    """The key kernel's slab mode vs its twin on the card, bit for bit:
    every shard of n = 2, 4, 8 (where H divides) at 436x1024 and
    2160x3840, one slab a launch, with every kernel mask, and the joined
    shards equal whole-frame fused_keys; then both slabs of a shard in one
    launch (``infer._key_image_slab`` on one contiguous (2, sh + 28, W)
    tensor, as the sharded frame builds them) against the two plain slabs,
    for the top, a middle and the bottom shard of every SLAB_PAIR_SHAPES
    frame with three masks, and a (3, sh + 28, W) batch of left and right
    slabs in one launch."""
    import torch.nn.functional as F

    from opengpc_tpu_torch import InferenceSettings
    from opengpc_tpu_torch.infer import _key_image_slab
    from opengpc_tpu_torch.match import SENTINEL_BASE
    from opengpc_tpu_torch.ops.fused import (PAD, fused_keys, fused_keys_slab,
                                             fused_keys_slab_plain)

    rng = np.random.default_rng(10)
    worst, cases, failures = 0, 0, []
    for h, w in SLAB_SHAPES:
        img = torch.from_numpy(structured_image(rng, h, w)).cuda()
        padded = F.pad(img, (0, 0, PAD, PAD))
        for name, mask in masks.items():
            whole = fused_keys(img, mask, 5, w, SENTINEL_BASE)
            for n in (2, 4, 8):
                if h % n:
                    continue
                sh, blocks = h // n, []
                for i in range(n):
                    slab = padded[i * sh:(i + 1) * sh + 2 * PAD]
                    got = fused_keys_slab(slab, mask, 5, w, SENTINEL_BASE,
                                          i * sh, h)
                    want = fused_keys_slab_plain(slab, mask, 5, w,
                                                 SENTINEL_BASE, i * sh, h)
                    err = max_err(got, want)
                    worst, cases = max(worst, err), cases + 1
                    if err or not (want < SENTINEL_BASE).any():
                        failures.append((h, w, name, n, i, err))
                    blocks.append(got)
                err = max_err(torch.cat(blocks), whole)
                worst, cases = max(worst, err), cases + 1
                if err:
                    failures.append((h, w, name, n, "joined", err))
    settings = InferenceSettings(**SETTINGS_KW)
    pair_masks = {k: masks[k] for k in ("zero", "tests32", "random0_32t")}
    for h, w, n in SLAB_PAIR_SHAPES:
        sh = h // n
        frames = [F.pad(torch.from_numpy(structured_image(rng, h, w)).cuda(),
                        (0, 0, PAD, PAD)) for _ in range(6)]
        for i in (0, n // 2, n - 1):
            slabs = [f[i * sh:(i + 1) * sh + 2 * PAD] for f in frames]
            pair = torch.stack(slabs[:2])
            lefts, rights = torch.stack(slabs[0::2]), torch.stack(slabs[1::2])
            for name, mask in pair_masks.items():
                def plain(sl, sr):
                    return torch.cat([
                        fused_keys_slab_plain(sl, mask, 5, 0, SENTINEL_BASE,
                                              i * sh, h),
                        fused_keys_slab_plain(sr, mask, 5, w, SENTINEL_BASE,
                                              i * sh, h)], dim=-1)
                want = plain(pair[0], pair[1])
                got = _key_image_slab(pair[0], pair[1], mask, settings,
                                      i * sh, h)
                got_b = _key_image_slab(lefts, rights, mask, settings,
                                        i * sh, h)
                err = max(max_err(got, want),
                          max_err(got_b, plain(lefts, rights)))
                worst, cases = max(worst, err), cases + 1
                if err or not (want < SENTINEL_BASE).any():
                    failures.append(("pair", h, w, n, i, name, err))
    torch.cuda.synchronize()
    return finish_vs_twin("fused_keys_slab", cases, worst, failures)


def oracle_census(oracle, img):
    """The native oracle's 5x5 census of a uint8 image, as int64."""
    from opengpc_tpu_torch.io import read_raw, write_raw

    with tempfile.TemporaryDirectory() as td:
        inp, out = os.path.join(td, "in.raw"), os.path.join(td, "out.raw")
        write_raw(inp, img)
        subprocess.run([oracle, "census", inp, out], check=True)
        return read_raw(out).astype(np.int64)


def phase_census_vs_twin(oracle):
    """fused_census vs its twin (``ops.census.census5x5``) on the card, bit
    for bit, on odd shapes up to 2160x3840, and equal to the oracle's
    census at 436x1024."""
    from opengpc_tpu_torch.ops.census import census5x5
    from opengpc_tpu_torch.ops.fused import fused_census

    rng = np.random.default_rng(11)
    worst, cases, failures = 0, 0, []
    for h, w in CENSUS_SHAPES:
        host = structured_image(rng, h, w)
        img = torch.from_numpy(host).cuda()
        got, want = fused_census(img), census5x5(img)
        err = max_err(got, want)
        worst, cases = max(worst, err), cases + 1
        if err or (h > 5 and not want.any()):
            failures.append((h, w, err))
        if (h, w) == (H, W):
            diff = np.abs(got.cpu().numpy() - oracle_census(oracle, host))
            worst, cases = max(worst, int(diff.max())), cases + 1
            if diff.any():
                failures.append((h, w, "oracle", int(diff.max())))
    torch.cuda.synchronize()
    return finish_vs_twin("fused_census", cases, worst, failures)


def _leaves(out):
    if isinstance(out, tuple):
        return [leaf for o in out for leaf in _leaves(o)]
    return [out]


def _decode(contract, out, settings):
    from opengpc_tpu_torch import (global_row_supports_to_numpy,
                                   masked_supports_to_numpy,
                                   row_supports_to_numpy)

    if contract == "global-compact":
        return global_row_supports_to_numpy(*out[0], out[1])
    if contract == "rows":
        return row_supports_to_numpy(*out[0], out[1])
    return masked_supports_to_numpy(out[0], out[1], settings.disp_high)


def sharded_cases():
    """(contract, settings, scene, expected overflow flag): masked and rows
    on both scenes, masked-compact clear on the sparse and set on the dense
    scene, global-compact at the library defaults on the sparse scene."""
    from opengpc_tpu_torch import InferenceSettings

    epi = InferenceSettings(**SETTINGS_KW)
    cases = [(c, epi, s, None) for c in ("masked", "rows")
             for s in ("dense", "sparse")]
    return cases + [("masked-compact", epi, "sparse", False),
                    ("masked-compact", epi, "dense", True),
                    ("global-compact", InferenceSettings(), "sparse", False)]


def phase_sharded_frame(oracle, paths, launches):
    """The row-sharded single frame at 436x1024 with both shipped forests:
    n = 1 over a real one-rank NCCL process group, n = 4 through the
    one-process helper (n = 2 is left to the CPU tests), every contract;
    and masked at 2160x3840 with n = 4.
    Each path runs with the launch counters at 0 and must launch the key
    kernel's slab mode once a shard; each result equals the
    single-device module of its contract on the card (bit for bit; the
    global contract as a support set, its segments following the bucket
    order) and passes the oracle gate, unless its overflow flag is set,
    as it must be on the dense scene."""
    import torch.distributed as dist

    from opengpc_tpu_torch import (build_sparsematch_global_compact,
                                   build_sparsematch_masked,
                                   build_sparsematch_masked_compact,
                                   build_sparsematch_rows, load_forest,
                                   make_filter_mask)
    from opengpc_tpu_torch.parallel import (_run_in_one_process,
                                            build_sharded_frame_sparsematch)
    from opengpc_tpu_torch.utils import make_pair, make_sparse_pair

    single_builders = {"masked": build_sparsematch_masked,
                       "rows": build_sparsematch_rows,
                       "masked-compact": build_sparsematch_masked_compact,
                       "global-compact": build_sparsematch_global_compact}
    scenes = {"dense": make_pair(H, W, TRUE_DISP),
              "sparse": make_sparse_pair(H, W, TRUE_DISP, density=0.15)}
    big = {"dense-2160x3840": make_pair(2160, 3840, TRUE_DISP, seed=5)}
    failures, report, all_counts = [], {}, {}

    def check(key, contract, settings, forest, pair, out, counts, want_flag):
        left, right = pair
        single = single_builders[contract](
            make_filter_mask(load_forest(paths[forest])), settings,
            device="cuda")(*(torch.from_numpy(a).cuda() for a in pair))
        all_counts[key] = counts
        rep = {}
        if want_flag is not None:
            rep["overflow"] = bool(out[-1])
            if bool(out[-1]) != want_flag or bool(single[-1]) != want_flag:
                failures.append(f"{key}: overflow {bool(out[-1])}, single "
                                f"{bool(single[-1])}, want {want_flag}")
            if want_flag:
                report[key] = rep
                return
        sup = _decode(contract, out, settings)
        if contract == "global-compact":
            same = (set(map(tuple, sup.tolist()))
                    == set(map(tuple, _decode(contract, single,
                                              settings).tolist())))
        else:
            same = all(torch.equal(a, b) for a, b in
                       zip(_leaves(out), _leaves(single), strict=True))
        ok, gate = oracle_gate(oracle, left, right, paths[forest], sup,
                               settings)
        report[key] = dict(rep, **gate, equals_single_device=same)
        if not (same and ok and len(sup)):
            failures.append(f"{key}: {report[key]}")

    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as td:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(td, "store"), 1),
            rank=0, world_size=1)
        try:
            for n in (1, 4):
                group = dist.group.WORLD if n == 1 else None
                for forest in FORESTS:
                    mask = make_filter_mask(load_forest(paths[forest]))
                    for contract, settings, scene, flag in sharded_cases():
                        mod = build_sharded_frame_sparsematch(
                            mask, settings, group=group, contract=contract,
                            device="cuda")
                        l_d, r_d = (torch.from_numpy(a).cuda()
                                    for a in scenes[scene])
                        key = f"n{n}/{forest}/{contract}/{scene}"
                        # one slab-mode launch a shard, both slabs
                        out, counts = launches.run(
                            key, lambda: mod(l_d, r_d) if n == 1
                            else _run_in_one_process(mod, l_d, r_d, n),
                            {"fused_keys_slab": n})
                        check(key, contract, settings, forest, scenes[scene],
                              out, counts, flag)
        finally:
            dist.destroy_process_group()
    from opengpc_tpu_torch import InferenceSettings

    settings = InferenceSettings(**SETTINGS_KW)
    mask = make_filter_mask(load_forest(paths["defaultZeroForest"]))
    mod = build_sharded_frame_sparsematch(mask, settings, device="cuda")
    for scene, pair in big.items():
        l_d, r_d = (torch.from_numpy(a).cuda() for a in pair)
        key = f"n4/defaultZeroForest/masked/{scene}"
        out, counts = launches.run(
            key, lambda: _run_in_one_process(mod, l_d, r_d, 4),
            {"fused_keys_slab": 4})
        check(key, "masked", settings, "defaultZeroForest", pair, out,
              counts, None)
    emit("sharded_frame", cases=len(report), launches=all_counts,
         checks=report, failures=failures)
    if failures:
        raise SystemExit(f"sharded frame failed: {failures}")


def phase_census(launches):
    """One census API call through fused_census on the card, with its
    launch counter read."""
    from opengpc_tpu_torch.ops.census import census5x5
    from opengpc_tpu_torch.ops.fused import fused_census

    img = torch.from_numpy(structured_image(np.random.default_rng(12), H,
                                            W)).cuda()
    out, counts = launches.run("census", lambda: fused_census(img),
                               {"fused_census": 1})
    same = bool(torch.equal(out, census5x5(img)))
    emit("census", launches=counts, equals_twin=same, shape=[H, W])
    if not same:
        raise SystemExit(f"census call failed: {counts}, equal {same}")


def phase_png_paths(td, paths, launches):
    """The one-call sparsematch on PNG paths at 436x1024: the dense and
    sparse pairs and a list of 4 pairs' paths (the thread-pool decode),
    written with the port's ``write_png``, driven as one path with the
    launch counters at 0 (one key-kernel launch a call, the batch folded)
    and equal to the same calls on the arrays; and the ms to read a frame
    with the reader that ran, beside the numpy codec on the same file and
    on a filter-0 file."""
    from opengpc_tpu_torch import InferenceSettings, sparsematch
    from opengpc_tpu_torch.io import png
    from opengpc_tpu_torch.utils import make_pair, make_sparse_pair

    settings = InferenceSettings(**SETTINGS_KW)
    forest = paths["defaultZeroForest"]
    scenes = {"dense": make_pair(H, W, TRUE_DISP),
              "sparse": make_sparse_pair(H, W, TRUE_DISP, density=0.15)}
    pairs = [make_pair(H, W, TRUE_DISP, seed=100 + b) for b in range(4)]

    def write(name, img):
        path = os.path.join(td, f"{name}.png")
        png.write_png(path, img)
        return path

    files = {s: (write(f"{s}_l", l), write(f"{s}_r", r))
             for s, (l, r) in scenes.items()}
    lists = tuple([write(f"batch{b}_{side}", p[i]) for b, p in enumerate(pairs)]
                  for i, side in enumerate("lr"))

    def drive():
        out = {s: sparsematch(*files[s], forest, settings, device="cuda")
               for s in scenes}
        out["batch4"] = sparsematch(*lists, forest, settings, device="cuda")
        return out

    out, counts = launches.run("png_paths", drive, {"fused_keys": 3})
    failures, report = [], {}
    for s, pair in scenes.items():
        same = bool(np.array_equal(
            out[s], sparsematch(*pair, forest, settings, device="cuda")))
        report[s] = dict(supports=len(out[s]), equals_array_call=same)
        if not same or not len(out[s]):
            failures.append(f"{s}: {report[s]}")
    want = sparsematch(np.stack([p[0] for p in pairs]),
                       np.stack([p[1] for p in pairs]), forest, settings,
                       device="cuda")
    same = all(np.array_equal(a, b) for a, b in zip(out["batch4"], want))
    report["batch4"] = dict(supports=[len(a) for a in out["batch4"]],
                            equals_array_call=same)
    if not same:
        failures.append(f"batch4: {report['batch4']}")
    frame = files["dense"][0]
    plain = os.path.join(td, "filter0.png")
    png._write_python(plain, scenes["dense"][0], 1)
    emit("png_paths", launches=counts, reader=png.png_reader(),
         read_ms_median=median_ms(lambda: png.read_gray(frame), 20),
         numpy_codec_read_ms=median_ms(lambda: png._read_python(frame), 3),
         numpy_codec_filter0_read_ms_median=median_ms(
             lambda: png._read_python(plain), 20),
         batch4_read_ms_median=median_ms(
             lambda: png.read_gray_batch(lists[0]), 20),
         shape=[H, W], checks=report, failures=failures)
    if failures:
        raise SystemExit(f"png paths failed: {failures}")


def main_path_masked_cases(paths):
    """(name, mask, left, right) of every masked case of ``main_path``:
    both scenes with both forests and the 17-test cut, and the batches'
    pairs with the zero forest."""
    from opengpc_tpu_torch import load_forest, make_filter_mask
    from opengpc_tpu_torch.utils import make_pair, make_sparse_pair

    zero = load_forest(paths["defaultZeroForest"])
    masks = {"defaultZeroForest": make_filter_mask(zero),
             "defaultTauForest": make_filter_mask(
                 load_forest(paths["defaultTauForest"])),
             "zero17": make_filter_mask(zero, max_tests=17)}
    makes = {"dense": lambda s: make_pair(H, W, TRUE_DISP, seed=s),
             "sparse": lambda s: make_sparse_pair(H, W, TRUE_DISP,
                                                  density=0.15, seed=s)}
    cases = []
    for scene, make in makes.items():
        for name, mask in masks.items():
            cases.append((f"{scene}/{name}", mask, *make(42)))
        for b in range(4):
            cases.append((f"{scene}/batch{b}", masks["defaultZeroForest"],
                          *make(100 + b)))
    return cases


def phase_native_decode(smi, paths):
    """The host library's masked decode on the card's host: the library
    must have built from ``cpp/``; its threaded and sequential scans equal
    the numpy decode on the card's masked buffers of every masked case of
    ``main_path`` and of a dense 2160x3840 pair; all three priced (median
    of 20, of 5 for numpy at 2160x3840) on the dense pairs' buffers, the
    scans in turns."""
    from opengpc_tpu_torch import (InferenceSettings, build_sparsematch_masked,
                                   load_forest, make_filter_mask)
    from opengpc_tpu_torch.infer import _masked_decode_numpy
    from opengpc_tpu_torch.io import _host, png
    from opengpc_tpu_torch.match import MASKED_SENTINEL
    from opengpc_tpu_torch.utils import make_pair

    if png._native_lib() is None:
        raise SystemExit("native decode: the host library did not build:\n"
                         f"{_host.build_info.get('log')}")
    settings = InferenceSettings(**SETTINGS_KW)
    dh = settings.disp_high
    failures, bufs = [], {}
    for name, mask, left, right in main_path_masked_cases(paths):
        buf, rc = build_sparsematch_masked(mask, settings, device="cuda")(
            *(torch.from_numpy(a).cuda() for a in (left, right)))
        buf, rc = buf.cpu().numpy(), rc.cpu().numpy()
        n = int(rc.sum())
        ref = _masked_decode_numpy(buf, n, dh)
        par = png.masked_decode_native(buf, n, dh, MASKED_SENTINEL,
                                       row_counts=rc)
        seq = png.masked_decode_native(buf, n, dh, MASKED_SENTINEL)
        if not (np.array_equal(par, ref) and np.array_equal(seq, ref) and n):
            failures.append(name)
        bufs[name] = (buf, rc, n)
    buf, rc, n = bufs["dense/defaultZeroForest"]
    scans = {
        "native_threaded": lambda: png.masked_decode_native(
            buf, n, dh, MASKED_SENTINEL, row_counts=rc),
        "native_sequential": lambda: png.masked_decode_native(
            buf, n, dh, MASKED_SENTINEL),
        "numpy": lambda: _masked_decode_numpy(buf, n, dh)}
    ms = {name: [] for name in scans}  # in turns: A B C C B A
    for name in list(scans) + list(scans)[::-1]:
        ms[name].append(median_ms(scans[name], 20))
    # the threaded scan's case: a 2160x3840 dense pair's buffer
    zero = make_filter_mask(load_forest(paths["defaultZeroForest"]))
    big, big_rc = build_sparsematch_masked(zero, settings, device="cuda")(
        *(torch.from_numpy(a).cuda()
          for a in make_pair(2160, 3840, TRUE_DISP, seed=5)))
    big, big_rc = big.cpu().numpy(), big_rc.cpu().numpy()
    big_n = int(big_rc.sum())
    ref = _masked_decode_numpy(big, big_n, dh)
    big_scans = {
        "native_threaded": lambda: png.masked_decode_native(
            big, big_n, dh, MASKED_SENTINEL, row_counts=big_rc),
        "native_sequential": lambda: png.masked_decode_native(
            big, big_n, dh, MASKED_SENTINEL)}
    if not all(np.array_equal(f(), ref) for f in big_scans.values()):
        failures.append("dense-2160x3840")
    big_ms = {name: [] for name in big_scans}  # A B B A
    for name in list(big_scans) + list(big_scans)[::-1]:
        big_ms[name].append(median_ms(big_scans[name], 20))
    big_ms["numpy"] = median_ms(lambda: _masked_decode_numpy(big, big_n, dh),
                                5)
    emit("native_decode", card=smi, cases=len(bufs) + 1, failures=failures,
         library=os.path.basename(_host.library_path()),
         reader=png.png_reader(),
         build_seconds=_host.build_info.get("seconds"),
         build_log=_host.build_info.get("log", "")[-800:],
         threads=png._DECODE_THREADS, cpu_count=os.cpu_count(),
         affinity=len(os.sched_getaffinity(0)), buffer=list(buf.shape),
         supports=n, ms_median_of_20_in_turns=ms,
         big_buffer=list(big.shape), big_supports=big_n, big_ms=big_ms)
    if failures:
        raise SystemExit(f"native decode differs from numpy: {failures}")


def np_downscale2(img):
    """The pyramid's 2x2 floor mean in numpy, (a + b + c + d) // 4."""
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    x = img[:2 * h2, :2 * w2].astype(np.int32)
    return ((x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2])
            // 4).astype(np.uint8)


def pyramid_gate(oracle, left, right, forest_file, supports, settings,
                 levels):
    """The oracle gate a level: level l's (x, y, d) rows, divided by 2^l,
    are a subset of the oracle's set on the images downscaled l times in
    numpy, and of the oracle's supports whose level-0 pixel no finer level
    took, at least 99.9% are reproduced (level 0: ``oracle_gate``)."""
    ok, report = True, {}
    taken = np.zeros(0, np.int64)  # level-0 pixels, x << 21 | y
    for level in range(levels):
        mine = supports[supports[:, 3] == level][:, :3].astype(np.int64)
        want = oracle_set(oracle, left, right, forest_file, settings)
        got = support_keys(mine >> level)
        exact = not (mine % (1 << level)).any()
        x, y = want >> 43, (want >> 22) & ((1 << 21) - 1)
        free = want[~np.isin(((x << level) << 21) | (y << level), taken)]
        extra = int(np.setdiff1d(got, want, assume_unique=True).size)
        reproduced = int(np.intersect1d(got, free, assume_unique=True).size)
        ok = ok and exact and not extra and reproduced >= 0.999 * free.size
        report[f"level{level}"] = dict(
            supports=len(mine), oracle=int(want.size), not_in_oracle=extra,
            oracle_untaken=int(free.size), reproduced=reproduced)
        taken = np.union1d(taken, (mine[:, 0] << 21) | mine[:, 1])
        left, right = np_downscale2(left), np_downscale2(right)
    return ok, report


def phase_pyramid(oracle, paths, launches):
    """The pyramid (``levels > 1``) on the card, each case driven with the
    launch counters at 0: the one-call at levels 2 and 3 with both forests
    at the CLI's settings on the dense and sparse pairs (rows pyramid, one
    key-kernel launch a level); levels 3 at the library defaults (global
    mode, the flat fallback, one code-kernel launch a level); 1080x1920 at
    levels 3 (the unpackable dedup branch); levels 5 (a level inside the
    margin); the B = 4 fold against its four single calls; the compact
    pyramid on the sparse pair and on a (sparse, dense) batch.  Each
    equals the CPU pipeline and passes ``pyramid_gate``; in epipolar mode
    > 99% of the supports have the true disparity."""
    from opengpc_tpu_torch import (InferenceSettings, load_forest,
                                   make_filter_mask, sparsematch)
    from opengpc_tpu_torch.infer import route
    from opengpc_tpu_torch.pyramid import (build_pyramid_sparsematch,
                                           build_pyramid_sparsematch_compact,
                                           pyramid_supports_to_numpy)
    from opengpc_tpu_torch.utils import make_pair, make_sparse_pair

    cli, lib = InferenceSettings(**SETTINGS_KW), InferenceSettings()
    zero = paths["defaultZeroForest"]
    scenes = {"dense": make_pair(H, W, TRUE_DISP),
              "sparse": make_sparse_pair(H, W, TRUE_DISP, density=0.15)}
    failures, report = [], {}

    def one_call(name, pair, forest, settings, levels, want_route, expect):
        mask = make_filter_mask(load_forest(paths[forest]))
        got_route = route(mask, pair[0].shape, settings, levels)
        sup, counts = launches.run(name, lambda: sparsematch(
            *pair, paths[forest], settings, device="cuda", levels=levels),
            expect)
        cpu = sparsematch(*pair, paths[forest], settings, device="cpu",
                          levels=levels)
        ok, rep = pyramid_gate(oracle, *pair, paths[forest], sup, settings,
                               levels)
        acc = accuracy(sup)
        same = bool(np.array_equal(sup, cpu))
        report[name] = dict(rep, route=got_route, equals_cpu=same,
                            true_disparity_share=acc, launches=counts)
        if not (ok and same and got_route == want_route and len(sup)
                and (acc > MIN_ACCURACY or not settings.epipolar_mode)):
            failures.append(f"{name}: {report[name]}")

    for levels in (2, 3):
        for forest in FORESTS:
            for scene, pair in scenes.items():
                one_call(f"levels{levels}/{forest}/{scene}", pair, forest,
                         cli, levels, "pyramid-rows", {"fused_keys": levels})
    for forest in FORESTS:
        for scene, pair in scenes.items():
            one_call(f"levels3/global/{forest}/{scene}", pair, forest, lib, 3,
                     "pyramid-flat", {"fused_codes": 3})
    one_call("levels3/1080x1920/unpackable",
             make_pair(1080, 1920, TRUE_DISP, seed=5), "defaultZeroForest",
             cli, 3, "pyramid-flat", {"fused_keys": 3})
    one_call("levels5/dense", scenes["dense"], "defaultZeroForest", cli, 5,
             "pyramid-rows", {"fused_keys": 5})

    pairs = [make_pair(H, W, TRUE_DISP, seed=500 + b) for b in range(4)]
    batch, counts = launches.run("levels3/batch4", lambda: sparsematch(
        [p[0] for p in pairs], [p[1] for p in pairs], zero, cli,
        device="cuda", levels=3), {"fused_keys": 3})
    singles = [sparsematch(*p, zero, cli, device="cuda", levels=3)
               for p in pairs]
    same = all(np.array_equal(a, b) for a, b in zip(batch, singles))
    report["levels3/batch4"] = dict(supports=[len(a) for a in batch],
                                    equals_single=same, launches=counts)
    if not same:
        failures.append("levels3/batch4 differs from its single calls")

    mask = make_filter_mask(load_forest(zero))
    mods = {dev: (build_pyramid_sparsematch_compact(mask, cli, 3,
                                                    device=dev),
                  build_pyramid_sparsematch(mask, cli, 3, device=dev))
            for dev in ("cuda", "cpu")}
    lefts, rights = (torch.from_numpy(np.stack(
        [scenes["sparse"][i], scenes["dense"][i]])) for i in (0, 1))
    sl, sr = lefts[0].cuda(), rights[0].cuda()
    out, counts = launches.run("compact/sparse",
                               lambda: mods["cuda"][0](sl, sr),
                               {"fused_keys": 3})
    got = pyramid_supports_to_numpy(*out[:5])
    rows = pyramid_supports_to_numpy(*mods["cuda"][1](sl, sr))
    cpu = mods["cpu"][0](lefts[0], rights[0])
    ok = (not bool(out[5]) and np.array_equal(got, rows) and len(got)
          and all(torch.equal(a.cpu(), b) for a, b in zip(out, cpu)))
    report["compact/sparse"] = dict(supports=len(got), overflow=bool(out[5]),
                                    equals_rows=bool(np.array_equal(got,
                                                                    rows)),
                                    launches=counts)
    if not ok:
        failures.append(f"compact/sparse: {report['compact/sparse']}")
    lb, rb = lefts.cuda(), rights.cuda()
    out, counts = launches.run("compact/sparse+dense",
                               lambda: mods["cuda"][0](lb, rb),
                               {"fused_keys": 3})
    cpu = mods["cpu"][0](lefts, rights)
    flags = out[5].tolist()
    ok = (flags == [False, True] and np.array_equal(
        pyramid_supports_to_numpy(*(o[0] for o in out[:5])), got)
        and all(torch.equal(a.cpu(), b) for a, b in zip(out, cpu)))
    report["compact/sparse+dense"] = dict(overflow=flags, launches=counts)
    if not ok:
        failures.append(f"compact/sparse+dense: {flags}")
    emit("pyramid", cases=len(report), checks=report, failures=failures)
    if failures:
        raise SystemExit(f"pyramid failed: {failures}")


def phase_stereomatch(paths, launches):
    """``build_stereomatch`` with both forests on the dense 436x1024 pair at
    the library defaults, capacity H*W (the default 32768 would truncate
    the global correspondences): one code-kernel launch a pair, a count
    within capacity, equal to the CPU pipeline, and, filtered as the
    rectified contract filters, the global-mode sparsematch set."""
    from opengpc_tpu_torch import (InferenceSettings, build_stereomatch,
                                   load_forest, make_filter_mask, sparsematch)
    from opengpc_tpu_torch.utils import make_pair

    settings = InferenceSettings(capacity=H * W)
    left, right = make_pair(H, W, TRUE_DISP)
    l_d, r_d = (torch.from_numpy(a).cuda() for a in (left, right))
    failures, report = [], {}
    for forest in FORESTS:
        mask = make_filter_mask(load_forest(paths[forest]))
        mod = build_stereomatch(mask, settings, device="cuda")
        out, counts = launches.run(f"stereomatch/{forest}",
                                   lambda: mod(l_d, r_d), {"fused_codes": 1})
        cpu = build_stereomatch(mask, settings, device="cpu")(
            torch.from_numpy(left), torch.from_numpy(right))
        same = all(torch.equal(a.cpu(), b) for a, b in zip(out, cpu))
        n = int(out[4])
        sx, sy, tx, ty = (o.cpu().numpy()[:n] for o in out[:4])
        dx = sx - tx
        keep = ((np.abs(sy - ty) <= settings.vertical_tolerance)
                & (np.abs(dx) <= settings.disp_high))
        got = set(zip(sx[keep].tolist(), sy[keep].tolist(), dx[keep].tolist()))
        want = set(map(tuple, sparsematch(left, right, mask, settings,
                                          device="cuda").tolist()))
        report[forest] = dict(count=n, capacity=settings.capacity,
                              filtered=len(got), sparsematch=len(want),
                              equals_cpu=same, launches=counts)
        if not (same and 0 < n <= settings.capacity and got == want):
            failures.append(f"{forest}: {report[forest]}")
    emit("stereomatch", checks=report, failures=failures)
    if failures:
        raise SystemExit(f"stereomatch failed: {failures}")


def phase_slab_times(smi, masks):
    """The key kernel's slab mode (both slabs of the n = 1 pair, the whole
    436x1024 frame, in one launch, on one contiguous (2, H + 28, W)
    tensor as the sharded frame builds them) against its two plain calls,
    and fused_census (one image at 436x1024 and at 2160x3840) against its
    twin, each with its bound; and the n = 1 sharded masked module
    against the single-device masked module per pair at 436x1024."""
    import torch.nn.functional as F

    from opengpc_tpu_torch import InferenceSettings, build_sparsematch_masked
    from opengpc_tpu_torch.infer import _key_image_slab
    from opengpc_tpu_torch.match import SENTINEL_BASE
    from opengpc_tpu_torch.ops.census import census5x5
    from opengpc_tpu_torch.ops.fused import (PAD, fused_census,
                                             fused_keys_slab_plain)
    from opengpc_tpu_torch.parallel import build_sharded_frame_sparsematch
    from opengpc_tpu_torch.utils import make_pair

    settings = InferenceSettings(**SETTINGS_KW)
    zero = masks["zero"]
    left, right = (torch.from_numpy(a).cuda()
                   for a in make_pair(H, W, TRUE_DISP))
    slabs = F.pad(torch.stack([left, right]), (0, 0, PAD, PAD))
    sl, sr = slabs
    times = {}
    ncand = int((_key_image_slab(sl, sr, zero, settings, 0, H)
                 < SENTINEL_BASE).sum())
    times["fused_keys_slab"] = with_bound(kernel_vs_plain_times(
        lambda: _key_image_slab(sl, sr, zero, settings, 0, H),
        lambda: torch.cat([
            fused_keys_slab_plain(sl, zero, 5, 0, SENTINEL_BASE, 0, H),
            fused_keys_slab_plain(sr, zero, 5, W, SENTINEL_BASE, 0, H)],
            dim=1), 200, 20),
        2 * (H + 2 * PAD) * W + 2 * 4 * H * W,
        code_ops(2, H, W, ncand, zero.num_tests))
    big = torch.from_numpy(structured_image(np.random.default_rng(14), 2160,
                                            3840)).cuda()
    for name, img, iters in (("fused_census", left, 200),
                             ("fused_census_2160x3840", big, 50)):
        h, w = img.shape
        times[name] = with_bound(kernel_vs_plain_times(
            lambda: fused_census(img), lambda: census5x5(img), iters, 10),
            h * w * (1 + 4), int(CENSUS_OPS * h * w))
        times[name]["shape"] = [h, w]
    emit("slab_census_times", card=smi, shape=[H, W], **times)
    sharded = build_sharded_frame_sparsematch(zero, settings, device="cuda")
    single = build_sparsematch_masked(zero, settings, device="cuda")
    mods = {"single_device_masked": single, "sharded_n1_masked": sharded}
    module_times = {name: dict(
        events_ms=[cuda_ms(lambda: m(left, right), 200) for _ in range(2)],
        profile=device_profile(lambda: m(left, right), 50))
        for name, m in mods.items()}
    # in turns on one card: single, sharded, sharded, single
    module_times["turns_ms"] = [
        cuda_ms(lambda: mods[k](left, right), 200)
        for k in ("single_device_masked", "sharded_n1_masked",
                  "sharded_n1_masked", "single_device_masked")]
    emit("sharded_times", card=smi, shape=[H, W], **module_times)
    return {name: dict(t, library_ms=None) for name, t in times.items()
            if name in KERNELS}


def phase_pyramid_times(smi, masks):
    """The one-call's module a pair at levels 1 (the masked module), 2 and
    3 (the pyramid module), B = 1 and 4, zero forest, dense pair: events
    and profiler device ms, busy share and the largest device items, and
    the host clock of the one-call; and the batched dedup at levels 3, B =
    4, pair by pair (JAX's ``lax.map``) against the one (B, K) sort that
    ships, in turns, beside the dedup sort alone."""
    from opengpc_tpu_torch import (InferenceSettings, build_sparsematch_masked,
                                   sparsematch)
    from opengpc_tpu_torch.infer import _stack
    from opengpc_tpu_torch.pyramid import (_dedup_unpack, _pack_params,
                                           _pyramid_batched_keys,
                                           build_pyramid_sparsematch)
    from opengpc_tpu_torch.utils import make_pair

    settings = InferenceSettings(**SETTINGS_KW)
    zero = masks["zero"]
    path = os.path.join(REPO, "forests", "defaultZeroForest.txt")
    left, right = make_pair(H, W, TRUE_DISP)
    l_d, r_d = (torch.from_numpy(a).cuda() for a in (left, right))
    pairs = [make_pair(H, W, TRUE_DISP, seed=300 + b) for b in range(4)]
    lb, rb = (torch.from_numpy(np.stack([p[i] for p in pairs])).cuda()
              for i in (0, 1))
    modules = {}
    for levels in (1, 2, 3):
        mod = (build_sparsematch_masked(zero, settings, device="cuda")
               if levels == 1 else
               build_pyramid_sparsematch(zero, settings, levels, device="cuda"))
        modules[f"levels{levels}"] = dict(
            events_ms_per_pair_b1=[cuda_ms(lambda: mod(l_d, r_d), 20)
                                   for _ in range(2)],
            events_ms_per_pair_b4=[cuda_ms(lambda: mod(lb, rb), 10) / 4
                                   for _ in range(2)],
            profile_b1=device_profile(lambda: mod(l_d, r_d), 10, tries=1),
            profile_b4=device_profile(lambda: mod(lb, rb), 5, tries=1),
            one_call_ms_median=median_ms(lambda: sparsematch(
                left, right, path, settings, device="cuda", levels=levels),
                10),
            one_call_ms_per_pair_b4_median=median_ms(lambda: sparsematch(
                [p[0] for p in pairs], [p[1] for p in pairs], path, settings,
                device="cuda", levels=levels), 5) / 4)
    mult, nbd = _pack_params(settings, 3)
    keys = _pyramid_batched_keys(lb, rb, zero, settings, 3, mult, nbd)

    def dedup(k):
        return _dedup_unpack(k, mult, nbd, W, settings.disp_high, 3)

    forms = {"per_pair": lambda: _stack([dedup(k) for k in keys]),
             "one_sort": lambda: dedup(keys)}
    # windows of many kernels lose an event or two most of the time (a
    # kernel counted 0.95-0.98 times a call): these report ``whole`` and
    # are not retaken
    turns = {name: [] for name in forms}
    for name in ("per_pair", "one_sort", "one_sort", "per_pair"):
        prof = device_profile(forms[name], 10, tries=1)
        turns[name].append([prof["device_ms"], prof["whole"]])
    sort_us = {}
    for name, fn in (("one_pair", lambda: torch.sort(keys[0], stable=False)),
                     ("b4_rows", lambda: torch.sort(keys, dim=-1,
                                                    stable=False))):
        prof = device_profile(fn, 20, tries=1)
        sort_us[name] = [prof["device_ms"] * 1e3, prof["whole"],
                         prof["kernels"][:4]]
    emit("pyramid_times", card=smi, shape=[H, W], forest="defaultZeroForest",
         modules=modules, dedup_b4_device_ms=turns,
         dedup_b4_events_ms={n: [cuda_ms(f, 10) for _ in range(2)]
                             for n, f in forms.items()},
         dedup_sort_us=sort_us, keys_shape=list(keys.shape))


# the offline workflow's phases: Sintel-size scenes, the extract defaults'
# annulus, 16,000 keypoints a pair (64 pairs make ~10^6 triplets, the
# order of the reference extract's defaults over Sintel)
MINE_PAIRS, TRAIN_PAIRS, KEYPOINTS = 4, 64, 16000
RADII = (20, 40)
CPU_SUBSET = 50000
# the quality bar of the JAX package's trained-forest gates: coverage
# within 10 % and exact-disparity precision within 1 % of the pretrained
# forest on a held-out scene, matched with these settings
QUALITY_KW = dict(gradient_threshold=5, vertical_tolerance=0, disp_high=32,
                  epipolar_mode=True, capacity=1 << 17)


def scene_keypoints(rng):
    """A ``make_scene(H, W)`` pair and ``KEYPOINTS`` stereo keypoints of it."""
    from opengpc_tpu_torch.mine import mine_stereo_pair
    from opengpc_tpu_torch.utils import make_scene

    left, right, gt, occ = make_scene(rng, H, W)
    keys = mine_stereo_pair(gt, occ, np.zeros((H, W), np.uint8), KEYPOINTS,
                            *RADII, rng)
    return left, right, keys


def phase_mine_device():
    """``extract_triplets_device`` on the card against the numpy
    ``extract_triplets`` on the same keypoints, byte for byte, on
    ``MINE_PAIRS`` Sintel-size pairs; host ms a pair of each path."""
    from opengpc_tpu_torch.mine import (extract_triplets,
                                        extract_triplets_device)

    rng = np.random.default_rng(8)
    failures, dev_ms, host_ms = [], [], []
    for p in range(MINE_PAIRS):
        left, right, keys = scene_keypoints(rng)
        t0 = time.perf_counter()
        dev = extract_triplets_device(left, right, *keys, device="cuda")
        t1 = time.perf_counter()
        host = extract_triplets(left, right, *keys)
        t2 = time.perf_counter()
        dev_ms.append((t1 - t0) * 1e3)
        host_ms.append((t2 - t1) * 1e3)
        if not (dev.dtype == np.uint8 and host.shape == (KEYPOINTS, 3, 729)
                and np.array_equal(dev, host)):
            failures.append(f"pair {p}: {dev.shape} {dev.dtype}, host "
                            f"{host.shape}")
    emit("mine_device", pairs=MINE_PAIRS, keypoints=KEYPOINTS, shape=[H, W],
         device_path_ms=dev_ms, host_path_ms=host_ms, failures=failures)
    if failures:
        raise SystemExit(f"device extraction failed: {failures}")


def quality_vs_pretrained(forest, pretrained_file, seed):
    """Supports and exact-disparity precision of a fresh forest and of a
    pretrained one on a held-out ``make_scene(H, W)``, matched on the
    card, and whether the fresh forest meets the quality bar."""
    from opengpc_tpu_torch import InferenceSettings, load_forest, sparsematch
    from opengpc_tpu_torch.metrics import support_precision
    from opengpc_tpu_torch.utils import make_scene

    left, right, gt, occ = make_scene(np.random.default_rng(seed), H, W)
    settings = InferenceSettings(**QUALITY_KW)
    out = {}
    for name, f in (("fresh", forest),
                    ("pretrained", load_forest(pretrained_file))):
        sup = sparsematch(left, right, f, settings, device="cuda")
        out[name] = [len(sup), support_precision(sup, gt, valid=occ == 0,
                                                 tol=0)[0]]
    (n_f, p_f), (n_p, p_p) = out["fresh"], out["pretrained"]
    return out, bool(n_p > 10000 and n_f >= 0.9 * n_p and p_f >= p_p - 0.01)


def phase_train(smi, paths):
    """Forest training on the card at ~10^6 triplets (``TRAIN_PAIRS`` pairs
    extracted on the card): ``fern_factory(2, 2, 2, 5)`` at the reference
    train defaults, with the zero and the tau optimizer, fern at a time
    (the default at this size) and batched.  The two forest texts must be
    byte-identical, the card's forest must equal the CPU's on the first
    ``CPU_SUBSET`` triplets, and the forest must meet the quality bar on a
    held-out scene.  Reports wall s a forest, the profiler's device ms and
    busy share of a forest, the scorer's device ms a level, and the peak
    device memory.  Returns the triplets and the zero optimizer's forest
    text fern at a time with its wall s, for ``multi_device``."""
    from opengpc_tpu_torch import (fern_factory, serialize_forest,
                                   tau_optimizer, train_forest,
                                   zero_optimizer)
    from opengpc_tpu_torch import train as train_mod
    from opengpc_tpu_torch.mine import extract_triplets_device

    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    chunks = []
    for _ in range(TRAIN_PAIRS):
        left, right, keys = scene_keypoints(rng)
        chunks.append(extract_triplets_device(left, right, *keys,
                                              device="cuda"))
    trips = np.concatenate(chunks)
    del chunks
    build_s = time.perf_counter() - t0
    n = len(trips)
    settings = fern_factory(2, 2, 2, 5)
    f, sub_n = len(settings.ferns), int(settings.sample_fraction * n)
    failures, report = [], {}
    for name, opt, pre in (("zero", zero_optimizer(), "defaultZeroForest"),
                           ("tau", tau_optimizer(), "defaultTauForest")):
        forests, rows = {}, {}
        for path, batch in (("fern_at_a_time", None), ("batched", True)):
            def train(batch=batch):
                return train_forest(trips, settings, opt, seed=0,
                                    verbose=False, batch_ferns=batch,
                                    device="cuda")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            forests[path] = train()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            prof = device_profile(train, 1, tries=1, warm=False)
            rows[path] = dict(wall_s=wall_s, max_memory_allocated=peak,
                              profiled_wall_ms=prof["wall_ms"],
                              device_ms=prof["device_ms"],
                              busy_share=prof["busy_share"],
                              whole=prof["whole"], top=prof["kernels"][:4])
        # the scorer alone, all flags set: one level of one fern's
        # bootstrap, and the same level of all six ferns at once
        crng = np.random.default_rng(0)
        data = torch.from_numpy(trips).cuda()
        stack = data[torch.as_tensor(crng.integers(0, n, (f, sub_n)),
                                     device="cuda")]
        del data
        cand = np.stack([train_mod.sample_candidates(crng, s,
                                                     opt.num_resamples)
                         for s in settings.ferns])
        ones = torch.ones((f, sub_n), dtype=torch.bool, device="cuda")
        taus = opt.tau_hi - opt.tau_lo
        scorers = {
            "one_fern": lambda: train_mod._score_level(
                stack[0], cand[0], opt.tau_lo, taus, ones[0], ones[0],
                ones[0]),
            "six_ferns": lambda: train_mod._score_level_ferns(
                stack, cand, opt.tau_lo, taus, ones, ones, ones)}
        rows["scorer_level"] = {}
        for key, fn in scorers.items():
            prof = device_profile(fn, 3)
            rows["scorer_level"][key] = dict(
                device_ms=prof["device_ms"], usable=prof["usable"],
                busy_share=prof["busy_share"], events_ms=cuda_ms(fn, 3))
        del stack, ones
        sub = trips[:CPU_SUBSET]
        t0 = time.perf_counter()
        card = serialize_forest(train_forest(sub, settings, opt, seed=5,
                                             verbose=False, device="cuda"))
        t1 = time.perf_counter()
        cpu = serialize_forest(train_forest(sub, settings, opt, seed=5,
                                            verbose=False, device="cpu"))
        t2 = time.perf_counter()
        fresh = forests["fern_at_a_time"]
        quality, good = quality_vs_pretrained(fresh, paths[pre], 77)
        same = (serialize_forest(fresh)
                == serialize_forest(forests["batched"]))
        taus_used = any(t.tau for fern in fresh.ferns for t in fern.tests)
        rows.update(batched_equals_fern_at_a_time=same,
                    subset_card_equals_cpu=card == cpu,
                    subset_wall_s=dict(card=t1 - t0, cpu=t2 - t1),
                    quality=quality, meets_quality_bar=good,
                    nonzero_tau=taus_used)
        if not (same and card == cpu and good
                and taus_used == (name == "tau")):
            failures.append(f"{name}: {rows}")
        report[name] = rows
        if name == "zero":
            forests_zero = forests
            walls_zero = {k: rows[k]["wall_s"] for k in forests}
    torch.cuda.empty_cache()
    one_device = (serialize_forest(forests_zero["fern_at_a_time"]),
                  walls_zero["fern_at_a_time"])
    emit("train", nvidia_smi=smi, triplets=n, bootstrap=sub_n, ferns=f,
         depth=settings.max_depth, cpu_subset=CPU_SUBSET,
         dataset_build_s=build_s,
         batch_cap_bytes=train_mod.BATCH_FERNS_BYTES_CAP,
         stack_bytes=f * sub_n * 3 * 729, results=report, failures=failures)
    if failures:
        raise SystemExit(f"training failed: {failures}")
    return trips, one_device


def write_sintel_tree(root, rng, scenes=("alley_1", "market_5"), frames=2):
    """A Sintel training tree of ``make_scene(H, W)`` frames: the stereo
    layout (8-bit clean frames, disparity PNGs (d = 4R + G/64), occlusion
    maps and empty out-of-frame maps, written with the port's
    ``write_png``) and beside it the optical-flow layout, whose clean
    frames are the left frames, whose ``.flo`` flow is the left frame's
    disparity as a horizontal shift and whose invalid maps are empty (the
    flow layout shares the occlusion maps)."""
    import shutil

    from opengpc_tpu_torch.io import write_flo, write_png
    from opengpc_tpu_torch.utils import make_scene

    tr = os.path.join(root, "training")
    for scene in scenes:
        for i in range(1, frames + 1):
            left, right, disp, occ = make_scene(rng, H, W)
            rgb = np.zeros((H, W, 3), np.uint8)
            rgb[:, :, 0] = disp // 4
            rgb[:, :, 1] = (disp % 4) * 64
            for sub, img in (("clean_left", left), ("clean_right", right),
                             ("disparities", rgb), ("occlusions", occ),
                             ("outofframe", np.zeros((H, W), np.uint8))):
                d = os.path.join(tr, sub, scene)
                os.makedirs(d, exist_ok=True)
                write_png(os.path.join(d, f"frame_{i:04d}.png"), img)
            name = f"frame_{i:04d}"
            for sub, src in (("clean", "clean_left"),
                             ("invalid", "outofframe")):
                d = os.path.join(tr, sub, scene)
                os.makedirs(d, exist_ok=True)
                shutil.copy(os.path.join(tr, src, scene, name + ".png"), d)
            os.makedirs(os.path.join(tr, "flow", scene), exist_ok=True)
            write_flo(os.path.join(tr, "flow", scene, name + ".flo"),
                      -disp.astype(np.float32),
                      np.zeros((H, W), np.float32))


def phase_workflow(td, oracle, paths, launches):
    """The reference's offline workflow through the port's CLIs on a
    Sintel-layout tree: ``python -m opengpc_tpu_torch.cli.extract --mode
    stereo`` at its defaults, ``cli.train`` on the card at its defaults
    (its forest equal to ``--device cpu``'s), then the one-call on the
    tree's first pair with the fresh forest at the CLI's settings (the
    masked route: one key-kernel launch), equal to the CPU pipeline and
    through the oracle gate, and the fresh forest held to the quality bar
    on a held-out scene.  Beside them, ``data/validate_real_sintel_torch.py``
    runs its battery on the tree's flow and stereo layouts on the card: it
    must exit 0 with every hard check passed."""
    from opengpc_tpu_torch import InferenceSettings, load_forest, sparsematch
    from opengpc_tpu_torch.cli.train import main as train_main
    from opengpc_tpu_torch.io import load_triplets, read_gray

    root = os.path.join(td, "sintel")
    t0 = time.perf_counter()
    write_sintel_tree(root, np.random.default_rng(31))
    tree_s = time.perf_counter() - t0
    # the real-Sintel battery through the port on the card, on this tree,
    # beside the rest of the phase (its mining runs on the host)
    import concurrent.futures

    pool = concurrent.futures.ThreadPoolExecutor(1)
    battery = pool.submit(run_script, [
        os.path.join("data", "validate_real_sintel_torch.py"),
        "--flow-root", root, "--stereo-root", root])
    pool.shutdown(wait=False)
    trips = os.path.join(td, "triplets.bin")
    os.makedirs(os.path.join(td, "workflow_forest"))
    forest = os.path.join(td, "workflow_forest", "fresh.txt")
    forest_cpu = os.path.join(td, "fresh_cpu.txt")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "opengpc_tpu_torch.cli.extract", root, trips,
         "--mode", "stereo", "--seed", "3"], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    extract_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"cli.extract failed:\n{proc.stdout}{proc.stderr}")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as log:
        rc = train_main([trips, forest, "--seed", "4"])
        train_s = time.perf_counter() - t0
        rc_cpu = train_main([trips, forest_cpu, "--seed", "4", "--device",
                             "cpu"])
    with open(forest) as a, open(forest_cpu) as b:
        same_forest = a.read() == b.read()
    scene = os.path.join(root, "training", "{}", "alley_1", "frame_0001.png")
    lp, rp = scene.format("clean_left"), scene.format("clean_right")
    settings = InferenceSettings(**SETTINGS_KW)
    sup, counts = launches.run(
        "workflow", lambda: sparsematch(lp, rp, forest, settings,
                                        device="cuda"), {"fused_keys": 1})
    left, right = read_gray(lp), read_gray(rp)
    cpu = sparsematch(left, right, forest, settings, device="cpu")
    ok_gate, gate = oracle_gate(oracle, left, right, forest, sup, settings)
    quality, good = quality_vs_pretrained(load_forest(forest),
                                          paths["defaultZeroForest"], 78)
    report = dict(triplets=len(load_triplets(trips)), rc=[rc, rc_cpu],
                  card_forest_equals_cpu=same_forest,
                  supports_equal_cpu=bool(np.array_equal(sup, cpu)),
                  oracle_gate=gate, quality=quality, meets_quality_bar=good)
    b_rc, b_out, b_err, battery_s = battery.result()
    report["sintel_battery"] = dict(
        rc=b_rc, passed="all hard checks passed" in b_out,
        checks=[ln for ln in b_out.splitlines()
                if ln.startswith("[") or "precision vs GT" in ln])
    ok = (rc == rc_cpu == 0 and same_forest and report["supports_equal_cpu"]
          and ok_gate and good and len(sup) > 0 and b_rc == 0
          and report["sintel_battery"]["passed"])
    emit("workflow", launches=counts, tree_s=tree_s, extract_s=extract_s,
         train_s=train_s, battery_s=battery_s,
         extract_tail=proc.stdout.splitlines()[-1:],
         train_tail=log.getvalue().splitlines()[-1:],
         checks=report)
    if b_rc != 0:
        print(b_out[-4000:], b_err[-4000:], file=sys.stderr)
    if not ok:
        raise SystemExit(f"workflow failed: {report}")


def run_script(argv, timeout=300, threads=None):
    """A repo script in a fresh process from the checkout's root, with
    ``threads`` intra-op threads if given: (exit code, stdout, stderr,
    seconds)."""
    env = dict(os.environ)
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)
    return (proc.returncode, proc.stdout, proc.stderr,
            time.perf_counter() - t0)


def start_examples(td):
    """Start the examples phase's untimed runs (the demo on the card and on
    the CPU, the evaluation on the CPU) side by side in the background,
    each with a share of the host's cores (three processes at torch's
    default of one intra-op thread a core ran 5-7x slower): name -> future
    of ``run_script``'s result.  The caller drives only correctness phases
    until it has every result, so no timing window shares the host with
    them."""
    import concurrent.futures

    demo = os.path.join("examples", "demo_torch.py")
    runs = {f"demo/{dev}": [demo, os.path.join(td, f"demo_{dev}"),
                            "--device", dev] for dev in ("cuda", "cpu")}
    runs["evaluate/cpu"] = [os.path.join("examples", "evaluate_torch.py"),
                            "--device", "cpu"]
    threads = max(1, (os.cpu_count() or 3) // len(runs))
    pool = concurrent.futures.ThreadPoolExecutor(len(runs))
    futures = {name: pool.submit(run_script, argv, threads=threads)
               for name, argv in runs.items()}
    pool.shutdown(wait=False)
    return futures


def phase_examples(td, done):
    """``examples/demo_torch.py`` (320x640, 3000 triplets) and
    ``examples/evaluate_torch.py`` (436x1024) in fresh processes on the
    card and with ``--device cpu`` (``done``: the results of
    ``start_examples``' runs): every run exits 0, the demo's support,
    precision and per-contract lines and files equal the CPU run's, and
    the evaluation table's supports, density and precision columns equal
    the CPU table's.  The card's evaluation runs here, alone, with
    ``--device-time``: the masked module's ms a pair by CUDA events, the
    median of its repeats."""
    outs = {dev: os.path.join(td, f"demo_{dev}") for dev in ("cuda", "cpu")}
    done = dict(done)
    done["evaluate/cuda"] = run_script(
        [os.path.join("examples", "evaluate_torch.py"), "--device-time"])
    failures = [f"{name}: exit {rc}\n{out[-2000:]}{err[-2000:]}"
                for name, (rc, out, err, _) in done.items() if rc != 0]
    if failures:
        raise SystemExit(f"examples failed: {failures}")

    def demo_lines(out):  # everything but the training time and the dir
        return [ln for ln in out.splitlines()
                if "trained fresh forest in" not in ln
                and not ln.startswith("outputs in")]

    def table(out, cols=6):  # the rows' quality columns
        return [ln.split("|")[1:cols + 1] for ln in out.splitlines()
                if ln.startswith("| ") and ln[2].isdigit()]

    demo_same = (demo_lines(done["demo/cuda"][1])
                 == demo_lines(done["demo/cpu"][1]))
    files = sorted(os.listdir(outs["cuda"]))
    files_same = files == sorted(os.listdir(outs["cpu"])) and all(
        open(os.path.join(outs["cuda"], f), "rb").read()
        == open(os.path.join(outs["cpu"], f), "rb").read() for f in files)
    card_table = table(done["evaluate/cuda"][1], cols=8)
    table_same = ([r[:6] for r in card_table]
                  == table(done["evaluate/cpu"][1]) and len(card_table) == 5)
    ms_pair = {r[0].strip(): float(r[6]) for r in card_table}
    emit("examples", seconds={k: v[3] for k, v in done.items()},
         demo_lines=demo_lines(done["demo/cuda"][1]),
         demo_equals_cpu=demo_same, demo_files_equal_cpu=files_same,
         demo_train_line=[ln for ln in done["demo/cuda"][1].splitlines()
                          if "trained fresh forest" in ln],
         evaluate_table=done["evaluate/cuda"][1].splitlines(),
         evaluate_equals_cpu=table_same, ms_per_pair=ms_pair,
         card=smi_line())
    if not (demo_same and files_same and table_same):
        raise SystemExit("examples differ from their --device cpu runs")


# bench records whose step runs no matcher: mining (host), the split
# scorer and densify (from a masked buffer made before the step)
BENCH_NO_MATCHER = ("mining_triplets_per_s", "train_split_evals_per_s",
                    "densify_ms_per_frame")


def start_bench():
    """Start ``bench_torch.py`` in smoke mode (``OGPC_BENCH_SMOKE=1``: one
    window of 3 steps a record, full sizes, every gate) on the card in the
    background, stdout and stderr merged into one stream, with two
    intra-op threads: a future of (exit code, output, seconds).  Untimed:
    the caller drives only correctness phases until it has the result."""
    import concurrent.futures

    def run():
        env = dict(os.environ, OGPC_BENCH_SMOKE="1", OMP_NUM_THREADS="2")
        env.pop("OGPC_BENCH_FAST", None)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              timeout=400)
        return proc.returncode, proc.stdout, time.perf_counter() - t0

    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(run)
    pool.shutdown(wait=False)
    return future


def phase_bench(done, smi):
    """``bench_torch.py``'s smoke run on the card (``done``: the result of
    ``start_bench``): exit 0, every gate passed (the oracle's among them),
    the last JSON line the headline naming this card, the headline printed
    at least twice and the same each time, the records' names exactly
    ``bench.py``'s 20, each record timed by CUDA events (mining by the
    host clock) with a device time, and the key kernel launched in every
    step that runs a matcher."""
    from bench_torch import HEADLINE, bench_py_metrics

    rc, out, seconds = done
    lines = []
    for ln in out.splitlines():
        if ln.startswith("{"):
            try:
                lines.append(json.loads(ln))
            except ValueError:
                pass
    records = [j for j in lines if "metric" in j]
    heads = [j for j in records if j["metric"] == HEADLINE]
    want = bench_py_metrics()
    failures = []
    if rc != 0:
        failures.append(f"exit {rc}: {out[-3000:]}")
    if not (lines and lines[-1].get("metric") == HEADLINE
            and len(heads) >= 2 and all(h == heads[-1] for h in heads)
            and heads[-1].get("device") == smi):
        failures.append(f"headline contract: {heads[-1:]} last {lines[-1:]}")
    if len(want) != 20 or {j["metric"] for j in records} != want:
        failures.append(f"metrics {sorted(j['metric'] for j in records)}")
    for rec in records:
        host = rec["metric"] == "mining_triplets_per_s"
        if rec["timer"] != ("host" if host else "cuda-events") or (
                not host and rec["device_ms"] is None):
            failures.append(f"{rec['metric']}: timer {rec['timer']}, "
                            f"device_ms {rec['device_ms']}")
        if rec["metric"] not in BENCH_NO_MATCHER and \
                rec["launches"].get("fused_keys", 0) < 1:
            failures.append(f"{rec['metric']}: launches {rec['launches']}")
    emit("bench", seconds=seconds, exit=rc, records=records[:-1],
         gates=[ln for ln in out.splitlines()
                if ln.startswith(("oracle check", "multi-plane gate",
                                  "bench_torch:"))],
         failures=failures)
    if failures:
        raise SystemExit(f"bench failed: {failures}")


def phase_entry(launches):
    """``entry_torch.entry()``'s module on the card against its module on
    the CPU, on the same example pair (one key-kernel launch), and
    ``entry_torch.dryrun_multichip(1)`` on the card."""
    import entry_torch

    cpu_mod, cpu_args = entry_torch.entry(device="cpu")
    mod, args = entry_torch.entry()
    out, counts = launches.run("entry", lambda: mod(*args),
                               {"fused_keys": 1})
    want = cpu_mod(*cpu_args)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(out, want))
    t0 = time.perf_counter()
    entry_torch.dryrun_multichip(1)
    emit("entry", launches=counts, count=int(out[3]), equals_cpu=same,
         dryrun_multichip_1_s=time.perf_counter() - t0)
    if not same:
        raise SystemExit("entry: the card's outputs differ from the CPU's")


CLI = "opengpc_tpu_torch.cli.sparsematch"
CLI_CAPACITY = str(1 << 20)  # above any pair's support count: nothing trimmed
TTOTAL_REPEATS = 20


def run_cli(argv):
    """The sparsematch CLI in this process: (rc, stdout, stderr)."""
    from opengpc_tpu_torch.cli.sparsematch import main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def tt_ms(stdout):
    """The ``tTotal`` ms (best of ``--repeats``) a CLI run printed."""
    line = [ln for ln in stdout.splitlines() if ln.startswith("tTotal:")][0]
    return float(line.split()[1])


def notices(err):
    """The CLI's routing notices (auto contract, overflow, resume)."""
    return [ln for ln in err.splitlines()
            if "contract" in ln or "overflow:" in ln]


def dir_bytes(d):
    return {name: open(os.path.join(d, name), "rb").read()
            for name in sorted(os.listdir(d))
            if os.path.isfile(os.path.join(d, name))}


def cli_cases():
    """(name, scene, forest, extra argv, kernel launches of one call
    without an overflow, those the overflow fallback adds) of
    ``cli_single``.  The auto contract takes row form on the dense pair
    and, through the density probe, masked-compact on the sparse one."""
    keys = {"fused_keys": 1}
    return [
        ("default_dense", "dense", "defaultZeroForest", [], keys, keys),
        ("default_dense_tau", "dense", "defaultTauForest", [], keys, keys),
        ("default_sparse_densify", "sparse", "defaultZeroForest",
         ["--densify", "DENSE"], keys, keys),
        ("viz_reference_densify", "dense", "defaultZeroForest",
         ["--viz-compat", "reference", "--densify", "DENSE"], keys, keys),
        ("global_dense", "dense", "defaultZeroForest", ["--global-mode"],
         keys, keys),
        ("global_sparse", "sparse", "defaultZeroForest", ["--global-mode"],
         keys, keys),
        ("flat", "dense", "defaultZeroForest", ["--contract", "flat"], keys,
         keys),
        ("rows", "dense", "defaultZeroForest", ["--contract", "rows"], keys,
         keys),
        ("masked_densify", "dense", "defaultZeroForest",
         ["--contract", "masked", "--densify", "DENSE"], keys, keys),
        ("masked_compact_sparse", "sparse", "defaultZeroForest",
         ["--contract", "masked-compact"], keys, keys),
        ("masked_compact_dense", "dense", "defaultZeroForest",
         ["--contract", "masked-compact", "--densify", "DENSE"], keys, keys),
        ("global_rows", "dense", "defaultZeroForest",
         ["--global-mode", "--contract", "global-rows"], keys, keys),
        ("global_compact_dense", "dense", "defaultZeroForest",
         ["--global-mode", "--contract", "global-compact"], keys, keys),
        ("pyramid3_dense", "dense", "defaultZeroForest", ["--pyramid", "3"],
         {"fused_keys": 3}, {"fused_keys": 3}),
        ("pyramid3_sparse", "sparse", "defaultZeroForest",
         ["--pyramid", "3"], {"fused_keys": 3}, {"fused_keys": 3}),
        ("max_tests17", "dense", "defaultZeroForest", ["--max-tests", "17"],
         keys, keys),
        ("quirk", "sparse", "defaultZeroForest", ["--matcher", "quirk"],
         {"fused_codes": 2}, {}),
        ("hashmatch", "sparse", "defaultZeroForest",
         ["--matcher", "hashmatch"], {"fused_codes": 2}, {}),
    ]


def oracle_lines(oracle, left, right, forest_file, mode):
    """The oracle's supports at the CLI's defaults in matcher ``mode`` (1
    quirk, 2 hashmatch), in its order."""
    from opengpc_tpu_torch.io import write_raw

    with tempfile.TemporaryDirectory() as td:
        lp, rp, op = (os.path.join(td, n) for n in ("l.raw", "r.raw", "o.txt"))
        write_raw(lp, left)
        write_raw(rp, right)
        subprocess.run([oracle, "sparsematch", forest_file, lp, rp, op, "5",
                        "0", "128", "1", str(mode)], check=True)
        return np.loadtxt(op, dtype=np.int64).reshape(-1, 3)


def top_level_import_s(stderr):
    """Seconds of the top-level imports that ``python -X importtime``
    printed (a nested import's name is indented under its importer)."""
    total = 0
    for ln in stderr.splitlines():
        parts = ln.split("|")
        if (ln.startswith("import time:") and len(parts) == 3
                and parts[1].strip().isdigit()
                and not parts[2].startswith("  ")):
            total += int(parts[1])
    return total / 1e6


def write_pair_pngs(td, name, left, right):
    from opengpc_tpu_torch.io import write_png

    out = []
    for side, img in (("l", left), ("r", right)):
        out.append(os.path.join(td, f"{name}_{side}.png"))
        write_png(out[-1], img)
    return out


def phase_cli_single(td, oracle, paths, launches):
    """``python -m opengpc_tpu_torch.cli.sparsematch`` on one 436x1024
    pair (dense and sparse, PNGs written by the port): every contract,
    ``--global-mode``, ``--pyramid 3``, ``--max-tests 17``, ``--densify``,
    ``--viz-compat reference`` and the host matchers, in this process
    through ``main([...])`` with the launch counters at 0 (one key-kernel
    launch a call, one a level, the overflow fallback's on top; one
    code-kernel launch an image for the host matchers).  Each card run's
    files equal ``--device cpu``'s byte for byte (supports, disparity.png,
    the densify PNG) and its notices the CPU's; its supports equal the
    one-call's on the card as sets and pass the oracle gate (the pyramid:
    the one-call at levels 3; the host matchers: the oracle's quirk and
    hashmatch modes).  The sparse pair must take a compact contract
    through the probe, the dense pair forced onto masked-compact its
    overflow fallback.  Then a whole CLI process at ``--repeats 20`` in a
    subprocess (its wall, and its imports from ``-X importtime``), and
    ``tTotal`` best of 20 in process."""
    from opengpc_tpu_torch import (InferenceSettings, load_forest,
                                   make_filter_mask, sparsematch)
    from opengpc_tpu_torch.io import read_supports
    from opengpc_tpu_torch.utils import make_pair, make_sparse_pair

    scenes = {"dense": make_pair(H, W, TRUE_DISP),
              "sparse": make_sparse_pair(H, W, TRUE_DISP, density=0.15)}
    files = {s: write_pair_pngs(td, f"cli_{s}", *p) for s, p in scenes.items()}
    failures, report, tt = [], {}, {}
    for name, scene, forest, extra, base, fallback in cli_cases():
        left, right = scenes[scene]
        runs = {}
        for device in ("cpu", "cuda"):
            d = os.path.join(td, f"cli_{name}_{device}")
            os.makedirs(d)
            argv = [paths[forest], *files[scene], "--capacity", CLI_CAPACITY,
                    "--out", os.path.join(d, "d.png"), "--supports-out",
                    os.path.join(d, "s.txt"), "--device", device] + [
                os.path.join(d, "dense.png") if a == "DENSE" else a
                for a in extra]
            if device == "cpu":
                rc, out, err = run_cli(argv)
                over = "overflow:" in err
                expect = {k: base.get(k, 0) + (fallback.get(k, 0) if over
                                               else 0)
                          for k in set(base) | set(fallback)}
            else:
                (rc, out, err), counts = launches.run(
                    f"cli_single/{name}", lambda: run_cli(argv), expect)
            runs[device] = (rc, err, dir_bytes(d))
        (rc_c, err_c, f_c), (rc_g, err_g, f_g) = runs["cpu"], runs["cuda"]
        sup = read_supports(os.path.join(td, f"cli_{name}_cuda", "s.txt"))
        gmode = "--global-mode" in extra
        settings = InferenceSettings(gradient_threshold=5, disp_high=128,
                                     vertical_tolerance=0,
                                     epipolar_mode=not gmode,
                                     capacity=int(CLI_CAPACITY))
        if "--matcher" in extra:
            mode = 1 if "quirk" in extra else 2
            want = oracle_lines(oracle, left, right, paths[forest], mode)
            ok_sup = (bool(np.array_equal(np.sort(support_keys(sup)),
                                          support_keys(want)))
                      if mode == 1 else bool(np.array_equal(sup, want)))
            check = dict(oracle=len(want), equals_oracle_mode=ok_sup)
        else:
            mask = (make_filter_mask(load_forest(paths[forest]), 17)
                    if "--max-tests" in extra else paths[forest])
            levels = 3 if "--pyramid" in extra else 1
            one = sparsematch(left, right, mask, settings, device="cuda",
                              levels=levels)[:, :3]
            ok_sup = bool(np.array_equal(support_keys(sup),
                                         support_keys(one)))
            check = dict(equals_one_call=ok_sup)
            if levels == 1 and "--max-tests" not in extra:
                ok_gate, gate = oracle_gate(oracle, left, right,
                                            paths[forest], sup, settings)
                ok_sup = ok_sup and ok_gate
                check["oracle_gate"] = gate
        same_files = f_c == f_g and "d.png" in f_g
        routed = {"default_sparse_densify": "chunk-compacted masked",
                  "pyramid3_sparse": "chunk-compacted pyramid",
                  "masked_compact_dense": "masked-compact overflow",
                  "global_compact_dense": "global-compact overflow"}
        took = routed.get(name, "") in err_g
        tt[name] = tt_ms(out)
        report[name] = dict(check, supports=len(sup), rc=[rc_c, rc_g],
                            files_equal_cpu=same_files,
                            files=sorted(f_g), notices=notices(err_g),
                            notices_equal_cpu=err_c == err_g,
                            routed=took, launches=counts)
        if not (rc_c == rc_g == 0 and ok_sup and same_files and took
                and err_c == err_g and len(sup)):
            failures.append(f"{name}: {report[name]}")
    # one whole CLI process, its imports timed by the interpreter
    d = os.path.join(td, "cli_process")
    os.makedirs(d)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", CLI,
         paths["defaultZeroForest"], *files["dense"], "--capacity",
         CLI_CAPACITY, "--repeats", str(TTOTAL_REPEATS), "--out",
         os.path.join(d, "d.png"), "--supports-out",
         os.path.join(d, "s.txt")], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    process_wall = time.perf_counter() - t0
    import_s = top_level_import_s(proc.stderr)
    same = (proc.returncode == 0 and dir_bytes(d) == dir_bytes(
        os.path.join(td, "cli_default_dense_cuda")))
    if not same:
        failures.append(f"cli process: rc {proc.returncode}, files equal "
                        f"{same}\n{proc.stderr[-3000:]}")
    timed = {}
    for name in ("default_dense", "default_sparse_densify", "masked_densify",
                 "global_dense", "pyramid3_dense"):
        cname, scene, forest, extra = [c for c in cli_cases()
                                       if c[0] == name][0][:4]
        d = os.path.join(td, f"cli_t_{name}")
        os.makedirs(d)
        argv = [paths[forest], *files[scene], "--capacity", CLI_CAPACITY,
                "--repeats", str(TTOTAL_REPEATS), "--out",
                os.path.join(d, "d.png")] + [
            a for a in extra if a not in ("--densify", "DENSE")]
        timed[name] = tt_ms(run_cli(argv)[1])
    emit("cli_single", nvidia_smi=smi_line(), shape=[H, W],
         process_wall_s=process_wall, process_import_s=import_s,
         process_stdout=proc.stdout.splitlines(),
         ttotal_ms_best_of_20=timed, ttotal_ms_single_call=tt,
         checks=report, failures=failures)
    if failures:
        raise SystemExit(f"cli_single failed: {failures}")


SEQ_SPARSE_HEAD, SEQ_DENSE, SEQ_SPARSE_TAIL = 8, 16, 8

# the builders the sparsematch CLI makes its matchers with, and the
# key-kernel launches each call of such a matcher makes at 436x1024 (one a
# pair, or a --batch stack of pairs; one a level for the pyramids, whose
# level count is the builders' third argument)
CLI_BUILDERS = (
    ("opengpc_tpu_torch.cli.sparsematch", (
        "build_sparsematch", "build_sparsematch_rows",
        "build_sparsematch_masked", "build_sparsematch_masked_compact",
        "build_sparsematch_global_rows", "build_sparsematch_global_compact"),
     lambda args: 1),
    ("opengpc_tpu_torch.pyramid", (
        "build_pyramid_sparsematch", "build_pyramid_sparsematch_compact"),
     lambda args: args[2]),
)


@contextlib.contextmanager
def counted_matchers():
    """Counts the calls of every matcher the sparsematch CLI builds while
    the context is open: yields ``{"dispatches": calls, "fused_keys": the
    key-kernel launches those calls should make}``.  The CLI's sequence
    mode chooses between a stacked dispatch, single frames and the direct
    full-width fallback as the hysteresis trips on its writer thread, so
    its launch count is read from its own calls."""
    import importlib

    calls = {"dispatches": 0, "fused_keys": 0}
    saved = []

    def counting(build, per_call):
        def counted_build(*args, **kw):
            match, n = build(*args, **kw), per_call(args)

            def counted(*frames):
                calls["dispatches"] += 1
                calls["fused_keys"] += n
                return match(*frames)

            return counted

        return counted_build

    try:
        for module, names, per_call in CLI_BUILDERS:
            mod = importlib.import_module(module)
            for name in names:
                saved.append((mod, name, getattr(mod, name)))
                setattr(mod, name, counting(saved[-1][2], per_call))
        yield calls
    finally:
        for mod, name, build in saved:
            setattr(mod, name, build)


def seq_frames():
    """32 pairs at 436x1024: 8 sparse, 16 dense, 8 sparse (the density
    switches twice, so the probe picks compact, the dense stretch
    overflows and the hysteresis routes it, and compact resumes)."""
    from opengpc_tpu_torch.utils import make_pair, make_sparse_pair

    kinds = (["sparse"] * SEQ_SPARSE_HEAD + ["dense"] * SEQ_DENSE
             + ["sparse"] * SEQ_SPARSE_TAIL)
    return [make_sparse_pair(H, W, TRUE_DISP, density=0.15, seed=400 + i)
            if k == "sparse" else make_pair(H, W, TRUE_DISP, seed=400 + i)
            for i, k in enumerate(kinds)], kinds


def seq_rate(stdout, n):
    """(frames/s over the run, frames/s over its second half) from the
    CLI's report lines."""
    total = [ln for ln in stdout.splitlines() if " pairs, " in ln][0]
    half = [ln for ln in stdout.splitlines() if ln.startswith("steady")][0]
    ms = float(total.split(" supports, ")[1].split(" ms")[0])
    half_ms = float(half.split(": ")[1].split(" ms")[0])
    return n / (ms / 1e3), (n - n // 2) / (half_ms / 1e3)


def phase_cli_sequence(td, launches):
    """Sequence mode on the card: a directory of 32 436x1024 pairs (16
    dense, 16 sparse, the density switching mid-sequence) at ``--batch 1``,
    ``--batch 4`` and ``--pyramid 3`` in this process; every frame's
    ``supports_NNNN.txt`` equals the single-pair CLI's on that frame (as a
    set: the contracts order a row differently), the hysteresis notices
    are bounded as the JAX package's tests bound them, and ``--densify``
    on an 8-frame window (4 sparse, 4 dense) writes the same
    ``dense_NNNN.png`` and supports files as ``--device cpu``.  Every card
    run goes through ``Launches.run``: a single-pair run launches the key
    kernel once a level, twice with its overflow notice; a sequence run
    once a level for each matcher call it made (``counted_matchers``),
    which at ``--batch 1`` must be one a frame and one an overflow notice.
    Reports frames/s over each run and over its second half."""
    from opengpc_tpu_torch.io import read_supports, write_png

    frames, kinds = seq_frames()
    ldir, rdir = os.path.join(td, "seq_l"), os.path.join(td, "seq_r")
    wdir = [os.path.join(td, "seq_win_l"), os.path.join(td, "seq_win_r")]
    for dd in [ldir, rdir] + wdir:
        os.makedirs(dd)
    win = range(SEQ_SPARSE_HEAD - 4, SEQ_SPARSE_HEAD + 4)
    t0 = time.perf_counter()
    for i, (left, right) in enumerate(frames):
        for dd, img in ((ldir, left), (rdir, right)):
            write_png(os.path.join(dd, f"f{i:04d}.png"), img)
        if i in win:
            for dd, src in zip(wdir, (ldir, rdir)):
                os.link(os.path.join(src, f"f{i:04d}.png"),
                        os.path.join(dd, f"f{i:04d}.png"))
    write_s = time.perf_counter() - t0
    forest = os.path.join(REPO, "forests", "defaultZeroForest.txt")
    n = len(frames)
    failures, report = [], {}

    def single_sets(extra, levels):
        out = []
        for i in range(n):
            d = os.path.join(td, "seq_single")
            os.makedirs(d, exist_ok=True)
            argv = [forest, os.path.join(ldir, f"f{i:04d}.png"),
                    os.path.join(rdir, f"f{i:04d}.png"), "--capacity",
                    CLI_CAPACITY, "--out", os.path.join(d, "d.png"),
                    "--supports-out", os.path.join(d, "s.txt")] + extra
            (rc, _, _), _ = launches.run(
                f"cli_sequence/single{levels}", lambda: run_cli(argv),
                lambda r: {"fused_keys": levels * (1 + r[2].count(
                    "overflow:"))})
            if rc:
                raise SystemExit(f"single-pair CLI rc {rc} on frame {i}")
            out.append(support_keys(read_supports(os.path.join(d, "s.txt"))))
        return out

    def sequence(name, argv):
        """One sequence run on the card: (rc, stdout, stderr, its matcher
        calls, its kernel launches)."""
        with counted_matchers() as calls:
            (rc, out, err), counts = launches.run(
                f"cli_sequence/{name}", lambda: run_cli(argv),
                lambda _: {"fused_keys": calls["fused_keys"]})
        return rc, out, err, calls["dispatches"], counts

    singles = {"plain": single_sets([], 1),
               "pyramid3": single_sets(["--pyramid", "3"], 3)}
    for name, extra, want in (("batch1", ["--batch", "1"], "plain"),
                              ("batch4", ["--batch", "4"], "plain"),
                              ("pyramid3", ["--pyramid", "3"], "pyramid3")):
        out_dir = os.path.join(td, f"seq_{name}")
        rc, out, err, calls, counts = sequence(
            name, [forest, ldir, rdir, "--out",
                   os.path.join(out_dir, "d.png")] + extra)
        got = [support_keys(read_supports(
            os.path.join(out_dir, f"supports_{i:04d}.txt"))) for i in range(n)]
        bad = [i for i in range(n)
               if not np.array_equal(got[i], singles[want][i])]
        rate, steady = seq_rate(out, n) if rc == 0 else (None, None)
        ovf = err.count("overflow:")
        report[name] = dict(rc=rc, frames_differ=bad, frames_per_s=rate,
                            steady_frames_per_s=steady,
                            supports=int(sum(g.size for g in got)),
                            overflow_notices=ovf, matcher_calls=calls,
                            launches=counts,
                            resumed="resuming the compact contract" in err,
                            probe_picked_compact="chunk-compacted" in err,
                            stdout=out.splitlines()[-2:])
        hysteresis = (name != "batch1"
                      or (1 <= ovf <= 4 and report[name]["resumed"]))
        # --batch 1 dispatches each frame alone, and re-runs an overflow
        calls_ok = (calls == n + ovf if name == "batch1"
                    else (n + 3) // 4 + ovf <= calls <= n + ovf)
        if rc or bad or not hysteresis or not calls_ok \
                or not report[name]["probe_picked_compact"]:
            failures.append(f"{name}: {report[name]}")
    dens = {}
    for device in ("cuda", "cpu"):
        out_dir = os.path.join(td, f"seq_dense_{device}")
        argv = [forest, *wdir, "--out", os.path.join(out_dir, "d.png"),
                "--densify", os.path.join(out_dir, "dense"), "--device",
                device]
        if device == "cuda":
            rc, _, _, calls, counts = sequence("densify_window", argv)
        else:
            rc = run_cli(argv)[0]
        dens[device] = (rc, dir_bytes(out_dir),
                        dir_bytes(os.path.join(out_dir, "dense")))
    same = dens["cuda"] == dens["cpu"] and len(dens["cuda"][2]) == len(win)
    report["densify_window"] = dict(frames=len(win), equal_cpu=same,
                                    rc=[dens["cuda"][0], dens["cpu"][0]],
                                    matcher_calls=calls, launches=counts)
    if not same:
        failures.append(f"densify window: {report['densify_window']}")
    emit("cli_sequence", nvidia_smi=smi_line(), shape=[H, W], frames=n,
         kinds="".join(k[0] for k in kinds), png_write_s=write_s,
         checks=report, failures=failures)
    if failures:
        raise SystemExit(f"cli_sequence failed: {failures}")


def phase_densify(smi):
    """Densify at 436x1024 on the dense pair's masked buffer: for both
    methods, ``densify_from_masked`` (the default seeding) and each
    seeding on the card equal ``densify_supports(masked_supports_to_numpy(
    ...))`` on the card, and each equals the CPU, bit for bit; each
    seeding timed with CUDA events and the profiler's device time, with
    its kernel launches a call; beside them the supports path (upload
    included) and the CLI's density probe."""
    from opengpc_tpu_torch import (InferenceSettings, build_sparsematch_masked,
                                   masked_supports_to_numpy)
    from opengpc_tpu_torch.cli.sparsematch import _probe_density
    from opengpc_tpu_torch.densify import (DEFAULT_SEEDING,
                                           _densify_from_masked,
                                           densify_from_masked,
                                           densify_supports)
    from opengpc_tpu_torch.utils import make_pair

    settings = InferenceSettings(**SETTINGS_KW)
    left, right = make_pair(H, W, TRUE_DISP)
    forest = os.path.join(REPO, "forests", "defaultZeroForest.txt")
    m = build_sparsematch_masked(load_mask(forest), settings, device="cuda")
    buf, counts = m(torch.from_numpy(left).cuda(),
                    torch.from_numpy(right).cuda())
    dh = settings.disp_high
    sup = masked_supports_to_numpy(buf, counts, dh)
    buf_cpu = buf.cpu()
    failures, report = [], {}

    def same(a, b):
        return all(np.array_equal(x, y) for x, y in zip(a, b))

    for method in ("multigrid", "jacobi"):
        iters = 10 if method == "multigrid" else 64
        want = densify_supports(sup, (H, W), method=method, device="cuda")
        ok = (same(densify_supports(sup, (H, W), method=method,
                                    device="cpu"), want)
              and same([t.cpu().numpy() for t in densify_from_masked(
                  buf, counts, dh, method=method, device="cuda")], want))
        for seed in ("scatter", "sortmerge"):
            def run(seed=seed, method=method, iters=iters):
                return _densify_from_masked(buf, dh, iters, seed_impl=seed,
                                            method=method)

            got = [t.cpu().numpy() for t in run()]
            cpu = [t.numpy() for t in _densify_from_masked(
                buf_cpu, dh, iters, seed_impl=seed, method=method)]
            equal = ok and same(got, want) and same(cpu, want)
            # one window of 3 calls: ~1,600 launches a call, so a lost
            # event or two are within the summed device ms
            prof = device_profile(run, 3, tries=1)
            report[f"{method}/{seed}"] = dict(
                equal_supports_path_and_cpu=equal, filled=int(got[1].sum()),
                events_ms=cuda_ms(run, 5), device_ms=prof["device_ms"],
                wall_ms=prof["wall_ms"], busy_share=prof["busy_share"],
                launches_per_call=prof["launches"], whole=prof["whole"],
                top=prof["kernels"][:4])
            if not equal or not got[1].any():
                failures.append(f"{method}/{seed}")
        report[f"{method}/supports_path"] = dict(
            host_ms_median=median_ms(lambda: densify_supports(
                sup, (H, W), method=method, device="cuda"), 5))
    dev = torch.device("cuda")
    report["probe"] = dict(
        density=_probe_density(settings, left, right, dev),
        host_ms_median=median_ms(
            lambda: _probe_density(settings, left, right, dev), 20))
    emit("densify", nvidia_smi=smi, shape=[H, W], supports=len(sup),
         default_seeding=DEFAULT_SEEDING, checks=report, failures=failures)
    if failures:
        raise SystemExit(f"densify failed: {failures}")


# the multi-device builders' cases: a B = 4 batch of dense or sparse
# 436x1024 pairs, the pyramids at 448x1024 (448 = 16 x 28: at n = 4 and
# 3 levels the coarsest slab is 28 rows, and 436 = 4 x 109 divides by no
# n x 2^(L-1) past 4)
MD_B, MD_PH, MD_LEVELS = 4, 448, 3
MD_GRIDS = ((1, 1), (2, 2), (1, 4), (4, 1))
TORCHRUN_TIMEOUT = 300


def md_batches(h, batch=MD_B, w=W):
    """The dense and sparse (density 0.15) batches of ``batch`` h x w
    pairs, host arrays."""
    from opengpc_tpu_torch.utils import make_pair, make_sparse_pair

    out = {}
    for scene, make in (
            ("dense", lambda b: make_pair(h, w, TRUE_DISP, seed=600 + b)),
            ("sparse", lambda b: make_sparse_pair(h, w, TRUE_DISP,
                                                  density=0.15,
                                                  seed=610 + b))):
        pairs = [make(b) for b in range(batch)]
        out[scene] = tuple(np.stack([p[i] for p in pairs]) for i in (0, 1))
    return out


def md_decode(contract, out, j, settings):
    """Frame j's (n, 3) supports of a batched result of ``contract``."""
    from opengpc_tpu_torch import (global_row_supports_to_numpy,
                                   masked_supports_to_numpy,
                                   row_supports_to_numpy, supports_to_numpy)

    def pick(t):
        return tuple(pick(x) for x in t) if isinstance(t, tuple) else t[j]

    # a compact contract's flags are not a frame's (masked-compact: one a
    # rank or a frame group)
    o = pick(out[:-1] if contract.endswith("compact") else out)
    if contract == "flat":
        return supports_to_numpy(*o)
    if contract == "rows":
        return row_supports_to_numpy(*o[0], o[1])
    if contract.startswith("global"):
        return global_row_supports_to_numpy(*o[0], o[1])
    return masked_supports_to_numpy(o[0], o[1], settings.disp_high)


def run_group(argv, timeout, cwd=REPO):
    """``argv`` in a session of its own: (rc, stdout, stderr, wall s).  At
    ``timeout`` the whole session (a launcher and every rank it started)
    is killed, and the run fails with rc -9."""
    import signal

    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        return -9, out, err + "\ntimed out", time.perf_counter() - t0
    return proc.returncode, out, err, time.perf_counter() - t0


def torchrun(pool, module, argv, cwd, nproc=1):
    """``torchrun --standalone --nproc-per-node nproc -m module argv``
    (one rank a card, its own rendezvous port) on a thread of ``pool``: a
    future of (rc, stdout, stderr, wall s).  A launch past
    ``TORCHRUN_TIMEOUT`` is killed, ranks and all, and fails."""
    return pool.submit(run_group, [
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc-per-node", str(nproc), "-m", module, *argv],
        TORCHRUN_TIMEOUT, cwd)


def phase_multi_device(td, oracle, paths, launches, train_ref, smi):
    """The multi-device builders of ``opengpc_tpu_torch.parallel`` on the
    card: the six batched contracts and the batched pyramid, the
    row-sharded pyramid (frame 0 of each batch) at n = 1 over a one-rank
    NCCL group (``run_whole``: the rank's block, the module, the all-gather)
    and at n = 2, 4 through the one-process helper; the 2-D frame (three
    contracts) and pyramid on the (1, 1) grid of that group and on (2, 2),
    (1, 4), (4, 1) through the helper.  Dense and sparse B = 4 batches at
    436x1024 (pyramids 448x1024, 3 levels), both forests.  Every path runs
    with the launch counters at 0 and must launch exactly its count; each
    result equals the single-device module of its contract on the card
    bit for bit (the sharded pyramids: the support set and counts) and
    every frame passes the oracle gate (``pyramid_gate`` a level), unless
    its overflow flag is set (then equal to the single-device module's
    flag).  Then ``sharded_sparsematch_step`` on the group, the trainer
    over the group at ``phase_train``'s ~10^6 triplets (its forest equal
    to the one-device forest), events and device ms a call of the n = 1
    group modules against the single-device masked module at B = 4, and
    four ``torchrun`` launches of the CLIs at one rank (``--shard-frame
    1`` single pair, plain and ``--pyramid 3``; ``--data-parallel 1
    --batch 4`` over ``cli_sequence``'s 32 pairs; ``cli.train
    --data-parallel 1``), started together before the builders run and
    waited for after them, whose files must equal the one-device CLI's
    from the earlier phases."""
    from concurrent.futures import ThreadPoolExecutor

    import torch.distributed as dist

    from opengpc_tpu_torch import (InferenceSettings, build_sparsematch,
                                   build_sparsematch_global_compact,
                                   build_sparsematch_global_rows,
                                   build_sparsematch_masked,
                                   build_sparsematch_masked_compact,
                                   build_sparsematch_rows, fern_factory,
                                   load_forest, make_filter_mask,
                                   serialize_forest, train_forest,
                                   zero_optimizer)
    from opengpc_tpu_torch import parallel as par
    from opengpc_tpu_torch.pyramid import (build_pyramid_sparsematch,
                                           pyramid_supports_to_numpy)

    epi, lib = InferenceSettings(**SETTINGS_KW), InferenceSettings()
    # the flat buffers hold every support: capacity H*W, as stereomatch's
    flat = dataclasses.replace(epi, capacity=H * W)
    contracts = {  # contract: (single-device builder, batched, settings)
        "flat": (build_sparsematch, par.build_batched_sparsematch, flat),
        "rows": (build_sparsematch_rows, par.build_batched_sparsematch_rows,
                 epi),
        "masked": (build_sparsematch_masked,
                   par.build_batched_sparsematch_masked, epi),
        "masked-compact": (build_sparsematch_masked_compact,
                           par.build_batched_sparsematch_masked_compact, epi),
        "global-rows": (build_sparsematch_global_rows,
                        par.build_batched_sparsematch_global_rows, lib),
        "global-compact": (build_sparsematch_global_compact,
                           par.build_batched_sparsematch_global_compact, lib)}
    # key-kernel launches of a B = 4 call over n ranks: the folding
    # contracts one a rank's block, the others one a pair
    folds = ("rows", "masked", "masked-compact")
    host = {h: md_batches(h) for h in (H, MD_PH)}
    frames = {h: {s: tuple(torch.from_numpy(a).cuda() for a in pair)
                  for s, pair in batches.items()}
              for h, batches in host.items()}
    failures, report, refs = [], {}, {}

    def reference(forest, scene, contract, mask):
        """The single-device module's result on the batch, and the oracle
        gate of every frame it does not flag: a builder's result that
        equals it bit for bit passes the same gate."""
        key = (forest, scene, contract)
        if key in refs:
            return refs[key]
        if contract == "pyramid":
            pl, pr = frames[MD_PH][scene]
            out = build_pyramid_sparsematch(mask, epi, MD_LEVELS,
                                            device="cuda")(pl, pr)
            sets, ok = [], True
            for j in range(MD_B):
                sup = pyramid_supports_to_numpy(*(t[j] for t in out))
                good, _ = pyramid_gate(oracle, host[MD_PH][scene][0][j],
                                       host[MD_PH][scene][1][j],
                                       paths[forest], sup, epi, MD_LEVELS)
                ok = ok and good and len(sup) > 0
                sets.append(support_keys(sup[:, :3]))
            refs[key] = (out, ok, sets)
            return refs[key]
        build, _, settings = contracts[contract]
        out = build(mask, settings, device="cuda")(*frames[H][scene])
        flags = [False] * MD_B
        if contract == "masked-compact":
            flags = [bool(out[2])] * MD_B
        elif contract == "global-compact":
            flags = out[2].tolist()
        ok, gated = True, 0
        for j in range(MD_B):
            if flags[j]:
                continue
            sup = md_decode(contract, out, j, settings)
            good, _ = oracle_gate(oracle, host[H][scene][0][j],
                                  host[H][scene][1][j], paths[forest], sup,
                                  settings)
            ok, gated = ok and good and len(sup) > 0, gated + 1
        refs[key] = (out, ok, gated)
        return refs[key]

    def check(key, same, ok, **extra):
        report[key] = dict(equals_single_device=bool(same),
                           oracle_gate=bool(ok), **extra)
        if not (same and ok):
            failures.append(f"{key}: {report[key]}")

    def equal(a, b):
        return all(torch.equal(x, y)
                   for x, y in zip(_leaves(a), _leaves(b), strict=True))

    def compact_equal(out, want, groups):
        """A compacted result: one flag a rank or frame group, set as the
        single-device module's flag; the buffers equal where it is
        clear."""
        return (tuple(out[2].shape) == (groups,)
                and bool(out[2].any()) == bool(want[2])
                and (bool(want[2]) or equal(out[:2], want[:2])))

    def pyramid_frames_equal(out, want_sets, want_counts, idx):
        return all(torch.equal(out[4][i], want_counts[j]) and np.array_equal(
            support_keys(pyramid_supports_to_numpy(
                *(t[i] for t in out))[:, :3]), want_sets[j])
            for i, j in idx)

    def run_n(mod, l, r, n):
        return (mod.run_whole(l, r) if n in (1, (1, 1))
                else par._run_in_one_process(mod, l, r, n))

    # the CLIs over a one-rank launch; their one-device references are
    # the earlier phases' output directories
    forest = paths["defaultZeroForest"]
    dense = [os.path.join(td, f"cli_dense_{side}.png") for side in "lr"]
    single_out = ["--capacity", CLI_CAPACITY, "--out", "OUT/d.png",
                  "--supports-out", "OUT/s.txt"]
    # the four launches at once, each its own process and rendezvous,
    # while this process drives the builders
    launch, started = {}, {}
    t_launch = time.perf_counter()
    pool = ThreadPoolExecutor(max_workers=4)
    for name, module, argv, ref_dir in (
            ("single_shard1", CLI,
             [forest, *dense, "--shard-frame", "1", "--densify",
              "OUT/dense.png", *single_out], "cli_masked_densify_cuda"),
            ("single_shard1_pyramid3", CLI,
             [forest, *dense, "--shard-frame", "1", "--pyramid", "3",
              *single_out], "cli_pyramid3_dense_cuda"),
            ("sequence_data1_batch4", CLI,
             [forest, os.path.join(td, "seq_l"), os.path.join(td, "seq_r"),
              "--data-parallel", "1", "--batch", "4", "--out", "OUT/d.png"],
             "seq_batch4"),
            ("train_data1", "opengpc_tpu_torch.cli.train",
             [os.path.join(td, "triplets.bin"), "OUT/fresh.txt", "--seed",
              "4", "--data-parallel", "1"], "workflow_forest")):
        out_dir = os.path.join(td, f"torchrun_{name}")
        os.makedirs(out_dir)
        started[name] = (ref_dir, out_dir, torchrun(
            pool, module, [a.replace("OUT", out_dir) for a in argv], REPO))
    torch.cuda.set_device(0)
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as store_dir:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(store_dir, "store"), 1),
            rank=0, world_size=1)
        try:
            world = dist.group.WORLD
            grid11 = par.make_mesh_2d(1, 1)
            for forest in FORESTS:
                mask = make_filter_mask(load_forest(paths[forest]))
                for scene in ("dense", "sparse"):
                    l_d, r_d = frames[H][scene]
                    pl, pr = frames[MD_PH][scene]
                    for contract, (_, build, s) in contracts.items():
                        want, ok, gated = reference(forest, scene, contract,
                                                    mask)
                        for n in (1, 2, 4):
                            key = f"batched/{contract}/n{n}/{forest}/{scene}"
                            mod = build(mask, s, world if n == 1 else None,
                                        device="cuda")
                            out, _ = launches.run(
                                key, lambda: run_n(mod, l_d, r_d, n),
                                {"fused_keys": n if contract in folds
                                 else MD_B})
                            same = (compact_equal(out, want, n)
                                    if contract == "masked-compact"
                                    else equal(out, want))
                            check(key, same, ok, gated_frames=gated)
                    wantp, okp, sets = reference(forest, scene, "pyramid",
                                                 mask)
                    for n in (1, 2, 4):
                        key = f"batched/pyramid/n{n}/{forest}/{scene}"
                        mod = par.build_batched_pyramid(
                            mask, epi, world if n == 1 else None, MD_LEVELS,
                            device="cuda")
                        out, _ = launches.run(
                            key, lambda: run_n(mod, pl, pr, n),
                            {"fused_keys": MD_LEVELS * n})
                        check(key, equal(out, wantp), okp)
                        key = f"sharded_pyramid/n{n}/{forest}/{scene}"
                        mod = par.build_sharded_frame_pyramid(
                            mask, epi, world if n == 1 else None, MD_LEVELS,
                            device="cuda")
                        out, _ = launches.run(
                            key, lambda: run_n(mod, pl[0], pr[0], n),
                            {"fused_keys_slab": MD_LEVELS * n})
                        check(key, pyramid_frames_equal(
                            tuple(t[None] for t in out), sets, wantp[4],
                            [(0, 0)]), okp)
                    for grid in MD_GRIDS:
                        ranks = grid[0] * grid[1]
                        group = grid11 if grid == (1, 1) else None
                        tag = f"{grid[0]}x{grid[1]}"
                        for contract in folds:
                            want, ok, gated = refs[(forest, scene, contract)]
                            key = f"2d/{contract}/{tag}/{forest}/{scene}"
                            mod = par.build_batched_sharded_frame_sparsematch(
                                mask, epi, group, contract, device="cuda")
                            out, _ = launches.run(
                                key, lambda: run_n(mod, l_d, r_d, grid),
                                {"fused_keys_slab": ranks})
                            same = (compact_equal(out, want, grid[0])
                                    if contract == "masked-compact"
                                    else equal(out, want))
                            check(key, same, ok, gated_frames=gated)
                        key = f"2d/pyramid/{tag}/{forest}/{scene}"
                        mod = par.build_batched_sharded_frame_pyramid(
                            mask, epi, group, MD_LEVELS, device="cuda")
                        out, _ = launches.run(
                            key, lambda: run_n(mod, pl, pr, grid),
                            {"fused_keys_slab": MD_LEVELS * ranks})
                        check(key, pyramid_frames_equal(
                            out, sets, wantp[4],
                            [(j, j) for j in range(MD_B)]), okp)
            paths_s = time.perf_counter() - t_start

            # the launches end before the trainer and the timing windows
            for name, (ref_dir, out_dir, proc) in started.items():
                rc, out, err, wall = proc.result()
                got = dir_bytes(out_dir)
                same = got == dir_bytes(os.path.join(td, ref_dir))
                launch[name] = dict(rc=rc, wall_s=wall,
                                    equals_one_device=same,
                                    files=sorted(got),
                                    stdout=out.splitlines()[-2:])
                if rc or not same:
                    failures.append(
                        f"torchrun {name}: {launch[name]} {err[-2000:]}")
            launches_s = time.perf_counter() - t_launch
            pool.shutdown()

            t0 = time.perf_counter()
            par.sharded_sparsematch_step(world, device="cuda")
            step_s = time.perf_counter() - t0

            trips, (one_text, one_wall) = train_ref
            t0 = time.perf_counter()
            text = serialize_forest(train_forest(
                trips, fern_factory(2, 2, 2, 5), zero_optimizer(), seed=0,
                verbose=False, device="cuda", group=world))
            torch.cuda.synchronize()
            trainer = dict(triplets=len(trips), wall_s=time.perf_counter() - t0,
                           one_device_wall_s=one_wall,
                           equals_one_device=text == one_text)
            if text != one_text:
                failures.append(f"trainer over the group: {trainer}")

            mask = make_filter_mask(load_forest(paths["defaultZeroForest"]))
            l_d, r_d = frames[H]["dense"]
            pl, pr = frames[MD_PH]["dense"]
            mods = {
                "single_masked": lambda m=build_sparsematch_masked(
                    mask, epi, device="cuda"): m(l_d, r_d),
                "batched_masked": lambda m=par.build_batched_sparsematch_masked(
                    mask, epi, world, device="cuda"): m.run_whole(l_d, r_d),
                "batched_masked_forward": lambda m=(
                    par.build_batched_sparsematch_masked(
                        mask, epi, world, device="cuda")): m(l_d, r_d),
                "2d_masked": lambda m=(
                    par.build_batched_sharded_frame_sparsematch(
                        mask, epi, grid11, device="cuda")): m.run_whole(
                    l_d, r_d),
                "single_pyramid3": lambda m=build_pyramid_sparsematch(
                    mask, epi, MD_LEVELS, device="cuda"): m(pl, pr),
                "batched_pyramid3": lambda m=par.build_batched_pyramid(
                    mask, epi, world, MD_LEVELS, device="cuda"): m.run_whole(
                    pl, pr),
                "2d_pyramid3": lambda m=(
                    par.build_batched_sharded_frame_pyramid(
                        mask, epi, grid11, MD_LEVELS, device="cuda")):
                    m.run_whole(pl, pr),
                "sharded_pyramid3_one_frame": lambda m=(
                    par.build_sharded_frame_pyramid(
                        mask, epi, world, MD_LEVELS, device="cuda")):
                    m.run_whole(pl[0], pr[0]),
            }
            out = par.build_batched_sparsematch_masked(
                mask, epi, world, device="cuda")(l_d, r_d)
            mods["all_gather_only"] = lambda: par.all_gather_outputs(out,
                                                                     world)
            times = {}
            for name, fn in mods.items():
                prof = device_profile(fn, 5, tries=1)
                times[name] = dict(
                    events_ms=[cuda_ms(fn, 10) for _ in range(2)],
                    device_ms=prof["device_ms"], busy_share=prof["busy_share"],
                    whole=prof["whole"], top=prof["kernels"][:3])
        finally:
            dist.destroy_process_group()

    emit("multi_device", nvidia_smi=smi, shape=[H, W], pyramid_shape=[MD_PH, W],
         batch=MD_B, levels=MD_LEVELS, cases=len(report), paths_s=paths_s,
         torchrun_s=launches_s,
         step_s=step_s, trainer=trainer, times=times, torchrun=launch,
         checks=report, failures=failures)
    if failures:
        raise SystemExit(f"multi_device failed: {failures[:20]}")


def phase_custom_ops(masks):
    """``torch.library.opcheck`` on every ``ogpc::`` op with CUDA inputs:
    the schema, the autograd registration, the fake against the card's
    outputs and a trace with dynamic shapes, on the dense 436x1024 pair
    and an odd 37x130 one (the row sort on their zero-forest key images),
    with the zero and tau forests where the op takes tests.  Any failure
    fails the run."""
    import torch.nn.functional as F

    from opengpc_tpu_torch.match import SENTINEL_BASE
    from opengpc_tpu_torch.ops import library
    from opengpc_tpu_torch.ops.fused import PAD, op_tests
    from opengpc_tpu_torch.ops.sort import padded_row_length
    from opengpc_tpu_torch.utils import make_pair

    rng = np.random.default_rng(11)
    pairs = {"436x1024": make_pair(H, W, TRUE_DISP),
             "37x130": make_pair(37, 130, 3, seed=7)}
    results, failures = {}, []

    def check(key, name, args):
        try:
            res = torch.library.opcheck(library.OPS[name], args)
        except Exception as e:  # noqa: BLE001  (reported, then fails)
            failures.append(f"{key}: {type(e).__name__}: {str(e)[:400]}")
            return
        results[key] = res
        if any(v != "SUCCESS" for v in res.values()):
            failures.append(f"{key}: {res}")

    for sname, pair in pairs.items():
        ld, rd = (torch.from_numpy(a).cuda() for a in pair)
        h, w = ld.shape
        sh, y0 = h // 2, h // 4
        slabs = [F.pad(x, (0, 0, PAD, PAD))[y0:y0 + sh + 2 * PAD]
                 .contiguous() for x in (ld, rd)]
        n2 = padded_row_length(w)
        key = torch.from_numpy(rng.integers(0, 1 << 20, (h, n2),
                                            dtype=np.int32)).cuda()
        pay = torch.arange(n2, dtype=torch.int32,
                           device="cuda").expand(h, -1).contiguous()
        check(f"fused_census/{sname}", "fused_census", (ld,))
        check(f"bitonic_sort_rows/{sname}", "bitonic_sort_rows", (key, pay))
        check(f"row_sort/{sname}", "row_sort", (library.fused_key_image(
            ld[None], rd[None], op_tests(masks["zero"]), 5,
            SENTINEL_BASE)[0],))
        for fname in ("zero", "tau"):
            t = op_tests(masks[fname])
            for name, args in (
                    ("fused_key_image", (ld[None], rd[None], t, 5,
                                         SENTINEL_BASE)),
                    ("fused_key_image_slab", (slabs[0][None],
                                              slabs[1][None], t, 5,
                                              SENTINEL_BASE, y0, h)),
                    ("fused_keys", (ld, t, 5, w, SENTINEL_BASE, 0)),
                    ("fused_keys_slab", (slabs[0], t, 5, 0, SENTINEL_BASE,
                                         y0, h)),
                    ("fused_codes", (ld, t, 5)),
                    ("fused_codes_pair", (ld, rd, t, 5)),
                    ("fused_sparsematch_rows", (ld, rd, t, 5, 128))):
                check(f"{name}/{sname}/{fname}", name, args)
    emit("custom_ops", ops=sorted(library.OPS), cases=len(results),
         tests=sorted({k for r in results.values() for k in r}),
         failures=failures[:10])
    if failures:
        raise SystemExit(f"opcheck failed: {failures[:10]}")


AOT_CLI = "opengpc_tpu_torch.cli.aot"


def phase_aot(td, oracle, paths, launches, smi):
    """Export, save, load and call on the card: masked at the CLI's
    settings, global-rows at the library defaults, masked-compact and the
    pyramid at 3 levels; each loaded program equal to its live module bit
    for bit with exact launches (``fused_keys`` once a call, once a level
    for the pyramid), the compact artifact raising ``OverflowError`` on
    the dense frame.  Then ``cli.aot export`` and ``run`` in fresh
    processes (the supports file equal to the one-call ``sparsematch``'s
    and through the oracle gate), the sharded-frame artifact at world 1
    over a one-rank NCCL group (one slab-mode launch a call), and the
    loaded and live masked and global-rows modules timed at B = 1."""
    import torch.distributed as dist

    from opengpc_tpu_torch import (InferenceSettings, aot,
                                   build_sparsematch_global_rows,
                                   build_sparsematch_masked,
                                   build_sparsematch_masked_compact,
                                   sparsematch)
    from opengpc_tpu_torch.io.supports import read_supports
    from opengpc_tpu_torch.parallel import build_sharded_frame_sparsematch
    from opengpc_tpu_torch.pyramid import build_pyramid_sparsematch
    from opengpc_tpu_torch.utils import make_pair, make_sparse_pair

    forest = paths["defaultZeroForest"]
    mask = load_mask(forest)
    epi = InferenceSettings(**SETTINGS_KW)
    scenes = {"dense": make_pair(H, W, TRUE_DISP),
              "sparse": make_sparse_pair(H, W, TRUE_DISP, density=0.15)}
    on_card = {s: tuple(torch.from_numpy(a).cuda() for a in p)
               for s, p in scenes.items()}
    lp, rp = write_pair_pngs(td, "aot", *scenes["dense"])
    art = os.path.join(td, "cli.ogpcx")
    env = dict(os.environ, PYTHONPATH=REPO)
    t_cli = time.perf_counter()
    export = subprocess.Popen(
        [sys.executable, "-m", AOT_CLI, "export", forest, art, "--height",
         str(H), "--width", str(W)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cases = (  # contract, settings, live builder, scenes, launches a call
        ("masked", epi, build_sparsematch_masked, ("dense",), 1),
        ("global-rows", InferenceSettings(), build_sparsematch_global_rows,
         ("dense",), 1),
        ("masked-compact", epi, build_sparsematch_masked_compact,
         ("sparse", "dense"), 1),
        ("pyramid", epi, lambda m, s, device: build_pyramid_sparsematch(
            m, s, num_levels=3, device=device), ("dense",), 3))
    failures, report, timing, served = [], {}, {}, {}
    for contract, settings, build, names, per_call in cases:
        t0 = time.perf_counter()
        blob = aot.export_sparsematch(mask, settings, (H, W), contract,
                                      device="cuda", num_levels=3)
        t1 = time.perf_counter()
        path = os.path.join(td, f"{contract}.ogpcx")
        aot.save_artifact(path, blob, contract=contract, settings=settings,
                          shape=(H, W), device="cuda",
                          extra=({"num_levels": 3}
                                 if contract == "pyramid" else None))
        call, meta = aot.load_artifact(path)
        t2 = time.perf_counter()
        live = build(mask, settings, device="cuda")
        served[contract] = (call, live)
        rep = dict(artifact_bytes=os.path.getsize(path), export_s=t1 - t0,
                   load_s=t2 - t1)
        expect = {"fused_keys": per_call}
        for scene in names:
            ld, rd = on_card[scene]
            key = f"aot/{contract}/{scene}"
            out, counts = launches.run(key + "/loaded",
                                       lambda: call(ld, rd), expect)
            want, _ = launches.run(key + "/live", lambda: live(ld, rd),
                                   expect)
            same = all(torch.equal(a, b) for a, b in
                       zip(_leaves(out), _leaves(want), strict=True))
            rep[scene] = dict(launches=counts, equals_live=same)
            if not same:
                failures.append(f"{key}: loaded differs from the live module")
            if contract == "masked-compact" and scene == "dense":
                try:
                    aot.decode_outputs(meta, out)
                    failures.append(f"{key}: no OverflowError")
                except OverflowError:
                    rep[scene]["overflow_error"] = True
                continue
            sup = aot.decode_outputs(meta, out)
            if contract != "pyramid":
                ok, gate = oracle_gate(oracle, *scenes[scene], forest, sup,
                                       settings)
                rep[scene].update(gate)
                if not ok:
                    failures.append(f"{key}: oracle gate {gate}")
            elif not len(sup):
                failures.append(f"{key}: no supports")
        report[contract] = rep

    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as sd:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(sd, "store"), 1),
            rank=0, world_size=1)
        try:
            blob = aot.export_sharded_frame(mask, epi, (H, W),
                                            dist.group.WORLD, "masked",
                                            device="cuda")
            call = aot.load_sharded_frame(blob)
            live = build_sharded_frame_sparsematch(
                mask, epi, group=dist.group.WORLD, device="cuda")
            ld, rd = on_card["dense"]
            expect = {"fused_keys_slab": 1}
            out, counts = launches.run("aot/sharded_frame/n1/loaded",
                                       lambda: call(ld, rd), expect)
            want, _ = launches.run("aot/sharded_frame/n1/live",
                                   lambda: live.run_whole(ld, rd), expect)
            same = all(torch.equal(a, b) for a, b in
                       zip(_leaves(out), _leaves(want), strict=True))
            report["sharded_frame_n1"] = dict(
                artifact_bytes=len(blob), launches=counts, equals_live=same)
            if not same:
                failures.append("aot/sharded_frame/n1: loaded differs from "
                                "the live module")
        finally:
            dist.destroy_process_group()

    ld, rd = on_card["dense"]
    for contract in ("masked", "global-rows"):
        call, live = served[contract]
        timing[contract] = {
            name: dict(events_ms=cuda_ms(lambda: fn(ld, rd), 50),
                       **{k: v for k, v in device_profile(
                           lambda: fn(ld, rd), 20).items()
                          if k in ("device_ms", "wall_ms", "busy_share",
                                   "launches", "usable")})
            for name, fn in (("loaded", call), ("live", live))}

    out_text = export.communicate(timeout=300)[0]
    sup_path = os.path.join(td, "cli_supports.txt")
    run = subprocess.run(
        [sys.executable, "-m", AOT_CLI, "run", art, lp, rp,
         "--supports-out", sup_path, "--repeats", "5"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    cli = dict(export_rc=export.returncode, run_rc=run.returncode,
               seconds=time.perf_counter() - t_cli)
    if export.returncode or run.returncode:
        failures.append(f"cli: {out_text[-800:]} {run.stdout[-400:]} "
                        f"{run.stderr[-800:]}")
    else:
        got = read_supports(sup_path)
        want = sparsematch(lp, rp, forest, InferenceSettings(
            gradient_threshold=5, disp_high=128, vertical_tolerance=0,
            epipolar_mode=True, capacity=65536), device="cuda")
        ok, gate = oracle_gate(oracle, *scenes["dense"], forest, got, epi)
        cli.update(gate, equals_one_call=bool(np.array_equal(got, want)),
                   tTotal_ms=tt_ms(run.stdout))
        if not (ok and cli["equals_one_call"]):
            failures.append(f"cli: {cli}")
    emit("aot", nvidia_smi=smi, checks=report, cli=cli, times=timing,
         failures=failures)
    if failures:
        raise SystemExit(f"aot failed: {failures}")


def phase_profiler_late(smi):
    """How many of a window's kernel events the profiler keeps late in the
    process: four windows of 50 census launches, no retake (the timing
    phases run early because this falls as the process ages)."""
    from opengpc_tpu_torch.ops.fused import fused_census
    from opengpc_tpu_torch.utils import make_pair

    img = torch.from_numpy(make_pair(H, W, TRUE_DISP)[0]).cuda()
    kept = []
    for _ in range(4):
        prof = device_profile(lambda: fused_census(img), 50, tries=1)
        kept.append(prof["kernels"][0][2] if prof["kernels"] else 0.0)
    emit("profiler_late", card=smi, kernel_events_kept_a_call=kept)


def load_mask(path):
    from opengpc_tpu_torch import load_forest, make_filter_mask

    return make_filter_mask(load_forest(path))


# -- four cards of one host: python3 chip_smoke.py --gpus 4 --------------------
#
# The parent checks the cards, builds the kernels and the oracle once and
# starts the rank worker (this script with --rank-worker) as one torchrun
# launch of a rank a card, NCCL between them.  While the worker's
# correctness phases run, the parent launches the CLIs over the same four
# cards and their one-card references; the worker's trainer and timing
# phases wait for the CLIs to end, so nothing else runs on the cards or
# the host while they take their walls and times.

MD4_WORKER_TIMEOUT = 240  # s, the rank worker's launch
MD4_ITERS = 50            # calls a timing window
NVLINK_BYTES_PER_S = 450e9  # one direction of an H100 SXM's NVLink
MD4_KERNELS = ("fused_keys", "fused_keys_slab", "fused_codes")
# the key and code ops (``ops.library``) and the kernel each launches
MD4_OPS = {"fused_key_image": "fused_keys", "fused_keys": "fused_keys",
           "fused_key_image_slab": "fused_keys_slab",
           "fused_keys_slab": "fused_keys_slab",
           "fused_codes": "fused_codes", "fused_codes_pair": "fused_codes"}


@dataclasses.dataclass(frozen=True)
class Md4Sizes:
    """The four-card run's shapes: B pairs of h x w (the batched contracts
    and the 2-D frame), pyramids of ph x w, the row-sharded frame at h x
    w and at ``big``, and the trainer's triplets from ``train_pairs``
    h x w scenes of ``keypoints`` keypoints each."""

    h: int = H
    w: int = W
    ph: int = MD_PH
    big: tuple = (2160, 3840)
    b: int = 16
    train_pairs: int = TRAIN_PAIRS
    keypoints: int = KEYPOINTS


# the CPU rehearsal over gloo ranks: frames of 64 rows a rank at n = 4
MD4_SMALL = Md4Sizes(h=256, w=128, ph=256, big=(512, 192), b=8,
                     train_pairs=2, keypoints=2000)


class Md4Calls:
    """Every call of the key and code ops (``MD4_OPS``, as ``ops.fused``
    calls them: ``library.<op>``) while ``on``: (op, its arguments, its
    output's tensors), each tensor copied as the call had it.  On the card
    every call is one launch of its kernel."""

    def __init__(self):
        self.calls = []

    @contextlib.contextmanager
    def on(self):
        from opengpc_tpu_torch.ops import library

        ops = {op: getattr(library, op) for op in MD4_OPS}

        def recording(op, fn):
            def call(*args):
                out = fn(*args)
                self.calls.append((op, tuple(
                    a.clone() if torch.is_tensor(a) else a for a in args),
                    tuple(t.clone() for t in _leaves(out))))
                return out
            return call

        for op, fn in ops.items():
            setattr(library, op, recording(op, fn))
        try:
            yield
        finally:
            for op, fn in ops.items():
                setattr(library, op, fn)


def md4_plain(op, args):
    """The plain version of the op ``op`` (its CPU implementation, which
    runs on any device) on ``args``: its output's tensors."""
    from opengpc_tpu_torch.ops import fused

    if op == "fused_key_image":
        out = fused._pair_keys_plain(*args)
    elif op == "fused_key_image_slab":
        *head, y0, h_total = args
        out = fused._pair_keys_plain(*head, (y0, h_total))
    elif op == "fused_keys":
        out = fused.fused_keys_plain(*args)
    elif op == "fused_keys_slab":
        out = fused.fused_keys_slab_plain(*args)
    elif op == "fused_codes":
        out = fused.fused_codes_plain(*args)
    else:  # fused_codes_pair
        left, right, tests, thr = args
        out = (fused.fused_codes_plain(left, tests, thr)
               + fused.fused_codes_plain(right, tests, thr))
    return tuple(_leaves(out))


def md4_tests(args):
    """The number of tests in a key or code op call's flat test list."""
    return len(next(a for a in args if isinstance(a, list))) // 5


def md4_has_candidates(op, args, out):
    """Whether a key or code op's output marks a candidate anywhere (a
    key op's sentinel base is its fifth argument)."""
    if MD4_OPS[op] == "fused_codes":
        return any(bool(t.any()) for t in out if t.dtype == torch.bool)
    return bool((out[0] < args[4]).any())


def md4_work(op, args, out):
    """(bytes, integer operations) of one key or code op call: each
    input read once, each output written once; the code math of every
    image (``code_ops``) with codes for its candidates (the code kernel:
    for every pixel)."""
    imgs = [a for a in args if torch.is_tensor(a)]
    tests = md4_tests(args)
    h, w = imgs[0].shape[-2:]
    images = sum(x.numel() // (h * w) for x in imgs)
    nbytes = sum(x.numel() for x in imgs) + sum(
        t.numel() * t.element_size() for t in out)
    if MD4_OPS[op] == "fused_codes":
        return nbytes, code_ops(images, h, w, images * h * w, tests)
    rows = out[0].shape[-2]  # slab mode: the rows without the halos
    return nbytes, code_ops(images, rows, w, int((out[0] < args[4]).sum()),
                            tests)


class Md4:
    """One rank of the four-card run: its group, card, shapes, launch
    counts and the failures of the phase in progress."""

    def __init__(self, device, sizes, save=None):
        import torch.distributed as dist

        self.dist, self.world = dist, dist.group.WORLD
        self.rank, self.n = dist.get_rank(), dist.get_world_size()
        self.dev, self.sz, self.save = device, sizes, save
        self.cuda = device.type == "cuda"
        self.totals = dict.fromkeys(KERNELS, 0)
        self.failures, self.saved = [], {}
        self.calls, self.timed_calls = Md4Calls(), {}

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def run(self, key, fn, expect):
        """``fn()`` with every launch counter at 0, read right after: a
        failure unless each kernel launched its ``expect`` count on this
        rank (on the CPU none: the wrappers take their twins there).  Its
        calls of the key and code ops are recorded (``Md4Calls``); on the
        card a failure too unless they are as many as the launches."""
        for name in KERNELS:
            wrapper(name).launches = 0
        first = len(self.calls.calls)
        with self.calls.on():
            out = fn()
        self.sync()
        counts = {name: wrapper(name).launches for name in KERNELS}
        want = {name: expect.get(name, 0) if self.cuda else 0
                for name in KERNELS}
        for name, k in counts.items():
            self.totals[name] += k
        if counts != want:
            self.failures.append(f"rank {self.rank} {key}: launches "
                                 f"{counts}, expected {want}")
        calls = {name: 0 for name in counts}
        for op, _, _ in self.calls.calls[first:]:
            calls[MD4_OPS[op]] += 1
        if self.cuda and calls != counts:
            self.failures.append(f"rank {self.rank} {key}: op calls "
                                 f"{calls}, launches {counts}")
        return out

    def keep(self, key, out):
        """Rank 0 keeps a whole result on the sparse scene with the zero
        forest for ``--save``."""
        if (self.save and self.rank == 0
                and key.endswith("/defaultZeroForest/sparse")):
            for i, leaf in enumerate(_leaves(out)):
                self.saved[f"{key}/{i}"] = leaf.cpu().numpy()

    def finish(self, phase, **fields):
        """Every rank's ``fields`` and failures gathered on every rank:
        rank 0 prints the phase line, and every rank fails when one
        did (so no rank waits in a collective for a rank that left)."""
        ranks = [None] * self.n
        self.dist.all_gather_object(ranks, dict(fields,
                                                failures=self.failures))
        self.failures = []
        if self.rank == 0:
            emit(phase, device=str(self.dev), world=self.n, ranks=ranks)
        bad = [f for r in ranks for f in r["failures"]]
        if bad:
            raise SystemExit(f"{phase} failed: {bad[:20]}")


def md4_grids(n):
    """Every (n_data, n_rows) grid of n ranks: (1, 4), (2, 2), (4, 1) at
    n = 4."""
    return [(d, n // d) for d in range(1, n + 1) if n % d == 0]


def md4_forest32(seed=32):
    """A ``utils.random_forest`` of at least 32 tests (its filter mask
    cuts it to 32 in file order): a forest the flat contract serves with
    the code kernel, past the 30 tests the key kernel packs."""
    from opengpc_tpu_torch.utils import random_forest

    rng = np.random.default_rng(seed)
    while True:
        forest = random_forest(rng, max_ferns=8)
        if sum(len(f.tests) for f in forest.ferns) >= 32:
            return forest


def md4_kernels(c):
    """The three kernels of the multi-device path on this rank's card
    against their plain versions, bit for bit, at every call the paths of
    ``md4_builders`` made on this rank (``Md4Calls``): the plain version on
    the call's own inputs against the output the kernel gave the path.
    Each kernel must have met a candidate in some call.  Keeps, for
    ``md4_kernel_times``, each kernel's call with the largest output.
    Returns the largest difference a kernel."""
    worst = dict.fromkeys(MD4_KERNELS, 0)
    cases = dict.fromkeys(MD4_KERNELS, 0)
    with_cand = dict.fromkeys(MD4_KERNELS, 0)
    shapes = {k: set() for k in MD4_KERNELS}
    for op, args, out in c.calls.calls:
        name = MD4_OPS[op]
        err = max(max_err(g, w_) for g, w_ in zip(
            out, md4_plain(op, args), strict=True))
        worst[name], cases[name] = max(worst[name], err), cases[name] + 1
        with_cand[name] += md4_has_candidates(op, args, out)
        shapes[name].add((op, tuple(args[0].shape), md4_tests(args)))
        if err:
            c.failures.append(f"rank {c.rank} {name}: {op} on "
                              f"{tuple(args[0].shape)} differs from its "
                              f"plain version by {err}")
        best = c.timed_calls.get(name)
        if best is None or out[0].numel() > best[2][0].numel():
            c.timed_calls[name] = (op, args, out)
    for name in MD4_KERNELS:
        if not with_cand[name]:
            c.failures.append(f"rank {c.rank} {name}: no call of the path "
                              "met a candidate")
    c.calls.calls = []
    c.sync()
    c.finish("md4_kernels", cases=cases, with_candidates=with_cand,
             max_abs_err=worst,
             shapes={k: sorted(map(list, v)) for k, v in shapes.items()})
    return worst


def md4_frames(sz):
    """The row-sharded frame's dense and sparse pairs at h x w and at the
    big shape, host arrays."""
    from opengpc_tpu_torch.utils import make_pair, make_sparse_pair

    return {shape: {"dense": make_pair(*shape, TRUE_DISP, seed=620 + i),
                    "sparse": make_sparse_pair(*shape, TRUE_DISP,
                                               density=0.15, seed=630 + i)}
            for i, shape in enumerate(((sz.h, sz.w), tuple(sz.big)))}


def pyramid_keys(xs, ys, ds, lv):
    """One frame's pyramid supports as sorted ``support_keys``-style int64
    keys of their (x, y, d), on the buffers' device: the support set
    without a copy to the host."""
    keep = lv >= 0
    return torch.sort((xs[keep].long() << 43) | (ys[keep].long() << 22)
                      | (ds[keep].long() + _D_BIAS)).values


def md4_frame_cases(frames, paths):
    """(shape, forest, ``sharded_cases`` case) of the row-sharded frame at
    each shape, but the global contract where its (y, x) key does not
    fit 30 bits (the builder refuses it there)."""
    from opengpc_tpu_torch.infer import _global_rows_ok

    out = []
    for shape in frames:
        for forest in FORESTS:
            mask = load_mask(paths[forest])
            out += [(shape, forest, case) for case in sharded_cases()
                    if case[0] != "global-compact"
                    or _global_rows_ok(mask, shape, case[1])]
    return out


def md4_prefetch(c, oracle, jobs):
    """The oracle's support sets of ``jobs`` ((left, right, forest file,
    settings)), several oracle processes at once."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max(1, (os.cpu_count() or 4) // c.n)) as pool:
        list(pool.map(lambda job: oracle_set(oracle, *job), jobs))


def md4_builders(c, oracle):
    """Every multi-device builder over the n ranks, NCCL on the cards
    (gloo on the CPU), each whole result (``run_whole``: the rank's
    block, its module, the all-gather) equal bit for bit to the
    single-device module of its contract on the rank's own card:

    * the six batched contracts and the batched pyramid (3 levels) on
      dense and sparse batches of B pairs, B/n a rank, and the flat one
      with a 32-test random forest (the code kernel's path);
    * the row-sharded pyramid (3 levels) on frame 0 of each pyramid batch;
    * the 2-D frame (three contracts) and pyramid on every grid of n
      ranks;
    * the row-sharded frame, every contract, at h x w and the big shape.

    Both forests.  The pyramids compare as support sets with exact counts,
    the global sharded frame as a support set (its segments follow the
    bucket order), a compacted result by its flags (one a rank or frame
    group, set as the single-device module's) and its buffers where they
    are clear.  Every unflagged frame of the single-device modules passes
    the oracle gate (``pyramid_gate`` a level): rank r gates the frames j
    with j % n == r and every n-th sharded-frame case.  Each path runs
    with the launch counters at 0 and must launch exactly: ``fused_keys``
    1 a rank's block on the folding contracts, 1 a pair on the flat and
    global ones, 1 a level on the batched pyramid; ``fused_codes`` 1 a
    pair on the flat one past 30 tests; ``fused_keys_slab`` 1 on the
    row-sharded frame and the 2-D frame, 1 a level on the pyramids."""
    from opengpc_tpu_torch import (InferenceSettings, build_sparsematch,
                                   build_sparsematch_global_compact,
                                   build_sparsematch_global_rows,
                                   build_sparsematch_masked,
                                   build_sparsematch_masked_compact,
                                   build_sparsematch_rows)
    from opengpc_tpu_torch import parallel as par
    from opengpc_tpu_torch.pyramid import (build_pyramid_sparsematch,
                                           pyramid_supports_to_numpy)

    from opengpc_tpu_torch import make_filter_mask, save_forest

    sz, dev, n, rank = c.sz, c.dev, c.n, c.rank
    b, h, ph, per = sz.b, sz.h, sz.ph, sz.b // c.n
    paths = {f: os.path.join(REPO, "forests", f + ".txt") for f in FORESTS}
    # the flat contract past 30 tests (the code kernel), as a file for the
    # oracle
    forest32 = md4_forest32()
    fd, paths["random32"] = tempfile.mkstemp(suffix=".txt")
    os.close(fd)
    save_forest(forest32, paths["random32"])
    epi, lib = InferenceSettings(**SETTINGS_KW), InferenceSettings()
    flat = dataclasses.replace(epi, capacity=h * sz.w)
    contracts = {  # contract: (single-device builder, batched, settings)
        "flat": (build_sparsematch, par.build_batched_sparsematch, flat),
        "rows": (build_sparsematch_rows, par.build_batched_sparsematch_rows,
                 epi),
        "masked": (build_sparsematch_masked,
                   par.build_batched_sparsematch_masked, epi),
        "masked-compact": (build_sparsematch_masked_compact,
                           par.build_batched_sparsematch_masked_compact, epi),
        "global-rows": (build_sparsematch_global_rows,
                        par.build_batched_sparsematch_global_rows, lib),
        "global-compact": (build_sparsematch_global_compact,
                           par.build_batched_sparsematch_global_compact, lib)}
    single_frame = {k: contracts[k][0] for k in (
        "masked", "rows", "masked-compact", "global-compact")}
    folds = ("rows", "masked", "masked-compact")
    t0 = time.perf_counter()
    host = {hh: md_batches(hh, sz.b, sz.w) for hh in (h, ph)}
    frames = md4_frames(sz)
    mine = [j for j in range(b) if j % n == rank]
    cases = md4_frame_cases(frames, paths)
    jobs = []
    for scene in ("dense", "sparse"):
        for j in mine:
            jobs.append((*(a[j] for a in host[h][scene]), paths["random32"],
                         epi))
    for forest in FORESTS:
        for scene in ("dense", "sparse"):
            for j in mine:
                left, right = (a[j] for a in host[h][scene])
                jobs += [(left, right, paths[forest], epi),
                         (left, right, paths[forest], lib)]
                left, right = (a[j] for a in host[ph][scene])
                for _ in range(MD_LEVELS):
                    jobs.append((left, right, paths[forest], epi))
                    left, right = np_downscale2(left), np_downscale2(right)
    for i, (shape, forest, (_, settings, scene, _)) in enumerate(cases):
        if i % n == rank:
            jobs.append((*frames[shape][scene], paths[forest], settings))
    md4_prefetch(c, oracle, jobs)
    setup_s = time.perf_counter() - t0
    gpu = {hh: {s: tuple(torch.from_numpy(a).to(dev) for a in pair)
                for s, pair in batches.items()}
           for hh, batches in host.items()}
    refs, report, gated = {}, {}, 0
    world = c.world
    grids = {g: par.make_mesh_2d(*g) for g in md4_grids(n)}

    def reference(forest, scene, contract, mask):
        """The single-device module's result on the whole batch, and the
        oracle gate of this rank's unflagged frames."""
        nonlocal gated
        key = (forest, scene, contract)
        if key in refs:
            return refs[key]
        ok = True
        if contract == "pyramid":
            out = build_pyramid_sparsematch(mask, epi, MD_LEVELS,
                                            device=dev)(*gpu[ph][scene])
            sets = [pyramid_keys(*(t[j] for t in out[:4])) for j in range(b)]
            for j in mine:
                sup = pyramid_supports_to_numpy(*(t[j] for t in out))
                good, _ = pyramid_gate(oracle, *(a[j] for a in
                                                 host[ph][scene]),
                                       paths[forest], sup, epi, MD_LEVELS)
                ok, gated = ok and good and len(sup) > 0, gated + 1
            refs[key] = (out, ok, sets)
            return refs[key]
        build, _, settings = contracts[contract]
        out = build(mask, settings, device=dev)(*gpu[h][scene])
        flags = [False] * b
        if contract == "masked-compact":
            flags = [bool(out[2])] * b
        elif contract == "global-compact":
            flags = out[2].tolist()
        for j in mine:
            if flags[j]:
                continue
            sup = md_decode(contract, out, j, settings)
            good, _ = oracle_gate(oracle, *(a[j] for a in host[h][scene]),
                                  paths[forest], sup, settings)
            ok, gated = ok and good and len(sup) > 0, gated + 1
        refs[key] = (out, ok, None)
        return refs[key]

    def check(key, out, same, ok):
        c.keep(key, out)
        report[key] = bool(same and ok)
        if not (same and ok):
            c.failures.append(f"rank {rank} {key}: equals single device "
                              f"{bool(same)}, oracle gate {bool(ok)}")

    def equal(a, b_):
        return all(torch.equal(x, y)
                   for x, y in zip(_leaves(a), _leaves(b_), strict=True))

    def compact_equal(out, want, groups):
        return (tuple(out[2].shape) == (groups,)
                and bool(out[2].any()) == bool(want[2])
                and (bool(want[2]) or equal(out[:2], want[:2])))

    def pyramid_equal(out, sets, counts, idx):
        return all(torch.equal(out[4][i], counts[j]) and torch.equal(
            pyramid_keys(*(t[i] for t in out[:4])), sets[j])
            for i, j in idx)

    mask32 = make_filter_mask(forest32)
    for scene in ("dense", "sparse"):
        want, ok, _ = reference("random32", scene, "flat", mask32)
        key = f"batched/flat/random32/{scene}"
        mod = par.build_batched_sparsematch(mask32, flat, world, device=dev)
        out = c.run(key, lambda: mod.run_whole(*gpu[h][scene]),
                    {"fused_codes": per})
        check(key, out, equal(out, want), ok)
    os.remove(paths["random32"])
    for forest in FORESTS:
        mask = load_mask(paths[forest])
        for scene in ("dense", "sparse"):
            lb, rb = gpu[h][scene]
            pl, pr = gpu[ph][scene]
            for contract, (_, build, s) in contracts.items():
                want, ok, _ = reference(forest, scene, contract, mask)
                key = f"batched/{contract}/{forest}/{scene}"
                mod = build(mask, s, world, device=dev)
                out = c.run(key, lambda: mod.run_whole(lb, rb),
                            {"fused_keys": 1 if contract in folds else per})
                check(key, out, compact_equal(out, want, n)
                      if contract == "masked-compact" else equal(out, want),
                      ok)
            wantp, okp, sets = reference(forest, scene, "pyramid", mask)
            key = f"batched/pyramid/{forest}/{scene}"
            mod = par.build_batched_pyramid(mask, epi, world, MD_LEVELS,
                                            device=dev)
            out = c.run(key, lambda: mod.run_whole(pl, pr),
                        {"fused_keys": MD_LEVELS})
            check(key, out, equal(out, wantp), okp)
            key = f"sharded_pyramid/{forest}/{scene}"
            mod = par.build_sharded_frame_pyramid(mask, epi, world,
                                                  MD_LEVELS, device=dev)
            out = c.run(key, lambda: mod.run_whole(pl[0], pr[0]),
                        {"fused_keys_slab": MD_LEVELS})
            check(key, out, pyramid_equal(tuple(t[None] for t in out), sets,
                                          wantp[4], [(0, 0)]), okp)
            for (nd, nr), grid in grids.items():
                tag = f"{nd}x{nr}"
                for contract in folds:
                    want, ok, _ = refs[(forest, scene, contract)]
                    key = f"2d/{contract}/{tag}/{forest}/{scene}"
                    mod = par.build_batched_sharded_frame_sparsematch(
                        mask, epi, grid, contract, device=dev)
                    out = c.run(key, lambda: mod.run_whole(lb, rb),
                                {"fused_keys_slab": 1})
                    check(key, out, compact_equal(out, want, nd)
                          if contract == "masked-compact"
                          else equal(out, want), ok)
                key = f"2d/pyramid/{tag}/{forest}/{scene}"
                mod = par.build_batched_sharded_frame_pyramid(
                    mask, epi, grid, MD_LEVELS, device=dev)
                out = c.run(key, lambda: mod.run_whole(pl, pr),
                            {"fused_keys_slab": MD_LEVELS})
                check(key, out, pyramid_equal(out, sets, wantp[4], [
                    (j, j) for j in range(b)]), okp)

    flags = {}
    for i, (shape, forest, (contract, settings, scene, flag)) in enumerate(
            cases):
        mask = load_mask(paths[forest])
        left, right = (torch.from_numpy(a).to(dev)
                       for a in frames[shape][scene])
        key = f"frame/{shape[0]}x{shape[1]}/{contract}/{forest}/{scene}"
        mod = par.build_sharded_frame_sparsematch(mask, settings, world,
                                                  contract, device=dev)
        out = c.run(key, lambda: mod.run_whole(left, right),
                    {"fused_keys_slab": 1})
        want = single_frame[contract](mask, settings, device=dev)(left,
                                                                  right)
        if flag is not None:
            # the flags agree; at the one-card phases' 436x1024 they are
            # also the ones ``sharded_cases`` names
            flags[key] = [bool(out[-1]), bool(want[-1])]
            if flags[key][0] != flags[key][1] or (
                    shape == (H, W) and flags[key][0] != flag):
                c.failures.append(f"rank {rank} {key}: overflow (sharded, "
                                  f"single device) {flags[key]}, want "
                                  f"{flag}")
                continue
            if flags[key][0]:
                check(key, out, True, True)
                continue
        sup = _decode(contract, out, settings)
        if contract == "global-compact":
            same = np.array_equal(support_keys(sup), support_keys(
                _decode(contract, want, settings)))
        else:
            same = equal(out, want)
        ok = True
        if i % n == rank:
            ok, _ = oracle_gate(oracle, *frames[shape][scene],
                                paths[forest], sup, settings)
            gated += 1
        check(key, out, same and len(sup) > 0, ok)
    if c.save and rank == 0:
        for shape, scenes in frames.items():
            for scene, pair in scenes.items():
                for side, a in zip("lr", pair):
                    c.saved[f"input/frame/{shape[0]}x{shape[1]}/{scene}/"
                            f"{side}"] = a
        for hh, batches in host.items():
            for scene, pair in batches.items():
                for side, a in zip("lr", pair):
                    c.saved[f"input/batch/{hh}/{scene}/{side}"] = a
    c.finish("md4_builders", paths=len(report), setup_s=setup_s,
             paths_s=time.perf_counter() - t0 - setup_s,
             oracle_runs=len(jobs), gated_frames=gated, flags=flags,
             passed=sum(report.values()),
             launches={k: v for k, v in c.totals.items() if v})


def md4_step(c):
    """``entry_torch.dryrun_multichip(n)`` on the n ranks: every builder at
    tiny shapes against its single-device module (the counterpart of the
    JAX package's ``MULTICHIP_r0*.json`` runs)."""
    import entry_torch

    t0 = time.perf_counter()
    entry_torch.dryrun_multichip(c.n, device=c.dev)
    c.sync()
    c.finish("md4_step", seconds=time.perf_counter() - t0)


def md4_train(c):
    """The sharded trainer over the n ranks (``train_forest(group=)``,
    each level's counts one ``all_reduce``) at ``phase_train``'s
    triplets and forest settings, zero optimizer: its forest text equals
    the one-card trainer's on the rank's own card, each with its wall s
    (on the cards taken after the CLI launches end)."""
    from opengpc_tpu_torch import (fern_factory, serialize_forest,
                                   train_forest, zero_optimizer)
    from opengpc_tpu_torch.mine import (extract_triplets_device,
                                        mine_stereo_pair)
    from opengpc_tpu_torch.utils import make_scene

    sz, rng = c.sz, np.random.default_rng(1)
    t0 = time.perf_counter()
    chunks = []
    for _ in range(sz.train_pairs):
        left, right, gt, occ = make_scene(rng, sz.h, sz.w)
        keys = mine_stereo_pair(gt, occ, np.zeros((sz.h, sz.w), np.uint8),
                                sz.keypoints, *RADII, rng)
        chunks.append(extract_triplets_device(left, right, *keys,
                                              device=c.dev))
    trips = np.concatenate(chunks)
    del chunks
    build_s = time.perf_counter() - t0
    walls, texts = {}, {}
    for name, group in (("one_card", None), ("ranks", c.world)):
        t0 = time.perf_counter()
        texts[name] = serialize_forest(train_forest(
            trips, fern_factory(2, 2, 2, 5), zero_optimizer(), seed=0,
            verbose=False, device=c.dev, group=group))
        c.sync()
        walls[name] = time.perf_counter() - t0
    if texts["ranks"] != texts["one_card"]:
        c.failures.append(f"rank {c.rank}: the sharded trainer's forest "
                          "differs from the one-card forest")
    c.finish("md4_train", triplets=len(trips), dataset_build_s=build_s,
             wall_s=walls["ranks"], one_card_wall_s=walls["one_card"],
             equals_one_card=texts["ranks"] == texts["one_card"])


def md4_times(c):
    """Times on the cards, every rank timing at once (rank 0's numbers and
    every rank's in the line): CUDA events ms a call over ``MD4_ITERS``
    calls and the profiler's device ms a call of the n-way sharded frame
    (masked and global, ``forward`` on the rank's rows and ``run_whole``)
    against the single-device masked module on the whole frame, at h x w
    and the big shape; each collective alone on the real buffers (the
    halo ``all_to_all_single``, the global bucket ``all_to_all_single``,
    the flag ``all_reduce`` and one ``all_gather_outputs`` of the masked
    frame), with its bytes and GB/s; pairs/s of the batched masked module
    at B over the n cards against B/n pairs on one; and the three kernels
    of the path against their plain versions at a call of the path
    (``md4_kernel_times``), with their bounds.  Every window has the same calls on every rank, so the
    collectives stay matched."""
    import torch.distributed._functional_collectives as funcol

    from opengpc_tpu_torch import InferenceSettings, build_sparsematch_masked
    from opengpc_tpu_torch import parallel as par
    from opengpc_tpu_torch.infer import _global_rows_ok
    from opengpc_tpu_torch.ops.fused import PAD
    from opengpc_tpu_torch.parallel.frame import _global_send, _slab_keys
    from opengpc_tpu_torch.parallel.groups import (any_rank, done,
                                                   exchange_halos)
    from opengpc_tpu_torch.utils import make_pair

    sz, n, rank, world = c.sz, c.n, c.rank, c.world
    epi, lib = InferenceSettings(**SETTINGS_KW), InferenceSettings()
    zero = load_mask(os.path.join(REPO, "forests", "defaultZeroForest.txt"))

    def timed(fn, iters=MD4_ITERS):
        """Events ms a call, and the profiler's device ms a call split into
        compute and the NCCL kernels (which wait for the slowest rank)."""
        prof = device_profile(fn, max(5, iters // 5), tries=1)
        return dict(events_ms=cuda_ms(fn, iters),
                    device_ms=prof["device_ms"],
                    collective_ms=prof["collective_ms"],
                    compute_ms=prof["device_ms"] - prof["collective_ms"],
                    whole=prof["whole"], top=prof["kernels"][:6])

    def rate(nbytes, ms):
        gbs = nbytes / (ms * 1e-3) / 1e9
        return dict(bytes=nbytes, us=ms * 1e3, gb_per_s=gbs,
                    nvlink_share=gbs * 1e9 / NVLINK_BYTES_PER_S)

    out = {}
    for fh, fw in ((sz.h, sz.w), tuple(sz.big)):
        tag = f"{fh}x{fw}"
        left, right = (torch.from_numpy(a).to(c.dev)
                       for a in make_pair(fh, fw, TRUE_DISP, seed=640))
        single = build_sparsematch_masked(zero, epi, device=c.dev)
        masked = par.build_sharded_frame_sparsematch(zero, epi, world,
                                                     "masked", device=c.dev)
        ls, rs = masked.shard(left, right)
        modules = {
            "single_device_masked": lambda: single(left, right),
            "sharded_masked_forward": lambda: masked(ls, rs),
            "sharded_masked_run_whole": lambda: masked.run_whole(left,
                                                                 right)}
        # the global contract where its (y, x) key fits 30 bits
        glob = None
        if _global_rows_ok(zero, (fh, fw), lib):
            glob = par.build_sharded_frame_sparsematch(
                zero, lib, world, "global-compact", device=c.dev)
            modules["sharded_global_forward"] = lambda: glob(ls, rs)
        row = {name: timed(fn) for name, fn in modules.items()}
        sh = fh // n
        both = torch.stack([ls, rs])
        flag = torch.zeros((), dtype=torch.bool, device=c.dev)
        res = masked(ls, rs)
        nbrs = (rank > 0) + (rank < n - 1)
        per_nb = PAD * fw * 2
        gathered = sum(t.numel() * t.element_size() for t in _leaves(res))
        coll = {
            "halo_all_to_all": (lambda: exchange_halos(both, world, rank, n),
                                nbrs * per_nb),
            "flag_all_reduce": (lambda: any_rank(flag, world), 4),
            "all_gather_outputs": (lambda: par.all_gather_outputs(res, world),
                                   n * gathered)}
        if glob is not None:
            key = _slab_keys(glob, both, *exchange_halos(both, world, rank, n),
                             rank * sh, fh)
            send, _ = _global_send(glob, key, rank, n, fh)
            coll["bucket_all_to_all"] = (lambda: done(
                funcol.all_to_all_single(send, None, None, world)),
                send.numel() * 4)
        row["collectives"] = {}
        for name, (fn, nbytes) in coll.items():
            t = timed(fn)
            row["collectives"][name] = dict(rate(nbytes, t["events_ms"]),
                                            **t)
        row["collectives"]["halo_all_to_all"]["bytes_a_neighbour"] = per_nb
        if glob is not None:
            row["collectives"]["bucket_all_to_all"]["cap"] = send.shape[1]
        out[tag] = row
    lefts, rights = (torch.from_numpy(a).to(c.dev)
                     for a in md_batches(sz.h, sz.b, sz.w)["dense"])
    batched = par.build_batched_sparsematch_masked(zero, epi, world,
                                                   device=c.dev)
    lb, rb = batched.shard(lefts, rights)
    single = build_sparsematch_masked(zero, epi, device=c.dev)
    pairs = {"batched_run_whole": (lambda: batched.run_whole(lefts, rights),
                                   sz.b),
             "batched_forward": (lambda: batched(lb, rb), sz.b),
             "one_card": (lambda: single(lb, rb), sz.b // n)}
    out["pairs_per_s"] = {}
    for name, (fn, count) in pairs.items():
        t = timed(fn)
        out["pairs_per_s"][name] = dict(t, pairs=count,
                                        pairs_per_s=count / t["events_ms"]
                                        * 1e3)
    out["kernels"] = md4_kernel_times(c)
    c.finish("md4_times", **out)
    return out


def md4_kernel_times(c):
    """Each kernel of the path against its plain version on this rank's
    card (``kernel_vs_plain_times``), at the path's own call with the
    largest output (``md4_kernels`` kept it), with its bound."""
    from opengpc_tpu_torch.ops import library

    out = {}
    for name, (op, args, res) in c.timed_calls.items():
        times = kernel_vs_plain_times(lambda: getattr(library, op)(*args),
                                      lambda: md4_plain(op, args), 100, 10)
        out[name] = dict(with_bound(times, *md4_work(op, args, res)), op=op,
                         shape=list(args[0].shape), tests=md4_tests(args))
    return out


def rank_worker(argv):
    """One rank of the four-card run, started by ``main_gpus`` as
    ``torchrun --nproc-per-node N chip_smoke.py --rank-worker ...``: the
    ``md4_*`` phases on ``cuda:LOCAL_RANK`` over NCCL, or with ``--device
    cpu`` over gloo at the CPU rehearsal's shapes (``--small``), where
    there is nothing to time.  ``--wait FILE`` holds the trainer and the
    timing phase until FILE exists; ``--save FILE`` writes rank 0's kept
    results."""
    import argparse

    import torch.distributed as dist

    from opengpc_tpu_torch.parallel import init_distributed

    p = argparse.ArgumentParser(prog="chip_smoke.py --rank-worker")
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true")
    p.add_argument("--wait", default=None)
    p.add_argument("--save", default=None)
    args = p.parse_args(argv)
    cpu = args.device == "cpu"
    if cpu:
        torch.set_num_threads(1)
    init_distributed("gloo" if cpu else "nccl")
    device = (torch.device("cpu") if cpu else
              torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))))
    c = Md4(device, MD4_SMALL if args.small else Md4Sizes(), args.save)
    oracle = os.path.join(REPO, "cpp", "build", "oracle")
    if not os.path.exists(oracle):
        raise SystemExit(f"no oracle at {oracle}: make -C cpp build/oracle")
    try:
        md4_builders(c, oracle)
        errs = md4_kernels(c)
        md4_step(c)
        if not cpu:
            t0 = time.perf_counter()
            while args.wait and not os.path.exists(args.wait):
                if time.perf_counter() - t0 > MD4_WORKER_TIMEOUT:
                    raise SystemExit(f"{args.wait} never came")
                time.sleep(0.2)
        md4_train(c)
        if not cpu:
            times = md4_times(c)
            totals = [None] * c.n
            dist.all_gather_object(totals, c.totals)
            if c.rank == 0:
                emit("md4_kernel_line", launches={
                    k: sum(t[k] for t in totals) for k in KERNELS},
                    max_abs_err=errs, times=times["kernels"])
        if args.save and c.rank == 0:
            np.savez(args.save, **c.saved)
    finally:
        rank = dist.get_rank()
        dist.destroy_process_group()
        if rank == 0:
            emit("md4_worker_exit")


def md4_worker_line(lines, phase):
    """The worker's JSON line of ``phase``."""
    for ln in lines:
        if ln.startswith('{"phase": "' + phase + '"'):
            return json.loads(ln)
    raise SystemExit(f"the rank worker printed no {phase} line")


def start_rank_worker(n, wait, td):
    """The rank worker as one ``torchrun --standalone --nproc-per-node n``
    launch in a session of its own, its output copied to this process's
    stdout as it comes, NCCL's log to ``td/nccl.<pid>.log``: (process, its
    lines, the copying thread)."""
    import threading

    env = dict(os.environ, NCCL_DEBUG="INFO",
               NCCL_DEBUG_FILE=os.path.join(td, "nccl.%p.log"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), os.path.join(REPO, "chip_smoke.py"),
         "--rank-worker", "--wait", wait], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    lines = []

    def copy():
        for ln in proc.stdout:
            lines.append(ln.rstrip("\n"))
            # the parent's in-process CLI runs swap sys.stdout meanwhile
            sys.__stdout__.write(ln)
            sys.__stdout__.flush()

    thread = threading.Thread(target=copy, daemon=True)
    thread.start()
    return proc, lines, thread


def md4_inputs(td):
    """The CLI launches' inputs: the dense 436x1024 pair and a 448x1024
    pair as PNGs, ``cli_sequence``'s 32 pairs in two directories and a
    triplet file of four ``make_scene`` pairs (host extraction)."""
    from opengpc_tpu_torch.io import write_png
    from opengpc_tpu_torch.io.triplets import save_triplets
    from opengpc_tpu_torch.mine import extract_triplets, mine_stereo_pair
    from opengpc_tpu_torch.utils import make_pair, make_scene

    dense = write_pair_pngs(td, "dense", *make_pair(H, W, TRUE_DISP))
    tall = write_pair_pngs(td, "tall", *make_pair(MD_PH, W, TRUE_DISP,
                                                  seed=3))
    seq = [os.path.join(td, "seq_l"), os.path.join(td, "seq_r")]
    for d in seq:
        os.makedirs(d)
    for i, pair in enumerate(seq_frames()[0]):
        for d, img in zip(seq, pair):
            write_png(os.path.join(d, f"f{i:04d}.png"), img)
    rng, chunks = np.random.default_rng(5), []
    for _ in range(4):
        left, right, gt, occ = make_scene(rng, H, W)
        keys = mine_stereo_pair(gt, occ, np.zeros((H, W), np.uint8),
                                KEYPOINTS, *RADII, rng)
        chunks.append(extract_triplets(left, right, *keys))
    trips = os.path.join(td, "triplets.bin")
    save_triplets(np.concatenate(chunks), trips)
    return dense, tall, seq, trips


def md4_cli_cases(inputs, n):
    """(name, module, argv with OUT for its output directory) of the CLI
    launches over n ranks; the one-card reference of each is the same
    argv without --data-parallel / --shard-frame."""
    dense, tall, seq, trips = inputs
    forest = os.path.join(REPO, "forests", "defaultZeroForest.txt")
    single = ["--capacity", CLI_CAPACITY, "--out", "OUT/d.png",
              "--supports-out", "OUT/s.txt"]
    d = 2 if n % 2 == 0 else 1  # the 2-D grid's frame groups
    return [
        (f"single_shard{n}", CLI, [forest, *dense, "--shard-frame", str(n),
                                   "--densify", "OUT/dense.png", *single]),
        (f"single_shard{n}_pyramid3", CLI, [
            forest, *tall, "--shard-frame", str(n), "--pyramid", "3",
            *single]),
        (f"sequence_data{n}_batch4", CLI, [
            forest, *seq, "--data-parallel", str(n), "--batch", "4", "--out",
            "OUT/d.png"]),
        (f"sequence_data{d}_shard{n // d}", CLI, [
            forest, *seq, "--data-parallel", str(d), "--shard-frame",
            str(n // d), "--batch", "4", "--out", "OUT/d.png"]),
        (f"train_data{n}", "opengpc_tpu_torch.cli.train",
         [trips, "OUT/fresh.txt", "--seed", "4", "--data-parallel", str(n)])]


def one_card_flags(argv):
    """``argv`` without --data-parallel / --shard-frame and their values."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a in ("--data-parallel", "--shard-frame"):
            skip = True
        else:
            out.append(a)
    return out


def same_files(got, want):
    """Two output directories hold the same files: byte for byte, a
    supports file's lines as a set (a sharded run writes them in
    per-rank blocks)."""
    a, b = dir_bytes(got), dir_bytes(want)
    if not a or sorted(a) != sorted(b):
        return False
    return all(sorted(a[k].splitlines()) == sorted(b[k].splitlines())
               if k.endswith(".txt") else a[k] == b[k] for k in a)


def md4_cli(td, inputs, oracle, n):
    """The CLIs as ``torchrun --nproc-per-node n`` launches on the cards,
    all started together (``md4_cli_cases``; at n = 4): ``sparsematch
    --shard-frame 4`` on one pair, plain (with ``--densify``) and with
    ``--pyramid 3``; sequence mode over ``cli_sequence``'s 32 pairs at
    ``--data-parallel 4 --batch 4`` and ``--data-parallel 2 --shard-frame
    2 --batch 4``; ``cli.train --data-parallel 4``; ``cli.aot export
    --shard-frame 4`` and then ``run`` of its artifact.  Meanwhile the one-card reference of each
    runs in this process on card 0.  Every launch must exit 0, and every
    file equal the one-card run's (``same_files``); the artifact's
    supports equal the one-card CLI's on the pair as a set and pass the
    oracle gate."""
    from concurrent.futures import ThreadPoolExecutor

    from opengpc_tpu_torch import InferenceSettings
    from opengpc_tpu_torch.cli.train import main as train_main
    from opengpc_tpu_torch.io.png import read_gray

    forest = os.path.join(REPO, "forests", "defaultZeroForest.txt")
    dense = inputs[0]
    art_dir = os.path.join(td, "md4_aot")
    os.makedirs(art_dir)
    art = os.path.join(art_dir, "m.ogpcx")
    pool = ThreadPoolExecutor(max_workers=8)
    t0 = time.perf_counter()
    launched = {}
    for name, module, argv in md4_cli_cases(inputs, n):
        out_dir = os.path.join(td, f"md4_{name}")
        os.makedirs(out_dir)
        launched[name] = (module, argv, out_dir, torchrun(
            pool, module, [a.replace("OUT", out_dir) for a in argv], REPO,
            nproc=n))
    export = torchrun(pool, AOT_CLI, ["export", forest, art, "--height",
                                      str(H), "--width", str(W),
                                      "--shard-frame", str(n)], REPO,
                     nproc=n)
    torch.cuda.set_device(0)
    refs, ref_s = {}, {}
    for name, (module, argv, _, _) in launched.items():
        flags = one_card_flags(argv)
        key = tuple(flags)
        if key in refs:
            launched[name] += (refs[key],)
            continue
        ref_dir = os.path.join(td, f"md4_ref_{name}")
        os.makedirs(ref_dir)
        flags = [a.replace("OUT", ref_dir) for a in flags]
        t1 = time.perf_counter()
        if module == CLI:
            rc, _, err = run_cli(flags)
        else:
            with contextlib.redirect_stdout(io.StringIO()):
                rc, err = train_main(flags), ""
        ref_s[name] = time.perf_counter() - t1
        if rc:
            raise SystemExit(f"one-card reference of {name} failed: {err}")
        refs[key] = ref_dir
        launched[name] += (ref_dir,)
    rc, out, err, wall = export.result()
    report, failures = {"aot_export": dict(rc=rc, wall_s=wall)}, []
    if rc:
        failures.append(f"aot export: rc {rc} {err[-2000:]}")
    else:
        sup_out = os.path.join(art_dir, "s.txt")
        rc, out, err, wall = torchrun(pool, AOT_CLI, [
            "run", art, *dense, "--supports-out", sup_out], REPO,
            nproc=n).result()
        ref = os.path.join(launched[f"single_shard{n}"][4], "s.txt")
        same = ok = False
        if rc == 0:
            got = np.loadtxt(sup_out, dtype=np.int64).reshape(-1, 3)
            same = np.array_equal(support_keys(got), support_keys(
                np.loadtxt(ref, dtype=np.int64).reshape(-1, 3)))
            ok, gate = oracle_gate(oracle, read_gray(dense[0]),
                                   read_gray(dense[1]), forest, got,
                                   InferenceSettings(**SETTINGS_KW))
        report["aot_run"] = dict(rc=rc, wall_s=wall, stdout=out[-300:],
                                 equals_one_card=same, oracle_gate=ok)
        if not (rc == 0 and same and ok):
            failures.append(f"aot run: {report['aot_run']} {err[-2000:]}")
    for name, (_, _, out_dir, fut, ref_dir) in launched.items():
        rc, out, err, wall = fut.result()
        same = rc == 0 and same_files(out_dir, ref_dir)
        report[name] = dict(rc=rc, wall_s=wall, equals_one_card=same,
                            files=len(dir_bytes(out_dir)),
                            stdout=out.splitlines()[-2:])
        if not same:
            failures.append(f"{name}: {report[name]} {err[-2000:]}")
    pool.shutdown()
    emit("md4_cli", ranks=n, seconds=time.perf_counter() - t0,
         one_card_s=ref_s, launches=report, failures=failures)
    return failures


def md4_nccl(td):
    """What NCCL's log says of the rank worker's links: the transports
    its channels took (``... via P2P/...``) and its version."""
    import glob

    via, version = set(), set()
    for path in glob.glob(os.path.join(td, "nccl.*.log")):
        with open(path, errors="replace") as f:
            for ln in f:
                if " via " in ln:
                    via.add(ln.split(" via ", 1)[1].strip())
                elif "NCCL version" in ln:
                    version.add(ln.split("NCCL version", 1)[1].strip())
    emit("md4_nccl", transports=sorted(via), version=sorted(version))


def main_gpus(n):
    """``chip_smoke.py --gpus n``: the multi-device surface on n cards of
    one host, one rank a card under torchrun, NCCL between them (see the
    ``md4_*`` phases).  Fails without n visible cards: it never runs fewer
    ranks, and never gloo."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < n:
        print(f"chip_smoke --gpus {n}: needs {n} CUDA devices, {count} "
              "visible", file=sys.stderr)
        sys.exit(2)
    import opengpc_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    # the links between the cards, as far as this host shows them: the
    # topology matrix and NVLink status (a container may refuse either;
    # its exit code is kept) and CUDA's peer access
    links = {}
    for name, cmd in (("topo", ["nvidia-smi", "topo", "-m"]),
                      ("nvlink", ["nvidia-smi", "nvlink", "--status"])):
        r = subprocess.run(cmd, capture_output=True, text=True)
        links[name] = dict(rc=r.returncode,
                           lines=(r.stdout + r.stderr).splitlines()[:40])
    print("\n".join(smi + links["topo"]["lines"]), flush=True)
    emit("md4_device", nvidia_smi=smi, links=links,
         peer_access=[[i == j or torch.cuda.can_device_access_peer(i, j)
                       for j in range(count)] for i in range(count)],
         torch=torch.__version__, cuda=torch.version.cuda, count=count,
         names=[torch.cuda.get_device_name(i) for i in range(count)])
    phase_build()
    oracle = build_oracle()
    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory() as td:
        inputs = md4_inputs(td)
        wait = os.path.join(td, "cli_done")
        t0 = time.perf_counter()
        proc, lines, thread = start_rank_worker(n, wait, td)
        try:
            try:
                failures = md4_cli(td, inputs, oracle, n)
            finally:
                open(wait, "w").close()
            rc = proc.wait(timeout=MD4_WORKER_TIMEOUT)
        except subprocess.TimeoutExpired:
            raise SystemExit(f"the rank worker ran past "
                             f"{MD4_WORKER_TIMEOUT} s and was killed")
        finally:
            if proc.poll() is None:
                import signal

                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        thread.join()
        # the worker's own lines count their seconds from its start
        emit("md4_worker", rc=rc, wall_s=time.perf_counter() - t0)
        md4_nccl(td)
    if rc:
        raise SystemExit(f"the rank worker failed: exit {rc}")
    if failures:
        raise SystemExit(f"md4_cli failed: {failures}")
    line = md4_worker_line(lines, "md4_kernel_line")
    for phase in ("md4_kernels", "md4_builders", "md4_step", "md4_train",
                  "md4_times"):
        md4_worker_line(lines, phase)
    missing = [k for k in MD4_KERNELS if not line["launches"][k]]
    if missing:
        raise SystemExit(f"no path launched {missing}")
    print("\n".join(smi), flush=True)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": KERNELS[name][1],
        "replaces": KERNELS[name][2], "launches": line["launches"][name],
        "max_abs_err": line["max_abs_err"][name],
        "ms": line["times"][name]["ms"],
        "plain_ms": line["times"][name]["plain_ms"],
        "bound_ms": line["times"][name]["bound_ms"],
        "bound_by": line["times"][name]["bound_by"], "library_ms": None,
        "ms_source": line["times"][name]["ms_source"]}
        for name in MD4_KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main(argv=None):
    import argparse

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank-worker"]:
        return rank_worker(argv[1:])
    p = argparse.ArgumentParser(description="The port's smoke run on the "
                                "card; with --gpus N its multi-device "
                                "surface on N cards of one host.")
    p.add_argument("--gpus", type=int, default=None, metavar="N",
                   help="run the multi-device phases on N cards (one rank "
                   "a card, NCCL); fails with fewer than N visible")
    args = p.parse_args(argv)
    if args.gpus is not None:
        return main_gpus(args.gpus)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs only on "
              "a GPU", file=sys.stderr)
        sys.exit(2)
    import opengpc_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = phase_device()
    phase_build()
    with tempfile.TemporaryDirectory() as td:
        paths = forest_paths(td)
        masks = kernel_masks(paths)
        images = row_sort_images(masks)
        errs = {"fused_keys": phase_kernel_vs_twin(),
                "fused_codes": phase_codes_vs_twin(masks),
                "bitonic_sort_rows": phase_sort_vs_twin(masks),
                "row_sort": phase_row_sort_vs_twin(masks, images),
                "fused_sparsematch_rows": phase_fused_match_vs_twin(masks),
                "fused_keys_slab": phase_slab_vs_twin(masks)}
        oracle = build_oracle()
        bench = start_bench()
        errs["fused_census"] = phase_census_vs_twin(oracle)
        phase_custom_ops(masks)
        launches = Launches()
        row_sort_launches = phase_main_path(oracle, launches)
        phase_routes(oracle, paths, launches)
        phase_variants(oracle, paths, masks, launches)
        phase_descriptors(paths, masks, launches)
        phase_entry(launches)
        for name, err in phase_fuzz(td, oracle, launches).items():
            errs[name] = max(errs[name], err)
        phase_bench(bench.result(), smi)
        # the timing phases early in the process: the profiler loses
        # kernel events late in a long one (``profiler_late`` shows it)
        times = {"fused_keys": phase_times(smi)}
        phase_key_times(smi, masks)
        times.update(phase_new_times(smi, masks, images))
        del images
        times.update(phase_slab_times(smi, masks))
        phase_pyramid_times(smi, masks)
        examples = start_examples(td)
        phase_sharded_frame(oracle, paths, launches)
        phase_census(launches)
        examples = {name: f.result() for name, f in examples.items()}
        phase_png_paths(td, paths, launches)
        phase_native_decode(smi, paths)
        phase_pyramid(oracle, paths, launches)
        phase_stereomatch(paths, launches)
        phase_aot(td, oracle, paths, launches, smi)
        phase_mine_device()
        train_ref = phase_train(smi, paths)
        phase_workflow(td, oracle, paths, launches)
        phase_examples(td, examples)
        phase_cli_single(td, oracle, paths, launches)
        phase_cli_sequence(td, launches)
        phase_densify(smi)
        phase_multi_device(td, oracle, paths, launches, train_ref, smi)
        phase_profiler_late(smi)
    totals = dict(launches.total, row_sort=row_sort_launches)
    missing = [k for k, n in totals.items() if n == 0]
    if missing:
        raise SystemExit(f"no path launched {missing}")
    sources = dict(KERNELS, row_sort=ROW_SORT)
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": sources[name][1],
        "replaces": sources[name][2], "launches": totals[name],
        "max_abs_err": errs[name], "ms": times[name]["ms"],
        "plain_ms": times[name]["plain_ms"],
        "bound_ms": times[name]["bound_ms"],
        "bound_by": times[name]["bound_by"],
        "library_ms": times[name]["library_ms"],
        "ms_source": times[name]["ms_source"],
        "graph_ms": times[name]["graph_ms"]["ms"]} for name in sources]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
