"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the checkout, holds the fused key kernel
against its plain-PyTorch twin bit for bit, drives the one-call
``sparsematch`` (the masked epipolar main path) at 436x1024, checks its
supports against the true disparity, the CPU pipeline and the native
oracle (``cpp/build/oracle``), and times the kernel, the pipeline and the
host decode with CUDA events.  Every phase prints one JSON line; the last
line is ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; without a CUDA device the script exits non-zero before doing
anything.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

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


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


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


def cuda_ms(fn, iters):
    """Mean device ms per call of ``fn`` over ``iters`` calls (events)."""
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


def device_profile(fn, iters):
    """torch.profiler over ``iters`` calls of ``fn``: the window's host ms
    per call, device ms per call summed over kernels, the device busy
    share, and the kernels by device time (us per call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if e.device_type == DeviceType.CUDA and us > 0:
            kernels[e.key] = (us / iters, e.count / iters)
    device_ms = sum(us for us, _ in kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                busy_share=device_ms / wall_ms,
                kernels=[[k[:70], us, n] for k, (us, n) in top[:12]])


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
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=_build.build_info.get("seconds"), ptxas=ptxas)


def phase_kernel_vs_twin():
    """Kernel vs plain twin on the card, bit for bit; returns the largest
    absolute difference seen (0 when every case agrees)."""
    from opengpc_tpu_torch import (InferenceSettings, load_forest,
                                   make_filter_mask)
    from opengpc_tpu_torch.infer import _batched_key_images
    from opengpc_tpu_torch.match import SENTINEL_BASE, _pack_ok, _pos_bits
    from opengpc_tpu_torch.ops.fused import fused_keys, fused_keys_plain

    zero = load_forest(os.path.join(REPO, "forests", "defaultZeroForest.txt"))
    tau = load_forest(os.path.join(REPO, "forests", "defaultTauForest.txt"))
    masks = {"zero": make_filter_mask(zero), "tau": make_filter_mask(tau),
             "zero17": make_filter_mask(zero, max_tests=17)}
    for i, m in enumerate(random_masks()):
        masks[f"random{i}_{m.num_tests}t"] = m
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
    # the batched two-column launch equals per-image twins concatenated
    settings = InferenceSettings(**SETTINGS_KW)
    lefts = torch.from_numpy(np.stack(
        [structured_image(rng, H, W) for _ in range(4)])).cuda()
    rights = torch.from_numpy(np.stack(
        [structured_image(rng, H, W) for _ in range(4)])).cuda()
    for mask in masks.values():
        got = _batched_key_images(lefts, rights, mask, settings)
        want = torch.cat([fused_keys_plain(lefts, mask, 5, 0, SENTINEL_BASE),
                          fused_keys_plain(rights, mask, 5, W, SENTINEL_BASE)],
                         dim=2)
        err = int((got.long() - want.long()).abs().max())
        worst = max(worst, err)
        cases += 1
        if err:
            failures.append(("batch4", H, W, err))
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


def oracle_gate(oracle, left, right, forest_file, supports, settings):
    """bench.py's gate: every support is in the oracle's set, and at least
    99.9% of the oracle's supports are reproduced."""
    from opengpc_tpu_torch.io import write_raw

    with tempfile.TemporaryDirectory() as td:
        lp, rp, op = (os.path.join(td, n) for n in ("l.raw", "r.raw", "o.txt"))
        write_raw(lp, left)
        write_raw(rp, right)
        subprocess.run(
            [oracle, "sparsematch", forest_file, lp, rp, op,
             str(settings.gradient_threshold),
             str(settings.vertical_tolerance), str(settings.disp_high),
             "1", "0"], check=True)
        with open(op) as f:
            want = {tuple(int(v) for v in ln.split()) for ln in f if ln.strip()}
    got = set(map(tuple, supports.tolist()))
    extra = len(got - want)
    ok = extra == 0 and len(got) >= 0.999 * len(want)
    return ok, {"supports": len(got), "oracle": len(want), "not_in_oracle": extra}


def accuracy(supports):
    """Share of supports at the true disparity (0 for an empty set)."""
    return float((supports[:, 2] == TRUE_DISP).mean()) if len(supports) else 0.0


def phase_main_path(oracle):
    """The one-call sparsematch on the card.  Resets the launch counter,
    drives every main-path call, reads the counter, then checks."""
    from opengpc_tpu_torch import (InferenceSettings, load_forest,
                                   make_filter_mask, sparsematch)
    from opengpc_tpu_torch.ops.fused import fused_keys
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

    fused_keys.launches = 0
    single, batched, per_pair, small17 = {}, {}, {}, {}
    for scene, (left, right) in scenes.items():
        for f in FORESTS:
            single[scene, f] = sparsematch(left, right, paths[f], settings,
                                           device="cuda")
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
    torch.cuda.synchronize()
    launches = fused_keys.launches

    failures, report = [], {}
    if launches == 0:
        failures.append("the main path launched no fused_keys kernel")
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
    emit("main_path", launches=launches, checks=report, failures=failures)
    if failures:
        raise SystemExit(f"main path failed: {failures}")
    return launches


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
    decode = []
    for _ in range(20):
        t0 = time.perf_counter()
        masked_supports_to_numpy(buf_h, rc_h, settings.disp_high)
        decode.append((time.perf_counter() - t0) * 1e3)
    one_call = []
    for _ in range(20):
        t0 = time.perf_counter()
        sparsematch(left, right, path, settings, device="cuda")
        one_call.append((time.perf_counter() - t0) * 1e3)
    prof_kernel = device_profile(kernel, 50)
    prof_plain = device_profile(plain, 10)
    prof_b1 = device_profile(lambda: mod(l_d, r_d), 50)
    prof_b4 = device_profile(lambda: mod(lb, rb), 20)
    emit("profile", card=smi, kernel_pair=prof_kernel, plain_pair=prof_plain,
         pipeline_b1=prof_b1, pipeline_b4=prof_b4)
    times = dict(card=smi, shape=[H, W], forest="defaultZeroForest",
                 kernel_pair_ms=[k1, k2], plain_pair_ms=[p1, p2],
                 kernel_ms_per_pair_b64=k64,
                 pipeline_ms_per_pair_b1=pipe1, pipeline_ms_per_pair_b4=pipe4,
                 d2h_ms=d2h, decode_ms_median=float(np.median(decode)),
                 one_call_ms_median=float(np.median(one_call)))
    emit("times", **times)
    # device time of the kernel (both images) and of the twin, per pair;
    # the events' times if the profiler saw no device activity
    if prof_kernel["device_ms"] > 0 and prof_plain["device_ms"] > 0:
        return prof_kernel["device_ms"], prof_plain["device_ms"]
    return (k1 + k2) / 2, (p1 + p2) / 2


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs only on "
              "a GPU", file=sys.stderr)
        sys.exit(2)
    import opengpc_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = phase_device()
    phase_build()
    max_err = phase_kernel_vs_twin()
    launches = phase_main_path(build_oracle())
    k_ms, p_ms = phase_times(smi)
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "fused_keys", "route": "cuda",
        "source": "opengpc_tpu_torch/csrc/fused_keys.cu",
        "replaces": "opengpc_tpu/ops/fused.py:203",
        "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
