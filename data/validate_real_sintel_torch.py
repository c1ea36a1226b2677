"""Turnkey validation battery for real MPI-Sintel data, through the
PyTorch port.

The port of data/validate_real_sintel.py: the same checks, the same check
lines and the same exit code, with every module taken from
``opengpc_tpu_torch`` and the matcher on ``--device`` (the card by
default).  Real Sintel is not in the repository; every mining and quality
number so far comes from synthetic Sintel-layout trees.  This script is the
first thing to run wherever the dataset exists:

    python data/validate_real_sintel_torch.py --flow-root  /data/MPI-Sintel \
                                              --stereo-root /data/Sintel-Stereo

(one or both roots; `training/` must sit under each root, the layouts of
SintelOpticalFlow.hpp:83-87 / SintelStereo.hpp:83-87).

Checks, per dataset:
  [hard] catalog walks, image/.flo/disparity decoding on a sample of
         real files (shape/finiteness/range), triplet mining yields data
  [hard] full-pipeline support set EQUAL to the native oracle
         (cpp/build/oracle) on a real pair — the parity contract on
         real data
  [soft] reported: match precision vs the real GT disparity (stereo),
         candidate density, triplet throughput, refmatch byte-diff when
         the reference binary is built

Exit code 0 iff every hard check passes.  Mining runs on the host; the
matcher runs on ``--device`` (``cuda``, the hand-written kernels, unless
``--device cpu`` is given).
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = os.path.join(REPO, "cpp", "build", "oracle")
REFMATCH = os.path.join(REPO, "cpp", "build", "refmatch")

_failures = []


def check(name, ok, detail="", hard=True):
    tag = "ok  " if ok else ("FAIL" if hard else "warn")
    print(f"[{tag}] {name}" + (f": {detail}" if detail else ""), flush=True)
    if not ok and hard:
        _failures.append(name)
    return ok


def _oracle_supports(forest_path, left, right, settings, epipolar):
    from opengpc_tpu_torch.io.raw import write_raw

    with tempfile.TemporaryDirectory() as tmp:
        lp, rp, out = (os.path.join(tmp, n)
                       for n in ("l.raw", "r.raw", "supp.txt"))
        write_raw(lp, left)
        write_raw(rp, right)
        subprocess.run(
            [ORACLE, "sparsematch", forest_path, lp, rp, out,
             str(settings.gradient_threshold),
             str(settings.vertical_tolerance), str(settings.disp_high),
             "1" if epipolar else "0", "0"], check=True)
        with open(out) as f:
            return set(tuple(int(v) for v in line.split())
                       for line in f if line.strip())


def validate_flow(root):
    from opengpc_tpu_torch.io.sintel import SintelFlow
    from opengpc_tpu_torch.mine import extract_flow_dataset

    print(f"\n== optical flow dataset: {root}")
    ds = SintelFlow(root)
    scenes = ds.scenes()
    if not check("flow catalog", len(scenes) > 0,
                 f"{len(scenes)} scenes"):
        return
    # decode a sample of real files across scenes
    n_flo = n_img = 0
    mags = []
    for scene in scenes[:5]:
        nf = ds.num_frames(scene)
        if not check(f"frames in {scene}", nf >= 2, f"{nf}"):
            continue
        for idx in (1, max(1, nf // 2)):
            u, v = ds.flow(scene, idx)
            img_s, img_t = ds.images(scene, idx)
            occ = ds.occlusion(scene, idx)
            inv = ds.invalid(scene, idx)
            check(f"flo dims {scene}/{idx}",
                  u.shape == img_s.shape == occ.shape == inv.shape,
                  f"{u.shape} vs {img_s.shape}")
            check(f"flo finite {scene}/{idx}",
                  bool(np.isfinite(u).all() and np.isfinite(v).all()))
            check(f"gray8 {scene}/{idx}",
                  img_s.dtype == np.uint8 and img_t.dtype == np.uint8,
                  str(img_s.dtype))
            check(f"occ/inv binary {scene}/{idx}",
                  set(np.unique(occ)) <= {0, 1, 255}
                  and set(np.unique(inv)) <= {0, 1, 255},
                  f"occ {sorted(set(np.unique(occ)))[:4]}", hard=False)
            mags.append(float(np.median(np.hypot(u, v))))
            n_flo += 1
            n_img += 2
    print(f"    decoded {n_flo} .flo + {n_img} frames; "
          f"median |flow| per frame: {np.round(mags, 2).tolist()}")
    t0 = time.perf_counter()
    trips = extract_flow_dataset(root, triplets_per_pair=200, num_scenes=2,
                                 seed=0, verbose=False)
    dt = time.perf_counter() - t0
    check("flow mining", len(trips) > 0,
          f"{len(trips)} triplets from 2 scenes in {dt:.1f}s "
          f"({len(trips)/max(dt,1e-9):.0f}/s)")


def validate_stereo(root, device):
    from opengpc_tpu_torch.config import InferenceSettings
    from opengpc_tpu_torch.forest import load_forest
    from opengpc_tpu_torch.infer import build_sparsematch_masked, \
        masked_supports_to_numpy
    from opengpc_tpu_torch.io.sintel import SintelStereo
    from opengpc_tpu_torch.metrics import support_precision
    from opengpc_tpu_torch.mine import extract_stereo_dataset

    print(f"\n== stereo dataset: {root}")
    ds = SintelStereo(root)
    scenes = ds.scenes()
    if not check("stereo catalog", len(scenes) > 0, f"{len(scenes)} scenes"):
        return
    scene = scenes[0]
    left, right = ds.images(scene, 1)
    disp = ds.disparity(scene, 1)
    occ = ds.occlusion(scene, 1)
    oof = ds.outofframe(scene, 1)
    check("stereo shapes",
          left.shape == right.shape == disp.shape == occ.shape == oof.shape,
          f"{left.shape}")
    check("disparity range plausible",
          bool((disp >= 0).all() and disp.max() < 1024),
          f"[{disp.min():.2f}, {disp.max():.2f}]")
    t0 = time.perf_counter()
    trips = extract_stereo_dataset(root, triplets_per_pair=200,
                                   num_scenes=2, seed=0, verbose=False)
    dt = time.perf_counter() - t0
    check("stereo mining", len(trips) > 0,
          f"{len(trips)} triplets from 2 scenes in {dt:.1f}s")

    # full pipeline on the real pair + ORACLE parity (the hard contract)
    forest_path = os.path.join(REPO, "forests", "defaultZeroForest.txt")
    forest = load_forest(forest_path)
    settings = InferenceSettings(gradient_threshold=5, vertical_tolerance=0,
                                 disp_high=128, epipolar_mode=True,
                                 capacity=1 << 19)
    lt, rt = (torch.from_numpy(a).to(device) for a in (left, right))
    buf, counts = build_sparsematch_masked(forest, settings,
                                           device=device)(lt, rt)
    supp = masked_supports_to_numpy(buf, counts, settings.disp_high)
    dens = len(supp) / left.size
    check("real-pair matching", len(supp) > 0,
          f"{len(supp)} supports ({dens:.1%} of pixels)")
    want = (_oracle_supports(forest_path, left, right, settings, True)
            if os.path.exists(ORACLE) else None)
    if want is not None:
        got = set(map(tuple, supp.tolist()))
        check("ORACLE parity on real pair", got == want,
              f"{len(got & want)}/{len(want)} common, "
              f"{len(got - want)} extra, {len(want - got)} missing")
    else:
        check("oracle built (make -C cpp)", False, ORACLE, hard=False)
    # quality vs the real GT — report-only (scene-dependent)
    # note the sign: our d = x_src - x_tar; Sintel left->right disparity
    # is positive leftward shift, so d == +disp at exact matches
    valid = (occ == 0) & (oof == 0)
    for tol in (0, 1, 3):
        prec, n = support_precision(supp, np.round(disp), valid=valid,
                                    tol=tol)
        print(f"    precision vs GT (tol {tol}): {prec:.4f} over {n} "
              "non-occluded supports")
    if os.path.exists(REFMATCH):
        # the unmodified reference code on the same real PNGs
        from opengpc_tpu_torch.io.sintel import _frame
        lp = _frame(ds.left_dir, scene, 1, "png")
        rp = _frame(ds.right_dir, scene, 1, "png")
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "ref.txt")
            subprocess.run([REFMATCH, forest_path, lp, rp, out, "5", "0",
                            "128", "1", "0"], check=True)
            with open(out) as f:
                ref = set(tuple(int(v) for v in line.split())
                          for line in f if line.strip())
        quirk = want if want is not None else set()
        print(f"    refmatch (real binary) on real PNGs: {len(ref)} "
              f"supports; clean-matcher overlap {len(ref & quirk)}")
    else:
        print("    (refmatch not built — `make -C cpp refmatch` for the "
              "real-binary differential)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--flow-root", default=None,
                   help="MPI-Sintel optical flow root (training/ beneath)")
    p.add_argument("--stereo-root", default=None,
                   help="Sintel stereo root (training/ beneath)")
    p.add_argument("--device", default="cuda",
                   help="where the matcher runs: cuda (the hand-written "
                   "kernels, default) or cpu")
    args = p.parse_args(argv)
    if not args.flow_root and not args.stereo_root:
        p.error("give --flow-root and/or --stereo-root")
    _failures.clear()
    if args.flow_root:
        validate_flow(args.flow_root)
    if args.stereo_root:
        validate_stereo(args.stereo_root, torch.device(args.device))
    print()
    if _failures:
        print(f"FAILED checks: {_failures}")
        return 1
    print("all hard checks passed — real Sintel data flows through the "
          "framework")
    return 0


if __name__ == "__main__":
    sys.exit(main())
