"""End-to-end demo with the PyTorch port: mine -> train -> match ->
visualize, no dataset needed.

The port of examples/demo.py.  It makes a small synthetic rectified stereo
"dataset" with known ground-truth disparity, mines patch triplets from it,
trains a fresh GPC forest, runs sparse matching with both the fresh forest
and the pretrained reference forest, then the row-form, masked, global and
3-level pyramid contracts, and writes disparity visualizations.  Every
device stage runs on ``--device`` (the card by default).

Run:  python examples/demo_torch.py [out_dir] [--height H] [--width W]
                                    [--triplets N] [--device cuda|cpu]
"""

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

# importable from any cwd, like examples/demo.py
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out_dir", nargs="?", default="demo_out")
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--triplets", type=int, default=3000,
                   help="triplets to mine from the scene")
    p.add_argument("--device", default="cuda",
                   help="where the device stages run: cuda (the "
                   "hand-written kernels, default) or cpu")
    args = p.parse_args(argv)

    from opengpc_tpu_torch import (InferenceSettings, build_sparsematch,
                                   build_sparsematch_global_rows,
                                   build_sparsematch_masked,
                                   build_sparsematch_rows, fern_factory,
                                   global_row_supports_to_numpy, load_forest,
                                   masked_supports_to_numpy,
                                   row_supports_to_numpy, save_forest,
                                   supports_to_numpy, train_forest,
                                   zero_optimizer)
    from opengpc_tpu_torch.io.png import write_png
    from opengpc_tpu_torch.metrics import support_precision
    from opengpc_tpu_torch.mine import (extract_triplets_device,
                                        mine_stereo_pair)
    from opengpc_tpu_torch.pyramid import (build_pyramid_sparsematch,
                                           pyramid_supports_to_numpy)
    from opengpc_tpu_torch.utils.scenes import make_scene
    from opengpc_tpu_torch.viz import disparity_visualization

    out_dir, h, w, device = args.out_dir, args.height, args.width, args.device
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    left, right, gt, occ = make_scene(rng, h, w)
    write_png(os.path.join(out_dir, "left.png"), left)
    write_png(os.path.join(out_dir, "right.png"), right)

    # --- mine triplets straight from the ground truth -------------------
    zeros = np.zeros((h, w), np.uint8)
    kl, kr, kn = mine_stereo_pair(gt, occ, zeros, args.triplets, 10, 25, rng)
    triplets = extract_triplets_device(left, right, kl, kr, kn, device=device)
    print(f"mined {len(triplets)} triplets")

    # --- train a fresh zero forest --------------------------------------
    t0 = time.perf_counter()
    forest = train_forest(triplets, fern_factory(2, 2, 2, 5),
                          zero_optimizer(), seed=1, verbose=False,
                          device=device)
    print(f"trained fresh forest in {time.perf_counter() - t0:.1f} s")
    save_forest(forest, os.path.join(out_dir, "fresh_forest.txt"))

    # --- match with the fresh forest and the pretrained one -------------
    settings = InferenceSettings(gradient_threshold=5, vertical_tolerance=0,
                                 disp_high=32, epipolar_mode=True,
                                 capacity=1 << 18)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pretrained = load_forest(os.path.join(repo, "forests",
                                          "defaultZeroForest.txt"))
    lt, rt = (torch.from_numpy(a).to(device) for a in (left, right))
    for name, f in (("fresh", forest), ("pretrained", pretrained)):
        match = build_sparsematch(f, settings, device=device)
        supp = supports_to_numpy(*match(lt, rt))
        prec, n = support_precision(supp, gt, valid=(occ == 0), tol=0)
        print(f"{name:>10}: {len(supp)} supports, "
              f"exact-disparity precision {prec:.3f} over {n}")
        vis = disparity_visualization(left, supp, max_disparity=32)
        write_png(os.path.join(out_dir, f"disparity_{name}.png"), vis)

    # --- the fast output contracts + multi-scale, same support semantics -
    (rxs, rds), rcounts = build_sparsematch_rows(
        pretrained, settings, device=device)(lt, rt)
    rows_supp = row_supports_to_numpy(rxs, rds, rcounts)
    print(f"  row-form: {len(rows_supp)} supports (per-row packed "
          "contract; identical set)")
    mbuf, mcounts = build_sparsematch_masked(pretrained, settings,
                                             device=device)(lt, rt)
    print(f"    masked: "
          f"{len(masked_supports_to_numpy(mbuf, mcounts, settings.disp_high))}"
          " supports (minimum-device-work contract; identical set)")
    gsettings = dataclasses.replace(settings, epipolar_mode=False)
    (gxs, gys, gds), gcounts = build_sparsematch_global_rows(
        pretrained, gsettings, device=device)(lt, rt)
    print(f"    global: "
          f"{len(global_row_supports_to_numpy(gxs, gys, gds, gcounts))} "
          "supports (segmented global contract)")
    prows = pyramid_supports_to_numpy(
        *build_pyramid_sparsematch(pretrained, settings, num_levels=3,
                                   device=device)(lt, rt))
    print(f"   pyramid: {len(prows)} supports over 3 levels "
          f"(per-level {np.bincount(prows[:, 3], minlength=3).tolist()})")
    print(f"outputs in {out_dir}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
