"""Minimal AOT serving loop with the PyTorch port: freeze the matcher
once, then serve a directory of frame pairs with no re-trace per frame.

The port of examples/serve.py: the forest, settings, frame shape and
output contract are burned into one ``torch.export`` artifact at export
time (``opengpc_tpu_torch.aot``); the serving side needs torch, the
port's ops and the artifact, not the forest file.

Usage:
    python examples/serve_torch.py <forest.txt> <left_dir> <right_dir>
                                   <out_dir> [--contract masked]
                                   [--disp-high 128] [--densify]
                                   [--reuse-artifact path.ogpcx]
                                   [--device cuda|cpu]

Demonstrates, end to end:
  1. `aot.export_sparsematch` + `save_artifact`: the one-time freeze.
  2. `aot.load_artifact` + `decode_outputs`: the generic server side
     (routes the device outputs by the artifact's own metadata).
  3. `densify.densify_from_masked`: a consumer on the device, chained onto
     the artifact's outputs with no host decode or upload.
"""
import argparse
import os
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("forest")
    p.add_argument("left_dir")
    p.add_argument("right_dir")
    p.add_argument("out_dir")
    p.add_argument("--contract", default="masked",
                   choices=("flat", "rows", "masked", "masked-compact"))
    p.add_argument("--disp-high", type=int, default=128)
    p.add_argument("--gradient-threshold", type=int, default=5)
    p.add_argument("--densify", action="store_true",
                   help="also write dense_<frame>.png via the masked-buffer "
                   "densifier on the device")
    p.add_argument("--reuse-artifact", default=None, metavar="PATH",
                   help="load this artifact instead of exporting (the "
                   "forest argument is ignored; shape must match)")
    p.add_argument("--device", default="cuda",
                   help="the device the exported program runs on: cuda "
                   "(the hand-written kernels, default) or cpu")
    args = p.parse_args(argv)

    from opengpc_tpu_torch import aot
    from opengpc_tpu_torch.config import InferenceSettings
    from opengpc_tpu_torch.forest import load_forest
    from opengpc_tpu_torch.io.png import read_gray, write_png
    from opengpc_tpu_torch.io.supports import write_supports

    lefts = sorted(f for f in os.listdir(args.left_dir)
                   if f.endswith(".png"))
    rights = sorted(f for f in os.listdir(args.right_dir)
                    if f.endswith(".png"))
    if not lefts or len(lefts) != len(rights):
        print(f"need equal non-empty frame lists, got {len(lefts)} left / "
              f"{len(rights)} right", file=sys.stderr)
        return 1
    os.makedirs(args.out_dir, exist_ok=True)

    probe = read_gray(os.path.join(args.left_dir, lefts[0]))
    settings = InferenceSettings(
        gradient_threshold=args.gradient_threshold,
        disp_high=args.disp_high, vertical_tolerance=0,
        epipolar_mode=True, capacity=262144)

    art = args.reuse_artifact or os.path.join(args.out_dir,
                                              "matcher.ogpcx")
    if args.reuse_artifact and not os.path.exists(art):
        # --reuse-artifact promises to serve an EXISTING artifact; a fresh
        # export here would serve another matcher than the one asked for
        print(f"--reuse-artifact {art}: no such file", file=sys.stderr)
        return 1
    if not args.reuse_artifact:
        t0 = time.perf_counter()
        blob = aot.export_sparsematch(load_forest(args.forest), settings,
                                      probe.shape, contract=args.contract,
                                      device=args.device)
        aot.save_artifact(art, blob, contract=args.contract,
                          settings=settings, shape=probe.shape,
                          device=args.device)
        print(f"exported {art} ({os.path.getsize(art)} B) "
              f"in {time.perf_counter() - t0:.1f} s")

    fn, meta = aot.load_artifact(art)
    if tuple(meta["shape"]) != probe.shape:
        print(f"artifact shape {meta['shape']} != frame {probe.shape}",
              file=sys.stderr)
        return 1

    masked = meta["contract"] in ("masked", "masked-compact")
    for i, (lf, rf) in enumerate(zip(lefts, rights)):
        left = read_gray(os.path.join(args.left_dir, lf))
        right = read_gray(os.path.join(args.right_dir, rf))
        t0 = time.perf_counter()
        out = fn(left, right)
        try:
            supports = aot.decode_outputs(meta, out)
        except OverflowError as e:
            # a masked-compact artifact and a dense frame: the artifact is
            # one frozen program, so skip the frame and keep serving
            print(f"[{i + 1}/{len(lefts)}] {lf}: SKIPPED — {e}",
                  file=sys.stderr)
            continue
        stem = os.path.splitext(lf)[0]
        write_supports(os.path.join(args.out_dir, f"{stem}.txt"),
                       supports[:, :3])
        line = (f"[{i + 1}/{len(lefts)}] {lf}: {len(supports)} supports "
                f"in {1e3 * (time.perf_counter() - t0):.1f} ms")
        if args.densify and masked:
            from opengpc_tpu_torch.densify import densify_from_masked
            from opengpc_tpu_torch.viz import dense_disparity_visualization

            dense, filled = densify_from_masked(
                out[0], out[1], meta["disp_high"], width=left.shape[1],
                device=out[0].device)
            write_png(os.path.join(args.out_dir, f"dense_{stem}.png"),
                      dense_disparity_visualization(
                          left, dense.cpu().numpy(), filled.cpu().numpy(),
                          max_disparity=meta["disp_high"]))
            line += " +dense"
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
