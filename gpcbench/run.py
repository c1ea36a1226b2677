"""Run one cell of the benchmark once and print its result line.

    python3 -m gpcbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The cell, its configuration and its
traffic mix come from ``BENCHMARK.json`` and the files under ``gpcbench/``
(``gpcbench.registry``).  The run loads, warms up, measures for
``--seconds`` and checks a sample of the window's outputs against the
plain reference.  Standard error gets the set-up split, then the compared
numbers beside their limits as its last lines; the last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, the compared numbers and their limits.

A cell on several cards starts its ranks itself (one process a card, with
``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR``/``MASTER_PORT``
on localhost set as ``torchrun`` would; NCCL) and prints rank 0's line.
Without a card, or with fewer than the cell needs, it (or, on several
cards, each rank) exits 2 and prints no result; it never runs on the CPU.  It exits 3 and prints no result when
JAX, Flax or the JAX package is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()
T0_WALL = time.time()

import os  # noqa: E402
import sys  # noqa: E402

# Python's bytecode of every module imported from here on (torch's and the
# port's included) is written to and read from a fixed folder of the
# checkout, even where the environment turns bytecode writing off, so that
# only a checkout's first run compiles it; the ranks inherit the setting.
CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), ".gpcbench_cache")
os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix = os.path.join(
    CACHE, "pycache")
os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
sys.dont_write_bytecode = False

import argparse  # noqa: E402
import json  # noqa: E402
import signal  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import threading  # noqa: E402

RUN_LIMIT_S = 330  # a run ends within the benchmark's 360 s


def _parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank-worker", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--t0-wall", type=float, default=None,
                   help=argparse.SUPPRESS)
    return p


def cache_dirs() -> None:
    """Every build and kernel cache that torch, Triton or the CUDA driver
    could write goes to a fixed folder of the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)


def emit(result: dict, out=None, err=None) -> None:
    """The compared numbers as the last lines of standard error (after the
    set-up split and the window's summary, which the run printed there),
    and the result as the last line of standard output."""
    out, err = out or sys.stdout, err or sys.stderr
    for name, c in result["checks"].items():
        rel = ">=" if c.get("at_least") else "<="
        print(f"check {name} {c['value']} {rel} {c['limit']}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()


def _power_limit(index: int):
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader", "-i", str(index)],
                           capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return q.stdout.strip() or None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(module: str, argv, world: int, limit_s: float):
    """Run ``python -m module --rank-worker argv`` as ``world`` ranks, all
    started at once with the environment ``torchrun`` would give them, and
    no launcher process that imports torch first; returns (exit code,
    rank 0's standard output), every rank's standard error passed through.
    The first rank to fail, the time limit or a SIGTERM to the launcher
    ends them all; every rank is ended before it returns."""
    port = _free_port()
    procs, out = [], []
    # a launcher ended from outside ends its ranks first (the finally below)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    for r in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="2", RANK=str(r),
                   LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, "--rank-worker", *argv], env=env,
            stdout=subprocess.PIPE if r == 0 else subprocess.DEVNULL,
            text=True, start_new_session=True))
    reader = threading.Thread(target=lambda: out.append(
        procs[0].stdout.read()))
    reader.start()
    end = time.monotonic() + limit_s
    try:
        while True:
            codes = [p.poll() for p in procs]
            rc = next((c for c in codes if c), 0)
            if rc or None not in codes:
                break
            if time.monotonic() > end:
                print(f"the ranks did not finish in {limit_s:.0f} s",
                      file=sys.stderr)
                rc = 1
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        reader.join()
    return rc, "".join(out)


def _launch(args, world: int) -> int:
    """Start the cell's ranks and relay rank 0's line."""
    rc, out = launch("gpcbench.run", [
        "--t0-wall", repr(T0_WALL), "--workload", args.workload,
        "--seed", str(args.seed), "--seconds", str(args.seconds),
        "--trace", str(args.trace)], world,
        RUN_LIMIT_S - (time.perf_counter() - T0))
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    if rc != 0 or not lines:
        print(f"the ranks exited {rc}", file=sys.stderr)
        return 2 if rc == 2 else 1
    from gpcbench import forbidden_modules
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    emit(json.loads(lines[-1]))
    return 0


def main(argv=None, log=None) -> int:
    """The run; ``log`` takes what the run prints to standard error
    before its checks (the set-up split, the traced summary, the window's
    readings)."""
    args = _parser().parse_args(argv)
    from gpcbench import registry
    cache_dirs()
    bench = registry.benchmark()
    cell_def = registry.cell(bench, args.workload)
    cfg = registry.config(cell_def["config"])
    tr = registry.traffic(cell_def["traffic"])
    chips = cell_def["chips"]
    if tr["ranks"] != chips:
        print(f"traffic {cell_def['traffic']} runs {tr['ranks']} ranks, the "
              f"cell has {chips} chips", file=sys.stderr)
        return 2
    if chips > 1 and not args.rank_worker:
        # the ranks look for the cards; the launcher imports no torch, which
        # would only add its import to the set-up
        return _launch(args, chips)
    t = time.perf_counter()
    import torch
    imports_torch = time.perf_counter() - t
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2

    from gpcbench import cell
    torch.set_num_threads(2)
    split = cell.Split()
    split.s["import_torch"] = imports_torch
    if args.rank_worker:
        split.s["launch"] = time.time() - args.t0_wall - (time.perf_counter()
                                                          - T0)
        local = int(os.environ["LOCAL_RANK"])
        device = torch.device("cuda", local)
        with split("dist_init"):
            ranks = cell.Ranks(device)
        t0 = (lambda: time.time() - args.t0_wall)
    else:
        device = torch.device("cuda", 0)
        ranks, t0 = cell.One(), T0
    try:
        result, bad = cell.run(args.workload, cfg, tr, args.seed,
                               args.seconds, bool(args.trace), device, ranks,
                               split, t0, bench, log=log or sys.stderr)
        if result is not None:
            result["device"]["power_limit"] = _power_limit(device.index)
            result = dict(result, checks=result.pop("checks"))
    finally:
        ranks.close()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    if result is None:
        return 0
    if args.rank_worker:
        print(json.dumps(result), flush=True)
    else:
        emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
