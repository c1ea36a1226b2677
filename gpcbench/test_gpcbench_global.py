"""The harness in global mode, on the CPU at 120 x 320: the global
reference against the port's global-rows and flat routes, the global
controls failing, the faults of a global entry failing a run, and a whole
global-mode cell found as files alone.  No global cell is in
BENCHMARK.json yet, so the configuration and the traffic are built here
from the library's defaults (global mode, gradient threshold 10, vertical
tolerance 1, dispHigh 128) and a Sintel-like batch with vertical offsets
of -1..1 rows."""

import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from gpcbench import cell, check, generator, port, registry
from gpcbench.reference import gpc

BENCH = registry.benchmark()
H, W = 120, 320
SEEDS = [5, 2**33 + 1, 987654321]
NAME = "tiny_global"


def global_cfg(forest_path=None):
    cfg = registry.config("sintel-epipolar")
    cfg.update(name="tiny-global", height=H, width=W, gradient_threshold=10,
               vertical_tolerance=1, epipolar_mode=False)
    if forest_path:
        cfg["forest_path"] = forest_path
    return cfg


def global_traffic(**kw):
    tr = registry.traffic("b32_inflight2_card")
    tr.update(entry="global_rows", batch=4, pool_pairs=8, vertical=[-1, 1])
    tr.update(kw)
    return tr


def random_forest(path, seed):
    """A 30-test forest text (6 ferns of 5 tests, offsets over the whole
    27 x 27 patch, taus in [-10, 10)) at ``path``."""
    rng = np.random.default_rng(seed)
    lines = ["6"]
    for f in range(6):
        lines.append(f"{f} l 5")
        for t in range(5):
            ix, iy, jx, jy = rng.integers(-13, 14, 4)
            lines.append(f"{t} {ix} {iy} {jx} {jy} {rng.integers(-10, 10)}")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(params=["zero", "random"])
def forest(request, tmp_path):
    if request.param == "zero":
        return registry.config("sintel-epipolar")["forest_path"]
    return random_forest(tmp_path / "forest.txt", 31)


def _tests(path):
    with open(path) as f:
        return gpc.parse_forest(f.read())


def _pool(seed, pairs=4, vertical=(-1, 1)):
    tr = global_traffic()
    return generator.make_pool(seed, pairs, H, W, tr["density"],
                               tr["disparity"], vertical=vertical)


# offsets of two rows put true matches past the tolerance, which the port
# has to drop
@pytest.mark.parametrize("vertical", [(-1, 1), (-2, 2)])
@pytest.mark.parametrize("seed", SEEDS)
def test_global_reference_against_the_port(seed, forest, vertical):
    from opengpc_tpu_torch.forest import load_forest
    from opengpc_tpu_torch.infer import (build_sparsematch,
                                         build_sparsematch_global_rows)
    cfg = global_cfg(forest)
    lefts, rights, _ = _pool(seed, vertical=vertical)
    tests = _tests(forest)
    rows = build_sparsematch_global_rows(load_forest(forest),
                                         port.settings(cfg), device="cpu")
    (xs, ys, ds), counts = rows(lefts, rights)
    out = (tuple(t.numpy() for t in (xs, ys, ds)), counts.numpy())
    r = check.compare(*out, lefts.numpy(), rights.numpy(), tests, cfg)
    assert r["supports"] > 0
    assert (r["support_mismatches"], r["row_count_mismatches"],
            r["failed_pairs"]) == (0, 0, 0)
    # the flat route of the same mode gives the same sets
    fx, fy, fd, n = build_sparsematch(load_forest(forest), port.settings(cfg),
                                      device="cpu")(lefts, rights)
    ref = gpc.global_supports(lefts.numpy(), rights.numpy(), tests, 10, 128,
                              1)
    for b in range(len(lefts)):
        k, sel = int(n[b]), ref[0] == b
        got = set(zip(fx[b, :k].tolist(), fy[b, :k].tolist(),
                      fd[b, :k].tolist()))
        want = set(zip(ref[2][sel].tolist(), ref[1][sel].tolist(),
                       ref[3][sel].tolist()))
        assert len(got) == k and got == want


def test_vertical_tolerance_decides_supports():
    lefts, rights, _ = _pool(SEEDS[0])
    dys = generator.vertical_offsets(SEEDS[0], 4, -1, 1).numpy()
    tests = _tests(global_cfg()["forest_path"])
    at1 = gpc.global_supports(lefts.numpy(), rights.numpy(), tests, 10, 128,
                              1)
    at0 = gpc.global_supports(lefts.numpy(), rights.numpy(), tests, 10, 128,
                              0)
    n1, n0 = (np.bincount(s[0], minlength=4) for s in (at1, at0))
    assert (dys != 0).any()
    # pairs shifted by a row keep their supports only under tolerance 1
    assert (n1[dys != 0] > 100).all() and (n0[dys != 0] < n1[dys != 0] / 10
                                           ).all()


@pytest.mark.parametrize("kind", check.CONTROLS[False])
@pytest.mark.parametrize("seed", SEEDS)
def test_global_controls_fail(kind, seed):
    cfg = global_cfg()
    tests = _tests(cfg["forest_path"])
    lefts, rights, _ = (t.numpy() for t in _pool(seed))
    out = check.control_outputs(lefts, rights, tests, cfg, kind)
    readings = check.compare(*out, lefts, rights, tests, cfg)
    assert not check.verdict(readings, len(lefts))
    assert readings["support_mismatches"] > 0
    # the layout the controls write is read back as it was meant
    ref = gpc.global_supports(lefts, rights, tests, 10, 128, 1)
    ok = check.compare(*check.global_layout(ref, len(lefts), H, 2 * W),
                       lefts, rights, tests, cfg)
    assert check.verdict(ok, len(lefts))


def test_global_controls_are_refused_in_epipolar_mode():
    cfg = registry.config("sintel-epipolar")
    lefts, rights, _ = (t.numpy() for t in _pool(1, pairs=1))
    with pytest.raises(ValueError):
        check.control_outputs(lefts, rights, _tests(cfg["forest_path"]), cfg,
                              "no_tolerance")


# --- a global entry under faults ---------------------------------------------

def _run(seed=2**32 + 77, trace_on=False, bench=None, root=registry.HERE,
         cfg=None, tr=None):
    bench = bench or dict(BENCH, workloads=[])
    return cell.run(NAME, cfg or global_cfg(), tr or global_traffic(), seed,
                    0.5, trace_on, "cpu", cell.One(), cell.Split(),
                    time.perf_counter(), bench, root=root)[0]


def _dropped(base):
    def run(*a, **k):
        (xs, ys, ds), counts = base(*a, **k)
        counts = counts.clone()
        counts[int(torch.nonzero(counts)[0])] -= 1
        return (xs, ys, ds), counts
    return run


def _altered(base):
    def run(*a, **k):
        (xs, ys, ds), counts = base(*a, **k)
        ds = ds.clone()
        ds[int(torch.nonzero(counts)[0]), 0] += 1
        return (xs, ys, ds), counts
    return run


def _half(base):
    def run(self, left, right):
        k = left.shape[0] // 2
        (xs, ys, ds), counts = base(self, left[:k], right[:k])
        pad = (left.shape[0] - k,) + xs.shape[1:]
        z = torch.zeros(pad, dtype=xs.dtype)
        return ((torch.cat([xs, z]), torch.cat([ys, z]), torch.cat([ds, z])),
                torch.cat([counts, torch.zeros_like(counts)]))
    return run


def _stale(base):
    first = []

    def run(self, left, right):
        if not first:
            first.append(base(self, left, right))
        return first[0]
    return run


def test_sound_global_run_is_correct():
    res = _run()
    assert res["correct"] is True and res["failed"] == 0
    # every (batch, slot) stratum of the pool is checked
    c = res["checks"]["checked_pairs"]
    assert c["limit"] == 8 and c["value"] >= 8


@pytest.mark.parametrize("fault", ["drop_support", "alter_answer",
                                   "half_batch", "stale_state"])
def test_global_fault_fails_the_run(monkeypatch, fault):
    from opengpc_tpu_torch import infer
    cls = infer.SparsematchGlobalRows
    if fault == "drop_support":
        monkeypatch.setattr(infer, "match_global_rows",
                            _dropped(infer.match_global_rows))
    elif fault == "alter_answer":
        monkeypatch.setattr(infer, "match_global_rows",
                            _altered(infer.match_global_rows))
    elif fault == "half_batch":
        monkeypatch.setattr(cls, "_run", _half(cls._run))
    else:
        monkeypatch.setattr(cls, "_run", _stale(cls._run))
    res = _run()
    assert res["correct"] is False and res["failed"] > 0
    assert res["checks"]["support_mismatches"]["value"] > 0
    if fault != "alter_answer":
        assert res["checks"]["row_count_mismatches"]["value"] > 0


# --- a global-mode cell added as files alone ---------------------------------

def test_a_global_cell_added_as_files_only_runs(tmp_path):
    root = tmp_path / "gpcbench"
    shutil.copytree(registry.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((root / "configs" / "sintel-epipolar.json").read_text())
    cfg.update(name="tiny-global", gradient_threshold=10,
               vertical_tolerance=1, epipolar_mode=False)
    (root / "configs" / "tiny-global.json").write_text(json.dumps(cfg))
    tr = global_traffic()
    (root / "traffic" / "tiny_global_mix.json").write_text(json.dumps(tr))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"] = [{"name": NAME, "config": "tiny-global",
                           "traffic": "tiny_global_mix", "chips": 1,
                           "why": "a test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "sintel_b32_card" in m.get("workloads", []):
            m["workloads"] = [NAME]
    cfg = registry.config("tiny-global", str(root))
    assert os.path.isfile(cfg["forest_path"])
    cfg.update(height=H, width=W)
    tr = registry.traffic("tiny_global_mix", str(root))
    assert tr["vertical"] == [-1, 1]
    res = _run(bench=bench, root=str(root), cfg=cfg, tr=tr)
    assert res["correct"] and set(res["metrics"]) == {"pairs_per_s",
                                                      "setup_s"}
    res = _run(trace_on=True, bench=bench, root=str(root), cfg=cfg, tr=tr)
    assert res["correct"] and {"busy_s", "window_s"} <= set(res["device"])
    # the global route marks no match stages: their readers stay silent
    assert "launches.per_call.batch" in res["metrics"]
    assert not {"sort_ms.per_pair.batch", "detect_ms.per_pair.batch",
                "emit_ms.per_pair.batch"} & set(res["metrics"])
