"""The harness on the CPU: pieces found by name, BENCHMARK.json against
the files, the end-to-end arithmetic, the roofline's counts, the trace
reduction, the result line, and what the benchmark may not import."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import pytest

import gpcbench
from gpcbench import cell, check, generator, registry, roofline, trace
from gpcbench.reference import gpc

ROOT = registry.ROOT
BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def small(cell_name, h=96, w=256, **traffic):
    d = registry.cell(BENCH, cell_name)
    cfg = registry.config(d["config"])
    cfg.update(height=h, width=w)
    tr = registry.traffic(d["traffic"])
    tr.update(traffic)
    return cfg, tr


def run_small(cell_name, seconds=0.5, trace_on=False, seed=2**33 + 3,
              **traffic):
    cfg, tr = small(cell_name, **traffic)
    return cell.run(cell_name, cfg, tr, seed, seconds, trace_on, "cpu",
                    cell.One(), cell.Split(), time.perf_counter(), BENCH)


# --- pieces by name -------------------------------------------------------

def test_every_piece_of_the_benchmark_is_found():
    for c in BENCH["configs"]:
        cfg = registry.config(c["name"])
        assert os.path.join(ROOT, c["file"]) == os.path.join(
            registry.HERE, "configs", c["name"] + ".json")
        assert os.path.isfile(cfg["forest_path"])
    for w in BENCH["workloads"]:
        tr = registry.traffic(w["traffic"])
        registry.entry(tr["entry"]).build
        assert tr["ranks"] == w["chips"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(registry.metric(m["name"]).read)


def test_a_piece_added_as_files_only_is_found(tmp_path):
    root = tmp_path / "gpcbench"
    shutil.copytree(registry.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((root / "configs" / "sintel-epipolar.json").read_text())
    cfg["name"] = "tiny-epipolar"
    (root / "configs" / "tiny-epipolar.json").write_text(json.dumps(cfg))
    tr = registry.traffic("b1_inflight1_card")
    tr.update(entry="tiny_entry", pool_pairs=2)
    (root / "traffic" / "tiny_mix.json").write_text(json.dumps(tr))
    (root / "entries" / "tiny_entry.py").write_text(
        (root / "entries" / "masked.py").read_text() + "\nTINY = True\n")
    (root / "metrics" / "calls_per_s.py").write_text(
        "def read(ctx):\n    return ctx.window.calls / ctx.window.seconds\n")
    assert registry.config("tiny-epipolar", str(root))["name"] == \
        "tiny-epipolar"
    assert registry.entry("tiny_entry", str(root)).TINY
    bench = dict(BENCH, workloads=[{"name": "tiny", "config":
                                    "tiny-epipolar", "traffic": "tiny_mix",
                                    "chips": 1, "why": "a test"}],
                 end_to_end=[{"name": "calls_per_s", "unit": "calls/s",
                              "better": "higher", "bound": 0.05,
                              "source": "host_clock"}])
    cfg = registry.config("tiny-epipolar", str(root))
    cfg.update(height=64, width=160)
    res, _ = cell.run("tiny", cfg, registry.traffic("tiny_mix", str(root)),
                      3, 0.3, False, "cpu", cell.One(), cell.Split(),
                      time.perf_counter(), bench, root=str(root))
    assert res["correct"] and res["metrics"]["calls_per_s"]["value"] > 0


def test_unknown_names_are_refused():
    with pytest.raises(FileNotFoundError):
        registry.traffic("no_such_mix")
    with pytest.raises(ValueError):
        registry.metric("../run")


# --- BENCHMARK.json against the contract and the files ----------------------

def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "-m", "gpcbench.run"]
    assert BENCH["paths"] == ["gpcbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gpcbench/")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:
        reports = registry.cell_metrics(BENCH, "end_to_end", w["name"])
        assert "setup_s" in {m["name"] for m in reports} and len(reports) > 1
        assert registry.cell_metrics(BENCH, "per_layer", w["name"])


def test_per_layer_entries_match_their_readers():
    layers = {}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert callable(registry.metric(m["name"]).read)
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:
            assert m["moves"] in {e["name"] for e in registry.cell_metrics(
                BENCH, "end_to_end", w)}
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        if m["unit"] == "%":
            assert m["name"].endswith(("roofline.batch", "roofline.b1")) or \
                m["name"].startswith("idle_share")
    assert all(len(v) == 1 for v in layers.values())


# --- end-to-end arithmetic ------------------------------------------------

def _ctx(**window):
    return types.SimpleNamespace(window=types.SimpleNamespace(**window),
                                 setup_s=12.5, ranks=None)


def test_pairs_per_s_is_all_the_work_over_all_the_time():
    read = registry.metric("pairs_per_s").read
    assert read(_ctx(pairs=32 * 3000, seconds=9.6)) == 32 * 3000 / 9.6
    res, _ = run_small("sintel_b32_card", batch=4, pool_pairs=8)
    v = res["metrics"]["pairs_per_s"]["value"]
    assert v > 0 and res["attempted"] % 4 == 0
    # every dispatched pair counts, over the window's whole length
    assert res["attempted"] / v >= 0.5


def test_frame_p95_is_over_every_call():
    read = registry.metric("frame_ms.p95").read
    ms = list(np.random.default_rng(1).permutation(np.arange(1, 201)))
    assert read(_ctx(call_ms=ms)) == 190
    assert read(_ctx(call_ms=[3.0] * 19 + [9.0])) == 3.0
    assert read(_ctx(call_ms=[3.0] * 18 + [9.0, 9.0])) == 9.0
    assert read(_ctx(call_ms=[])) is None
    res, _ = run_small("uhd4k_b1_card", pool_pairs=3)
    assert res["metrics"]["frame_ms.p95"]["value"] > 0


def test_setup_s_counts_from_the_process_start():
    assert registry.metric("setup_s").read(_ctx()) == 12.5


# --- the roofline's counts ------------------------------------------------

def test_roofline_counts_follow_the_shapes():
    t, bound = roofline.least_s(32, 436, 436, 1024, 0, 30)
    nbytes = 2 * 32 * 436 * 1024 + 4 * 32 * 436 * 2048
    ops = 2 * 32 * 436 * 1024
    assert bound == "bytes" and t == nbytes / roofline.HBM_BYTES_PER_S
    assert ops * (19 / roofline.INT16_OPS_PER_S
                  + 1 / roofline.INT32_OPS_PER_S) < t
    t2, bound2 = roofline.least_s(32, 436, 436, 1024, 10**9, 30)
    assert bound2 == "operations" and t2 == pytest.approx(
        ops * 19 / roofline.INT16_OPS_PER_S + ops / roofline.INT32_OPS_PER_S
        + 10**9 * 30 * (2 / roofline.INT16_OPS_PER_S
                        + 2 / roofline.INT32_OPS_PER_S))
    # a slab reads its halo rows and writes only its own
    assert roofline.least_s(1, 568, 540, 3840, 0, 30)[0] == (
        2 * 568 * 3840 + 4 * 540 * 2 * 3840) / roofline.HBM_BYTES_PER_S
    assert roofline.INT32_OPS_PER_S == pytest.approx(16.73e12, rel=1e-3)


def test_key_least_s_sums_the_launches_of_a_call(monkeypatch):
    cfg, tr = small("sintel_b32_card", batch=4, pool_pairs=8)
    r = cell.Run(cfg, tr, "cpu", cell.One(), cell.Split())
    r.setup(2**33 + 11)
    assert r.entry.key_launch() == [(4, 96, 96, 0, 0)]
    batches = [0, 1, 1]
    one = r.key_least_s(batches)
    # the global entry keys pair by pair: B launches of one pair each
    per_pair = registry.entry("global_rows").GlobalRows.key_launch(
        types.SimpleNamespace(cfg=cfg, batch=4))
    assert per_pair == [(1, 96, 96, 0, p) for p in range(4)]
    monkeypatch.setattr(r.entry, "key_launch", lambda: per_pair)
    assert r.key_least_s(batches) == pytest.approx(one, rel=1e-12)
    # and the reader gives the same work the same share
    read = registry.metric("fused_keys_roofline.batch").read
    base = dict(key_least_s=sum(one), calls=3, key_s=6e-5)
    ranks = [dict(base, key_launches=3, key_launches_per_call=1)]
    split = [dict(base, key_launches=12, key_launches_per_call=4)]
    assert read(types.SimpleNamespace(ranks=split)) == pytest.approx(
        read(types.SimpleNamespace(ranks=ranks)), rel=1e-12)


def test_candidate_rows_match_the_reference():
    imgs, _, _ = generator.make_pool(41, 3, 80, 200, 0.2, (4, 96))
    want = gpc.candidates(imgs.numpy(), 5).sum(-1)
    assert np.array_equal(roofline.candidate_rows(imgs, 5).numpy(), want)


# --- the trace reduction --------------------------------------------------

class Ev:
    def __init__(self, kind, name, start, dur, corr=0, cuda=False):
        self.k, self.n, self.s, self.d, self.c = kind, name, start, dur, corr
        self.dev = "DeviceType.CUDA" if cuda else "DeviceType.CPU"

    def activity_type(self):
        return self.k

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def correlation_id(self):
        return self.c

    def device_type(self):
        return self.dev


class OldEv(Ev):
    """An event of a torch whose kineto events carry no activity type."""

    activity_type = property()


def _events(cls=Ev):
    ua, op, rt = "user_annotation", "cpu_op", "cuda_runtime"
    return [
        cls(ua, "window", 0, 1000),
        cls(ua, "enqueue", 10, 90), cls(op, "ogpc::fused_key_image", 20, 20),
        cls(rt, "cudaLaunchKernel", 15, 2, 1),
        cls(rt, "cudaLaunchKernel", 50, 2, 2),
        cls(rt, "cudaLaunchKernel", 60, 2, 3),
        cls(ua, "consume", 100, 10), cls(rt, "cudaLaunchKernel", 105, 2, 4),
        cls(ua, "wait", 110, 800),
        cls("kernel", "copy_kernel", 100, 50, 1, True),
        cls("kernel", "fused_keys_kernel", 150, 100, 0, True),
        cls("kernel", "radixSortKVInPlace", 250, 300, 2, True),
        cls("gpu_memcpy", "Memcpy DtoD", 550, 50, 3, True),
        cls("kernel", "reduce_kernel", 700, 100, 4, True),
        cls("gpu_user_annotation", "enqueue", 100, 500, 0, True),
        cls("kernel", "ncclDevKernel_SendRecv", 850, 20, 9, True),
    ]


@pytest.mark.parametrize("cls", [Ev, OldEv])
def test_trace_reduction(cls):
    s = trace.reduce(_events(cls))
    assert s["window_s"] == 1000e-9 and s["calls"] == 1
    assert s["key_s"] == 100e-9 and s["key_launches"] == 1
    # launched in the enqueue span after the key op: the sort and the copy
    assert s["match_s"] == 350e-9
    assert s["nccl_s"] == 20e-9
    assert s["busy_s"] == (500 + 100 + 20) * 1e-9
    assert s["enqueue_ms"] == [90e-6]
    idle = s["idle_by_host"]
    assert idle == pytest.approx({"enqueue": 100e-9, "wait": 150e-9,
                                  "other": 130e-9})
    assert s["device_ops"]["radixSortKVInPlace"] == 300e-9
    assert "enqueue" not in s["device_ops"]


def test_union_and_top():
    assert trace._union([(0, 5), (3, 8), (10, 12)]) == (10, [(8, 10)])
    assert trace.top({"a": 1, "b": 3, "c": 2}, 2) == [["b", 3], ["c", 2]]
    assert trace.merge([{"a": 2}, {"a": 4, "b": 2}]) == {"a": 3, "b": 1}


# --- the result line ------------------------------------------------------

def test_result_line_keys():
    res, bad = run_small("sintel_b32_card", batch=4, pool_pairs=8)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0 and not bad
    assert set(res["metrics"]) == {"pairs_per_s", "setup_s"}
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(res["checks"]) == set(check.LIMITS) | {"checked_pairs"}
    res, _ = run_small("sintel_b32_card", trace_on=True, batch=4,
                       pool_pairs=8)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["metrics"]) <= {m["name"] for m in BENCH["per_layer"]}


def test_emit_puts_the_checks_last(capsys):
    from gpcbench.run import emit
    res, _ = run_small("uhd4k_b1_card", pool_pairs=2)
    capsys.readouterr()
    emit(res)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == res
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert [ln.split()[1] for ln in tail] == list(res["checks"])


# --- no card, no JAX ------------------------------------------------------

def _cli(args, cwd=ROOT, **env):
    e = dict(os.environ, PYTHONPATH=cwd, CUDA_VISIBLE_DEVICES="", **env)
    return subprocess.run([sys.executable, "-m", "gpcbench.run", *args],
                          cwd=cwd, env=e, capture_output=True, text=True,
                          timeout=300)


def test_without_a_card_it_fails_and_prints_no_result():
    p = _cli(["--workload", "sintel_b32_card", "--seed", "1", "--seconds",
              "1", "--trace", "0"])
    assert p.returncode == 2 and p.stdout == ""
    assert "needs 1 CUDA device" in p.stderr


def test_four_card_cell_without_cards_fails(tmp_path):
    # the four-card pieces as a cell of a BENCHMARK.json of the test's own
    bench = dict(BENCH, workloads=BENCH["workloads"] + [
        {"name": "uhd4k_rows4_b4", "config": "uhd4k-epipolar",
         "traffic": "b4_inflight2_rows4_card", "chips": 4, "why": "a test"}])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copytree(registry.HERE, tmp_path / "gpcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(["--workload", "uhd4k_rows4_b4", "--seed", "1", "--seconds",
              "1", "--trace", "0"], cwd=str(tmp_path))
    assert p.returncode != 0 and p.stdout == ""
    assert "needs 4 CUDA device" in p.stderr


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(registry.HERE, tmp_path / "gpcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(["--workload", "uhd4k_b1_card", "--seed", "1", "--seconds",
              "1", "--trace", "0"], cwd=str(tmp_path))
    assert p.returncode != 0 and p.stdout == ""


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_in_the_sources():
    files = [os.path.join(d, f) for d, _, fs in os.walk(registry.HERE)
             for f in fs if f.endswith(".py")]
    for path in files:
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(gpcbench.FORBIDDEN), path
        if os.sep + "reference" + os.sep in path:
            assert tops <= {"numpy", "__future__"}, path


def test_the_top_level_name_is_compared_whole():
    sys.modules.setdefault("opengpc_tpu_torch", sys.modules.get(
        "opengpc_tpu_torch") or types.ModuleType("opengpc_tpu_torch"))
    assert "opengpc_tpu" not in gpcbench.forbidden_modules()
    sys.modules["opengpc_tpu_x"] = types.ModuleType("opengpc_tpu_x")
    try:
        assert gpcbench.forbidden_modules() == []
    finally:
        del sys.modules["opengpc_tpu_x"]


def test_a_run_loads_no_jax():
    code = (
        "import time, json\n"
        "from gpcbench import cell, registry\n"
        "b = registry.benchmark()\n"
        "c = registry.config('uhd4k-epipolar'); c.update(height=64, width=160)\n"
        "t = registry.traffic('b1_inflight1_card'); t.update(pool_pairs=2)\n"
        "r, bad = cell.run('uhd4k_b1_card', c, t, 1, 0.2, True, 'cpu',\n"
        "    cell.One(), cell.Split(), time.perf_counter(), b)\n"
        "from gpcbench import forbidden_modules as f\n"
        "print(json.dumps([r['correct'], bad, f()]))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, timeout=300,
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True)
    assert json.loads(p.stdout.strip().splitlines()[-1]) == [True, [], []]
