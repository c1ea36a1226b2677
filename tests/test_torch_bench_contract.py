"""Output contract and gates of ``bench_torch.py``, the port's counterpart
of ``bench.py``.

The bench runs once here, on the CPU twins in smoke mode (``--device cpu``,
``OGPC_BENCH_SMOKE=1``: 1 window of 3 steps, the full sizes and every
gate), with stdout and stderr merged into one stream.  Its records
must carry exactly ``bench.py``'s metric names, read from ``bench.py``'s
source, and its last JSON line must be the headline.  Without a card and
without ``--device`` it must refuse to run; the oracle gate must raise,
never skip."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_torch  # noqa: E402

HEADLINE = bench_torch.HEADLINE
RECORD_FIELDS = {"metric", "value", "unit", "note", "events_ms", "q1", "q3",
                 "device_ms", "ms_source", "timer", "launches"}


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="2", **extra)
    env.pop("OGPC_BENCH_FAST", None)
    return env


def _json_lines(text):
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            out.append(json.loads(line))
        except ValueError:
            continue
    return out


@pytest.fixture(scope="module")
def smoke():
    r = subprocess.run(
        [sys.executable, "bench_torch.py", "--device", "cpu"], cwd=REPO,
        env=_env(OGPC_BENCH_SMOKE="1"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=600)
    return r, _json_lines(r.stdout)


def test_smoke_exits_0_and_ends_with_the_headline(smoke):
    r, lines = smoke
    assert r.returncode == 0, r.stdout[-4000:]
    assert lines, "bench_torch printed no JSON lines"
    last = lines[-1]
    assert last["metric"] == HEADLINE and last["unit"] == "Mpix/s"
    assert last["device"] == "cpu"
    assert "vs_baseline" not in last
    # the early print survives too: the headline at least twice, the same
    heads = [j for j in lines if j.get("metric") == HEADLINE]
    assert len(heads) >= 2 and all(h == heads[-1] for h in heads)


def test_smoke_records_are_bench_py_metrics(smoke):
    _, lines = smoke
    want = bench_torch.bench_py_metrics()
    assert len(want) == 20 and HEADLINE in want
    got = [j["metric"] for j in lines if "metric" in j]
    assert set(got) == want
    # one record a metric, the headline printed twice
    assert sorted(got) == sorted(list(want) + [HEADLINE])


def test_smoke_records_are_positive_host_timed(smoke):
    _, lines = smoke
    for rec in lines:
        assert RECORD_FIELDS <= set(rec), rec
        assert rec["value"] > 0 and rec["q1"] <= rec["value"] <= rec["q3"]
        # on the CPU every time is the host clock's; no device number
        assert rec["timer"] == "host" and rec["ms_source"] == "host", rec
        assert rec["events_ms"] is None and rec["device_ms"] is None
        assert rec["host_ms"] > 0
        assert set(rec["launches"]) == set(bench_torch.KERNEL_COUNTERS)
        # CPU tensors take the kernels' twins: no launch
        assert not any(rec["launches"].values()), rec


def test_without_a_card_refuses_and_names_device_cpu():
    r = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO,
                       env=_env(CUDA_VISIBLE_DEVICES=""),
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True, timeout=120)
    assert r.returncode == 1, r.stdout[-2000:]
    assert "--device cpu" in r.stdout
    assert not _json_lines(r.stdout)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("script", ["bench_torch.py", "entry_torch.py"])
def test_scripts_import_neither_jax_nor_the_jax_package(script):
    mods = set(_imported_modules(os.path.join(REPO, script)))
    assert any(m.startswith("opengpc_tpu_torch") for m in mods)
    bad = {m for m in mods if m.split(".")[0] in ("jax", "jaxlib",
                                                  "opengpc_tpu")}
    assert not bad, (script, bad)
    code = (f"import sys; sys.path.insert(0, {REPO!r}); "
            f"import {script[:-3]}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'opengpc_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _oracle_like(n=5000, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1024, n)
    y = rng.integers(0, 436, n)
    d = rng.integers(-128, 129, n)
    return np.unique(np.stack([x, y, d], axis=1), axis=0)


def test_oracle_gate_passes_the_oracle_set_and_a_capacity_trim():
    want = _oracle_like()
    bench_torch.gate_oracle_subset(want, want, 1 << 19, "exact")
    cap = len(want) // 2
    bench_torch.gate_oracle_subset(want[:cap], want, cap, "trimmed")


def test_oracle_gate_raises_on_one_foreign_support():
    want = _oracle_like()
    got = want.copy()
    got[7] = (1023, 435, 200)  # d = 200 is past disp_high: no oracle row
    assert not (want == got[7]).all(axis=1).any()
    with pytest.raises(bench_torch.GateError, match="not in the oracle set"):
        bench_torch.gate_oracle_subset(got, want, 1 << 19, "foreign")


def test_oracle_gate_raises_under_999_per_mille_coverage():
    want = _oracle_like()
    got = want[: int(len(want) * 0.998)]
    with pytest.raises(bench_torch.GateError, match="oracle supports"):
        bench_torch.gate_oracle_subset(got, want, 1 << 19, "coverage")


def test_oracle_gate_raises_when_the_oracle_cannot_be_built(tmp_path):
    with pytest.raises(bench_torch.GateError, match="cannot run"):
        bench_torch.oracle_binary(repo=str(tmp_path))


def test_env_flag_tolerant_parse():
    """As bench.py's: "", "0", "false", "no" are off, anything else on."""
    for val, want in [("", False), ("0", False), ("false", False),
                      ("no", False), ("1", True), ("true", True),
                      ("yes", True), (" 1 ", True)]:
        os.environ["_OGPC_TEST_FLAG"] = val
        assert bench_torch._env_flag("_OGPC_TEST_FLAG") is want, (val, want)
    del os.environ["_OGPC_TEST_FLAG"]
