"""The port's repo-level scripts against their JAX counterparts, on the CPU
(``--device cpu``) at small sizes, in process:

* ``examples/demo_torch.py`` writes the forest file and PNGs of
  ``examples/demo.py`` byte for byte and prints the same lines, the
  training time apart;
* ``examples/evaluate_torch.py`` prints ``examples/evaluate.py``'s quality
  table, and refuses ``--device-time`` off the card with exit 1;
* ``data/validate_real_sintel_torch.py`` passes on the synthetic
  Sintel-layout tree of ``test_mine.py`` with the JAX runner's check
  lines."""

import importlib.util
import os
import re

import pytest
import torch

from test_mine import sintel_tree  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOREST = os.path.join(REPO, "forests", "defaultZeroForest.txt")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(*parts):
    path = os.path.join(REPO, *parts)
    name = "_" + os.path.splitext(parts[-1])[0]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(text, drop):
    return [ln for ln in text.splitlines() if not re.search(drop, ln)]


def test_demo_matches_jax(tmp_path, capsys):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    _script("examples", "demo.py").main(str(jdir), 96, 192, 1000)
    jout = capsys.readouterr().out
    rc = _script("examples", "demo_torch.py").main(
        [str(tdir), "--height", "96", "--width", "192", "--triplets", "1000",
         "--device", "cpu"])
    tout = capsys.readouterr().out
    assert rc == 0
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    assert {"fresh_forest.txt", "disparity_fresh.png",
            "disparity_pretrained.png"} <= set(names)
    for name in names:
        assert (jdir / name).read_bytes() == (tdir / name).read_bytes(), name
    drop = r"trained fresh forest in|outputs in"
    assert _lines(tout, drop) == _lines(jout, drop)
    assert re.search(r"pretrained: \d+ supports, exact-disparity precision "
                     r"0\.99\d", tout), tout


def test_evaluate_table_matches_jax(capsys):
    argv = [FOREST, "--height", "96", "--width", "256", "--tests",
            "30,20,17,10"]
    assert _script("examples", "evaluate.py").main(argv) == 0
    jout = capsys.readouterr().out
    assert _script("examples", "evaluate_torch.py").main(
        argv + ["--device", "cpu"]) == 0
    tout = capsys.readouterr().out
    jtable = [ln for ln in jout.splitlines() if ln.startswith("|")]
    table = [ln for ln in tout.splitlines() if ln.startswith("|")]
    assert len(table) == 2 + 4 and table == jtable
    assert "| 20 | 1-op |" in tout and "| 30 | 2-op |" in tout


def test_evaluate_device_time_refuses_the_cpu(capsys):
    rc = _script("examples", "evaluate_torch.py").main(
        [FOREST, "--height", "64", "--width", "128", "--device-time",
         "--device", "cpu"])
    assert rc == 1
    captured = capsys.readouterr()
    assert "--device-time" in captured.err and "|" not in captured.out


def test_validate_real_sintel_matches_jax_runner(sintel_tree, capsys):
    argv = ["--flow-root", sintel_tree, "--stereo-root", sintel_tree]
    assert _script("data", "validate_real_sintel.py").main(argv) == 0
    jout = capsys.readouterr().out
    rc = _script("data", "validate_real_sintel_torch.py").main(
        argv + ["--device", "cpu"])
    tout = capsys.readouterr().out
    assert rc == 0, tout
    assert "all hard checks passed" in tout and "[FAIL]" not in tout
    for line in ("flow mining", "stereo mining", "real-pair matching",
                 "ORACLE parity on real pair", "precision vs GT"):
        assert line in tout, (line, tout)
    m = re.search(r"precision vs GT \(tol 0\): ([\d.]+) over (\d+)", tout)
    assert m and float(m.group(1)) > 0.99 and int(m.group(2)) > 100, tout

    def checks(text):  # the check lines, their timings dropped
        return [re.sub(r" in [\d.]+s.*", "", ln) for ln in text.splitlines()
                if ln.startswith("[") or "precision vs GT" in ln]

    assert checks(tout) == checks(jout)
