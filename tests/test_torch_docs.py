"""docs/API_torch.md drift guard, modelled on tests/test_docs.py: every
public top-level function and class of ``opengpc_tpu_torch`` (outside
``cli/``) must be named in the port's API reference, every flag its command
table names must be an option of that command's parser, and every console
script of the port that pyproject.toml declares must resolve to a callable
``main``."""

import ast
import importlib
import os
import re
import tomllib

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "opengpc_tpu_torch")
DOC = os.path.join(REPO, "docs", "API_torch.md")
CLIS = ("sparsematch", "extract", "train", "aot")


def _public_symbols():
    """(module path, name) of every top-level public def/class in the
    package, the CLI modules excepted (documented as commands)."""
    out = []
    for root, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "_build")]
        if os.path.basename(root) == "cli":
            continue
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                tree = ast.parse(fh.read())
            for node in tree.body:
                if isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                        and not node.name.startswith("_"):
                    out.append((os.path.relpath(path, REPO), node.name))
    return out


def _doc():
    with open(DOC) as f:
        return f.read()


def _flags_of(name):
    """Every ``--flag`` an ``add_argument`` call of the CLI module adds."""
    with open(os.path.join(PKG, "cli", f"{name}.py")) as f:
        src = ast.parse(f.read())
    found = set()
    for node in ast.walk(src):
        if isinstance(node, ast.Call) and \
                getattr(node.func, "attr", "") == "add_argument":
            for a in node.args:
                if isinstance(a, ast.Constant) and \
                        str(a.value).startswith("--"):
                    found.add(a.value)
    return found


def test_every_public_symbol_documented():
    doc = _doc()
    symbols = _public_symbols()
    assert len(symbols) >= 196
    missing = [f"{p}::{n}" for p, n in symbols
               if not re.search(rf"\b{re.escape(n)}\b", doc)]
    assert not missing, (
        "public symbols missing from docs/API_torch.md (add an entry or "
        f"prefix with _ if internal): {missing}")


@pytest.mark.parametrize("cli", CLIS)
def test_documented_cli_flags_exist(cli):
    """Every --flag on a command's row of the table is a real option of
    that command, and the row exists."""
    table = _doc().split("## Command-line tools")[1].split("\n## ")[0]
    cmd = f"`opengpc-torch-{cli}"
    rows = [ln for ln in table.splitlines()
            if f"{cmd} " in ln or f"{cmd}`" in ln]
    assert rows, f"no row for opengpc-torch-{cli}"
    real = _flags_of(cli)
    for line in rows:
        unknown = set(re.findall(r"--[a-z][a-z0-9-]*", line)) - real
        assert not unknown, (cli, sorted(unknown), sorted(real))


def test_doc_contract_names_match_cli_choices():
    """The sparsematch row's --contract list is the parser's choices."""
    m = re.search(r"--contract ([a-z|\\-]+)`", _doc())
    assert m, "no --contract value list in docs/API_torch.md"
    documented = set(m.group(1).replace("\\", "").split("|"))
    from opengpc_tpu_torch.cli import sparsematch

    action = next(a for a in sparsematch._parser()._actions
                  if "--contract" in a.option_strings)
    assert documented == set(action.choices)


def test_lacks_section_names_each_deliberate_gap():
    """The closing section names each JAX surface the port leaves out, and
    none of them exists in the port."""
    lacks = _doc().split("## What the port deliberately lacks")[1]
    public = {n for _, n in _public_symbols()}
    for name in ("resolve_use_pallas", "device_time_per_iter",
                 "FusedKernelBudgetError", "tile_codes_and_cand",
                 "bitonic_network", "TILE_R", "DATA_AXIS", "ROWS_AXIS",
                 "--platforms", "--pallas"):
        assert name in lacks, name
        assert name not in public, name


def _port_scripts():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    return {k: v for k, v in scripts.items() if k.startswith("opengpc-torch-")}


@pytest.mark.parametrize("cli", CLIS)
def test_console_script_resolves(cli):
    """pyproject.toml names opengpc-torch-<cli> -> the port CLI's main,
    beside the JAX package's entry of the same command."""
    scripts = _port_scripts()
    target = scripts[f"opengpc-torch-{cli}"]
    mod, _, attr = target.partition(":")
    assert mod == f"opengpc_tpu_torch.cli.{cli}" and attr == "main"
    assert callable(getattr(importlib.import_module(mod), attr))
    assert set(scripts) == {f"opengpc-torch-{c}" for c in CLIS}
