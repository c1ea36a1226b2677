"""Finds the benchmark's pieces by name.

``BENCHMARK.json`` at the root of the checkout names the cells; each
piece is a file of its own under this folder:

* a configuration: ``configs/<name>.json``
* a traffic mix: ``traffic/<name>.json``
* an entry point, the module a cell drives: ``entries/<name>.py``
* a per-layer metric's reader: ``metrics/<name>.py``

A piece is added by adding its file and its entry in ``BENCHMARK.json``;
no file here lists them.  ``root`` arguments let a test point the lookup
at a folder of its own.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _path(kind: str, name: str, suffix: str, root: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = os.path.join(root, kind, name + suffix)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {name!r} under {kind}/ ({path})")
    return path


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    """The parsed ``BENCHMARK.json`` of the checkout at ``root``."""
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(name: str, root: str = HERE) -> dict:
    """The configuration ``configs/<name>.json``; its ``forest`` is a path
    relative to the configuration's folder."""
    path = _path("configs", name, ".json", root)
    cfg = _json(path)
    cfg["forest_path"] = os.path.normpath(
        os.path.join(os.path.dirname(path), cfg["forest"]))
    return cfg


def traffic(name: str, root: str = HERE) -> dict:
    return _json(_path("traffic", name, ".json", root))


def _module(kind: str, name: str, root: str):
    path = _path(kind, name, ".py", root)
    spec = importlib.util.spec_from_file_location(
        f"gpcbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str, root: str = HERE):
    """The entry module ``entries/<name>.py``: ``build(ctx)`` returns the
    object the window calls."""
    return _module("entries", name, root)


def metric(name: str, root: str = HERE):
    """The reader ``metrics/<name>.py``: ``read(ctx)`` returns the value or
    None when the run has nothing to read for it."""
    return _module("metrics", name, root)


def cell_metrics(bench: dict, section: str, cell_name: str):
    """The metrics of ``section`` ("end_to_end" or "per_layer") that the
    cell reports: those whose ``workloads`` list it, or that have none."""
    return [m for m in bench[section]
            if cell_name in m.get("workloads", [cell_name])]
