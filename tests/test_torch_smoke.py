"""The port stays free of JAX, its wrapper counts only kernel launches, and
``chip_smoke.py`` refuses to run without a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from opengpc_tpu_torch import load_forest, make_filter_mask
from opengpc_tpu_torch.match import SENTINEL_BASE
from opengpc_tpu_torch.ops.fused import fused_keys, fused_keys_plain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_no_jax():
    """Importing every module of the port imports no JAX and builds and
    loads neither the kernels nor the host library."""
    code = ("import sys, opengpc_tpu_torch, opengpc_tpu_torch.infer, "
            "opengpc_tpu_torch.match, opengpc_tpu_torch.ops.fused, "
            "opengpc_tpu_torch.ops.sort, opengpc_tpu_torch.ops.fused_match, "
            "opengpc_tpu_torch.ops.census, opengpc_tpu_torch.parallel, "
            "opengpc_tpu_torch.ops._build, opengpc_tpu_torch.pyramid, "
            "opengpc_tpu_torch.io.png, opengpc_tpu_torch.io._host, "
            "opengpc_tpu_torch.mine, opengpc_tpu_torch.train, "
            "opengpc_tpu_torch.metrics, opengpc_tpu_torch.cli.extract, "
            "opengpc_tpu_torch.cli.train, opengpc_tpu_torch.cli.sparsematch, "
            "opengpc_tpu_torch.densify, opengpc_tpu_torch.viz, "
            "opengpc_tpu_torch.types, opengpc_tpu_torch.io.supports, "
            "opengpc_tpu_torch.utils.timing\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'opengpc_tpu.')) or m == 'opengpc_tpu')\n"
            "assert not bad, bad\n"
            "from opengpc_tpu_torch.ops import _build\n"
            "from opengpc_tpu_torch.io import _host, png\n"
            "assert _build._lib is None\n"
            "assert png._NATIVE is None and not png._NATIVE_TRIED\n"
            "assert not _host.build_info\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cpu_tensor_runs_twin_and_counts_no_launch():
    mask = make_filter_mask(load_forest(
        os.path.join(REPO, "forests", "defaultZeroForest.txt")))
    img = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (48, 64)).astype(np.uint8))
    before = fused_keys.launches
    got = fused_keys(img, mask, 5, 0, SENTINEL_BASE)
    assert fused_keys.launches == before == 0
    assert torch.equal(got, fused_keys_plain(img, mask, 5, 0, SENTINEL_BASE))


def test_library_name_follows_every_csrc_file(tmp_path):
    """An edited header changes the library's name, so a stale build is
    never loaded; the hash covers every .cu, .cuh and .h file."""
    from opengpc_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    files = _build.csrc_files(str(csrc))
    names = {os.path.basename(f) for f in files}
    assert {"fused_keys.cu", "tile_codes.cuh", "bitonic.cuh"} <= names
    first = _build._library_path(files)
    assert _build._library_path(_build.csrc_files(str(csrc))) == first
    header = csrc / "tile_codes.cuh"
    header.write_text(header.read_text() + "// edited\n")
    second = _build._library_path(_build.csrc_files(str(csrc)))
    assert second != first
    (csrc / "extra.h").write_text("#pragma once\n")
    assert _build._library_path(_build.csrc_files(str(csrc))) not in (first,
                                                                      second)


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert not proc.stdout.strip()


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
