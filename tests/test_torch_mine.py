"""Mining, the host file formats and the two offline CLIs of the PyTorch
port against the JAX package.

The same seeds and the same synthetic Sintel-layout trees (the fixtures of
``test_mine.py``) go through both packages: keypoints, triplets, dataset
files, ``.flo`` files and forest files must be byte-identical, and
``extract_triplets_device`` (on the CPU here) must equal the numpy path.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import opengpc_tpu.io.flo as jflo
import opengpc_tpu.io.triplets as jtriplets
import opengpc_tpu.metrics as jmetrics
import opengpc_tpu.mine as jmine
import opengpc_tpu_torch.io.flo as tflo
import opengpc_tpu_torch.io.triplets as ttriplets
import opengpc_tpu_torch.metrics as tmetrics
import opengpc_tpu_torch.mine as tmine
from opengpc_tpu.io.sintel import decode_stereo_disparity as jdecode
from opengpc_tpu_torch.io.sintel import decode_stereo_disparity as tdecode
from opengpc_tpu_torch.ops.preprocess import box3
from opengpc_tpu_torch.utils.scenes import make_scene
from test_mine import hard_sintel_tree, sintel_tree  # noqa: F401 (fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stereo_inputs(seed, h=160, w=240):
    left, right, gt, occ = make_scene(np.random.default_rng(seed), h, w)
    oof = np.zeros((h, w), np.uint8)
    oof[:, :24] = 255
    return left, right, gt, occ, oof


def _flow_inputs(seed, h=120, w=200):
    rng = np.random.default_rng(seed)
    u = rng.normal(0, 6, (h, w)).astype(np.float32)
    u[:, :10] = 2.5  # exact halves: C round() goes away from zero
    v = rng.normal(0, 3, (h, w)).astype(np.float32)
    v[:10] = -1.5
    occ = [(rng.random((h, w)) < 0.1).astype(np.uint8) * 255
           for _ in range(4)]
    return u, v, occ


@pytest.mark.parametrize("mode", ["stereo", "flow"])
def test_mine_pair_equals_jax(mode):
    """The same generator state gives the same (ref, pos, neg) keypoints,
    and leaves the generator in the same state."""
    rngs = [np.random.default_rng(3), np.random.default_rng(3)]
    if mode == "stereo":
        _, _, gt, occ, oof = _stereo_inputs(0)
        outs = [m.mine_stereo_pair(gt, occ, oof, 400, 10, 25, r)
                for m, r in zip((jmine, tmine), rngs)]
    else:
        u, v, occ = _flow_inputs(1)
        outs = [m.mine_flow_pair(u, v, *occ, 300, 10, 20, r)
                for m, r in zip((jmine, tmine), rngs)]
    for want, got in zip(*outs):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert rngs[0].integers(1 << 30) == rngs[1].integers(1 << 30)


def test_round_ref_equals_jax():
    a = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.49, -3.51, 0.0])
    np.testing.assert_array_equal(tmine._round_ref(a), jmine._round_ref(a))
    np.testing.assert_array_equal(tmine._round_ref(a),
                                  [-3, -2, -1, 1, 2, 3, 3, -4, 0])


@pytest.mark.parametrize("shape", [(48, 64), (61, 97), (130, 250)])
def test_blur_equals_box3(shape):
    img = np.random.default_rng(shape[1]).integers(0, 256, shape).astype(
        np.uint8)
    want = box3(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(tmine._blur(img), want)
    np.testing.assert_array_equal(jmine._blur(img), want)


@pytest.mark.parametrize("shape", [(160, 240), (100, 165)])
def test_extract_triplets_equal_jax_and_device_path(shape):
    """Host triplets equal JAX's; ``extract_triplets_device`` (on the CPU)
    equals the numpy path, including keypoints on the interior rule's
    edge that it must drop."""
    left, right, gt, occ, oof = _stereo_inputs(9, *shape)
    kl, kr, kn = tmine.mine_stereo_pair(gt, occ, oof, 500, 10, 25,
                                        np.random.default_rng(4))
    h, w = shape
    edge = np.array([[20, 30], [21, 21], [w - 20, 40], [w - 21, h - 21]])
    kl, kr, kn = (np.concatenate([k, edge]) for k in (kl, kr, kn))
    want = jmine.extract_triplets(left, right, kl, kr, kn)
    got = tmine.extract_triplets(left, right, kl, kr, kn)
    dev = tmine.extract_triplets_device(left, right, kl, kr, kn,
                                        device="cpu")
    assert want.shape == (500 + 2, 3, 729) and want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert dev.dtype == np.uint8
    np.testing.assert_array_equal(dev, want)


@pytest.mark.parametrize("mode", ["stereo", "flow", "hard_stereo"])
def test_extract_dataset_equals_jax(mode, request):
    """A whole tree walked, mined, extracted and shuffled: the same seed
    and tree give the same triplet file bytes."""
    if mode == "hard_stereo":
        root = request.getfixturevalue("hard_sintel_tree")[0]
    else:
        root = request.getfixturevalue("sintel_tree")
    kw = dict(triplets_per_pair=60, radius_lo=10, radius_hi=20, seed=5,
              verbose=False)
    if mode == "flow":
        want = jmine.extract_flow_dataset(root, **kw)
        got = tmine.extract_flow_dataset(root, **kw)
    else:
        want = jmine.extract_stereo_dataset(root, **kw)
        got = tmine.extract_stereo_dataset(root, **kw)
    assert len(want) > 100
    assert got.tobytes() == want.tobytes()


def test_triplet_file_roundtrip_equals_jax(tmp_path):
    trips = np.random.default_rng(2).integers(0, 256, (37, 3, 729)).astype(
        np.uint8)
    paths = [str(tmp_path / f"{n}.bin") for n in ("jax", "torch")]
    jtriplets.save_triplets(trips, paths[0])
    ttriplets.save_triplets(trips, paths[1])
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(ttriplets.load_triplets(paths[0]), trips)
    with pytest.raises(ValueError):
        ttriplets.save_triplets(trips[:, :2], paths[1])
    with open(paths[1], "ab") as f:
        f.write(b"\0")
    with pytest.raises(IOError, match="2187"):
        ttriplets.load_triplets(paths[1])


def test_flo_roundtrip_equals_jax(tmp_path):
    u, v, _ = _flow_inputs(6, 17, 23)
    paths = [str(tmp_path / f"{n}.flo") for n in ("jax", "torch")]
    jflo.write_flo(paths[0], u, v)
    tflo.write_flo(paths[1], u, v)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    got_u, got_v = tflo.read_flo(paths[1])
    np.testing.assert_array_equal(got_u, u)
    np.testing.assert_array_equal(got_v, v)
    with open(paths[1], "r+b") as f:
        f.write(b"\0\0\0\0")
    with pytest.raises(IOError, match="tag"):
        tflo.read_flo(paths[1])


def test_decode_and_metrics_equal_jax():
    rng = np.random.default_rng(8)
    rgb = rng.integers(0, 256, (9, 11, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tdecode(rgb), jdecode(rgb))
    gt = rng.integers(0, 20, (30, 40))
    valid = rng.random((30, 40)) < 0.8
    sup = np.stack([rng.integers(0, 40, 200), rng.integers(0, 30, 200),
                    rng.integers(0, 20, 200)], axis=1)
    for tol in (0, 1.0, 3):
        assert (tmetrics.support_precision(sup, gt, valid, tol)
                == jmetrics.support_precision(sup, gt, valid, tol))
    assert tmetrics.support_precision(sup[:0], gt) == (0.0, 0)
    assert (tmetrics.support_pr_vs_reference(sup[:150], sup[50:])
            == jmetrics.support_pr_vs_reference(sup[:150], sup[50:]))


def _times_masked(text):
    return re.sub(r"[0-9.]+ s\b", "<s>", text)


@pytest.mark.parametrize("case", [
    ["--fern-type", "zero"],
    ["--fern-type", "tau", "--only-score-non-split", "--w1", "0.6"],
    ["--no-batch-ferns", "--checkpoint", "{ckpt}"],
], ids=["zero", "tau_nonsplit", "checkpoint"])
def test_cli_extract_then_train_equal_jax(sintel_tree, tmp_path, capsys,
                                          case):
    """``cli.extract`` then ``cli.train --device cpu`` write the same
    triplet file, forest file (and checkpoint) and log lines as the JAX
    CLIs with the same arguments."""
    from opengpc_tpu.cli.extract import main as jextract
    from opengpc_tpu.cli.train import main as jtrain
    from opengpc_tpu_torch.cli.extract import main as textract
    from opengpc_tpu_torch.cli.train import main as ttrain

    files, logs = {}, {}
    for name, extract, train, extra in (("jax", jextract, jtrain, []),
                                        ("torch", textract, ttrain,
                                         ["--device", "cpu"])):
        trips = str(tmp_path / f"{name}.bin")
        forest = str(tmp_path / f"{name}.txt")
        ckpt = str(tmp_path / f"{name}_ckpt.txt")
        assert extract([sintel_tree, trips, "--mode", "stereo",
                        "--triplets-per-pair", "90", "--radius-lower", "5",
                        "--radius-upper", "12", "--seed", "3"]) == 0
        args = [a.replace("{ckpt}", ckpt) for a in case]
        assert train([trips, forest, "--num-s", "1", "--num-m", "1",
                      "--num-l", "1", "--depth", "3", "--num-resamples", "4",
                      "--seed", "4"] + args + extra) == 0
        outs = [trips, forest] + ([ckpt] if "{ckpt}" in case else [])
        files[name] = []
        for path in outs:
            with open(path, "rb") as f:
                files[name].append(f.read())
        logs[name] = _times_masked(capsys.readouterr().out.replace(
            name, "<name>"))
    assert files["torch"] == files["jax"]
    assert logs["torch"] == logs["jax"]
    assert "Exported forest to" in logs["torch"]


def test_cli_extract_flow_equals_jax(sintel_tree, tmp_path):
    from opengpc_tpu.cli.extract import main as jextract
    from opengpc_tpu_torch.cli.extract import main as textract

    paths = [str(tmp_path / f"{n}.bin") for n in ("jax", "torch")]
    for main, path in zip((jextract, textract), paths):
        assert main([sintel_tree, path, "--triplets-per-pair", "40",
                     "--radius-lower", "6", "--radius-upper", "14",
                     "--num-scenes", "1", "--seed", "8"]) == 0
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        want = a.read()
        assert want and b.read() == want


def test_cli_train_errors(tmp_path, capsys):
    """``--data-parallel N`` (N > 1) outside a torchrun launch exits 1
    naming the launch; a file that is no triplet dataset exits 1 with one
    line."""
    from opengpc_tpu_torch.cli.train import main

    trips = str(tmp_path / "t.bin")
    ttriplets.save_triplets(np.zeros((4, 3, 729), np.uint8), trips)
    assert main([trips, str(tmp_path / "f.txt"), "--data-parallel", "2",
                 "--device", "cpu"]) == 1
    assert ("torchrun --nproc-per-node 2 -m opengpc_tpu_torch.cli.train"
            in capsys.readouterr().err)
    with open(trips, "ab") as f:
        f.write(b"\0")
    assert main([trips, str(tmp_path / "f.txt"), "--device", "cpu"]) == 1
    assert capsys.readouterr().err.startswith("error: ")
    assert not os.path.exists(tmp_path / "f.txt")


def test_cli_modules_run_as_scripts(sintel_tree, tmp_path):
    """``python -m opengpc_tpu_torch.cli.extract`` and ``... .cli.train``
    run as scripts."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    trips, forest = str(tmp_path / "t.bin"), str(tmp_path / "f.txt")
    for argv in (["opengpc_tpu_torch.cli.extract", sintel_tree, trips,
                  "--mode", "stereo", "--triplets-per-pair", "30"],
                 ["opengpc_tpu_torch.cli.train", trips, forest, "--num-s",
                  "1", "--num-m", "0", "--num-l", "0", "--depth", "2",
                  "--device", "cpu"]):
        proc = subprocess.run([sys.executable, "-m"] + argv, cwd=REPO,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0, proc.stderr
    with open(forest) as f:
        assert f.read().startswith("1\n0 s 2\n")
