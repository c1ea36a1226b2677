"""Fern-forest training of the PyTorch port against the JAX package.

The same seeded numpy triplets go through ``opengpc_tpu.train`` and
``opengpc_tpu_torch.train`` (``device="cpu"``): the level counts must be
equal exactly, the chosen splits and stats equal and equal to the C++
oracle's trainfern, and the exported forest text byte-identical.  The
quality gate trains through the port end to end (mine, train, match with
the port's one-call) and holds the fresh forest to the pretrained one on a
held-out scene.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opengpc_tpu.config as jconfig
import opengpc_tpu.forest as jforest
import opengpc_tpu.train as jtrain
import opengpc_tpu_torch.config as tconfig
import opengpc_tpu_torch.forest as tforest
import opengpc_tpu_torch.train as ttrain
from opengpc_tpu_torch.forest import SCALE_L, SCALE_M, SCALE_S
from opengpc_tpu_torch.io.triplets import save_triplets
from test_train import _oracle_train, make_triplets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAU_RANGES = {"zero": (0, 1), "tau": (-10, 10)}


def _flags(rng, *shape):
    return [rng.random(shape) < p for p in (0.7, 0.6, 0.8)]


@pytest.mark.parametrize("scale", [SCALE_S, SCALE_M, SCALE_L])
def test_sample_candidates_equal_jax(scale):
    want = jtrain.sample_candidates(np.random.default_rng(3), scale, 200)
    got = ttrain.sample_candidates(np.random.default_rng(3), scale, 200)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ferns", [1, 3], ids=["one_fern", "three_ferns"])
@pytest.mark.parametrize("kind", ["zero", "tau"])
def test_score_level_counts_equal_jax(kind, ferns):
    """The (R, T, 3) counts of one level, and of the same level of F = 3
    ferns, on random triplets with random prefix flags and exclusions."""
    rng = np.random.default_rng(20 + ferns)
    tau_lo, tau_hi = TAU_RANGES[kind]
    n, r = 257, 6
    trips = np.stack([make_triplets(rng, n) for _ in range(ferns)])
    cand = np.stack([jtrain.sample_candidates(rng, SCALE_L, r)
                     for _ in range(ferns)])
    ep, en, inc = _flags(rng, ferns, n)
    if ferns == 1:
        want = jtrain._score_level(
            jnp.asarray(trips[0]), jnp.asarray(cand[0]), jnp.int32(tau_lo),
            tau_hi - tau_lo, jnp.asarray(ep[0]), jnp.asarray(en[0]),
            jnp.asarray(inc[0]))
        got = ttrain._score_level(
            torch.from_numpy(trips[0]), cand[0], tau_lo, tau_hi - tau_lo,
            torch.from_numpy(ep[0]), torch.from_numpy(en[0]),
            torch.from_numpy(inc[0]))
    else:
        want = jtrain._score_level_ferns(
            jnp.asarray(trips), jnp.asarray(cand), jnp.int32(tau_lo),
            tau_hi - tau_lo, jnp.asarray(ep), jnp.asarray(en),
            jnp.asarray(inc))
        got = ttrain._score_level_ferns(
            torch.from_numpy(trips), cand, tau_lo, tau_hi - tau_lo,
            torch.from_numpy(ep), torch.from_numpy(en), torch.from_numpy(inc))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ferns", [1, 3], ids=["one_fern", "three_ferns"])
def test_level_fold_equal_jax(ferns):
    """The chosen split's fold, the split marks, the include count and the
    diagnostic counts equal JAX's, for one fern and for F = 3."""
    rng = np.random.default_rng(40 + ferns)
    n = 311
    trips = np.stack([make_triplets(rng, n) for _ in range(ferns)])
    i = rng.integers(0, 729, ferns)
    j = rng.integers(0, 729, ferns)
    tau = rng.integers(-10, 10, ferns)
    ep, en, sp = _flags(rng, ferns, n)
    sn = rng.random((ferns, n)) < 0.5
    t = [torch.from_numpy(a) for a in (ep, en, sp, sn)]
    if ferns == 1:
        want = jtrain._apply_level(
            jnp.asarray(trips[0]), jnp.int32(i[0]), jnp.int32(j[0]),
            jnp.int32(tau[0]), jnp.asarray(ep[0]), jnp.asarray(en[0]))
        got = ttrain._apply_level(torch.from_numpy(trips[0]), int(i[0]),
                                  int(j[0]), int(tau[0]), t[0][0], t[1][0])
        want_inc = jtrain._include_and_tot(jnp.asarray(sp[0]),
                                           jnp.asarray(sn[0]))
        got_inc = ttrain._include_and_tot(t[2][0], t[3][0])
        want_diag = jtrain._diag_counts(jnp.asarray(ep[0]), jnp.asarray(en[0]),
                                        jnp.ones((n,), bool))
        got_diag = ttrain._diag_counts(t[0][0], t[1][0],
                                       torch.ones((n,), dtype=torch.bool))
    else:
        want = jtrain._apply_level_ferns(
            jnp.asarray(trips), jnp.asarray(i, jnp.int32),
            jnp.asarray(j, jnp.int32), jnp.asarray(tau, jnp.int32),
            jnp.asarray(ep), jnp.asarray(en))
        got = ttrain._apply_level_ferns(torch.from_numpy(trips), i, j, tau,
                                        t[0], t[1])
        want_inc = jtrain._include_and_tot_ferns(jnp.asarray(sp),
                                                 jnp.asarray(sn))
        got_inc = ttrain._include_and_tot(t[2], t[3])
        want_diag = jtrain._diag_counts_ferns(
            jnp.asarray(ep), jnp.asarray(en), jnp.ones((ferns, n), bool))
        got_diag = ttrain._diag_counts(t[0], t[1], torch.ones(
            (ferns, n), dtype=torch.bool))
    want_marks = jtrain._mark_splits(*(jnp.asarray(a) for a in (sp, sn, ep, en)))
    got_marks = ttrain._mark_splits(t[2], t[3], t[0], t[1])
    for w, g in zip(list(want) + list(want_inc) + list(want_diag)
                    + list(want_marks),
                    list(got) + list(got_inc) + list(got_diag)
                    + list(got_marks)):
        np.testing.assert_array_equal(g.numpy().reshape(np.shape(w)),
                                      np.asarray(w))


@pytest.mark.parametrize("only_non_split", [False, True])
@pytest.mark.parametrize("kind", ["zero", "tau"])
def test_train_fern_equals_jax_and_oracle(oracle_path, tmp_path, kind,
                                          only_non_split):
    """Injected candidates: the port's fern and every level's stats equal
    JAX's, and the splits and counts equal the oracle's trainfern."""
    tau_lo, tau_hi = TAU_RANGES[kind]
    rng = np.random.default_rng(5 + tau_hi)
    n, depth, resamples = 300, 4, 6
    trips = make_triplets(rng, n)
    cands = [jtrain.sample_candidates(rng, SCALE_L, resamples)
             for _ in range(depth)]
    want_fern, want_stats = jtrain.train_fern(
        trips, SCALE_L,
        jconfig.OptimizerSettings(tau_lo, tau_hi, resamples, only_non_split,
                                  0.5),
        depth, candidates=cands, verbose=False)
    fern, stats = ttrain.train_fern(
        trips, SCALE_L,
        tconfig.OptimizerSettings(tau_lo, tau_hi, resamples, only_non_split,
                                  0.5),
        depth, candidates=cands, verbose=False, device="cpu")
    assert dataclasses.astuple(fern) == dataclasses.astuple(want_fern)
    assert ([dataclasses.astuple(s) for s in stats]
            == [dataclasses.astuple(s) for s in want_stats])

    oracle = _oracle_train(oracle_path, tmp_path, trips, cands, depth, tau_lo,
                           tau_hi, 0.5, only_non_split)
    for s, w in zip(stats, oracle):
        assert (s.i, s.j, s.tau) == (w["i"], w["j"], w["tau"])
        assert s.hmean == pytest.approx(w["score"], rel=1e-5)
        assert (s.tp, s.fp, s.fn, s.tot) == (w["tpx"], w["fpx"], w["fnx"],
                                             w["totx"])
        assert (s.tp_all, s.fp_all, s.fn_all) == (w["tp"], w["fp"], w["fn"])


@pytest.mark.parametrize("only_non_split", [False, True])
@pytest.mark.parametrize("batch_ferns", [False, True])
@pytest.mark.parametrize("kind", ["zero", "tau"])
def test_forest_text_equals_jax(kind, batch_ferns, only_non_split):
    trips = make_triplets(np.random.default_rng(11), 350)
    make = f"{kind}_optimizer"
    want = jtrain.train_forest(
        trips, jconfig.fern_factory(1, 1, 1, 3),
        getattr(jconfig, make)(num_resamples=4,
                               only_score_non_split_samples=only_non_split),
        seed=3, verbose=False, batch_ferns=batch_ferns)
    got = ttrain.train_forest(
        trips, tconfig.fern_factory(1, 1, 1, 3),
        getattr(tconfig, make)(num_resamples=4,
                               only_score_non_split_samples=only_non_split),
        seed=3, verbose=False, batch_ferns=batch_ferns, device="cpu")
    assert tforest.serialize_forest(got) == jforest.serialize_forest(want)


def test_verbose_log_equals_jax(capsys):
    """Both trainers print the same tables, line for line, apart from the
    seconds they took."""
    import re

    trips = make_triplets(np.random.default_rng(12), 200)
    logs = []
    for config, train, kw in ((jconfig, jtrain, {}),
                              (tconfig, ttrain, {"device": "cpu"})):
        for batch in (False, True):
            train.train_forest(trips, config.fern_factory(1, 0, 1, 2),
                               config.tau_optimizer(num_resamples=3), seed=4,
                               verbose=True, batch_ferns=batch, **kw)
        logs.append(re.sub(r"[0-9.]+ s\b", "<s>", capsys.readouterr().out))
    assert "level 2/2: all 2 ferns scored" in logs[1]
    assert logs[0] == logs[1]


def test_checkpoint_file_equals_jax(tmp_path):
    trips = make_triplets(np.random.default_rng(9), 150)
    paths = [str(tmp_path / f"{name}.txt") for name in ("jax", "torch")]
    want = jtrain.train_forest(trips, jconfig.fern_factory(1, 0, 1, 2),
                               jconfig.zero_optimizer(num_resamples=3), seed=1,
                               verbose=False, checkpoint_path=paths[0])
    got = ttrain.train_forest(trips, tconfig.fern_factory(1, 0, 1, 2),
                              tconfig.zero_optimizer(num_resamples=3), seed=1,
                              verbose=False, checkpoint_path=paths[1],
                              device="cpu")
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    assert tforest.load_forest(paths[1]) == got
    assert tforest.serialize_forest(got) == jforest.serialize_forest(want)


def test_batched_rejects_checkpoint(tmp_path):
    trips = make_triplets(np.random.default_rng(13), 120)
    for config, train, kw in ((jconfig, jtrain, {}),
                              (tconfig, ttrain, {"device": "cpu"})):
        with pytest.raises(ValueError, match="checkpoint"):
            train.train_forest(trips, config.fern_factory(1, 0, 0, 2),
                               config.zero_optimizer(num_resamples=3), seed=1,
                               verbose=False,
                               checkpoint_path=str(tmp_path / "c.txt"),
                               batch_ferns=True, **kw)


def test_batch_ferns_default_respects_bytes_cap(monkeypatch):
    """The default takes the batched trainer only while the (F, sub_n, 3,
    729) stack fits ``BATCH_FERNS_BYTES_CAP``; both paths give the same
    forest."""
    trips = make_triplets(np.random.default_rng(77), 80)
    settings = tconfig.fern_factory(1, 1, 0, 2)
    opt = tconfig.zero_optimizer(num_resamples=2)
    calls = []
    real = ttrain._train_forest_batched

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(ttrain, "_train_forest_batched", spy)
    stack_bytes = 2 * int(0.7 * 80) * 3 * 729
    monkeypatch.setattr(ttrain, "BATCH_FERNS_BYTES_CAP", stack_bytes - 1)
    seq = ttrain.train_forest(trips, settings, opt, seed=9, verbose=False,
                              device="cpu")
    assert calls == []
    monkeypatch.setattr(ttrain, "BATCH_FERNS_BYTES_CAP", stack_bytes)
    bat = ttrain.train_forest(trips, settings, opt, seed=9, verbose=False,
                              device="cpu")
    assert calls == [1]
    assert tforest.serialize_forest(seq) == tforest.serialize_forest(bat)


@pytest.mark.parametrize("kind", ["zero", "tau"])
def test_trained_forest_quality_vs_pretrained(kind):
    """Mine, train and match through the port on the CPU: the fresh
    forest matches a held-out multi-plane scene about as well as the
    pretrained forest (coverage within 10 %, exact-disparity precision
    within 1 %)."""
    from opengpc_tpu_torch import InferenceSettings, load_forest, sparsematch
    from opengpc_tpu_torch.metrics import support_precision
    from opengpc_tpu_torch.mine import extract_triplets, mine_stereo_pair
    from opengpc_tpu_torch.utils.scenes import make_scene

    seeds = {"zero": (5, 1, 77), "tau": (15, 2, 78)}[kind]
    rng = np.random.default_rng(seeds[0])
    h, w = 240, 480
    left, right, gt, occ = make_scene(rng, h, w)
    kl, kr, kn = mine_stereo_pair(gt, occ, np.zeros((h, w), np.uint8),
                                  2500, 10, 25, rng)
    trips = extract_triplets(left, right, kl, kr, kn)
    assert len(trips) >= 2000
    make = f"{kind}_optimizer"
    fresh = ttrain.train_forest(trips, tconfig.fern_factory(2, 2, 2, 5),
                                getattr(tconfig, make)(), seed=seeds[1],
                                verbose=False, device="cpu")
    if kind == "tau":
        assert any(t.tau != 0 for f in fresh.ferns for t in f.tests)

    l2, r2, gt2, occ2 = make_scene(np.random.default_rng(seeds[2]), h, w)
    settings = InferenceSettings(gradient_threshold=5, vertical_tolerance=0,
                                 disp_high=32, epipolar_mode=True,
                                 capacity=1 << 17)
    name = "defaultZeroForest" if kind == "zero" else "defaultTauForest"
    pre = load_forest(os.path.join(REPO, "forests", name + ".txt"))
    results = {}
    for key, forest in (("fresh", fresh), ("pretrained", pre)):
        supp = sparsematch(l2, r2, forest, settings, device="cpu")
        prec, _ = support_precision(supp, gt2, valid=(occ2 == 0), tol=0)
        results[key] = (len(supp), prec)
    (n_fresh, p_fresh), (n_pre, p_pre) = results["fresh"], results["pretrained"]
    assert n_pre > 10000
    assert n_fresh >= 0.9 * n_pre, (n_fresh, n_pre)
    assert p_fresh >= p_pre - 0.01, (p_fresh, p_pre)


@pytest.mark.parametrize("entry", ["train_forest", "train_fern",
                                   "extract_triplets_device", "cli.train"])
def test_entry_points_need_the_card_by_default(entry, tmp_path):
    """Without a usable CUDA device the default ``device="cuda"`` (and the
    CLI without ``--device``) raises instead of quietly running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    from opengpc_tpu_torch.cli.train import main
    from opengpc_tpu_torch.mine import extract_triplets_device

    trips = make_triplets(np.random.default_rng(1), 40)
    path = str(tmp_path / "t.bin")
    calls = {
        "train_forest": lambda: ttrain.train_forest(
            trips, tconfig.fern_factory(1, 0, 0, 1),
            tconfig.zero_optimizer(num_resamples=2), verbose=False),
        "train_fern": lambda: ttrain.train_fern(
            trips, SCALE_S, tconfig.zero_optimizer(num_resamples=2), 1,
            rng=np.random.default_rng(0), verbose=False),
        "extract_triplets_device": lambda: extract_triplets_device(
            np.zeros((64, 64), np.uint8), np.zeros((64, 64), np.uint8),
            *[np.full((1, 2), 30)] * 3),
        "cli.train": lambda: (save_triplets(trips, path),
                              main([path, str(tmp_path / "f.txt")])),
    }
    with pytest.raises((RuntimeError, AssertionError)):
        calls[entry]()
    assert not os.path.exists(tmp_path / "f.txt")


@pytest.mark.parametrize("max_tests", [1, 4, 5, 9, 40])
def test_truncate_forest_and_patch_index_equal_jax(max_tests):
    """``truncate_forest`` keeps the same file-order prefix as JAX's (the
    boundary fern cut level-wise), and ``patch_linear_index`` addresses
    the same training-patch byte."""
    with open(os.path.join(REPO, "forests", "defaultTauForest.txt")) as f:
        text = f.read()
    want = jforest.truncate_forest(jforest.parse_forest(text), max_tests)
    got = tforest.truncate_forest(tforest.parse_forest(text), max_tests)
    assert tforest.serialize_forest(got) == jforest.serialize_forest(want)
    for ix, iy in ((-13, -13), (0, 0), (5, -7), (13, 13)):
        assert (tforest.patch_linear_index(ix, iy)
                == jforest.patch_linear_index(ix, iy))
    assert tforest.PATCH == jforest.PATCH
    assert tforest.SCALE_HALF == jforest.SCALE_HALF
