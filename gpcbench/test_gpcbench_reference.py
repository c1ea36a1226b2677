"""The plain reference against the port's CPU path, on small frames of each
shape class the cells drive: a batch folded into one row sort, one pair
with wide rows and disparities up to dispHigh, and a batch of frames whose
rows are split over four shards."""

import os

import numpy as np
import pytest

from gpcbench import check, generator, port, registry
from gpcbench.reference import gpc

CFG = registry.config("sintel-epipolar")
FORESTS = {
    "zero": CFG["forest_path"],
    "tau": os.path.join(registry.ROOT, "forests", "defaultTauForest.txt"),
}
SEEDS = [5, 2**33 + 1, 987654321]


def _tests(path):
    with open(path) as f:
        return gpc.parse_forest(f.read())


def _port_masked(lefts, rights, forest, cfg=CFG):
    from opengpc_tpu_torch.forest import load_forest
    from opengpc_tpu_torch.infer import build_sparsematch_masked
    mod = build_sparsematch_masked(load_forest(forest), port.settings(cfg),
                                   device="cpu")
    buf, counts = mod(lefts, rights)
    return buf.numpy(), counts.numpy()


def _port_rows4(lefts, rights, forest, cfg=CFG):
    from opengpc_tpu_torch.forest import load_forest
    from opengpc_tpu_torch.parallel import _run_in_one_process
    from opengpc_tpu_torch.parallel.frame import \
        build_batched_sharded_frame_sparsematch
    mod = build_batched_sharded_frame_sparsematch(
        load_forest(forest), port.settings(cfg), contract="masked",
        device="cpu")
    buf, counts = _run_in_one_process(mod, lefts, rights, (1, 4))
    return buf.numpy(), counts.numpy()


def _assert_equal(buf, counts, lefts, rights, forest):
    tests = _tests(forest)
    r = check.compare(buf, counts, lefts.numpy(), rights.numpy(), tests, CFG)
    assert r["supports"] > 0
    assert (r["support_mismatches"], r["row_count_mismatches"],
            r["failed_pairs"]) == (0, 0, 0)


@pytest.mark.parametrize("forest", sorted(FORESTS))
@pytest.mark.parametrize("seed", SEEDS)
def test_batch_folded(seed, forest):
    lefts, rights, _ = generator.make_pool(seed, 4, 64, 256, 0.15, (4, 96))
    _assert_equal(*_port_masked(lefts, rights, FORESTS[forest]), lefts,
                  rights, FORESTS[forest])


@pytest.mark.parametrize("seed", SEEDS)
def test_one_wide_pair(seed):
    lefts, rights, _ = generator.make_pool(seed, 1, 72, 700, 0.3, (8, 128))
    _assert_equal(*_port_masked(lefts, rights, FORESTS["zero"]), lefts,
                  rights, FORESTS["zero"])


@pytest.mark.parametrize("seed", SEEDS)
def test_rows_over_four_shards(seed):
    lefts, rights, _ = generator.make_pool(seed, 4, 112, 256, 0.15, (8, 128))
    _assert_equal(*_port_rows4(lefts, rights, FORESTS["zero"]), lefts,
                  rights, FORESTS["zero"])


def test_true_disparity_dominates():
    lefts, rights, ds = generator.make_pool(17, 3, 96, 384, 0.15, (4, 96))
    b, _, _, d = gpc.epipolar_supports(lefts.numpy(), rights.numpy(),
                                       _tests(FORESTS["zero"]), 5, 128)
    assert np.mean(d == ds.numpy()[b]) > 0.99


@pytest.mark.parametrize("forest", sorted(FORESTS))
def test_forest_parser_matches_the_port(forest):
    from opengpc_tpu_torch.forest import load_forest, make_filter_mask
    mask = make_filter_mask(load_forest(FORESTS[forest]))
    t = _tests(FORESTS[forest])
    assert np.array_equal(t[:, [1, 0]], mask.i_off)
    assert np.array_equal(t[:, [3, 2]], mask.j_off)
    assert np.array_equal(t[:, 4], mask.tau)


def test_box_and_gradient_match_the_port():
    from opengpc_tpu_torch.ops.preprocess import box3, candidate_mask, sobel3
    img, _, _ = generator.make_pool(23, 1, 50, 90, 0.4, (4, 8))
    img = img[0]
    assert np.array_equal(gpc.box3(img.numpy()), box3(img).numpy())
    assert np.array_equal(gpc.candidates(img.numpy(), 5),
                          candidate_mask(sobel3(img, 5)).numpy())


def test_codes_match_the_port():
    from opengpc_tpu_torch.forest import load_forest, make_filter_mask
    from opengpc_tpu_torch.ops.codes import leaf_codes
    from opengpc_tpu_torch.ops.preprocess import box3
    img, _, _ = generator.make_pool(29, 1, 60, 120, 0.4, (4, 8))
    mask = make_filter_mask(load_forest(FORESTS["tau"]))
    want = leaf_codes(box3(img[0]), mask).numpy()
    idx = np.nonzero(gpc.candidates(img.numpy(), 5))
    got = gpc.codes_at(img.numpy(), _tests(FORESTS["tau"]), idx)
    assert len(got) > 0
    assert np.array_equal(got, want[idx[1], idx[2]].astype(np.int64))
