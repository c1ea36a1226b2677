"""With the timed path broken underneath, a run's ``correct`` comes out
false: once for each fault a cell can have.  The runs go through the
harness on the CPU at a small size, past its look for a card; the
four-rank fault runs four gloo ranks.  The controls of
``gpcbench.check`` fail the comparison at the same size."""

import json
import sys
import time

import numpy as np
import pytest
import torch

from gpcbench import cell, check, generator, registry
from gpcbench.reference import gpc

BENCH = registry.benchmark()
# the four-card cell's pieces (not a cell of BENCHMARK.json yet)
FOUR = "uhd4k_rows4_b4"
FOUR_CFG, FOUR_TRAFFIC = "uhd4k-epipolar", "b4_inflight2_rows4_card"


def _run(cell_name, h=96, w=256, seed=2**32 + 77, **traffic):
    d = registry.cell(BENCH, cell_name)
    cfg = registry.config(d["config"])
    cfg.update(height=h, width=w)
    tr = registry.traffic(d["traffic"])
    tr.update(traffic)
    return cell.run(cell_name, cfg, tr, seed, 0.5, False, "cpu", cell.One(),
                    cell.Split(), time.perf_counter(), BENCH)[0]


CELLS = [("sintel_b32_card", dict(batch=4, pool_pairs=8)),
         ("uhd4k_b1_card", dict(pool_pairs=3))]


@pytest.fixture
def masked_run(monkeypatch):
    from opengpc_tpu_torch import infer
    return monkeypatch, infer.SparsematchMasked


@pytest.mark.parametrize("cell_name,traffic", CELLS)
def test_sound_run_is_correct(cell_name, traffic):
    assert _run(cell_name, **traffic)["correct"] is True


@pytest.mark.parametrize("cell_name,traffic", CELLS)
def test_state_returned_unchanged(masked_run, cell_name, traffic):
    monkeypatch, cls = masked_run
    run, first = cls._run, []

    def stale(self, left, right):
        if not first:
            first.append(run(self, left, right))
        return first[0]

    monkeypatch.setattr(cls, "_run", stale)
    assert _run(cell_name, **traffic)["correct"] is False


def test_half_of_the_batch_left_out(masked_run):
    monkeypatch, cls = masked_run
    run = cls._run

    def half(self, left, right):
        k = left.shape[0] // 2
        buf, counts = run(self, left[:k], right[:k])
        pad = torch.full((left.shape[0] - k,) + buf.shape[1:], check.SENTINEL,
                         dtype=buf.dtype)
        return (torch.cat([buf, pad]),
                torch.cat([counts, torch.zeros_like(counts)]))

    monkeypatch.setattr(cls, "_run", half)
    res = _run("sintel_b32_card", batch=4, pool_pairs=8)
    assert res["correct"] is False and res["failed"] > 0


@pytest.mark.parametrize("cell_name,traffic", CELLS)
def test_answer_altered_where_produced(monkeypatch, cell_name, traffic):
    from opengpc_tpu_torch import match
    emit = match._masked_emit

    def altered(keep, src_x, d, w, disp_high):
        d = d.clone()
        d.view(-1)[int(torch.nonzero(keep.view(-1))[0])] += 1
        return emit(keep, src_x, d, w, disp_high)

    monkeypatch.setattr(match, "_masked_emit", altered)
    res = _run(cell_name, **traffic)
    assert res["correct"] is False
    assert res["checks"]["support_mismatches"]["value"] > 0


def test_row_count_altered_where_produced(monkeypatch):
    from opengpc_tpu_torch import match
    emit = match._masked_emit

    def altered(keep, src_x, d, w, disp_high):
        out, counts = emit(keep, src_x, d, w, disp_high)
        counts = counts.clone()
        counts[int(torch.argmax(counts))] -= 1
        return out, counts

    monkeypatch.setattr(match, "_masked_emit", altered)
    res = _run("sintel_b32_card", batch=4, pool_pairs=8)
    assert res["correct"] is False
    assert res["checks"]["row_count_mismatches"]["value"] > 0
    assert res["checks"]["support_mismatches"]["value"] == 0


def _rank(fault: str) -> None:
    """One gloo rank of the four-card cell at a small size, run by
    ``test_exchange_between_chips_left_out``."""
    torch.set_num_threads(1)
    if fault == "halo":
        from opengpc_tpu_torch.ops.fused import PAD
        from opengpc_tpu_torch.parallel import frame

        def no_exchange(x, group, rank, n):
            z = torch.zeros_like(x[..., :PAD, :])
            return z, z.clone()

        frame.exchange_halos = no_exchange
    cfg = registry.config(FOUR_CFG)
    cfg.update(height=112, width=256)
    tr = registry.traffic(FOUR_TRAFFIC)
    tr.update(batch=4, pool_pairs=8)
    ranks = cell.Ranks("cpu")
    res, bad = cell.run(FOUR, cfg, tr, 5, 0.5, False, "cpu",
                        ranks, cell.Split(), time.perf_counter(), BENCH)
    ranks.close()
    if res is not None:
        print(json.dumps(res), flush=True)


def _four_ranks(fault: str, monkeypatch) -> dict:
    """Four gloo ranks started by the harness's own launcher."""
    from gpcbench.run import launch
    monkeypatch.chdir(registry.ROOT)
    monkeypatch.setenv("PYTHONPATH", registry.ROOT)
    rc, out = launch("gpcbench.test_gpcbench_faults", [fault], 4, 240)
    assert rc == 0
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("fault,correct", [("none", True), ("halo", False)])
def test_exchange_between_chips_left_out(fault, correct, monkeypatch):
    res = _four_ranks(fault, monkeypatch)
    assert res["correct"] is correct and res["device"]["count"] == 4


@pytest.mark.parametrize("kind", ["drop_test", "first_of_runs"])
@pytest.mark.parametrize("h,w,bsz", [(96, 256, 4), (112, 700, 1)])
def test_controls_fail(kind, h, w, bsz):
    cfg = registry.config("uhd4k-epipolar")
    tests = gpc.parse_forest(open(cfg["forest_path"]).read())
    lefts, rights, _ = generator.make_pool(123, bsz, h, w, 0.15, (8, 128))
    lefts, rights = lefts.numpy(), rights.numpy()
    buf, counts = check.control_outputs(lefts, rights, tests, cfg, kind)
    readings = check.compare(buf, counts, lefts, rights, tests, cfg)
    assert not check.verdict(readings, bsz)
    assert readings["support_mismatches"] > 0
    # the layout the control writes is read back as it was meant
    ref = gpc.epipolar_supports(lefts, rights, tests, 5, 128)
    ok = check.compare(*_layout(ref, bsz, h, w), lefts, rights, tests, cfg)
    assert check.verdict(ok, bsz)


def _layout(sup, bsz, h, w):
    b, y, x, d = sup
    buf = np.full((bsz, h, 2 * w), check.SENTINEL, np.int32)
    row = b * h + y
    col = np.arange(len(b)) - np.searchsorted(row, row)
    buf[b, y, col] = (x << 9) | (d + 128)
    counts = np.bincount(row, minlength=bsz * h).reshape(bsz, h)
    return buf, counts.astype(np.int32)


if __name__ == "__main__":
    # ``python -m gpcbench.test_gpcbench_faults --rank-worker FAULT``: one
    # rank of ``test_exchange_between_chips_left_out``
    _rank(sys.argv[-1])
