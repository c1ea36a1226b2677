"""The port's stage spans (``utils.timing.span``): under a torch profiler
each matcher call emits its ``ogpc.*`` ranges once, nested in the order the
stages run; with no profiler no range is entered and the outputs are the
same; an exported program holds no profiler op."""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import opengpc_tpu_torch as pt
from opengpc_tpu_torch.parallel import (
    _run_in_one_process, build_batched_sharded_frame_sparsematch,
    build_sharded_frame_sparsematch)
from opengpc_tpu_torch.utils import make_pair
from opengpc_tpu_torch.utils.timing import span

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZERO = os.path.join(REPO, "forests", "defaultZeroForest.txt")
H, W = 72, 200
MASKED_STAGES = ["ogpc.keys", "ogpc.fold", "ogpc.sort", "ogpc.detect",
                 "ogpc.emit", "ogpc.unfold"]


def mask_and_settings(epipolar=True):
    return (pt.make_filter_mask(pt.load_forest(ZERO), 32),
            pt.InferenceSettings(gradient_threshold=5, disp_high=64,
                                 epipolar_mode=epipolar))


def images(batch=None):
    pairs = [make_pair(H, W, 9, seed=s) for s in range(batch or 1)]
    left, right = (torch.from_numpy(np.stack(x)) for x in zip(*pairs))
    return (left, right) if batch else (left[0], right[0])


def traced(fn):
    """fn's result and its ``ogpc.*`` ranges as (start ns, end ns, name),
    outermost first where two start together."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    found = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("ogpc.")]
    return out, sorted(found, key=lambda s: (s[0], -s[1]))


def names(spans):
    return [n for _, _, n in spans]


def assert_inside(spans, outer):
    s0, e0, _ = outer
    assert all(s0 <= s and e <= e0 for s, e, _ in spans)


def assert_in_turn(spans):
    """Each range ends before the next starts."""
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("batch", [None, 3], ids=["pair", "batch3"])
def test_masked_forward_spans_nest_in_stage_order(batch):
    mask, settings = mask_and_settings()
    mod = pt.build_sparsematch_masked(mask, settings, device="cpu")
    left, right = images(batch)
    out, spans = traced(lambda: mod(left, right))
    assert names(spans) == ["ogpc.forward"] + MASKED_STAGES
    assert_inside(spans[1:], spans[0])
    assert_in_turn(spans[1:])
    assert out[1].sum() > 0


def test_a_span_is_an_op_event_not_a_user_annotation():
    # the profiler copies a user annotation onto the device's timeline,
    # where a reader without activity types takes it for a kernel
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("ogpc.sort"):
            torch.ones(4).add_(1)
    found = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "ogpc.sort"]
    assert len(found) == 1 and not found[0].is_user_annotation()


def test_no_profiler_enters_no_range(monkeypatch):
    mask, settings = mask_and_settings()
    mod = pt.build_sparsematch_masked(mask, settings, device="cpu")
    left, right = images(2)
    (want_buf, want_counts), spans = traced(lambda: mod(left, right))
    assert spans

    def refuse(name):
        raise AssertionError(f"a range {name!r} with no profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert span("ogpc.sort") is span("ogpc.emit")
    buf, counts = mod(left, right)
    assert torch.equal(buf, want_buf) and torch.equal(counts, want_counts)


def test_export_under_a_profiler_holds_no_profiler_op(monkeypatch):
    mask, settings = mask_and_settings()
    mod = pt.build_sparsematch_masked(mask, settings, device="cpu")
    left, right = images()
    real = torch._C._profiler._RecordFunctionFast
    entered = []

    def record(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", record)
    with profile(activities=[ProfilerActivity.CPU]):
        program = torch.export.export(mod, (left, right), strict=False)
    assert entered == []
    targets = [str(n.target) for n in program.graph.nodes]
    assert not [t for t in targets if "profiler" in t]
    buf, counts = program.module()(left, right)
    want_buf, want_counts = mod(left, right)
    assert torch.equal(buf, want_buf) and torch.equal(counts, want_counts)


def test_one_process_batched_shards_span_each_shard():
    mask, settings = mask_and_settings()
    mod = build_batched_sharded_frame_sparsematch(mask, settings,
                                                  device="cpu")
    left, right = images(2)
    grid = (2, 2)  # two frame groups of two row shards: four shards
    out, spans = traced(lambda: _run_in_one_process(mod, left, right, grid))
    per_shard = ["ogpc.keys", "ogpc.sort", "ogpc.detect", "ogpc.emit",
                 "ogpc.unfold"]
    assert names(spans) == per_shard * 4
    assert_in_turn(spans)
    whole = pt.build_sparsematch_masked(mask, settings, device="cpu")(left,
                                                                       right)
    assert torch.equal(out[0], whole[0]) and torch.equal(out[1], whole[1])


@pytest.mark.parametrize("batched", [False, True], ids=["frame", "batched"])
def test_sharded_forward_spans_its_halos(batched):
    mask, settings = mask_and_settings()
    if batched:
        mod = build_batched_sharded_frame_sparsematch(mask, settings,
                                                      device="cpu")
        left, right = images(2)
        tail = ["ogpc.sort", "ogpc.detect", "ogpc.emit", "ogpc.unfold"]
    else:
        mod = build_sharded_frame_sparsematch(mask, settings, device="cpu")
        left, right = images()
        tail = ["ogpc.sort", "ogpc.detect", "ogpc.emit"]
    _, spans = traced(lambda: mod(left, right))
    assert names(spans) == ["ogpc.forward", "ogpc.halo", "ogpc.keys"] + tail
    assert_inside(spans[1:], spans[0])
    assert_in_turn(spans[1:])


@pytest.mark.parametrize("build,epipolar", [
    ("build_sparsematch_masked", True),
    ("build_sparsematch_rows", True),
    ("build_sparsematch_masked_compact", True),
    ("build_sparsematch", True),
    ("build_sparsematch_global_rows", False),
    ("build_sparsematch_global_compact", False),
    ("build_stereomatch", False),
])
def test_every_matcher_spans_one_forward_a_call(build, epipolar):
    mask, settings = mask_and_settings(epipolar)
    mod = getattr(pt, build)(mask, settings, device="cpu")
    left, right = images()
    _, spans = traced(lambda: (mod(left, right), mod(left, right)))
    forwards = [s for s in spans if s[2] == "ogpc.forward"]
    assert len(forwards) == 2
    assert_in_turn(forwards)
    for s, e, _ in spans:
        assert any(f[0] <= s and e <= f[1] for f in forwards)
