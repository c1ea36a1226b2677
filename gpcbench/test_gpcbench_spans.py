"""The program's spans in a traced window (``trace.summarize_spans``, read
by ``gpcbench.spans``): each device activity and idle gap charged to the
innermost span, self host time, the readers, the table in
``trace.reduce``'s summary and the rest of the summary unchanged by the
spans."""

import io
import json
import time
import types

import pytest

from gpcbench import cell, spans, trace
from gpcbench.test_gpcbench_harness import Ev, OldEv, _events, small


def _with_spans(cls=Ev):
    """The harness test's window with the program's nested spans (op
    events) in its ``enqueue``: ``ogpc.forward`` around ``ogpc.keys``
    (which holds the key op), ``ogpc.sort`` (the radix sort's launch) and
    ``ogpc.emit`` (the copy's), and a device-side copy of the sort's range,
    which is no kernel."""
    op = "cpu_op"
    return _events(cls) + [
        cls(op, "ogpc.forward", 12, 86), cls(op, "ogpc.keys", 18, 24),
        cls(op, "ogpc.sort", 45, 13), cls(op, "ogpc.emit", 59, 11),
        cls("gpu_user_annotation", "ogpc.sort", 600, 250, 0, True)]


def _ns(x):
    return pytest.approx(x * 1e-9)


@pytest.mark.parametrize("cls", [Ev, OldEv])
def test_innermost_span_takes_each_activity_and_gap(cls):
    table = trace.summarize_spans(_with_spans(cls))
    assert set(table) == {"ogpc.forward", "ogpc.keys", "ogpc.sort",
                          "ogpc.emit"}
    fwd, keys, sort, emit = (table[f"ogpc.{n}"]
                             for n in ("forward", "keys", "sort", "emit"))
    assert [t["calls"] for t in table.values()] == [1] * 4
    assert fwd["host_s"] == _ns(86) and fwd["self_host_s"] == _ns(86 - 48)
    assert sort["self_host_s"] == sort["host_s"] == _ns(13)
    # the copy kernel was launched in forward before keys began; the key
    # kernel has no launch to link; the consume's reduce is outside
    assert fwd["device_s"] == _ns(50) and fwd["launches"] == 1
    assert keys["device_s"] == 0 and keys["launches"] == 0
    assert sort["device_s"] == _ns(300) and sort["launches"] == 1
    assert emit["device_s"] == _ns(50) and emit["launches"] == 1
    assert fwd["all_launches"] == 3 and sort["all_launches"] == 1
    # the window's first gap (0, 100) has its middle in the sort's span
    assert sort["idle_s"] == _ns(100)
    assert sum(t["idle_s"] for t in table.values()) == _ns(100)


@pytest.mark.parametrize("cls", [Ev, OldEv])
def test_reduce_is_unchanged_by_the_spans(cls):
    want, got = trace.reduce(_events(cls)), trace.reduce(_with_spans(cls))
    assert want.keys() == got.keys()
    for k in want:
        if k not in ("kinds", "spans"):
            assert got[k] == want[k], k
    assert got["kinds"]["cpu_op"] == want["kinds"]["cpu_op"] + 4
    assert want["spans"] == {}
    assert got["spans"] == trace.summarize_spans(_with_spans(cls))


def test_a_child_past_its_parent_is_cut():
    pieces, parent = trace._pieces([(0, 10), (2, 4), (6, 12), (20, 30)])
    assert pieces == [(0, 2, 0), (2, 4, 1), (4, 6, 0), (6, 10, 2),
                      (20, 30, 3)]
    assert parent == [None, 0, 0, None]


def _ctx(summaries):
    return types.SimpleNamespace(ranks=summaries)


def test_readers_read_the_spans():
    s = dict(trace.reduce(_with_spans()), pairs=4)
    ctx = _ctx([s])
    assert spans.sort_ms(ctx) == pytest.approx(300e-9 * 1e3 / 4)
    assert spans.emit_ms(ctx) == pytest.approx(50e-9 * 1e3 / 4)
    # stages the program did not mark have nothing to read
    assert spans.detect_ms(ctx) is None and spans.fold_ms(ctx) is None
    assert spans.launches_per_call(ctx) == 3
    # two ranks: device ms add up, launches a call are their mean
    assert spans.sort_ms(_ctx([s, s])) == 2 * spans.sort_ms(ctx)
    assert spans.launches_per_call(_ctx([s, s])) == 3


@pytest.mark.parametrize("name", sorted(spans.READERS))
def test_readers_are_none_without_program_spans(name):
    read = spans.READERS[name]
    bare = dict(trace.reduce(_events()), pairs=4)
    assert read(_ctx([bare])) is None
    assert bare["spans"] == {}
    assert read(_ctx([dict(bare, spans=None)])) is None
    assert read(_ctx(None)) is None


def test_a_traced_run_on_the_cpu_spans_every_call():
    cfg, tr = small("sintel_b32_card", batch=4, pool_pairs=8)
    log = io.StringIO()
    res, _ = cell.run("sintel_b32_card", cfg, tr, 2**33 + 5, 0.5, True,
                      "cpu", cell.One(), cell.Split(), time.perf_counter(),
                      cell.registry.benchmark(), log=log)
    assert res["correct"]
    (s,) = [json.loads(ln.split(" ", 1)[1])
            for ln in log.getvalue().splitlines()
            if ln.startswith("trace_summary ")]
    # the readers reach the result line
    assert {f"{n}.batch" for n in spans.READERS} <= set(res["metrics"])
    calls = s["calls"]
    assert calls > 0
    table = spans.per_call(s)
    for name in ("ogpc.forward", "ogpc.keys", "ogpc.fold", "ogpc.sort",
                 "ogpc.detect", "ogpc.emit", "ogpc.unfold"):
        assert table[name]["calls"] == 1, name
        assert table[name]["host_ms"] > 0
    # the stages run inside forward, which runs inside enqueue
    stages = sum(t["host_ms"] for n, t in table.items()
                 if n != "ogpc.forward")
    fwd = table["ogpc.forward"]
    assert fwd["self_host_ms"] == pytest.approx(fwd["host_ms"] - stages)
    assert fwd["host_ms"] <= res["metrics"]["enqueue_ms.per_call.batch"][
        "value"]
