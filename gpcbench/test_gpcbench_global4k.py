"""The cell ``uhd4k_global_b1_card`` on the CPU: its configuration is the
library's default settings at 4K, which the port routes to global-rows,
and a run of its traffic at a small frame is correct, traced and untraced,
and reports its readers; a program without the global stage spans reads
none of them."""

import io
import json
import time
import types

import pytest

from gpcbench import cell, port, registry, spans
from gpcbench.test_gpcbench_harness import BENCH, small

CELL = "uhd4k_global_b1_card"
STAGES = ("gsort", "gdetect", "gpack")


def test_the_configuration_is_the_library_defaults_at_4k():
    from opengpc_tpu_torch.config import InferenceSettings
    from opengpc_tpu_torch.forest import load_forest, make_filter_mask
    from opengpc_tpu_torch.infer import route
    d = registry.cell(BENCH, CELL)
    cfg = registry.config(d["config"])
    assert (cfg["height"], cfg["width"]) == (2160, 3840)
    assert port.settings(cfg) == InferenceSettings()
    mask = make_filter_mask(load_forest(cfg["forest_path"]))
    assert route(mask, (2160, 3840), port.settings(cfg)) == "global-rows"
    tr = registry.traffic(d["traffic"])
    assert (tr["entry"], tr["batch"], tr["in_flight"]) == ("global_rows", 1, 1)
    assert tr["vertical"] == [-2, 2]


def test_a_small_run_is_correct_and_reports_frame_ms():
    cfg, tr = small(CELL, h=120, w=320)
    res, _ = cell.run(CELL, cfg, tr, 2**33 + 5, 0.5, False, "cpu",
                      cell.One(), cell.Split(), time.perf_counter(), BENCH)
    assert res["correct"] and res["failed"] == 0
    assert set(res["metrics"]) == {"frame_ms.p95", "setup_s"}


def test_a_traced_small_run_spans_every_stage():
    cfg, tr = small(CELL, h=120, w=320)
    log = io.StringIO()
    res, _ = cell.run(CELL, cfg, tr, 2**31 + 11, 0.5, True, "cpu",
                      cell.One(), cell.Split(), time.perf_counter(), BENCH,
                      log=log)
    assert res["correct"]
    (s,) = [json.loads(ln.split(" ", 1)[1])
            for ln in log.getvalue().splitlines()
            if ln.startswith("trace_summary ")]
    table = spans.per_call(s)
    for name in ("ogpc.forward", "ogpc.keys", "ogpc.fold") + tuple(
            f"ogpc.{n}" for n in STAGES):
        assert table[name]["calls"] == 1, name
    # the CPU launches nothing: the stage readers read 0, the device's
    # readers nothing
    for n in STAGES:
        assert res["metrics"][f"{n}_ms.per_pair.global4k"]["value"] == 0
    assert res["metrics"]["launches.per_call.global4k"]["value"] == 0
    assert res["metrics"]["enqueue_ms.per_call.global4k"]["value"] > 0
    assert not {"match_ms.per_pair.global4k", "idle_share.global4k",
                "fused_keys_global4k_roofline.b1"} & set(res["metrics"])
    # no reader of another cell reaches this one
    assert all(k.endswith(("global4k", "global4k_roofline.b1"))
               for k in res["metrics"])


@pytest.mark.parametrize("name", [f"{n}_ms.per_pair.global4k"
                                  for n in STAGES])
def test_stage_readers_are_none_without_the_global_spans(name):
    read = registry.metric(name).read
    table = {"ogpc.forward": {}, "ogpc.sort": {"device_s": 1.0}}
    ctx = types.SimpleNamespace(ranks=[{"spans": table, "pairs": 1}])
    assert read(ctx) is None
    assert read(types.SimpleNamespace(ranks=None)) is None
