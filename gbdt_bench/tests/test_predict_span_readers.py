"""The readers of the port's ``predict`` spans (``metrics/predict_*``) on
synthetic readings: each gives its value, nothing for a training reading,
and nothing where the port records no such span or reading (a program
without the phase spans); their entries keep to BENCHMARK.json's shape.

    python -m pytest gbdt_bench/tests -q
"""

import json

import pytest

from gbdt_bench.harness.registry import Registry
from gbdt_bench.tests.test_gbdt_bench_harness import (
    ROOT, test_benchmark_json_keeps_to_its_shape)

NEW = {"predict_rows_host_ms_per_call": 7.0, "predict_stage_host_ms_per_call": 1.5,
       "predict_walk_device_ms_per_call": 48.0, "predict_sum_device_ms_per_call": 6.0,
       "predict_walk_useful_share": 0.625}


def _call(walk_ms, sum_ms, steps, useful):
    return {"name": "predict.predict", "dur": 0.1,
            "attrs": {"rows": 10, "bucket": 16, "warm": True, "walk_device_ms": walk_ms,
                      "sum_device_ms": sum_ms, "finish_device_ms": 0.5,
                      "walk_steps": steps, "walk_useful_steps": useful,
                      "walk_useful_share": useful / steps}}


def _readings(spans, kind="predict"):
    return {"kind": kind, "calls": 2, "stretch": {"busy_s": 1.0, "window_s": 1.2},
            "port_spans": {"stretch": spans}}


SPANS = [{"name": "predict.rows", "dur": 0.006, "attrs": {}},
         {"name": "predict.stage", "dur": 0.001, "attrs": {"bytes": 40}},
         {"name": "predict.walk", "dur": 0.002, "attrs": {"levels": 16, "pairs": 100}},
         _call(40.0, 5.0, 1600, 1000),
         {"name": "predict.rows", "dur": 0.008, "attrs": {}},
         {"name": "predict.stage", "dur": 0.002, "attrs": {"bytes": 40}},
         _call(56.0, 7.0, 1600, 1000)]


@pytest.mark.parametrize("name", sorted(NEW))
def test_each_reader_gives_its_value_and_nothing_elsewhere(name):
    read = Registry().reader(name)
    assert read(_readings(SPANS)) == pytest.approx(NEW[name])
    assert read(_readings(SPANS, kind="train")) is None
    # the parent's spans: the call's retroactive span, no phase and no reading
    bare = [{"name": "predict.predict", "dur": 0.1,
             "attrs": {"rows": 10, "bucket": 16, "warm": True}}]
    assert read(_readings(bare)) is None
    assert read(_readings([])) is None


def test_the_new_entries_keep_to_the_shape():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in b["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["workloads"] == ["higgs-predict"] and m["layer"] == "prediction"
        assert m["source"] in ("program_span", "program_counter")
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
    for held_out in (False, True):
        test_benchmark_json_keeps_to_its_shape(held_out)
