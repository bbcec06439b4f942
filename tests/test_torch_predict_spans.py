"""The spans of one ``predict`` call, on the CPU: the call's span and its
five phases (``predict.rows``, ``.stage``, ``.walk``, ``.sum``,
``.finish``) in the ring, their mirror into a torch.profiler trace as
``user_annotation`` events (entered only while a profiler records), the
traced call's readings (``walk_useful_share`` exact on a hand-built model;
the device milliseconds exist only on the card, tests/test_torch_gpu.py),
and that tracing changes neither the answers nor the one blocking read a
call.
"""

import json

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.models import gbdt as gm
from lightgbm_tpu_torch.obs import metrics as obs
from lightgbm_tpu_torch.obs import trace as trc
from lightgbm_tpu_torch.utils import sanitizer as san

PHASES = ["predict.rows", "predict.stage", "predict.walk", "predict.sum",
          "predict.finish"]
CPU = {"device_type": "cpu", "verbosity": -1}


@pytest.fixture(scope="module")
def booster():
    rng = np.random.RandomState(3)
    X = rng.randn(2000, 6)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 15, **CPU}
    bst = tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 8)
    return bst, X.astype(np.float32)


@pytest.fixture(autouse=True)
def _ring():
    obs.set_enabled(True)
    trc.reset_trace()
    yield
    obs.set_enabled(True)
    trc.reset_trace()


def _call(entry, bst, X):
    if entry == "gbdt":  # a direct GBDT.predict (the serving runtime's)
        return bst._gbdt.predict(X), "predict.predict"
    if entry == "raw":
        return bst.predict(X, raw_score=True), "predict.raw"
    return bst.predict(X), "predict.predict"


@pytest.mark.parametrize("entry", ["booster", "raw", "gbdt"])
def test_a_call_records_its_span_and_five_phases_inside_it(booster, entry):
    bst, X = booster
    bst.predict(X[:50])
    trc.reset_trace()
    _call(entry, bst, X[:300])
    spans = trc.spans()
    call = spans[-1]
    _, name = _call(entry, bst, X[:1])
    assert call["name"] == name and call["depth"] == 0
    assert {k: call["attrs"][k] for k in ("rows", "bucket", "warm")} == {
        "rows": 300, "bucket": 512, "warm": True}
    kids = spans[:-1]
    assert [s["name"] for s in kids] == PHASES
    assert all(s["parent"] == call["id"] and s["depth"] == 1 for s in kids)
    end = call["ts"] + call["dur"]
    for a, b in zip(kids, kids[1:]):
        assert a["ts"] + a["dur"] <= b["ts"]
    assert call["ts"] <= kids[0]["ts"] and kids[-1]["ts"] + kids[-1]["dur"] <= end + 1e-6
    walk, stage, sums = kids[2]["attrs"], kids[1]["attrs"], kids[3]["attrs"]
    n_trees = len(bst._gbdt.models)
    assert walk["pairs"] == n_trees * 300 and 1 <= walk["levels"] <= 14
    assert stage["bytes"] == 4 * 300 * X.shape[1]
    assert sums["launches"] == 2 + n_trees
    assert "walk_useful_share" not in call["attrs"]  # tracing off: no readings


def test_the_profiler_trace_holds_each_phase_and_the_gate_keeps_it_out(
        booster, tmp_path, monkeypatch):
    bst, X = booster
    entered = []

    def spy(name, attrs):
        entered.append(name)
        return torch.profiler.record_function(name)

    monkeypatch.setattr(trc, "_annotation_factory", spy)
    bst.predict(X[:200])
    assert entered == [] and not trc.mirror_active()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert trc.mirror_active()
        bst.predict(X[:200])
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    notes = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"]
    assert sorted(notes) == sorted(["predict.predict"] + PHASES)
    assert sorted(entered) == sorted(notes)
    call = trc.spans("predict.predict")[-1]["attrs"]
    assert 0 < call["walk_useful_share"] <= 1  # a profiler turns tracing on
    assert "walk_device_ms" not in call  # no device clock on the CPU


def test_telemetry_false_records_no_span():
    rng = np.random.RandomState(4)
    X = rng.randn(500, 4)
    p = {"objective": "binary", "num_leaves": 7, "telemetry": False, **CPU}
    bst = tlgb.train(p, tlgb.Dataset(X, label=(X[:, 0] > 0).astype(float), params=p), 3)
    trc.reset_trace()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        bst.predict(X[:100])
    bst.predict(X[:100])
    assert trc.spans() == []


def test_answers_and_reads_are_the_same_with_tracing_on_and_off(booster, tmp_path,
                                                                monkeypatch):
    bst, X = booster
    traced = tlgb.Booster(params={**CPU, "trace_file": str(tmp_path / "t.json")},
                          model_str=bst.model_to_string())
    made, probe = [], gm._WalkProbe
    monkeypatch.setattr(gm, "_WalkProbe",
                        lambda *a, **kw: made.append(1) or probe(*a, **kw))
    outs = []
    for model, profile in ((bst, False), (bst, True), (traced, False)):
        for raw in (False, True):
            with san.DispatchCounter() as c:
                if profile:
                    with torch.profiler.profile(
                            activities=[torch.profiler.ProfilerActivity.CPU]):
                        out = model.predict(X[:700], raw_score=raw)
                else:
                    out = model.predict(X[:700], raw_score=raw)
            assert (c.predicts, c.host_syncs) == (1, 1)
            outs.append((raw, out))
    assert len(made) == 4  # the profiled calls and the trace_file model's
    for raw, out in outs:
        want = outs[int(raw)][1]
        assert out.dtype == want.dtype and np.array_equal(out, want)


def _tree_text(i, split_feature, threshold, left, right, leaf_value):
    n = len(leaf_value)

    def row(v):
        return " ".join(str(x) for x in v)
    return "\n".join([
        f"Tree={i}", f"num_leaves={n}", "num_cat=0",
        f"split_feature={row(split_feature)}", f"split_gain={row([1] * (n - 1))}",
        f"threshold={row(threshold)}", f"decision_type={row([0] * (n - 1))}",
        f"left_child={row(left)}", f"right_child={row(right)}",
        f"leaf_value={row(leaf_value)}", f"leaf_weight={row([1] * n)}",
        f"leaf_count={row([1] * n)}", f"internal_value={row([0] * (n - 1))}",
        f"internal_weight={row([1] * (n - 1))}", f"internal_count={row([1] * (n - 1))}",
        "is_linear=0", "shrinkage=1", ""])


def test_walk_useful_share_is_exact_on_a_hand_built_model():
    """A stump (both leaves at depth 1) and a depth-3 chain (leaves at 1, 2,
    3 and 3): the walk takes 3 levels for every pair, and needs 1 + the
    chain's leaf depth for each row."""
    stump = _tree_text(0, [0], [0.5], [-1], [-2], [0.1, -0.1])
    chain = _tree_text(1, [0, 1, 2], [0.0, 0.0, 0.0], [-1, -2, -3], [1, 2, -4],
                       [0.2, 0.3, -0.2, -0.3])
    text = "\n".join(["tree", "version=v4", "num_class=1", "num_tree_per_iteration=1",
                      "label_index=0", "max_feature_idx=2", "objective=regression",
                      "feature_names=a b c", "tree_sizes=1 1", "", stump, chain,
                      "end of trees", ""])
    bst = tlgb.Booster(params={**CPU, "trace_file": "unused.json"}, model_str=text)
    X = np.random.RandomState(5).randn(1000, 3).astype(np.float32)
    bst.predict(X)
    depth = np.where(X[:, 0] <= 0, 1, np.where(X[:, 1] <= 0, 2, 3))
    attrs = trc.spans("predict.predict")[-1]["attrs"]
    assert attrs["walk_steps"] == 2 * 1000 * 3
    assert attrs["walk_useful_steps"] == int(1000 + depth.sum())
    assert attrs["walk_useful_share"] == (1000 + depth.sum()) / 6000
