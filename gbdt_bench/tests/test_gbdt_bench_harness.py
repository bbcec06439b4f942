"""CPU tests of the benchmark: the files found by name, the import guard, the
plain reference against hand-worked cases and against the port, the byte
counts, the trace reduction, and whole runs of every cell at a small size on
the CPU, sound and broken.

    python -m pytest gbdt_bench/tests -q
"""

import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from gbdt_bench.data import forest, tabular
from gbdt_bench.harness import guard
from gbdt_bench.harness.cli import main, run_cell
from gbdt_bench.harness.registry import Registry
from gbdt_bench.harness.trace import breakdown, reduce_events
from gbdt_bench.reference import binning, gbdt, model_text
from gbdt_bench.roofline import needed_bytes

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "gbdt_bench"

# small cells for the CPU: the same loops and judgement at a few thousand rows
SMALL = {
    "higgs-train": dict(config_patch={"dataset": {"train_rows": 6000, "test_rows": 500},
                                      "params": {"num_leaves": 15,
                                                 "tree_growth_mode": "rounds"}},
                        traffic_patch={"profile_steps": 1, "judge_tree": 7}),
    "epsilon-train": dict(config_patch={"dataset": {"train_rows": 3000, "test_rows": 500,
                                                    "table_args": {"features": 40}},
                                        "params": {"num_leaves": 15,
                                                   "tree_growth_mode": "windowed"}},
                          traffic_patch={"profile_steps": 1, "judge_tree": 7}),
    "higgs-predict": dict(traffic_patch={"pool_rows": 20000, "min_rows": 300, "max_rows": 3000,
                                         "trees": 12, "leaves": 31, "grow_rows": 8192,
                                         "profile_calls": 2}),
}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def small_run(cell, seed=20261018, trace=False, seconds=1.0, **kw):
    kw.setdefault("registry", Registry(held_out=True))
    return run_cell(cell, seed, seconds, trace, time.perf_counter(), device="cpu",
                    **SMALL[cell], **kw)


# -- the files, found by name ------------------------------------------------
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@pytest.mark.parametrize("held_out", [False, True])
def test_benchmark_json_keeps_to_its_shape(held_out):
    """BENCHMARK.json, and BENCHMARK.json with the held-out cells added back."""
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    if held_out:
        b = Registry(held_out=True).benchmark
    assert b["paths"] == ["gbdt_bench"] and b["command"][1] == "gbdt_bench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    configs = {c["name"] for c in b["configs"]}
    used = {w["config"] for w in b["workloads"]}
    assert configs == used
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("gbdt_bench/")
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["name"] for w in b["workloads"]] + list(configs)
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_every_cell_finds_its_files():
    reg = Registry(held_out=True)
    for w in reg.benchmark["workloads"]:
        cell = reg.cell(w["name"])
        assert reg.config(cell["config"])["dataset"]["table"] in tabular.TABLES
        assert hasattr(reg.loop(reg.traffic(cell["traffic"])), "run")
        assert reg.limits(w["name"])
        assert any(m["name"] != "setup_s" for m in reg.end_to_end(w["name"]))
        assert reg.per_layer(w["name"])
    for m in reg.benchmark["per_layer"]:
        assert callable(reg.reader(m["name"]))


def _digest(path: Path) -> dict:
    return {str(p.relative_to(path)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(path.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_mix_and_metric_are_new_files_only(tmp_path):
    """A later change adds a traffic file, a limits file, a reader and
    entries; no file already there changes, and the new cell runs."""
    shutil.copytree(BENCH, tmp_path / "gbdt_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path / "gbdt_bench")
    new_bench = tmp_path / "gbdt_bench"
    mix = json.loads((new_bench / "traffic" / "predict_calls.json").read_text())
    mix.update(min_rows=1, max_rows=300)
    (new_bench / "traffic" / "predict_calls_small.json").write_text(json.dumps(mix))
    (new_bench / "limits" / "higgs-predict-small.json").write_text(
        (new_bench / "limits" / "higgs-predict.json").read_text())
    (new_bench / "metrics" / "predict_calls_traced.py").write_text(
        "def read(r):\n    return r.get('calls') if r.get('kind') == 'predict' else None\n")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "higgs-predict-small", "config": "higgs",
                           "traffic": "predict_calls_small", "chips": 1, "why": "test"})
    for m in b["end_to_end"]:
        if "workloads" in m and "higgs-predict" in m["workloads"]:
            m["workloads"].append("higgs-predict-small")
    b["per_layer"].append({"name": "predict_calls_traced", "unit": "count",
                           "better": "higher", "source": "program_counter",
                           "layer": "prediction", "moves": "predict_rows_s",
                           "workloads": ["higgs-predict-small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    after = _digest(new_bench)
    assert all(after[k] == v for k, v in before.items())
    reg = Registry(bench_dir=new_bench, benchmark_json=tmp_path / "BENCHMARK.json")
    assert reg.traffic("predict_calls_small")["max_rows"] == 300
    assert [m["name"] for m in reg.per_layer("higgs-predict-small")] == [
        "predict_calls_traced"]
    res = run_cell("higgs-predict-small", 5, 0.5, True, time.perf_counter(), device="cpu",
                   registry=reg, traffic_patch=SMALL["higgs-predict"]["traffic_patch"]
                   | {"min_rows": 1, "max_rows": 300})
    assert res["correct"], res["checks"]
    assert res["metrics"]["predict_calls_traced"]["value"] == 2


# -- the import guard ----------------------------------------------------------
def test_import_guard_compares_whole_top_level_names():
    assert guard.forbidden(["lightgbm_tpu.basic", "jax.numpy", "jaxlib.xla_client",
                            "flax.linen", "numpy"]) == ["flax", "jax", "jaxlib",
                                                        "lightgbm_tpu"]
    assert guard.forbidden(["lightgbm_tpu_torch", "lightgbm_tpu_torch.ops.split",
                            "jaxtyping", "gbdt_bench.reference"]) == []


def test_the_harness_and_reference_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import gbdt_bench.harness.cli, "
            "gbdt_bench.harness.loops.train_loop, gbdt_bench.harness.loops.predict_calls; "
            "import lightgbm_tpu_torch; from gbdt_bench.harness import guard; "
            "print(guard.forbidden())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    for path in (BENCH / "reference").glob("*.py"):
        assert "lightgbm_tpu" not in path.read_text() and "import jax" not in path.read_text()


def test_run_fails_without_the_port_or_a_card(tmp_path):
    """In a folder that holds only BENCHMARK.json and gbdt_bench/, a run
    exits non-zero and prints no result."""
    shutil.copytree(BENCH, tmp_path / "gbdt_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "gbdt_bench/run.py", "--workload", "higgs-predict",
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_a_reader_that_loads_the_jax_package_leaves_no_result(tmp_path, monkeypatch, capsys):
    """The guard runs after the readers and the breakdown: a reader that
    imports a module named ``lightgbm_tpu`` makes the run exit 3 with no
    result line."""
    shutil.copytree(BENCH, tmp_path / "gbdt_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["per_layer"].append({"name": "loads_jax_package", "unit": "count", "better": "lower",
                           "source": "program_counter", "layer": "prediction",
                           "moves": "predict_rows_s", "workloads": ["higgs-predict"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    (tmp_path / "gbdt_bench" / "metrics" / "loads_jax_package.py").write_text(
        "def read(r):\n    import lightgbm_tpu\n    return 1\n")
    stub = tmp_path / "stub" / "lightgbm_tpu"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path / "stub"))
    saved = {k: v for k, v in sys.modules.items() if k.split(".")[0] in guard.FORBIDDEN}
    for k in saved:
        del sys.modules[k]
    try:
        reg = Registry(bench_dir=tmp_path / "gbdt_bench",
                       benchmark_json=tmp_path / "BENCHMARK.json")
        rc = main(["--workload", "higgs-predict", "--seed", "4", "--seconds", "0.5",
                   "--trace", "1"], time.perf_counter(), device="cpu", registry=reg,
                  **SMALL["higgs-predict"])
        assert "lightgbm_tpu" in sys.modules
    finally:
        for k in [k for k in sys.modules if k.split(".")[0] in guard.FORBIDDEN]:
            del sys.modules[k]
        sys.modules.update(saved)
    out = capsys.readouterr()
    assert rc == 3, out.err[-2000:]
    assert out.out.strip() == "" and "lightgbm_tpu" in out.err


# -- the reference -------------------------------------------------------------
THREE_NODES = """tree
version=v4
num_class=1
num_tree_per_iteration=1
label_index=0
max_feature_idx=1
objective=binary sigmoid:1

Tree=0
num_leaves=3
num_cat=0
split_feature=0 1
split_gain=1 1
threshold=0.5 -1.25
decision_type=10 0
left_child=1 -2
right_child=-1 -3
leaf_value=0.25 -0.5 1.5
is_linear=0
shrinkage=1

end of trees
"""


def test_reference_walks_a_hand_built_model():
    trees = model_text.parse(THREE_NODES)
    assert trees[0].num_leaves == 3
    X = torch.tensor([[0.5, -2.0],              # left, then x1 <= -1.25: leaf 1
                      [0.5000001, -2.0],        # right: leaf 0
                      [float("nan"), 0.0],      # NaN on a NaN node, default left: x1 > -1.25
                      [0.0, float("nan")]],     # NaN on a node of type none reads 0.0
                     dtype=torch.float32)
    raw = model_text.raw_scores(trees, X).numpy()
    np.testing.assert_array_equal(raw, [-0.5, 0.25, 1.5, 1.5])
    import lightgbm_tpu_torch as lgb
    port = lgb.Booster(params={"device_type": "cpu"}, model_str=THREE_NODES)
    np.testing.assert_allclose(port.predict(X.numpy(), raw_score=True), raw, rtol=0, atol=1e-7)


def test_reference_bins_a_hand_worked_column():
    # five distinct values under max_bin: midpoints, merged to keep 3 a bin
    col = torch.tensor([1.0, 1, 1, 2, 2, 2, 3, 3, 3, 4, 5, 5, float("nan")], dtype=torch.float64)
    bounds, has_nan = binning.bin_bounds(col[:, None], max_bin=8, min_data_in_bin=3)
    np.testing.assert_array_equal(bounds[0], [1.5, 2.5, 3.5, math.inf])
    assert bool(has_nan[0])
    bins = binning.transform(col[:, None].float(), bounds, has_nan)[:, 0].tolist()
    assert bins == [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4]


@pytest.mark.parametrize("max_bin", [15, 63])
def test_reference_bins_as_the_port_does(max_bin):
    from lightgbm_tpu_torch.binning import DatasetBinner
    X, _ = tabular.higgs_like(30000, 4, "cpu")
    X[:, 3] = torch.round(X[:, 3] * 4) / 4  # a column of few values, one of them big
    port = DatasetBinner.fit(X.numpy(), max_bin=max_bin, sample_cnt=20000, seed=1)
    idx = binning.sample_rows(len(X), 20000, 1)
    bounds, has_nan = binning.bin_bounds(X[torch.as_tensor(idx)].double(), max_bin)
    for m, b in zip(port.mappers, bounds):
        np.testing.assert_array_equal(m.upper_bounds, b)
    np.testing.assert_array_equal(port.transform(X.numpy()),
                                  binning.transform(X, bounds, has_nan).numpy())


def test_reference_histograms_gains_and_leaves_by_hand():
    # 6 rows, 2 features of 3 bins (no NaN bin); a stump on feature 1 at bin 0
    bins = torch.tensor([[0, 0], [0, 1], [1, 0], [1, 2], [2, 1], [2, 2]], dtype=torch.uint8)
    y = torch.tensor([0, 1, 0, 1, 1, 1], dtype=torch.float64)
    score = torch.zeros(6, dtype=torch.float64)
    g, h = gbdt.gradients(score, y)  # g = 0.5 - y, h = 0.25
    hist = gbdt._hist(bins, torch.arange(6), torch.zeros(6, dtype=torch.int64), 1, g, h, 3)[0]
    np.testing.assert_allclose(hist[1, :, 0].numpy(), [1.0, -1.0, -1.0])
    np.testing.assert_allclose(hist[0, :, 2].numpy(), [2, 2, 2])
    nb = torch.tensor([3, 3])
    nan_bin = torch.tensor([-1, -1])
    gains, _ = gbdt.split_gains(hist, nb, nan_bin, min_data=1, min_hess=0.0)

    def gain(mask):
        GL, HL = float(g[mask].sum()), float(h[mask].sum())
        GR, HR = float(g[~mask].sum()), float(h[~mask].sum())
        return GL ** 2 / HL + GR ** 2 / HR - float(g.sum()) ** 2 / float(h.sum())
    for f in range(2):
        for t in range(2):
            assert float(gains[f, t, 0]) == pytest.approx(gain(bins[:, f] <= t), abs=1e-12)
    text = THREE_NODES.replace("num_leaves=3", "num_leaves=2").replace(
        "split_feature=0 1", "split_feature=1").replace("split_gain=1 1", "split_gain=1")
    text = (text.replace("threshold=0.5 -1.25", "threshold=0").replace("decision_type=10 0", "decision_type=0")
            .replace("left_child=1 -2", "left_child=-1").replace("right_child=-1 -3", "right_child=-2"))
    best = bins[:, 1] <= 0
    lv = [-0.1 * float(g[best].sum() / h[best].sum()), -0.1 * float(g[~best].sum() / h[~best].sum())]
    tree = model_text.parse(text.replace("leaf_value=0.25 -0.5 1.5", "leaf_value=%r %r" % tuple(lv)))[0]
    res, leaf = gbdt.check_tree(bins, y, score, tree, np.array([0]), nb, nan_bin, lr=0.1,
                                init=0.0, min_data=1, min_hess=0.0)
    assert res["gain_gap"] == pytest.approx(0.0, abs=1e-12)
    assert res["leaf_gap"] == pytest.approx(0.0, abs=1e-12)
    assert leaf.tolist() == [0, 1, 0, 1, 1, 1]


def test_byte_counts_of_a_hand_built_tree():
    # root 100 -> (60, 40); node 1 (the 60) -> (45, 15)
    tree = model_text.Tree(num_leaves=3, split_feature=np.array([0, 1]),
                           threshold=np.array([0.0, 0.0]), decision_type=np.array([0, 0]),
                           left_child=np.array([1, -2]), right_child=np.array([-1, -3]),
                           leaf_value=np.zeros(3))
    rows = {0: 100, 1: 60, ~0: 40, ~1: 45, ~2: 15}
    splits = needed_bytes.splits_of(tree, rows.__getitem__)
    assert splits == [(100, 60, 40), (60, 45, 15)]
    b = needed_bytes.iteration_bytes(100, 28, 64, splits)
    assert b["hist"] == (100 + 40 + 15) * (28 + 8) + 3 * 28 * 64 * 12
    assert b["partition"] == (100 + 60) * 8
    assert b["gradients"] == 1600 and b["score"] == 1200
    assert b["total"] == b["hist"] + b["partition"] + 1600 + 1200


def test_the_random_forest_reads_back_as_it_was_grown():
    X, _ = tabular.higgs_like(4000, 9, "cpu")
    f = forest.grow(X, 6, 31, 9, min_rows=20, leaf_scale=0.05, max_depth=8)
    assert (f["num_leaves"] > 16).all()
    trees = model_text.parse(forest.model_text(f, X.shape[1]))
    raw = model_text.raw_scores(trees, X).numpy()
    want = sum(f["leaf_value"][t][np.asarray(
        _leaves(trees[t], X.numpy()))] for t in range(6))
    np.testing.assert_allclose(raw, want, rtol=0, atol=1e-12)
    assert forest.depths(f).max() == 8


def _leaves(tree, X):
    out = []
    for x in X:
        node = 0
        while node >= 0:
            v = x[tree.split_feature[node]]
            left = bool(tree.default_left[node]) if np.isnan(v) else v <= tree.threshold[node]
            node = tree.left_child[node] if left else tree.right_child[node]
        out.append(~node)
    return out


def test_trace_reduction_of_a_hand_built_trace():
    ev = [{"ph": "X", "name": "bench.stretch", "cat": "user_annotation", "ts": 0, "dur": 100},
          {"ph": "X", "name": "k1", "cat": "kernel", "ts": 10, "dur": 20},
          {"ph": "X", "name": "k2", "cat": "kernel", "ts": 25, "dur": 15},
          {"ph": "X", "name": "Memcpy", "cat": "gpu_memcpy", "ts": 60, "dur": 10},
          {"ph": "X", "name": "aten::add", "cat": "cpu_op", "ts": 40, "dur": 20},
          {"ph": "X", "name": "cudaGraphLaunch", "cat": "cuda_runtime", "ts": 70, "dur": 40},
          {"ph": "X", "name": "port.span", "cat": "user_annotation", "ts": 12, "dur": 20},
          {"ph": "X", "name": "port.span", "cat": "user_annotation", "ts": 62, "dur": 5},
          {"ph": "X", "name": "late", "cat": "user_annotation", "ts": 95, "dur": 20}]
    s = reduce_events(ev)
    assert s["host_annotations"] == {"port.span": (pytest.approx(25e-6), 2)}
    assert s["busy_s"] == pytest.approx(40e-6)
    assert s["kernels"] == 2
    assert s["idle_by_host"]["aten::add"] == pytest.approx(20e-6)
    assert s["idle_by_host"]["cudaGraphLaunch"] == pytest.approx(30e-6)
    assert s["idle_by_host"]["host (no traced op)"] == pytest.approx(10e-6)
    bd = breakdown(s)
    assert bd["device_ops"][0] == ["k1", pytest.approx(20e-6)]


# -- whole runs on the CPU -------------------------------------------------------
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_small_run_is_correct_and_reports_its_metrics(cell):
    res = small_run(cell)
    assert res["correct"], res["checks"]
    reg = Registry(held_out=True)
    assert set(res["metrics"]) == {m["name"] for m in reg.end_to_end(cell)}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checks"
    traced = small_run(cell, trace=True)
    assert traced["correct"], traced["checks"]
    assert set(traced["metrics"]) <= {m["name"] for m in reg.per_layer(cell)}
    assert traced["device"]["window_s"] > 0


@pytest.mark.parametrize("cell,fault", [("higgs-train", "unchanged"),
                                        ("higgs-train", "half_batch"),
                                        ("higgs-train", "altered"),
                                        ("epsilon-train", "half_batch"),
                                        ("higgs-predict", "half_batch"),
                                        ("higgs-predict", "altered")])
def test_a_planted_fault_makes_the_run_incorrect(cell, fault):
    res = small_run(cell, fault=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", ["higgs-train", "epsilon-train"])
def test_the_held_out_check_catches_an_altered_answer(cell, monkeypatch):
    """A training run whose port ``predict`` moves one held-out answer by
    0.01 reads not correct on ``predict_gap`` alone."""
    from lightgbm_tpu_torch.models import gbdt as port_gbdt
    inner = port_gbdt.GBDT.predict

    def altered(self, X, *a, **kw):
        out = np.array(inner(self, X, *a, **kw))
        out[0] += 0.01
        return out
    monkeypatch.setattr(port_gbdt.GBDT, "predict", altered)
    res = small_run(cell)
    assert not res["correct"]
    limits = Registry(held_out=True).limits(cell)
    failed = [k for k, c in res["checks"].items() if float(c["value"]) > limits[k]]
    assert failed == ["predict_gap"], res["checks"]


@pytest.mark.parametrize("cell", ["higgs-train", "higgs-predict"])
def test_the_control_is_incorrect(cell):
    res = small_run(cell, control="bf16")
    assert not res["correct"], res["checks"]


@pytest.mark.gpu
def test_a_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "gbdt_bench/run.py", "--workload", "higgs-predict",
                          "--seed", "8", "--seconds", "5", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
