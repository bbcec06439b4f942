"""The surfaces of lightgbm_tpu_torch this slice adds: the Dask-style
estimators (dask.py over parallel/launcher.py::train_distributed),
``predict(mesh=)`` over a device mesh and over a process group, the
command line (cli.py, ``python -m lightgbm_tpu_torch``) and plotting.py.
The port's mirror of tests/test_launcher.py's estimator cases,
tests/test_cli_io.py and tests/test_plotting.py.

Bars.  A distributed estimator's model is the local estimator's model: the
same trees bit for bit (the merge is exact), where the JAX package holds
its predictions within 5e-2.  ``predict(mesh=)`` is ``predict`` bit for
bit.  The CLI's model predicts as the API's model (1e-12, its text
output), and its C++ conversion compiles with g++ and predicts as the host
f64 walk of the trees (1e-12).  Plotting runs on matplotlib's Agg backend.
"""

import os
import shutil
import subprocess
import sys

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import lightgbm_tpu_torch as tlgb  # noqa: E402
from lightgbm_tpu_torch.parallel.launcher import run_spmd  # noqa: E402
from lightgbm_tpu_torch.parallel.mesh import make_device_mesh  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device_type": "cpu", "verbosity": -1}


def _trees(booster) -> str:
    text = booster.model_to_string()
    return text[text.index("Tree=0"):text.index("end of trees")]


# ---------------------------------------------------------------------------
# the Dask-style estimators
# ---------------------------------------------------------------------------
def _est_kw(n):
    return dict(n_estimators=4, num_leaves=8, min_child_samples=5, subsample_for_bin=n,
                **CPU)


def test_distributed_regressor_is_the_local_regressor():
    rng = np.random.RandomState(12)
    n = 3000
    X = rng.randn(n, 5)
    y = X @ rng.randn(5) + 0.2 * rng.randn(n)
    est = tlgb.DaskLGBMRegressor(num_machines=2, launch_timeout_s=85, **_est_kw(n)).fit(X, y)
    local = tlgb.LGBMRegressor(**_est_kw(n)).fit(X, y)
    assert _trees(est.booster_) == _trees(local.booster_)
    np.testing.assert_array_equal(est.predict(X), local.predict(X))
    assert est.n_features_in_ == 5 and est.get_params()["num_machines"] == 2


def test_distributed_classifier_is_the_local_classifier():
    rng = np.random.RandomState(13)
    n = 3000
    X = rng.randn(n, 5)
    y = np.where(X @ rng.randn(5) > 0, "pos", "neg")  # string labels: the encoder
    est = tlgb.DaskLGBMClassifier(num_machines=2, launch_timeout_s=85,
                                  **_est_kw(n)).fit(X, y)
    local = tlgb.LGBMClassifier(**_est_kw(n)).fit(X, y)
    assert set(est.classes_) == {"neg", "pos"}
    assert _trees(est.booster_) == _trees(local.booster_)
    np.testing.assert_array_equal(est.predict_proba(X), local.predict_proba(X))
    assert (est.predict(X) == y).mean() > 0.8


def test_distributed_ranker_is_the_local_ranker():
    """Uneven queries: the launcher's shards snap to query boundaries."""
    rng = np.random.RandomState(14)
    group = rng.randint(30, 70, 47)
    n = int(group.sum())
    X = rng.randn(n, 6)
    y = np.clip(np.floor(X[:, 0] * 0.8 + 0.3 * rng.randn(n)) + 2, 0, 4)
    est = tlgb.DaskLGBMRanker(num_machines=2, launch_timeout_s=85,
                              **_est_kw(n)).fit(X, y, group=group)
    local = tlgb.LGBMRanker(**_est_kw(n)).fit(X, y, group=group)
    assert _trees(est.booster_) == _trees(local.booster_)
    with pytest.raises(ValueError, match="group"):
        tlgb.DaskLGBMRanker(num_machines=2).fit(X, y)


def test_distributed_eval_set_and_early_stopping_are_the_local_ones():
    rng = np.random.RandomState(15)
    n = 3000
    X = rng.randn(n, 5)
    y = X @ rng.randn(5) + 0.2 * rng.randn(n)
    Xv, yv = X[:800], rng.randn(800)  # an unlearnable target: stops early
    kw = dict(_est_kw(n), n_estimators=60, num_leaves=31, min_child_samples=2,
              learning_rate=0.9)
    fit = dict(eval_set=[(Xv, yv)], eval_names=["val"], eval_metric="l2")
    est = tlgb.DaskLGBMRegressor(num_machines=2, launch_timeout_s=85, **kw).fit(
        X, y, early_stopping_rounds=2, **fit)
    local = tlgb.LGBMRegressor(**kw).fit(X, y, callbacks=[tlgb.early_stopping(2)], **fit)
    curve = est.evals_result_["val"]["l2"]
    assert 2 < len(curve) < 60
    np.testing.assert_array_equal(curve, local.evals_result_["val"]["l2"])
    assert est.best_iteration_ == local.best_iteration_
    np.testing.assert_array_equal(est.predict(X[:50]), local.predict(X[:50]))


# ---------------------------------------------------------------------------
# predict(mesh=)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("extra", [{"objective": "binary"},
                                   {"objective": "multiclass", "num_class": 3},
                                   {"objective": "binary", "boosting": "rf",
                                    "bagging_freq": 1, "bagging_fraction": 0.6}])
def test_predict_over_a_device_mesh_is_predict_bitwise(extra):
    rng = np.random.RandomState(0)
    X = rng.randn(3001, 6)
    y = (X[:, 0] > 0).astype(float) if extra["objective"] == "binary" else (
        np.digitize(X[:, 0], [-0.5, 0.5]))
    p = {**CPU, **extra}
    bst = tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 5)
    mesh = make_device_mesh(["cpu", "cpu"])
    for raw in (False, True):
        np.testing.assert_array_equal(bst.predict(X, raw_score=raw, mesh=mesh),
                                      bst.predict(X, raw_score=raw))
    np.testing.assert_array_equal(bst.predict_sharded(X[:7], mesh), bst.predict(X[:7]))
    np.testing.assert_array_equal(bst._gbdt.predict_raw_sharded(X, mesh),
                                  bst.predict(X, raw_score=True))
    # the tables are placed on each device once, in the pack
    packs = [s for s in bst._gbdt._pred_cache.values() if s is not None]
    assert any("mesh_walk" in s for s in packs)


_PREDICT_SPMD = r'''
import os
import numpy as np
import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.parallel.mesh import make_mesh

X = np.load(os.path.join(WORKDIR, "X.npy"))
bst = lgb.Booster(model_file=os.path.join(WORKDIR, "m.txt"), params={"device_type": "cpu"})
np.save(os.path.join(WORKDIR, f"p{RANK}.npy"), bst.predict(X, mesh=make_mesh()))
'''


def test_predict_over_a_process_group_is_predict_bitwise(tmp_path):
    rng = np.random.RandomState(1)
    X = rng.randn(2001, 6)
    y = (X[:, 0] + X[:, 1] > 0).astype(float)
    p = {**CPU, "objective": "binary"}
    bst = tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 5)
    bst.save_model(str(tmp_path / "m.txt"))
    np.save(tmp_path / "X.npy", X)
    run_spmd(_PREDICT_SPMD, 2, str(tmp_path), timeout_s=80)
    want = tlgb.Booster(model_file=str(tmp_path / "m.txt"),
                        params={"device_type": "cpu"}).predict(X)
    for r in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"p{r}.npy"), want)


# ---------------------------------------------------------------------------
# the command line (tests/test_cli_io.py)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def csv_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(0)
    n, f = 1200, 6
    X = rng.randn(n, f)
    y = ((X @ rng.randn(f) + 0.5 * rng.randn(n)) > 0).astype(np.float64)

    def write(path, Xa, ya):
        with open(path, "w") as fh:
            for i in range(len(Xa)):
                fh.write(",".join([f"{ya[i]:g}"] + [f"{v:.8g}" for v in Xa[i]]) + "\n")

    write(tmp / "train.csv", X[:1000], y[:1000])
    write(tmp / "valid.csv", X[1000:], y[1000:])
    return dict(tmp=tmp, train=str(tmp / "train.csv"), valid=str(tmp / "valid.csv"),
                X=X, y=y)


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("PYTEST_CURRENT_TEST", None)
    return subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch", *args],
                          capture_output=True, text=True, env=env, timeout=120)


def test_cli_train_predict_roundtrip(csv_files):
    tmp = csv_files["tmp"]
    conf, model_p, out_p = tmp / "train.conf", tmp / "model.txt", tmp / "preds.txt"
    conf.write_text(f"task = train\nobjective = binary\ndata = {csv_files['train']}\n"
                    f"valid = {csv_files['valid']}\nnum_iterations = 10   # comment\n"
                    f"num_leaves = 15\nverbosity = -1\ndevice_type = cpu\n"
                    f"output_model = {model_p}\n")
    r = _cli(f"config={conf}")
    assert r.returncode == 0, r.stderr[-2000:]
    r = _cli("task=predict", f"data={csv_files['valid']}", f"input_model={model_p}",
             f"output_result={out_p}", "device_type=cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    cli_preds = np.loadtxt(out_p)
    bst = tlgb.Booster(model_file=str(model_p), params={"device_type": "cpu"})
    api = bst.predict(csv_files["X"][1000:])
    np.testing.assert_allclose(cli_preds, api, rtol=1e-12, atol=1e-12)
    assert ((api > 0.5) == (csv_files["y"][1000:] > 0.5)).mean() > 0.85
    # the CLI's training is lgb.train's on the file's values
    rows = np.loadtxt(csv_files["train"], delimiter=",")
    p = {**CPU, "objective": "binary", "num_leaves": 15}
    api_bst = tlgb.train(p, tlgb.Dataset(rows[:, 1:], label=rows[:, 0], params=p), 10)
    assert _trees(bst) == _trees(api_bst)


def test_cli_convert_model_compiles_and_matches(csv_files, tmp_path):
    import ctypes

    from lightgbm_tpu_torch.cli import run

    X, y = csv_files["X"], csv_files["y"]
    p = {**CPU, "objective": "binary", "num_leaves": 7}
    bst = tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 3)
    model_p, cpp_p, so_p = tmp_path / "m.txt", tmp_path / "pred.cpp", tmp_path / "pred.so"
    bst.save_model(str(model_p))
    assert run(["task=convert_model", f"input_model={model_p}", f"convert_model={cpp_p}",
                "device_type=cpu"]) == 0
    r = subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-o", str(so_p), str(cpp_p)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    lib = ctypes.CDLL(str(so_p))
    lib.Predict.restype = ctypes.c_double
    lib.Predict.argtypes = [ctypes.POINTER(ctypes.c_double)]
    trees = bst._gbdt._trees_for_export(0, -1)
    host64 = 1.0 / (1.0 + np.exp(-np.sum([t.predict(X[:64]) for t in trees], axis=0)))
    api32 = bst.predict(X[:64])
    for i in range(64):
        row = np.ascontiguousarray(X[i], dtype=np.float64)
        got = lib.Predict(row.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        assert abs(got - host64[i]) < 1e-12 and abs(got - api32[i]) < 1e-5


def test_cli_refit_and_bad_tasks(csv_files):
    from lightgbm_tpu_torch.cli import parse_argv, run

    tmp = csv_files["tmp"]
    X, y = csv_files["X"], csv_files["y"]
    p = {**CPU, "objective": "binary", "num_leaves": 7}
    model_p, out_p = tmp / "m_refit_src.txt", tmp / "m_refit.txt"
    tlgb.train(p, tlgb.Dataset(X[:1000], label=y[:1000], params=p), 3).save_model(
        str(model_p))
    r = _cli("task=refit", f"data={csv_files['train']}", f"input_model={model_p}",
             f"output_model={out_p}", "verbosity=-1", "device_type=cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    refitted = tlgb.Booster(model_file=str(out_p), params={"device_type": "cpu"})
    assert np.isfinite(refitted.predict(X[:10])).all()
    assert run(["task=train", "device_type=cpu", "verbosity=-1"]) == 1  # no data=
    assert run(["task=nonsense", "verbosity=-1"]) == 1
    conf = tmp / "o.conf"
    conf.write_text("num_leaves = 3\nobjective = binary\n")
    assert parse_argv([f"config={conf}", "num_leaves=9"]) == {"num_leaves": "9",
                                                              "objective": "binary"}


# ---------------------------------------------------------------------------
# plotting (tests/test_plotting.py)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def model():
    rng = np.random.RandomState(0)
    X = rng.randn(300, 5)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float)
    p = {**CPU, "objective": "binary", "num_leaves": 7}
    return tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 5)


def test_plot_importance(model):
    ax = tlgb.plot_importance(model)
    assert "Column_0" in [t.get_text() for t in ax.get_yticklabels()]
    assert ax.get_title() == "Feature importance"


def test_plot_split_value_histogram(model):
    assert tlgb.plot_split_value_histogram(model, feature=0) is not None
    with pytest.raises(ValueError):
        tlgb.plot_split_value_histogram(model, feature="nope")
    hist, edges = model.get_split_value_histogram(0)
    assert hist.sum() == int(model.feature_importance("split")[0])
    assert len(edges) == len(hist) + 1


def test_plot_metric_from_record_and_estimator():
    rng = np.random.RandomState(1)
    X = rng.randn(300, 5)
    y = (X[:, 0] > 0).astype(float)
    p = {**CPU, "objective": "binary", "metric": "binary_logloss"}
    d = tlgb.Dataset(X, label=y, params=p)
    ev = {}
    tlgb.train(p, d, 5, valid_sets=[d], valid_names=["train"],
               callbacks=[tlgb.record_evaluation(ev)])
    assert tlgb.plot_metric(ev).get_ylabel() == "binary_logloss"
    with pytest.raises(TypeError):
        tlgb.plot_metric(tlgb.Booster.__new__(tlgb.Booster))
    clf = tlgb.LGBMClassifier(n_estimators=5, **CPU).fit(
        X, y.astype(int), eval_set=[(X, y.astype(int))], eval_metric="binary_logloss")
    assert len(clf.evals_result_["valid_0"]["binary_logloss"]) == 5
    assert tlgb.plot_metric(clf) is not None


def test_plot_tree_and_digraph(model):
    g = tlgb.create_tree_digraph(model, tree_index=0,
                                 show_info=["internal_count", "leaf_count"])
    assert "split0" in g.source and "leaf" in g.source
    with pytest.raises(IndexError):
        tlgb.create_tree_digraph(model, tree_index=99)
    if shutil.which("dot") is not None:  # plot_tree renders through graphviz's dot
        assert tlgb.plot_tree(model) is not None


def test_training_imports_no_plotting_backend():
    """matplotlib and graphviz are imported only when a plot is drawn: the
    package, training and prediction import neither."""
    code = ("import sys, numpy as np, lightgbm_tpu_torch as lgb\n"
            "X = np.random.RandomState(0).randn(200, 3)\n"
            "p = {'objective': 'regression', 'device_type': 'cpu', 'verbosity': -1}\n"
            "lgb.train(p, lgb.Dataset(X, label=X[:, 0], params=p), 2).predict(X)\n"
            "bad = sorted(m for m in ('matplotlib', 'graphviz') if m in sys.modules)\n"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
