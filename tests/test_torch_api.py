"""The API surface of lightgbm_tpu_torch against the JAX package, on the
CPU: cv and CVBooster, the prediction surface (pred_leaf, pred_contrib,
prediction early stopping, to_if_else), the Booster and Dataset methods,
feval, refit and the scikit-learn estimators; and the estimators against
an external oracle, scikit-learn's HistGradientBoosting.

Held to: cv's result keys equal and its values within 1e-5; one JAX-trained
model text loaded into both packages gives pred_leaf and pred_contrib
bitwise (the same traversal and the same numpy SHAP code on the same
trees), early-stopped margins within 1e-6 with the same rows stopped, and
the same C++ source; refit leaf values within 1e-6; the estimators'
predictions within 1e-5; the Booster and Dataset methods equal to the
JAX package's results.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.convert import booster_from_jax_model_string
from lightgbm_tpu_torch.parallel.mesh import make_device_mesh

CPU = {"device_type": "cpu"}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data(kind="binary", seed=9, n=2500, f=6):
    """Values on a coarse grid (gains well apart), 5% missing."""
    rng = np.random.RandomState(seed)
    X = np.round(rng.randn(n, f) * 8) / 8
    X[rng.rand(n, f) < 0.05] = np.nan
    Z = np.nan_to_num(X)
    s = 2.0 * (Z[:, 0] > 0.3) + 1.5 * Z[:, 1] - 1.0 * (Z[:, 2] < -0.5) + 0.5 * Z[:, 3]
    group = None
    if kind == "binary":
        y = (s + 0.5 * rng.randn(n) > 0.6).astype(np.float64)
    elif kind == "multiclass":
        y = np.digitize(s + 0.5 * rng.randn(n), [-0.5, 1.0]).astype(np.float64)
    elif kind == "rank":
        y = np.clip(np.round(s + rng.randn(n)), 0, 4)
        group = np.full(n // 25, 25)
    else:
        y = s + 0.3 * rng.randn(n)
    return X, y, group


def _params(objective, **extra):
    return {"objective": objective, "num_leaves": 7, "min_data_in_leaf": 20,
            "learning_rate": 0.3, "min_gain_to_split": 0.1, "verbosity": -1, **extra}


@pytest.fixture(scope="module")
def binary_pair():
    """A 10-round binary model of each package on the same data."""
    X, y, _ = _data("binary")
    p = _params("binary")
    jd = jlgb.Dataset(X, label=y, free_raw_data=False)
    td = tlgb.Dataset(X, label=y, free_raw_data=False, params={**p, **CPU})
    return (X, y, jlgb.train(dict(p), jd, 10), tlgb.train({**p, **CPU}, td, 10))


@pytest.fixture(scope="module")
def jax_models():
    """JAX-trained binary (20 rounds) and 3-class (8 rounds) model text."""
    out = {}
    for kind, extra, rounds in (("binary", {}, 20), ("multiclass", {"num_class": 3}, 8)):
        X, y, _ = _data(kind, seed=13)
        bst = jlgb.train(_params(kind, **extra), jlgb.Dataset(X, label=y), rounds)
        out[kind] = (X, bst, bst.model_to_string())
    return out


# ---------------------------------------------------------------------------
# cv
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,params", [
    ("binary", _params("binary", metric=["auc", "binary_logloss"])),
    ("rank", _params("lambdarank", metric="ndcg", eval_at=[3, 5])),
])
def test_cv_matches_jax(kind, params):
    X, y, group = _data(kind)
    jres = jlgb.cv(dict(params), jlgb.Dataset(X, label=y, group=group), 4, nfold=3,
                   seed=3, eval_train_metric=True, return_cvbooster=True)
    tres = tlgb.cv({**params, **CPU}, tlgb.Dataset(X, label=y, group=group, params=CPU),
                   4, nfold=3, seed=3, eval_train_metric=True, return_cvbooster=True)
    jcv, tcv = jres.pop("cvbooster"), tres.pop("cvbooster")
    assert set(tres) == set(jres) and len(jres) >= 4
    for key in jres:
        np.testing.assert_allclose(tres[key], jres[key], rtol=1e-5, atol=1e-5, err_msg=key)
    assert isinstance(tcv, tlgb.CVBooster) and len(tcv.boosters) == 3
    np.testing.assert_allclose(np.stack(tcv.predict(X)), np.stack(jcv.predict(X)),
                               rtol=1e-5, atol=1e-5)
    if group is not None:  # group-aware folds: whole queries in each fold
        for b in tcv.boosters:
            assert int(np.sum(b._gbdt.train_set.group)) == b._gbdt.train_set.num_data()
            assert set(b._gbdt.train_set.group) == {25}


def test_cv_early_stopping_and_feval():
    X, y, _ = _data("binary")

    def err(score, ds):
        return "err", float(np.mean((score > 0) != (ds.get_label() > 0))), False

    p = _params("binary", metric="binary_logloss", early_stopping_round=2,
                learning_rate=0.8)
    jres = jlgb.cv(dict(p), jlgb.Dataset(X, label=y), 30, nfold=3, feval=err)
    tres = tlgb.cv({**p, **CPU}, tlgb.Dataset(X, label=y, params=CPU), 30, nfold=3,
                   feval=err)
    assert set(tres) == set(jres) and "valid err-mean" in tres
    assert len(tres["valid err-mean"]) == len(jres["valid err-mean"]) < 30
    for key in jres:
        np.testing.assert_allclose(tres[key], jres[key], rtol=1e-5, atol=1e-5, err_msg=key)


# ---------------------------------------------------------------------------
# prediction surface on one JAX-trained model text
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_pred_leaf_is_bitwise(kind, jax_models):
    X, jb, text = jax_models[kind]
    tb = booster_from_jax_model_string(text, device_type="cpu")
    jl, tl = jb.predict(X, pred_leaf=True), tb.predict(X, pred_leaf=True)
    assert tl.dtype == np.int32 and tl.shape == jl.shape == (len(X), tb.num_trees())
    np.testing.assert_array_equal(tl, jl)
    # the leaves are the value path's: each tree's leaf values sum to the margin
    raw = tb.predict(X, raw_score=True)
    vals = np.stack([t.leaf_value[tl[:, i]] for i, t in enumerate(tb._gbdt.models)], 1)
    k = tb.num_model_per_iteration()
    summed = vals.sum(1) if k == 1 else vals.reshape(len(X), -1, k).sum(1)
    np.testing.assert_allclose(summed, raw, rtol=1e-5, atol=1e-5)
    sl = tb.predict(X, pred_leaf=True, start_iteration=2, num_iteration=3)
    np.testing.assert_array_equal(sl, tl[:, 2 * k:5 * k])


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_pred_contrib_is_bitwise(kind, jax_models):
    X, jb, text = jax_models[kind]
    tb = booster_from_jax_model_string(text, device_type="cpu")
    jc, tc = jb.predict(X[:200], pred_contrib=True), tb.predict(X[:200], pred_contrib=True)
    np.testing.assert_array_equal(tc, jc)
    k = tb.num_model_per_iteration()
    f = X.shape[1]
    raw = tb.predict(X[:200], raw_score=True).reshape(200, k)
    np.testing.assert_allclose(tc.reshape(200, k, f + 1).sum(-1), raw, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind,freq,margin", [("binary", 3, 1.0), ("multiclass", 2, 0.8)])
def test_early_stop_prediction_matches_jax(kind, freq, margin, jax_models):
    X, jb, text = jax_models[kind]
    tb = booster_from_jax_model_string(text, device_type="cpu")
    jb._gbdt.cfg.pred_early_stop = True
    jb._gbdt.cfg.pred_early_stop_freq = freq
    jb._gbdt.cfg.pred_early_stop_margin = margin
    try:
        jr = jb.predict(X, raw_score=True)
        jp = jb.predict(X)
    finally:
        jb._gbdt.cfg.pred_early_stop = False
    es = {"pred_early_stop": True, "pred_early_stop_freq": freq,
          "pred_early_stop_margin": margin}
    tr = tb.predict(X, raw_score=True, **es)
    stats = tb._gbdt.early_stop_stats
    np.testing.assert_allclose(tr, jr, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tb.predict(X, **es), jp, rtol=1e-6, atol=1e-6)
    full = tb.predict(X, raw_score=True)
    stopped = np.any(tr != full, axis=-1) if tr.ndim > 1 else tr != full
    jfull = jb.predict(X, raw_score=True)
    jstopped = np.any(np.abs(jr - jfull) > 1e-5, axis=-1) if jr.ndim > 1 else (
        np.abs(jr - jfull) > 1e-5)
    np.testing.assert_array_equal(stopped, jstopped)
    assert 0 < stopped.sum() < len(X) and stats["stopped"] >= stopped.sum()
    assert stats["reads"] == stats["chunks"] >= 2
    # rows that ran every chunk end at the full prediction, bitwise
    assert np.array_equal(tr[~stopped], full[~stopped])


def test_early_stop_is_off_for_regression_and_forests(jax_models):
    X, y, _ = _data("regression")
    p = {**_params("regression"), **CPU}
    bst = tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 5)
    np.testing.assert_array_equal(bst.predict(X, pred_early_stop=True,
                                              pred_early_stop_margin=0.0),
                                  bst.predict(X))


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_to_if_else_is_the_jax_packages(kind, jax_models):
    X, jb, text = jax_models[kind]
    tb = booster_from_jax_model_string(text, device_type="cpu")
    jsrc = jb._gbdt.to_if_else()
    assert tb.to_if_else() == jsrc
    assert "PredictTree0" in jsrc and "extern \"C\"" in jsrc


def test_pred_contrib_on_linear_trees_raises(binary_pair):
    X, _, _, tb = binary_pair
    t = tb._gbdt.models[0]
    t.is_linear = True
    try:
        with pytest.raises(ValueError, match="linear"):
            tb.predict(X[:5], pred_contrib=True)
    finally:
        t.is_linear = False


# ---------------------------------------------------------------------------
# Booster and Dataset methods (tests/test_api_surface.py for the port)
# ---------------------------------------------------------------------------
def test_trees_to_dataframe_and_dump_model(binary_pair):
    _, _, jb, tb = binary_pair
    jdf, tdf = jb.trees_to_dataframe(), tb.trees_to_dataframe()
    assert list(tdf.columns) == list(jdf.columns)
    assert len(tdf) == len(jdf)
    for col in ("tree_index", "node_index", "parent_index", "left_child",
                "right_child", "split_feature", "missing_direction", "count"):
        assert tdf[col].tolist() == jdf[col].tolist(), col
    np.testing.assert_allclose(tdf["value"].astype(float), jdf["value"].astype(float),
                               rtol=1e-5, atol=1e-5)
    jd, td = jb.dump_model(), tb.dump_model()
    assert set(td) == set(jd) and td["num_tree_per_iteration"] == 1
    assert [t["num_leaves"] for t in td["tree_info"]] == [
        t["num_leaves"] for t in jd["tree_info"]]


def test_bounds_importance_and_histogram(binary_pair):
    X, _, jb, tb = binary_pair
    assert tb.lower_bound() == pytest.approx(jb.lower_bound(), abs=1e-5)
    assert tb.upper_bound() == pytest.approx(jb.upper_bound(), abs=1e-5)
    raw = tb.predict(X, raw_score=True)
    assert tb.lower_bound() - 1e-6 <= raw.min() and raw.max() <= tb.upper_bound() + 1e-6
    for kind in ("split", "gain"):
        np.testing.assert_allclose(tb.feature_importance(kind), jb.feature_importance(kind),
                                   rtol=1e-5)
    first3 = tb.feature_importance("split", iteration=3)
    assert first3.sum() == sum(t.num_internal for t in tb._gbdt.models[:3])
    for f in (0, "Column_1"):
        jh, th = jb.get_split_value_histogram(f), tb.get_split_value_histogram(f)
        np.testing.assert_array_equal(th[0], jh[0])
        np.testing.assert_allclose(th[1], jh[1])
    xs = tb.get_split_value_histogram(0, xgboost_style=True)
    assert list(xs.columns) == ["SplitValue", "Count"]
    assert tb.num_model_per_iteration() == jb.num_model_per_iteration() == 1


def test_leaf_output_shuffle_and_train_name(binary_pair):
    X, y, _, tb0 = binary_pair
    tb = tlgb.Booster(model_str=tb0.model_to_string(), params=CPU)
    before = tb.predict(X, raw_score=True)
    np.random.seed(0)
    tb.shuffle_models()
    np.testing.assert_allclose(tb.predict(X, raw_score=True), before, rtol=1e-6, atol=1e-6)
    v = tb.get_leaf_output(0, 1)
    tb.set_leaf_output(0, 1, v + 1.0)
    assert tb.get_leaf_output(0, 1) == v + 1.0
    leaf = tb.predict(X, pred_leaf=True)[:, 0]
    np.testing.assert_allclose(tb.predict(X, raw_score=True) - before,
                               (leaf == 1).astype(float), atol=1e-5)
    p = {**_params("binary"), **CPU}
    bst = tlgb.Booster(params=p, train_set=tlgb.Dataset(X, label=y, params=p))
    bst.update()
    bst.set_train_data_name("my_train")
    assert bst.eval_train()[0][0] == "my_train"
    assert bst.free_dataset() is bst
    # one machine: no process group to bring up (parallel/distributed.py)
    assert bst.set_network(["127.0.0.1:1"]) is bst
    assert bst.free_network() is bst
    with pytest.raises(TypeError, match="mesh"):
        bst.predict(X, mesh=object())
    np.testing.assert_array_equal(bst.predict(X, mesh=make_device_mesh(["cpu"] * 3)),
                                  bst.predict(X))


def test_eval_with_feval_matches_jax(binary_pair):
    X, y, _, _ = binary_pair

    def acc(score, ds):
        return "acc", float(np.mean((score > 0) == (ds.get_label() > 0))), True

    p = _params("binary", metric="auc")
    out = []
    for lgb, extra in ((jlgb, {}), (tlgb, CPU)):
        tr = lgb.Dataset(X[:2000], label=y[:2000], params={**p, **extra})
        va = lgb.Dataset(X[2000:], label=y[2000:], reference=tr)
        res = {}
        bst = lgb.train({**p, **extra}, tr, 5, valid_sets=[tr, va], valid_names=["tr", "va"],
                        feval=acc, callbacks=[lgb.record_evaluation(res)])
        out.append((res, bst.eval(va, "again", feval=acc), bst.eval_train(feval=acc)))
    (jres, jev, jtr), (tres, tev, ttr) = out
    assert set(tres["va"]) == set(jres["va"]) == {"auc", "acc"}
    for name in ("tr", "va"):
        for key in jres[name]:
            np.testing.assert_allclose(tres[name][key], jres[name][key], rtol=1e-6, atol=1e-6)
    for a, b in ((jev, tev), (jtr, ttr)):
        assert [r[:2] for r in b] == [r[:2] for r in a]
        np.testing.assert_allclose([r[2] for r in b], [r[2] for r in a], rtol=1e-6, atol=1e-6)


def test_dataset_fields_and_names():
    rng = np.random.RandomState(1)
    X = rng.randn(100, 3)
    y = rng.rand(100)
    for lgb in (jlgb, tlgb):
        d = lgb.Dataset(X, label=y, free_raw_data=False, params=CPU)
        assert d.get_data() is X
        np.testing.assert_array_equal(d.get_label(), y)
        d.set_weight(np.ones(100))
        assert d.get_weight().sum() == 100 and d.get_field("weight").sum() == 100
        d.set_position(np.arange(100))
        assert d.get_position()[-1] == 99
        d.set_group([40, 60])
        assert d.get_field("query").tolist() == [40, 60]
        d.set_init_score(np.zeros(100))
        assert d.get_init_score().shape == (100,)
        with pytest.raises(lgb.LightGBMError):
            d.set_field("bogus", [1])
        with pytest.raises(ValueError):
            d.set_label(np.full(100, np.nan))
        d.set_label(y)
        d.set_feature_name(["a", "b", "c"])
        d.construct()
        assert d.get_feature_name() == ["a", "b", "c"]
        assert d.feature_num_bin("a") > 1
        with pytest.raises(lgb.LightGBMError):
            d.set_feature_name(["x"])  # wrong length after construction
    nb = [lgb.Dataset(X, label=y, params=CPU).construct().feature_num_bin(2)
          for lgb in (jlgb, tlgb)]
    assert nb[0] == nb[1]


def test_dataset_reference_chain_subset_and_added_features(tmp_path):
    rng = np.random.RandomState(2)
    X = rng.randn(300, 3)
    y = (X[:, 0] > 0).astype(float)
    d1 = tlgb.Dataset(X, label=y, params=CPU)
    d2 = tlgb.Dataset(X + 0.1, label=y, params=CPU)
    d2.set_reference(d1)
    d2.construct()
    assert d2.binner is d1.binner and {d1, d2} <= d2.get_ref_chain()
    with pytest.raises(tlgb.LightGBMError):
        d2.set_reference(tlgb.Dataset(X))
    idx = np.arange(0, 300, 3)
    for lgb, extra in ((jlgb, {}), (tlgb, CPU)):
        d = lgb.Dataset(X, label=y, weight=np.arange(300.0), group=[100, 100, 100],
                        params=extra).construct()
        sub = d.subset(idx)
        assert sub.num_data() == 100 and sub.binner is d.binner
        np.testing.assert_array_equal(np.asarray(sub.bins), np.asarray(d.bins)[idx])
        np.testing.assert_array_equal(sub.get_weight(), np.arange(300.0)[idx])
        assert sub.get_group().tolist() == [34, 33, 33]
    X2 = rng.randn(300, 2)
    for lgb, extra in ((jlgb, {}), (tlgb, CPU)):
        a = lgb.Dataset(X, label=y, free_raw_data=False, params=extra).construct()
        a.add_features_from(lgb.Dataset(X2, free_raw_data=False, params=extra))
        assert a.num_feature() == 5 and len(a.get_feature_name()) == 5
        bst = lgb.train({"objective": "binary", "verbosity": -1, **extra}, a, 2)
        assert bst.num_trees() == 2
    # save_binary writes the bin cache that Dataset(path) loads back
    d1.save_binary(str(tmp_path / "d1.bin"))
    back = tlgb.Dataset(str(tmp_path / "d1.bin"), params=CPU).construct()
    np.testing.assert_array_equal(back.bins, d1.bins)
    np.testing.assert_array_equal(back.get_label(), y)
    # categorical features are set before construction only (A11); a
    # Dataset constructed without linear_tree holds no raw values for linear
    # trees, and training them raises the JAX package's error (an
    # unconstructed one takes linear_tree from the Booster's parameters)
    late = tlgb.Dataset(X, label=y, free_raw_data=False, params=CPU)
    assert late.set_categorical_feature([0]).categorical_feature == [0]
    late.construct()
    with pytest.raises(tlgb.basic.LightGBMError, match="categorical"):
        late.set_categorical_feature([1])
    with pytest.raises(ValueError, match="linear_tree requires raw feature values"):
        tlgb.train({**CPU, "objective": "binary", "linear_tree": True},
                   tlgb.Dataset(X, label=y, params=CPU).construct(), 1)


def test_refit_matches_jax(binary_pair):
    X, y, jb, tb = binary_pair
    rng = np.random.RandomState(4)
    y2 = np.where(rng.rand(len(y)) < 0.2, 1 - y, y)
    w = rng.rand(len(y)) + 0.5
    for kw in ({}, {"weight": w}):
        jr = jb.refit(X, y2, decay_rate=0.7, **kw)
        tr = tb.refit(X, y2, decay_rate=0.7, **kw)
        for a, b in zip(jr._gbdt.models, tr._gbdt.models):
            np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tr.predict(X), jr.predict(X), rtol=1e-6, atol=1e-6)
    # the original booster is untouched
    assert not np.allclose(tr.predict(X, raw_score=True), tb.predict(X, raw_score=True))


# ---------------------------------------------------------------------------
# scikit-learn estimators
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("est,kind,extra", [
    ("LGBMRegressor", "regression", {}),
    ("LGBMClassifier", "binary", {}),
    ("LGBMClassifier", "multiclass", {}),
    ("LGBMRanker", "rank", {}),
    ("LGBMRegressor", "regression", {"subsample": 0.7, "colsample_bytree": 0.8}),
    ("LGBMRegressor", "regression", {"boosting_type": "dart"}),
])
def test_estimators_match_jax(est, kind, extra):
    X, y, group = _data(kind)
    kw = dict(n_estimators=8, num_leaves=7, learning_rate=0.3, min_child_samples=20,
              min_split_gain=0.1, random_state=3, **extra)
    fit = {} if group is None else {"group": group}
    jm = getattr(jlgb, est)(**kw).fit(X, y, **fit)
    tm = getattr(tlgb, est)(**kw, device_type="cpu").fit(X, y, **fit)
    tol = 1e-4 if kind == "multiclass" else 1e-5
    np.testing.assert_allclose(tm.predict(X), jm.predict(X), rtol=tol, atol=tol)
    if est == "LGBMClassifier":
        np.testing.assert_allclose(tm.predict_proba(X), jm.predict_proba(X), rtol=tol,
                                   atol=tol)
        assert list(tm.classes_) == list(jm.classes_)
    np.testing.assert_array_equal(tm.feature_importances_, jm.feature_importances_)
    assert tm.n_features_in_ == X.shape[1] and tm.n_estimators_ == 8
    assert tm.get_params()["device_type"] == "cpu"


def test_estimator_eval_set_custom_objective_and_init_model():
    X, y, _ = _data("regression")

    def l2(y_true, y_pred):
        return y_pred - y_true, np.ones_like(y_pred)

    def mae(y_true, y_pred):
        return "mae", float(np.mean(np.abs(y_true - y_pred))), False

    out = []
    for lgb, extra in ((jlgb, {}), (tlgb, CPU)):
        m = lgb.LGBMRegressor(n_estimators=5, num_leaves=7, objective=l2, **extra)
        m.fit(X[:2000], y[:2000], eval_set=[(X[2000:], y[2000:])], eval_metric=mae)
        m2 = lgb.LGBMRegressor(n_estimators=3, num_leaves=7, **extra)
        m2.fit(X[:2000], y[:2000], init_model=m.booster_)
        out.append((m, m2))
    (jm, jm2), (tm, tm2) = out
    np.testing.assert_allclose(tm.predict(X), jm.predict(X), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.evals_result_["valid_0"]["mae"],
                               jm.evals_result_["valid_0"]["mae"], rtol=1e-5)
    assert tm2.booster_.num_trees() == 8
    np.testing.assert_allclose(tm2.predict(X), jm2.predict(X), rtol=1e-5, atol=1e-5)


def _int_data(n=3000, f=6, vals=12, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randint(0, vals, size=(n, f)).astype(np.float64)
    return X, X @ rng.randn(f) + 2.0 * rng.randn(n)


def _leaf_groups(values):
    groups = {}
    for i, v in enumerate(np.round(values, 6)):
        groups.setdefault(float(v), []).append(i)
    return {frozenset(g) for g in groups.values()}


@pytest.mark.parametrize("mode", ["strict", "rounds"])
def test_one_iteration_matches_sklearn_histgbm(mode):
    """External oracle (tests/test_sklearn_parity.py for the port): with
    one bin per integer value, no regularization and matched stopping
    parameters, one iteration of the estimator grows scikit-learn
    HistGradientBoosting's tree: the same leaves, row partition and
    values."""
    sk = pytest.importorskip("sklearn.ensemble")
    X, y = _int_data()
    skm = sk.HistGradientBoostingRegressor(
        max_iter=1, max_leaf_nodes=15, learning_rate=0.7, l2_regularization=0.0,
        min_samples_leaf=1, max_bins=64, early_stopping=False, validation_fraction=None)
    skm.fit(X, y)
    ours = tlgb.LGBMRegressor(
        n_estimators=1, num_leaves=15, learning_rate=0.7, min_child_samples=1,
        min_child_weight=0.0, reg_lambda=0.0, min_split_gain=1e-10,
        tree_growth_mode=mode, device_type="cpu").fit(X, y)
    assert ours.booster_._gbdt.models[0].num_leaves == skm._predictors[0][0].get_n_leaf_nodes()
    assert np.abs(ours.predict(X) - skm.predict(X)).max() < 1e-3
    assert _leaf_groups(ours.predict(X)) == _leaf_groups(skm.predict(X))


def test_binary_classifier_matches_sklearn_histgbm():
    sk = pytest.importorskip("sklearn.ensemble")
    X, y = _int_data()
    yb = (y > np.median(y)).astype(np.float64)
    skm = sk.HistGradientBoostingClassifier(
        max_iter=1, max_leaf_nodes=15, learning_rate=0.7, l2_regularization=0.0,
        min_samples_leaf=1, max_bins=64, early_stopping=False, validation_fraction=None)
    skm.fit(X, yb)
    ours = tlgb.LGBMClassifier(
        n_estimators=1, num_leaves=15, learning_rate=0.7, min_child_samples=1,
        min_child_weight=0.0, reg_lambda=0.0, min_split_gain=1e-10,
        device_type="cpu").fit(X, yb)
    raw = ours.predict(X, raw_score=True)
    assert np.abs(raw - skm.decision_function(X)).max() < 1e-3
    assert _leaf_groups(raw) == _leaf_groups(skm.decision_function(X))
