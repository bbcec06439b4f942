"""Linear trees of lightgbm_tpu_torch (ops/linear.py and the GBDT paths
around it) against the JAX package's.

Held to: the JAX package's tree structure node for node; leaf models and
predictions within 1e-4 relative (both packages build the moment matrices
in f32 in another summation order and solve in f32 LAPACK, so a leaf's
coefficients carry the solve's conditioning on top of f32 rounding), with
an absolute floor of 1e-5 for values near 0; the port's own model text
reloads bitwise.  Rows with NaN in a path feature take the constant leaf
value in both packages; prediction early stopping stops the same rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops import linear as jlin
from lightgbm_tpu_torch.ops import linear as tlin

from test_torch_train import _data

ROUNDS = 5
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _linear_data(seed=11, n=3000):
    """_data's regression rows plus a slope in feature 5, which the leaf
    models take up where 5 is on a leaf's path."""
    X, y = _data("regression", seed=seed, n=n)
    return X, y + 0.8 * np.nan_to_num(X[:, 5])


def _params(grower, **extra):
    return {"objective": "regression", "num_leaves": 8, "min_data_in_leaf": 50,
            "learning_rate": 0.3, "linear_tree": True, "linear_lambda": 0.01,
            "tree_growth_mode": grower, "min_gain_to_split": 0.1, "verbosity": -1,
            **extra}


def _fit_inputs(seed=0, n=2000, f=6, L=5):
    rng = np.random.RandomState(seed)
    raw = rng.randn(n, f).astype(np.float32)
    raw[rng.rand(n, f) < 0.03] = np.nan
    leaf = rng.randint(0, L, n).astype(np.int32)
    grad = rng.randn(n).astype(np.float32)
    hess = (0.5 + rng.rand(n)).astype(np.float32)
    mask = rng.rand(n) < 0.9
    used = rng.rand(L, f) < 0.5
    used[0] = False  # a leaf without path features keeps its constant
    lv = rng.randn(L).astype(np.float32)
    return raw, leaf, grad, hess, mask, used, lv


@pytest.mark.parametrize("K", [2, 6])
def test_fit_linear_leaves_matches_jax(K):
    raw, leaf, grad, hess, mask, used, lv = _fit_inputs()
    L = used.shape[0]
    j = jlin.fit_linear_leaves(*map(jnp.asarray, (raw, leaf, grad, hess, mask, used, lv)),
                               jnp.float32(0.1), K=K, num_leaves=L)
    t = tlin.fit_linear_leaves(*map(torch.from_numpy, (raw, leaf, grad, hess, mask,
                                                       used, lv)),
                               0.1, K=K, num_leaves=L)
    coef, const, fidx, nf, pred, good = (np.asarray(a) for a in j)
    np.testing.assert_array_equal(t[2].numpy(), fidx)
    np.testing.assert_array_equal(t[3].numpy(), nf)
    np.testing.assert_array_equal(t[5].numpy(), good)
    assert good.sum() >= 3
    for got, want in ((t[0], coef), (t[1], const), (t[4], pred)):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # NaN in a path feature: the constant leaf value
    lid = torch.from_numpy(leaf)
    rows = tlin.predict_linear_rows(torch.from_numpy(raw), lid, *t[:4],
                                    torch.from_numpy(lv)).numpy()
    jrows = np.asarray(jlin.predict_linear_rows(jnp.asarray(raw), jnp.asarray(leaf),
                                                *j[:4], jnp.asarray(lv)))
    np.testing.assert_allclose(rows, jrows, rtol=RTOL, atol=ATOL)
    ok = np.arange(K)[None, :] < nf[leaf][:, None]
    nan_path = (np.isnan(np.take_along_axis(raw, fidx[leaf], axis=1)) & ok).any(axis=1)
    assert nan_path.any()
    np.testing.assert_array_equal(rows[nan_path], lv[leaf[nan_path]])


@pytest.mark.parametrize("grower", ["strict", "rounds"])
def test_linear_training_matches_jax(grower):
    X, y = _linear_data()
    p = _params(grower, metric="l2")
    jtr = jlgb.Dataset(X[:2500], label=y[:2500], params=p)
    jva = jlgb.Dataset(X[2500:], label=y[2500:], reference=jtr)
    jres = {}
    jb = jlgb.train(dict(p), jtr, ROUNDS, valid_sets=[jva],
                    callbacks=[jlgb.record_evaluation(jres)])
    tp = {**p, "device_type": "cpu"}
    ttr = tlgb.Dataset(X[:2500], label=y[:2500], params=tp)
    tva = tlgb.Dataset(X[2500:], label=y[2500:], reference=ttr)
    tres = {}
    tb = tlgb.train(tp, ttr, ROUNDS, valid_sets=[tva],
                    callbacks=[tlgb.record_evaluation(tres)])
    for a, b in zip(jb._gbdt.models, tb._gbdt.models):
        assert b.is_linear and a.num_leaves == b.num_leaves > 4
        m = a.num_leaves - 1
        np.testing.assert_array_equal(b.split_feature[:m], a.split_feature[:m])
        np.testing.assert_array_equal(b.threshold[:m], a.threshold[:m])
        for la, lb, ca, cb in zip(a.leaf_features, b.leaf_features, a.leaf_coeff,
                                  b.leaf_coeff):
            np.testing.assert_array_equal(lb, la)
            np.testing.assert_allclose(cb, ca, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(b.leaf_const, a.leaf_const, rtol=RTOL, atol=ATOL)
    assert any(len(f) for t in tb._gbdt.models for f in t.leaf_features)
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=RTOL, atol=ATOL)
    # the valid scores, fed by predict_linear_rows each iteration
    np.testing.assert_allclose(tres["valid_0"]["l2"], jres["valid_0"]["l2"], rtol=RTOL)


def test_linear_model_text_crosses_both_ways(tmp_path):
    X, y = _linear_data(seed=12)
    p = _params("rounds")
    jb = jlgb.train(dict(p), jlgb.Dataset(X, label=y, params=p), ROUNDS)
    tp = {**p, "device_type": "cpu"}
    tb = tlgb.train(tp, tlgb.Dataset(X, label=y, params=tp), ROUNDS)
    text = tb.model_to_string()
    assert "is_linear=1" in text and "leaf_coeff=" in text
    # port text -> port booster: bitwise; -> JAX booster, through a file
    again = tlgb.Booster(model_str=text, params={"device_type": "cpu"})
    np.testing.assert_array_equal(again.predict(X), tb.predict(X))
    path = tmp_path / "linear.txt"
    tb.save_model(str(path))
    back = jlgb.Booster(model_file=str(path))
    np.testing.assert_allclose(back.predict(X), tb.predict(X), rtol=RTOL, atol=ATOL)
    # JAX text -> port booster
    carried = tlgb.Booster(model_str=jb.model_to_string(), params={"device_type": "cpu"})
    np.testing.assert_allclose(carried.predict(X), jb.predict(X), rtol=RTOL, atol=ATOL)


def test_linear_nan_rows_fall_back_to_constant():
    """A row with NaN in its leaf's path features predicts the leaf's
    constant value, in both packages."""
    X, y = _linear_data(seed=13)
    p = _params("strict")
    jb = jlgb.train(dict(p), jlgb.Dataset(X, label=y, params=p), 2)
    tp = {**p, "device_type": "cpu"}
    tb = tlgb.train(tp, tlgb.Dataset(X, label=y, params=tp), 2)
    Xn = X[:200].copy()
    Xn[:, 5] = np.nan
    np.testing.assert_allclose(tb.predict(Xn), jb.predict(Xn), rtol=RTOL, atol=ATOL)
    t = tb._gbdt.models[0]
    leaf = t.predict_leaf_batch(Xn)
    on_path = np.array([5 in list(t.leaf_features[l]) for l in leaf])
    assert on_path.any()
    np.testing.assert_allclose(t.predict_batch(Xn)[on_path], t.leaf_value[leaf[on_path]])


def test_linear_rollback_init_model_and_late_valid():
    """Rollback, continued training (init_model) and a validation set added
    after training started replay the linear leaves on the device: the
    scores equal the predictions of the trees they hold."""
    X, y = _linear_data(seed=14)
    tp = {**_params("rounds"), "device_type": "cpu"}
    ds = tlgb.Dataset(X, label=y, params=tp)
    bst = tlgb.Booster(params=tp, train_set=ds)
    for _ in range(4):
        bst.update()
    bst.rollback_one_iter()
    g = bst._gbdt
    np.testing.assert_allclose(g._score.numpy(), bst.predict(X, raw_score=True),
                               rtol=RTOL, atol=ATOL)
    late = tlgb.Dataset(X[:500], label=y[:500], reference=ds)
    bst.add_valid(late, "late")
    np.testing.assert_allclose(g._valid_scores[0].numpy(),
                               bst.predict(X[:500], raw_score=True), rtol=RTOL, atol=ATOL)
    more = tlgb.train(tp, tlgb.Dataset(X, label=y, params=tp), 2, init_model=bst)
    assert more.num_trees() == 5
    np.testing.assert_allclose(more._gbdt._score.numpy(), more.predict(X, raw_score=True),
                               rtol=RTOL, atol=ATOL)


def test_linear_prediction_early_stop_matches_jax():
    """Prediction early stopping over linear trees (binary): the rows that
    stop agree with the JAX package's, a row that runs every window ends
    bitwise at the full prediction."""
    X, y = _linear_data(seed=15)
    yb = (y > np.median(y)).astype(float)
    p = _params("rounds", objective="binary")
    jb = jlgb.train(dict(p), jlgb.Dataset(X, label=yb, params=p), 8)
    tp = {**p, "device_type": "cpu"}
    tb = tlgb.train(tp, tlgb.Dataset(X, label=yb, params=tp), 8)
    es = dict(pred_early_stop=True, pred_early_stop_freq=2, pred_early_stop_margin=1.0)
    got = tb.predict(X, raw_score=True, **es)
    for key, v in es.items():  # the JAX package reads them from its config
        setattr(jb._gbdt.cfg, key, v)
    want = jb.predict(X, raw_score=True)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    stats = tb._gbdt.early_stop_stats
    assert 0 < stats["stopped"] < len(X) and stats["chunks"] == 4
    full = tb.predict(X, raw_score=True)
    ran = np.abs(got) < 1.0  # never past the margin: every window ran
    np.testing.assert_array_equal(got[ran], full[ran])


@pytest.mark.parametrize("extra,match", [
    ({"boosting": "dart"}, "dart"),
    ({"objective": "regression_l1"}, "renewal"),
    ({"is_enable_sparse": True}, "dense raw feature values"),
], ids=["dart", "renewing_objective", "sparse"])
def test_linear_gates_raise(extra, match):
    import scipy.sparse as sp

    X, y = _linear_data(n=300)
    p = {**_params("rounds"), "device_type": "cpu", **extra}
    data = sp.csr_matrix(np.nan_to_num(X)) if extra.get("is_enable_sparse") else X
    with pytest.raises((ValueError, tlgb.basic.LightGBMError), match=match):
        tlgb.train(p, tlgb.Dataset(data, label=y, params=p), 1)
