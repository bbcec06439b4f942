"""The boosting modes and the training-state API of lightgbm_tpu_torch
against the JAX package, on the CPU: GOSS (with the JAX package's
uniforms given), DART, random forest, bagging_by_query, a custom
objective, init_model continuation, rollback and a validation set added
after training started.

Held to: GOSS's mask and weights bitwise; the same tree structure, tree
for tree; leaf values and predictions within 1e-5 (1e-4 for multiclass,
the bar of test_torch_multiclass.py, whose docstring gives the reason);
random-forest model text crossing between the packages within 1e-6 with
``average_output`` kept.  Both packages run their default CPU grower (the
strict one) unless a case names another.
"""

import jax
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.convert import booster_from_jax_model_string
from lightgbm_tpu_torch.models import gbdt as tgbdt

N_TR = 1500


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data(kind="binary", seed=5, n=2000, f=6):
    """Values on a coarse grid (gains well apart), 5% missing.  2000 rows,
    so a prediction over all of them takes the JAX traversal's 2048-row
    bucket, not one that tests/test_predict_budget.py counts compiles of."""
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
            "learning_rate": 0.2, "min_gain_to_split": 0.1, "verbosity": -1, **extra}


def _both(params, rounds, kind=None, valid=True, **train_kw):
    """Train both packages on the same data: (X, jax booster, port booster,
    jax evals, port evals)."""
    X, y, group = _data(kind or ("binary" if params["objective"] == "binary"
                                 else "regression"))
    g_tr = None if group is None else group[: N_TR // 25]
    g_va = None if group is None else group[N_TR // 25:]
    jtr = jlgb.Dataset(X[:N_TR], label=y[:N_TR], group=g_tr)
    jva = jlgb.Dataset(X[N_TR:], label=y[N_TR:], group=g_va, reference=jtr)
    tp = {**params, "device_type": "cpu"}
    ttr = tlgb.Dataset(X[:N_TR], label=y[:N_TR], group=g_tr, params=tp)
    tva = tlgb.Dataset(X[N_TR:], label=y[N_TR:], group=g_va, reference=ttr)
    jres, tres = {}, {}
    jb = jlgb.train(dict(params), jtr, rounds, valid_sets=[jva] if valid else None,
                    callbacks=[jlgb.record_evaluation(jres)],
                    **train_kw.get("jax", {}))
    tb = tlgb.train(tp, ttr, rounds, valid_sets=[tva] if valid else None,
                    callbacks=[tlgb.record_evaluation(tres)],
                    **train_kw.get("port", {}))
    return X, jb, tb, jres, tres


def _same_trees(jb, tb, tol=1e-5, n_trees=None):
    jt, tt = jb._gbdt.models, tb._gbdt.models
    assert len(jt) == len(tt)
    if n_trees is not None:
        assert len(jt) == n_trees
    for a, b in zip(jt, tt):
        assert a.num_leaves == b.num_leaves
        m = a.num_leaves - 1
        for f in ("split_feature", "threshold", "left_child", "right_child",
                  "decision_type"):
            np.testing.assert_array_equal(getattr(b, f)[:m], getattr(a, f)[:m], err_msg=f)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=tol, atol=tol)
        assert b.shrinkage == pytest.approx(a.shrinkage, rel=1e-12)


def _same_predictions(X, jb, tb, tol=1e-5):
    for raw in (False, True):
        tp, jp = tb.predict(X, raw_score=raw), jb.predict(X, raw_score=raw)
        assert tp.shape == jp.shape
        np.testing.assert_allclose(tp, jp, rtol=tol, atol=tol)


def _jax_uniforms(self, n):
    key = jax.random.PRNGKey(self.cfg.bagging_seed + self.iter_)
    return torch.from_numpy(np.array(jax.random.uniform(key, (n,)))).to(self.device)


# ---------------------------------------------------------------------------
# GOSS
# ---------------------------------------------------------------------------
def test_goss_mask_is_the_jax_packages_bitwise():
    """The port's mask and weights from the JAX package's uniforms, on the
    gradients of a binary model, against the JAX package's _goss_mask."""
    X, y, _ = _data("binary")
    p = _params("binary", data_sample_strategy="goss", top_rate=0.2, other_rate=0.1)
    jb = jlgb.Booster(params=dict(p), train_set=jlgb.Dataset(X, label=y))
    for _ in range(6):
        jb.update()
    g = jb._gbdt
    g.iter_ = 11  # past the warm-up of int(1 / 0.2) iterations
    jm, jw = (np.asarray(a) for a in g._goss_mask())
    u = torch.from_numpy(np.array(jax.random.uniform(
        jax.random.PRNGKey(g.cfg.bagging_seed + 11), (len(y),))))
    tm, tw = tgbdt.goss_mask(torch.from_numpy(np.array(g._cur_grad)),
                             torch.from_numpy(np.array(g._cur_hess)), u, 0.2, 0.1)
    np.testing.assert_array_equal(tm.numpy(), jm)
    np.testing.assert_array_equal(tw.numpy(), jw)
    assert 0 < tm.sum() < len(y) and (tw > 1).any()


@pytest.mark.parametrize("mode", ["strict", "rounds"])
@pytest.mark.parametrize("spelling", [{"data_sample_strategy": "goss"},
                                      {"boosting": "goss"}])
def test_goss_trains_the_jax_packages_trees(mode, spelling, monkeypatch):
    """25 rounds at learning rate 0.2: 20 past the warm-up.  The split floor
    of 1.0 leaves out a late low-gain split (gain 1.5 in tree 15 of the
    rounds grower) whose two candidate thresholds isolate the same rows: an
    exact tie, which the port's exact sums keep and the JAX package's f32
    sums break (ROADMAP queue C: not a fault)."""
    monkeypatch.setattr(tgbdt.GBDT, "_goss_uniforms", _jax_uniforms)
    p = _params("binary", top_rate=0.2, other_rate=0.1, tree_growth_mode=mode,
                min_gain_to_split=1.0, **spelling)
    X, jb, tb, jres, tres = _both(p, 25)
    _same_trees(jb, tb, n_trees=25)
    _same_predictions(X, jb, tb)
    np.testing.assert_allclose(tres["valid_0"]["binary_logloss"],
                               jres["valid_0"]["binary_logloss"], rtol=1e-5, atol=1e-6)


def test_goss_draws_are_seeded_on_the_training_device():
    X, y, _ = _data("binary")
    p = _params("binary", data_sample_strategy="goss", device_type="cpu",
                learning_rate=0.5)
    a, b = (tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 6) for _ in range(2))
    assert a.model_to_string() == b.model_to_string()
    masks = []
    for seed in (1, 2):
        q = {**p, "bagging_seed": seed}
        bst = tlgb.Booster(params=q, train_set=tlgb.Dataset(X, label=y, params=q))
        for _ in range(3):
            bst.update()
        masks.append(bst._gbdt._bagging_mask()[0].numpy())
    assert not np.array_equal(*masks)


# ---------------------------------------------------------------------------
# DART and random forest
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("extra", [
    {},
    {"uniform_drop": True, "drop_rate": 0.3, "skip_drop": 0.2},
    {"xgboost_dart_mode": True, "max_drop": 2, "drop_rate": 0.5, "skip_drop": 0.0},
])
def test_dart_matches_jax(extra):
    p = _params("regression", boosting="dart", **extra)
    X, jb, tb, _, _ = _both(p, 12)
    _same_trees(jb, tb, n_trees=12)
    _same_predictions(X, jb, tb)
    assert sum(tb._gbdt.drops) > 0


def test_dart_rescales_pending_trees_without_reading_them():
    """The drops of a DART iteration run on pending device trees: the
    iteration makes no host read, and the rescale reaches the exported
    trees (the same model as a run that reads every tree each iteration)."""
    X, y, _ = _data("regression")
    p = _params("regression", boosting="dart", drop_rate=0.5, skip_drop=0.0,
                device_type="cpu", tree_growth_mode="rounds")
    from lightgbm_tpu_torch.utils import sanitizer as san

    bst = tlgb.Booster(params=p, train_set=tlgb.Dataset(X, label=y, params=p))
    read = tlgb.Booster(params=p, train_set=tlgb.Dataset(X, label=y, params=p))
    with san.DispatchCounter() as c:
        for _ in range(8):
            bst.update()
    assert c.host_syncs == 0 and len(bst._gbdt._pending) == 8
    for _ in range(8):
        read.update()
        read._gbdt.models  # noqa: B018 -- materialise every tree
    assert sum(bst._gbdt.drops) > 0 and bst._gbdt.drops == read._gbdt.drops
    assert bst.model_to_string() == read.model_to_string()
    # the validation-free score equals the model's prediction
    np.testing.assert_allclose(bst._gbdt._score.numpy(), bst.predict(X, raw_score=True),
                               rtol=1e-5, atol=1e-5)


def test_dart_multiclass_matches_jax():
    X, y, _ = _data("multiclass")
    p = _params("multiclass", num_class=3, boosting="dart", drop_rate=0.3, skip_drop=0.0)
    jb = jlgb.train(dict(p), jlgb.Dataset(X, label=y), 6)
    tp = {**p, "device_type": "cpu"}
    tb = tlgb.train(tp, tlgb.Dataset(X, label=y, params=tp), 6)
    _same_trees(jb, tb, tol=1e-4, n_trees=18)
    _same_predictions(X, jb, tb, tol=1e-4)


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_random_forest_matches_jax(objective):
    p = _params(objective, boosting="rf", bagging_freq=1, bagging_fraction=0.6,
                feature_fraction=0.8)
    X, jb, tb, jres, tres = _both(p, 10)
    _same_trees(jb, tb, n_trees=10)
    _same_predictions(X, jb, tb)
    assert all(t.shrinkage == 1.0 for t in tb._gbdt.models)
    for key in jres["valid_0"]:  # metrics read the averaged margin
        np.testing.assert_allclose(tres["valid_0"][key], jres["valid_0"][key],
                                   rtol=1e-5, atol=1e-6, err_msg=key)


def test_random_forest_needs_bagging():
    X, y, _ = _data("binary")
    p = _params("binary", boosting="rf", device_type="cpu")
    with pytest.raises(ValueError, match="bagging"):
        tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 1)


def test_random_forest_model_text_crosses_both_ways():
    p = _params("binary", boosting="random_forest", bagging_freq=1, bagging_fraction=0.7)
    X, jb, tb, _, _ = _both(p, 6)
    jt, tt = jb.model_to_string(), tb.model_to_string()
    assert "\naverage_output\n" in tt and "\naverage_output\n" in jt
    carried = booster_from_jax_model_string(jt, device_type="cpu")
    assert carried._gbdt.average_output
    np.testing.assert_allclose(carried.predict(X), jb.predict(X), rtol=1e-6, atol=1e-6)
    back = jlgb.Booster(model_str=tt)
    assert back._gbdt.average_output
    np.testing.assert_allclose(back.predict(X), tb.predict(X), rtol=1e-6, atol=1e-6)
    again = tlgb.Booster(model_str=tt, params={"device_type": "cpu"})
    np.testing.assert_array_equal(again.predict(X), tb.predict(X))
    def trees(text):
        return text.split("\nTree=", 1)[1].split("end of trees")[0]

    assert trees(again.model_to_string()) == trees(tt)


# ---------------------------------------------------------------------------
# bagging by query, custom objectives, init_model, rollback, late valid sets
# ---------------------------------------------------------------------------
def test_bagging_by_query_matches_jax():
    p = _params("lambdarank", bagging_freq=1, bagging_fraction=0.5,
                bagging_by_query=True, eval_at=[3])
    X, jb, tb, jres, tres = _both(p, 5, kind="rank")
    _same_trees(jb, tb, n_trees=5)
    _same_predictions(X, jb, tb)
    mask = tb._gbdt._bagging_mask()[0].numpy()
    per_query = mask[: N_TR].reshape(-1, 25)
    assert np.all(per_query.all(axis=1) | ~per_query.any(axis=1))  # whole queries


def _l2_fobj(score, ds):
    return score - ds.get_label(), np.ones_like(score)


@pytest.mark.parametrize("how", ["fobj", "callable_objective"])
def test_custom_objective_matches_jax(how):
    X, y, _ = _data("regression")
    p = _params("regression")
    jd, td = jlgb.Dataset(X, label=y), tlgb.Dataset(X, label=y, params={"device_type": "cpu"})
    tp = {**p, "device_type": "cpu"}
    if how == "fobj":
        jb = jlgb.Booster(params={**p, "objective": "none"}, train_set=jd)
        tb = tlgb.Booster(params={**tp, "objective": "none"}, train_set=td)
        for _ in range(5):
            jb.update(fobj=_l2_fobj)
            tb.update(fobj=_l2_fobj)
    else:
        jb = jlgb.train({**p, "objective": _l2_fobj}, jd, 5)
        tb = tlgb.train({**tp, "objective": _l2_fobj}, td, 5)
    _same_trees(jb, tb, n_trees=5)
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=1e-5, atol=1e-5)
    # custom gradients run eagerly: nothing is captured or replayed
    assert all(s["replays"] == 0 for s in tb._gbdt.round_stats)


@pytest.mark.parametrize("source", ["booster", "string", "file"])
def test_init_model_continues_as_jax_does(source, tmp_path):
    p = _params("regression")
    X, jb0, tb0, _, _ = _both(p, 5, valid=False)
    X, y, _ = _data("regression")
    if source == "booster":
        j_init, t_init = jb0, tb0
    else:  # the JAX package takes text through a file only
        jb0.save_model(str(tmp_path / "j.txt"))
        tb0.save_model(str(tmp_path / "t.txt"))
        j_init = str(tmp_path / "j.txt")
        t_init = tb0.model_to_string() if source == "string" else str(tmp_path / "t.txt")
    jb = jlgb.train(dict(p), jlgb.Dataset(X[:N_TR], label=y[:N_TR]), 5, init_model=j_init)
    tp = {**p, "device_type": "cpu"}
    tb = tlgb.train(tp, tlgb.Dataset(X[:N_TR], label=y[:N_TR], params=tp), 5,
                    init_model=t_init)
    assert tb.num_trees() == 10 and tb.current_iteration() == 10
    _same_trees(jb, tb, n_trees=10)
    _same_predictions(X, jb, tb)
    # the replayed score is the model's raw prediction on the training rows
    np.testing.assert_allclose(tb._gbdt._score.numpy(),
                               tb.predict(X[:N_TR], raw_score=True), rtol=1e-5, atol=1e-5)


def test_init_model_from_a_snapshot_is_not_ported():
    """Snapshots are ported now (ROADMAP A14; the name is kept, and
    tests/test_torch_resume.py holds the resume itself): a snapshot that
    does not exist raises instead of training from nothing, and
    resume="auto" without any snapshot trains from scratch."""
    X, y, _ = _data("regression")
    p = _params("regression", device_type="cpu")
    with pytest.raises(FileNotFoundError):
        tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 1,
                   init_model="model.txt.snapshot_iter_5")
    out = {"output_model": "no_such_dir/model.txt"}
    bst = tlgb.train({**p, **out, "resume": "auto"}, tlgb.Dataset(X, label=y, params=p), 1)
    assert bst.num_trees() == 1


@pytest.mark.parametrize("mode", ["strict", "rounds"])
def test_rollback_matches_jax(mode):
    p = _params("binary", tree_growth_mode=mode)
    X, y, _ = _data("binary")
    jb = jlgb.Booster(params=dict(p), train_set=jlgb.Dataset(X, label=y))
    tp = {**p, "device_type": "cpu"}
    tb = tlgb.Booster(params=tp, train_set=tlgb.Dataset(X, label=y, params=tp))
    for b in (jb, tb):
        for _ in range(4):
            b.update()
        b.rollback_one_iter()
        b.rollback_one_iter()
        for _ in range(2):
            b.update()
    assert tb.current_iteration() == 4 and tb.num_trees() == 4
    _same_trees(jb, tb, n_trees=4)
    _same_predictions(X, jb, tb)
    np.testing.assert_allclose(tb._gbdt._score.numpy(), np.asarray(jb._gbdt._score),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind,extra,tol", [
    ("binary", {}, 1e-5),
    ("multiclass", {"num_class": 3}, 1e-4),
])
def test_validation_set_added_after_training_started(kind, extra, tol):
    X, y, _ = _data(kind)
    p = _params(kind, **extra)
    tp = {**p, "device_type": "cpu"}
    jtr = jlgb.Dataset(X[:N_TR], label=y[:N_TR])
    ttr = tlgb.Dataset(X[:N_TR], label=y[:N_TR], params=tp)
    jb = jlgb.Booster(params=dict(p), train_set=jtr)
    tb = tlgb.Booster(params=tp, train_set=ttr)
    for b, lgb, tr in ((jb, jlgb, jtr), (tb, tlgb, ttr)):
        for _ in range(3):
            b.update()
        b.add_valid(lgb.Dataset(X[N_TR:], label=y[N_TR:], reference=tr), "late")
        b.update()
    jv, tv = jb.eval_valid(), tb.eval_valid()
    assert [r[:2] for r in tv] == [r[:2] for r in jv]
    np.testing.assert_allclose([r[2] for r in tv], [r[2] for r in jv], rtol=tol, atol=tol)
    np.testing.assert_allclose(tb._gbdt._valid_scores[0].numpy(),
                               tb.predict(X[N_TR:], raw_score=True), rtol=tol, atol=tol)
