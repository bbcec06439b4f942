"""Whole trainings of lightgbm_tpu_torch against the JAX package beyond
binary and L2: multiclass (softmax and one-vs-all, K trees an iteration),
ranking (LambdaRank; XE-NDCG with the JAX package's draws given), and the
objectives with leaf renewal (quantile) or a log link (Poisson), on the
strict and the rounds grower, on the CPU.  Multiclass model text crosses
between the packages.

Held to: the same tree structure, tree for tree; leaf values, predictions
and the valid-set metrics within 1e-4 (the JAX package sums histograms in
f32 and recovers a sibling as parent minus child, so a leaf with a small
hessian sum keeps the parent's absolute rounding error: up to ~5e-5
relative on these fixtures; the port's sums are exact, and the rest is the
same f32 arithmetic); the port's own model text round trip and its
graph-path rounds bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import objectives as tobj
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.convert import booster_from_jax_model_string
from lightgbm_tpu_torch.models.gbdt import GBDT
from lightgbm_tpu_torch.ops import predict as tpredict

TOL = 1e-4
ROUNDS = 4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data(kind, seed=7, n=2400, f=6):
    """Values on a coarse grid (gains well apart), 5% missing; labels per
    kind; query sizes for ranking."""
    rng = np.random.RandomState(seed)
    X = np.round(rng.randn(n, f) * 8) / 8
    X[rng.rand(n, f) < 0.05] = np.nan
    Z = np.nan_to_num(X)
    s = 2.0 * (Z[:, 0] > 0.3) + 1.5 * Z[:, 1] - 1.0 * (Z[:, 2] < -0.5) + 0.5 * Z[:, 3]
    group = None
    if kind == "multiclass":
        y = np.digitize(s + 0.5 * rng.randn(n), [-0.5, 1.0]).astype(np.float64)
    elif kind == "rank":
        y = np.clip(np.round(s + rng.randn(n)), 0, 4)
        group = np.full(n // 24, 24)
    elif kind == "poisson":
        y = rng.poisson(np.exp(0.3 * s)).astype(np.float64)
    else:
        y = s + rng.randn(n)
    return X, y, group


def _train_both(objective, kind, mode, extra=None, valid=True, position=None):
    X, y, group = _data(kind)
    n_tr = 1920
    params = {"objective": objective, "num_leaves": 7, "min_data_in_leaf": 20,
              "learning_rate": 0.3, "min_gain_to_split": 0.1, "verbosity": -1,
              "tree_growth_mode": mode, **(extra or {})}
    g_tr = g_va = None
    if group is not None:
        g_tr, g_va = group[:n_tr // 24], group[n_tr // 24:]
    pos = None if position is None else position[:n_tr]
    jtr = jlgb.Dataset(X[:n_tr], label=y[:n_tr], group=g_tr, position=pos)
    jva = jlgb.Dataset(X[n_tr:], label=y[n_tr:], group=g_va, reference=jtr)
    jres, tres = {}, {}
    jb = jlgb.train(dict(params), jtr, ROUNDS, valid_sets=[jva] if valid else None,
                    callbacks=[jlgb.record_evaluation(jres)])
    tp = {**params, "device_type": "cpu"}
    ttr = tlgb.Dataset(X[:n_tr], label=y[:n_tr], group=g_tr, position=pos, params=tp)
    tva = tlgb.Dataset(X[n_tr:], label=y[n_tr:], group=g_va, reference=ttr)
    tb = tlgb.train(tp, ttr, ROUNDS, valid_sets=[tva] if valid else None,
                    callbacks=[tlgb.record_evaluation(tres)])
    return X, jb, tb, jres, tres


def _assert_same(X, jb, tb, jres, tres, trees):
    jt, tt = jb._gbdt.models, tb._gbdt.models
    assert len(jt) == len(tt) == trees
    for a, b in zip(jt, tt):
        assert a.num_leaves == b.num_leaves and a.num_leaves > 2
        m = a.num_leaves - 1
        np.testing.assert_array_equal(b.split_feature[:m], a.split_feature[:m])
        np.testing.assert_array_equal(b.threshold[:m], a.threshold[:m])
        np.testing.assert_array_equal(b.left_child[:m], a.left_child[:m])
        np.testing.assert_array_equal(b.right_child[:m], a.right_child[:m])
        np.testing.assert_allclose(b.leaf_value[:a.num_leaves],
                                   a.leaf_value[:a.num_leaves], rtol=TOL, atol=TOL)
    for raw in (False, True):
        tp, jp = tb.predict(X, raw_score=raw), jb.predict(X, raw_score=raw)
        assert tp.shape == jp.shape
        np.testing.assert_allclose(tp, jp, rtol=TOL, atol=TOL)
    assert set(tres) == set(jres)
    for name in jres:
        assert set(tres[name]) == set(jres[name])
        for key in jres[name]:
            np.testing.assert_allclose(tres[name][key], jres[name][key],
                                       rtol=TOL, atol=TOL, err_msg=key)


@pytest.mark.parametrize("mode", ["strict", "rounds"])
@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_multiclass_matches_jax(objective, mode):
    X, jb, tb, jres, tres = _train_both(
        objective, "multiclass", mode,
        {"num_class": 3, "metric": ["multi_logloss", "multi_error", "auc_mu"]})
    assert tb.predict(X).shape == (len(X), 3)
    _assert_same(X, jb, tb, jres, tres, 3 * ROUNDS)


@pytest.mark.parametrize("positions", [False, True])
@pytest.mark.parametrize("mode", ["strict", "rounds"])
def test_lambdarank_matches_jax(mode, positions):
    """With positions, a bias per display position is learned beside the
    trees (position-debiased LambdaRank)."""
    position = np.tile(np.arange(24), 100) if positions else None
    X, jb, tb, jres, tres = _train_both(
        "lambdarank", "rank", mode, {"metric": ["ndcg", "map"], "eval_at": [1, 3, 5],
                                     "lambdarank_position_bias_regularization": 0.5},
        position=position)
    _assert_same(X, jb, tb, jres, tres, ROUNDS)
    if positions:
        np.testing.assert_allclose(tb._gbdt.objective.pos_bias.numpy(),
                                   np.asarray(jb._gbdt.objective.pos_bias),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mode", ["strict", "rounds"])
def test_rank_xendcg_matches_jax_with_its_draws(mode, monkeypatch):
    def jax_draws(self, shape, device):
        key = jax.random.PRNGKey(self._seed + self._iter)
        return torch.from_numpy(np.array(jax.random.uniform(key, shape, dtype=jnp.float32)))

    monkeypatch.setattr(tobj.RankXENDCG, "draws", jax_draws)
    X, jb, tb, jres, tres = _train_both("rank_xendcg", "rank", mode,
                                        {"eval_at": [3, 5]})
    _assert_same(X, jb, tb, jres, tres, ROUNDS)


@pytest.mark.parametrize("mode", ["strict", "rounds"])
@pytest.mark.parametrize("objective,kind,extra", [
    ("poisson", "poisson", {}),
    ("quantile", "regression", {"alpha": 0.7}),
    ("regression_l1", "regression", {}),
])
def test_renewing_and_log_link_objectives_match_jax(objective, kind, extra, mode):
    X, jb, tb, jres, tres = _train_both(objective, kind, mode, extra)
    _assert_same(X, jb, tb, jres, tres, ROUNDS)


@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_multiclass_model_text_crosses_both_ways(objective, tmp_path):
    X, jb, tb, _, _ = _train_both(objective, "multiclass", "rounds",
                                  {"num_class": 3}, valid=False)
    text = tb.model_to_string()
    assert "num_class=3" in text and "num_tree_per_iteration=3" in text
    assert f"objective={objective} num_class:3" in text
    # JAX text -> port booster
    carried = booster_from_jax_model_string(jb.model_to_string(), device_type="cpu")
    assert carried.current_iteration() == ROUNDS
    for raw in (False, True):
        np.testing.assert_allclose(carried.predict(X, raw_score=raw),
                                   jb.predict(X, raw_score=raw), rtol=1e-6, atol=1e-6)
    # port text -> JAX booster, through a file
    path = tmp_path / "port_model.txt"
    tb.save_model(str(path))
    back = jlgb.Booster(model_file=str(path))
    np.testing.assert_allclose(back.predict(X), tb.predict(X), rtol=1e-6, atol=1e-6)
    # port text -> port booster: bitwise, whole model and an iteration window
    again = tlgb.Booster(model_str=text, params={"device_type": "cpu"})
    np.testing.assert_array_equal(again.predict(X), tb.predict(X))
    np.testing.assert_array_equal(again.predict(X, start_iteration=1, num_iteration=2),
                                  tb.predict(X, start_iteration=1, num_iteration=2))


def test_multiclass_prediction_is_each_class_summed_alone():
    """predict_raw_multiclass: class c's margin is predict_raw_values over
    trees c, c + K, c + 2K, ... in that order, bit for bit."""
    X, _, tb, _, _ = _train_both("multiclass", "multiclass", "rounds",
                                 {"num_class": 3}, valid=False)
    g = tb._gbdt
    trees = g._trees_for_export(0, -1)
    x = torch.as_tensor(np.asarray(X, np.float32))
    whole = tpredict.predict_raw_multiclass(x, **g._stacked(trees, x.device), k=3)
    for c in range(3):
        one = tpredict.predict_raw_values(x, **g._stacked(trees[c::3], x.device))
        np.testing.assert_array_equal(whole[:, c].numpy(), one.numpy())


@pytest.mark.parametrize("objective,extra", [
    ("multiclass", {"num_class": 3}),
    ("lambdarank", {}),
])
def test_fused_path_takes_every_class_tree(objective, extra):
    """fused_training on and off grow the same model text; on the fused
    path every round of every class tree is one dispatch of the one cache
    of the training (on the card: one capture a key, the class trees
    replaying it)."""
    kind = "multiclass" if objective == "multiclass" else "rank"
    X, y, group = _data(kind)
    texts = []
    for fused in (True, False):
        p = {"objective": objective, "num_leaves": 7, "min_data_in_leaf": 20,
             "verbosity": -1, "device_type": "cpu", "tree_growth_mode": "rounds",
             "fused_training": fused, **extra}
        bst = tlgb.train(p, tlgb.Dataset(X, label=y, group=group, params=p), 3)
        texts.append(bst.model_to_string())
        stats = bst._gbdt.round_stats
        assert len(stats) == 3 * extra.get("num_class", 1)
        if fused:
            assert all(s["dispatches"] == s["rounds"] > 0 for s in stats)
            assert bst._gbdt._round_graphs is not None
        else:
            assert all(s["dispatches"] == 0 for s in stats)
    assert texts[0] == texts[1]


def test_fused_gate_for_more_trees_an_iteration():
    """GBDT._fused_eligible: at most 8 trees an iteration (the JAX
    package's cap); XE-NDCG (host draw counter) and renewing objectives
    stay eager; the strict grower is never fused."""
    X, y, group = _data("rank", n=240)
    yc = np.arange(len(X)) % 9

    def gate(label=y, **extra):
        p = {"device_type": "cpu", "verbosity": -1, "tree_growth_mode": "rounds",
             **extra}
        g = GBDT(Config.from_dict(p))
        ds = tlgb.Dataset(X, label=label, group=group, params=p)
        ds.construct()
        return g._fused_eligible(ds)

    assert gate(label=yc, objective="multiclass", num_class=8)
    assert not gate(label=yc, objective="multiclass", num_class=9)
    assert gate(objective="lambdarank")
    assert not gate(objective="rank_xendcg")
    assert not gate(objective="quantile")
    assert not gate(objective="regression", tree_growth_mode="strict")


def test_query_information_is_checked():
    X, y, group = _data("rank", n=240)
    p = {"objective": "lambdarank", "device_type": "cpu", "verbosity": -1}
    with pytest.raises(ValueError, match="group"):
        tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 1)
    with pytest.raises(ValueError, match="group sizes"):
        tlgb.train(p, tlgb.Dataset(X, label=y, group=group[:-1], params=p), 1)
    ds = tlgb.Dataset(X, label=y, group=group, params=p)
    np.testing.assert_array_equal(ds.query_boundaries, np.arange(0, 241, 24))
