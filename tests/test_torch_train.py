"""Whole-slice parity: lightgbm_tpu_torch.train against lightgbm_tpu.train
with the round-batched grower, binary and L2, on the CPU.

Held to: bitwise-equal bins; the same tree structure; leaf values and
predictions within 1e-5 (histograms are summed in another order -- the JAX
package scatters in f32, the port adds 64-bit fixed point -- and the rest
is the same f32 arithmetic).  Model text crosses between the packages in
both directions and predicts within 1e-6 (f32 traversal of the same f64
thresholds; only the order of the per-tree sum can differ).
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.convert import booster_from_jax_model_string
from lightgbm_tpu_torch.ops import hist_cuda

ROUNDS = 5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data(objective, seed=11, n=3000, f=8):
    rng = np.random.RandomState(seed)
    # values on a coarse grid keep every split's gain well apart from its
    # runner-up, so summation order cannot flip a choice (min_gain_to_split
    # below drops the near-zero-gain splits where it could)
    X = np.round(rng.randn(n, f) * 8) / 8
    X[rng.rand(n, f) < 0.05] = np.nan
    Z = np.nan_to_num(X)
    s = 2.0 * (Z[:, 0] > 0.3) + 1.5 * Z[:, 1] - 1.0 * (Z[:, 2] < -0.5) + 0.5 * Z[:, 3] * (Z[:, 4] > 0)
    if objective == "binary":
        y = (s + 0.5 * rng.randn(n) > 0.6).astype(np.float64)
    else:
        y = s + 0.1 * rng.randn(n)
    return X, y


def _train_both(objective, extra=None):
    X, y = _data(objective)
    params = {"objective": objective, "num_leaves": 15, "min_data_in_leaf": 20,
              "learning_rate": 0.2, "max_bin": 255, "tree_growth_mode": "rounds",
              "min_gain_to_split": 0.1, "verbosity": -1,
              "metric": (["auc", "binary_logloss"] if objective == "binary"
                         else ["l2", "rmse"])}
    params.update(extra or {})
    jtr = jlgb.Dataset(X[:2500], label=y[:2500])
    jva = jlgb.Dataset(X[2500:], label=y[2500:], reference=jtr)
    jres = {}
    jb = jlgb.train(dict(params), jtr, ROUNDS, valid_sets=[jva],
                    callbacks=[jlgb.record_evaluation(jres)])
    tparams = {**params, "device_type": "cpu"}
    ttr = tlgb.Dataset(X[:2500], label=y[:2500], params=tparams)
    tva = tlgb.Dataset(X[2500:], label=y[2500:], reference=ttr)
    tres = {}
    tb = tlgb.train(tparams, ttr, ROUNDS, valid_sets=[tva],
                    callbacks=[tlgb.record_evaluation(tres)])
    return X, jtr, ttr, jb, tb, jres, tres


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_train_matches_jax(objective):
    hist_cuda.reset_counts()
    X, jtr, ttr, jb, tb, jres, tres = _train_both(objective)
    np.testing.assert_array_equal(np.asarray(ttr.bins), np.asarray(jtr.bins))
    jt, tt = jb._gbdt.models, tb._gbdt.models
    assert len(jt) == len(tt) == ROUNDS
    for a, b in zip(jt, tt):
        assert a.num_leaves == b.num_leaves and a.num_leaves > 4
        m = a.num_leaves - 1
        np.testing.assert_array_equal(b.split_feature[:m], a.split_feature[:m])
        np.testing.assert_array_equal(b.threshold[:m], a.threshold[:m])
        np.testing.assert_array_equal(b.left_child[:m], a.left_child[:m])
        np.testing.assert_array_equal(b.right_child[:m], a.right_child[:m])
        np.testing.assert_array_equal(b.decision_type[:m], a.decision_type[:m])
        np.testing.assert_allclose(b.leaf_value[:a.num_leaves],
                                   a.leaf_value[:a.num_leaves], rtol=1e-5, atol=1e-5)
    for raw in (False, True):
        np.testing.assert_allclose(tb.predict(X, raw_score=raw),
                                   jb.predict(X, raw_score=raw),
                                   rtol=1e-5, atol=1e-5)
    # the valid-set metric, fed by the per-iteration score update
    assert set(tres["valid_0"]) == set(jres["valid_0"]) and len(jres["valid_0"]) == 2
    for key in jres["valid_0"]:
        np.testing.assert_allclose(tres["valid_0"][key], jres["valid_0"][key],
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    # every mode's launch count, the lane and carried modes' too, stays 0
    assert {"histogram_multi", "histogram_multi_bf16",
            "histogram_multi_quantized"} <= set(hist_cuda.launches)
    assert hist_cuda.launches == dict.fromkeys(hist_cuda.launches, 0)
    assert hist_cuda.plain_calls["histogram_multi"] >= ROUNDS


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_model_text_crosses_both_ways(objective, tmp_path):
    X, _, _, jb, tb, _, _ = _train_both(objective)
    # JAX text -> port booster
    carried = booster_from_jax_model_string(jb.model_to_string(), device_type="cpu")
    np.testing.assert_allclose(carried.predict(X), jb.predict(X), rtol=1e-6, atol=1e-6)
    # port text -> JAX booster, through a file
    path = tmp_path / "port_model.txt"
    tb.save_model(str(path))
    back = jlgb.Booster(model_file=str(path))
    np.testing.assert_allclose(back.predict(X), tb.predict(X), rtol=1e-6, atol=1e-6)
    # port text -> port booster: bitwise
    again = tlgb.Booster(model_str=tb.model_to_string(), params={"device_type": "cpu"})
    np.testing.assert_array_equal(again.predict(X), tb.predict(X))


def test_quantized_training_runs_the_int8_path():
    hist_cuda.reset_counts()
    X, y = _data("binary")
    params = {"objective": "binary", "num_leaves": 15, "device_type": "cpu",
              "use_quantized_grad": True, "num_grad_quant_bins": 16,
              "verbosity": -1, "seed": 3, "tree_growth_mode": "rounds"}
    b1 = tlgb.train(params, tlgb.Dataset(X, label=y, params=params), ROUNDS)
    b2 = tlgb.train(params, tlgb.Dataset(X, label=y, params=params), ROUNDS)
    # the seeded generator makes stochastic rounding repeatable
    np.testing.assert_array_equal(b1.predict(X), b2.predict(X))
    assert hist_cuda.plain_calls["histogram_multi_quantized"] >= 2 * ROUNDS
    p = b1.predict(X)
    assert np.all((p > 0) & (p < 1))
    # within reach of the JAX package's quantized model (different random
    # bits, so the trees differ: compare accuracy, not values)
    jparams = {k: v for k, v in params.items() if k != "device_type"}
    jp = jlgb.train(jparams, jlgb.Dataset(X, label=y), ROUNDS).predict(X)
    acc = lambda q: np.mean((q > 0.5) == (y > 0))  # noqa: E731
    assert abs(acc(p) - acc(jp)) < 0.03


@pytest.mark.parametrize("params,match", [
    ({"monotone_constraints": [1, 0, 0, 0, 0, 0, 0, 0]}, "monotone_constraints"),
    ({"tree_learner": "voting"}, "tree_learner"),
    ({"tree_growth_mode": "strict", "extra_trees": True}, "extra_trees"),
    ({"tree_learner": "data"}, "tree_learner"),
    ({"linear_tree": True}, "linear_tree"),
])
def test_unported_configurations_raise(params, match, monkeypatch):
    """The cases once refused now train as the JAX package does (the name
    is kept): the distributed tree learners on one rank train serially (the
    serial model's trees bit for bit; ROADMAP A13), the others the same
    trees on the default (CPU: strict) grower, extra_trees with the JAX
    package's per-node draws injected, linear trees with leaf models within
    1e-4 relative (their f32 solves)."""
    X, y = _data("binary", n=600 if match == "tree_learner" else 3000)
    p = {"device_type": "cpu", "verbosity": -1, "objective": "binary", **params}
    if match == "tree_learner":
        def trees(q):
            t = tlgb.train(q, tlgb.Dataset(X, label=y, params=q), 3).model_to_string()
            return t[t.index("Tree=0"):t.index("end of trees")]
        assert trees(p) == trees({**p, "tree_learner": "serial"})
        return
    from test_torch_constraints import assert_same_models, jax_node_uniforms, train_pair

    from lightgbm_tpu_torch.models import gbdt as tgbdt

    monkeypatch.setattr(tgbdt.GBDT, "_node_uniforms", jax_node_uniforms)
    p = {k: v for k, v in p.items() if k != "device_type"}
    p.update(num_leaves=15, min_data_in_leaf=20, min_gain_to_split=1.0)
    jb, tb = train_pair(p, X, y, rounds=3, dataset_params=(
        {"linear_tree": True} if match == "linear_tree" else None))
    if match == "linear_tree":
        assert all(t.is_linear for t in tb._gbdt.models)
        np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=1e-4, atol=1e-5)
    else:
        assert_same_models(jb, tb, X, min_leaves=5)
