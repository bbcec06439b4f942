"""The constraint envelope of lightgbm_tpu_torch against the JAX package:
monotone constraints (basic, intermediate, advanced as intermediate, and
monotone_penalty), interaction constraints in both forms, forced splits,
CEGB split / coupled / lazy penalties, extra_trees and
feature_fraction_bynode (the JAX package's per-node threefry draws
injected into the port's uniform table), on the strict and rounds growers
through lgb.train, and the rounds grower's graph path against its eager
one.  The windowed grower's per-node sampling is in
tests/test_torch_windowed.py.

Held to the North star: the same trees (features, thresholds, children,
decision types) on fixtures whose gains are separated (tests/
test_torch_train.py::_data: values on a coarse grid, min_gain_to_split
drops near-zero-gain splits), leaf values and predictions within 1e-5
(the JAX package sums histograms in f32, the port in 64-bit fixed point;
the rest is the same f32 arithmetic), raw margins within 1e-5 a tree
(each sums the trees' leaf values).  One tie is allowed, as in
tests/test_torch_windowed.py: where no training row with a missing value
of a node's feature reaches the node, its missing direction is a tie of
two equal gains, which the JAX side's f32 subtraction residue in the
missing bin breaks one way and the port's exact zero the other; such a
node may differ in its default-left bit alone.  Monotonicity, the
interaction sets and the forced prefix are checked on the port's trees
themselves.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.models import gbdt as tgbdt
from lightgbm_tpu_torch.ops import treegrow_windowed as twin

from test_torch_train import _data

ROUNDS = 5
TOL = 1e-5
MONO = [1, 1, 1, 1, 0, -1, 0, 0]
SETS = [[0, 1], [2, 3, 4], [1, 5, 6, 7]]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_table(key, num_leaves: int, f: int) -> np.ndarray:
    """The JAX package's per-node draws as the port's (2L - 1, 2, F) table:
    node i's key is fold_in(key, i), split in two, one (F,) uniform each."""
    def one(i):
        kb, ke = jax.random.split(jax.random.fold_in(key, i))
        return jnp.stack([jax.random.uniform(kb, (f,)), jax.random.uniform(ke, (f,))])
    return np.array(jax.vmap(one)(jnp.arange(2 * num_leaves - 1, dtype=jnp.int32)))


def jax_node_uniforms(self, c):
    """GBDT._node_uniforms replaced by the JAX package's draws for class
    tree c of this iteration (its key: extra_seed + iteration * 131 + c)."""
    key = jax.random.PRNGKey(self.cfg.extra_seed + self.iter_ * 131 + c)
    table = jax_table(key, self.cfg.num_leaves, self.train_set.num_feature())
    return torch.from_numpy(table).to(self.device)


def params_for(grower, objective="binary", **extra):
    return {"objective": objective, "num_leaves": 15, "min_data_in_leaf": 20,
            "learning_rate": 0.2, "tree_growth_mode": grower,
            "min_gain_to_split": 1.0, "verbosity": -1, **extra}


def train_pair(params, X, y, rounds=ROUNDS, dataset_params=None):
    """The same training in both packages: (JAX booster, port booster)."""
    dp = dataset_params or {}
    jb = jlgb.train(dict(params), jlgb.Dataset(X, label=y, params=dict(dp)), rounds)
    tp = {**params, "device_type": "cpu"}
    tb = tlgb.train(tp, tlgb.Dataset(X, label=y, params={**dp, **tp}), rounds)
    return jb, tb


def visits(tree, X, nd):
    """Which rows of X pass node ``nd`` of a host tree (NaN: the default
    side)."""
    rows = np.arange(len(X))
    node = np.zeros(len(X), np.int64)
    hit = node == nd
    dl = tree.default_left()
    for _ in range(tree.num_leaves):
        cur = np.maximum(node, 0)
        v = X[rows, tree.split_feature[cur]]
        left = np.where(np.isnan(v), dl[cur], v <= tree.threshold[cur])
        node = np.where(node >= 0, np.where(left, tree.left_child[cur],
                                            tree.right_child[cur]), node)
        hit |= node == nd
    return hit


def assert_same_models(jb, tb, X, tol=TOL, min_leaves=2):
    jt, tt = jb._gbdt.models, tb._gbdt.models
    assert len(jt) == len(tt) > 0
    assert max(t.num_leaves for t in tt) >= min_leaves
    for a, b in zip(jt, tt):
        assert a.num_leaves == b.num_leaves
        m = a.num_leaves - 1
        for name in ("split_feature", "threshold", "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(b, name)[:m], getattr(a, name)[:m],
                                          err_msg=name)
        # the missing-direction tie (module docstring)
        for nd in np.nonzero(a.decision_type[:m] != b.decision_type[:m])[0]:
            assert a.decision_type[nd] ^ b.decision_type[nd] == 2, nd
            nan_rows = np.isnan(X[:, a.split_feature[nd]])
            assert not (visits(b, X, nd) & nan_rows).any(), nd
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=tol, atol=tol)
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=tol, atol=tol)
    # a raw margin sums the trees' leaf values, each held to ``tol``
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=tol,
                               atol=tol * len(tt))


def monotone_violations(bst, X, mono, rows=200):
    """Steps against its sign along each constrained column, swept over a
    grid for ``rows`` rows of X (0: monotone)."""
    grid = np.linspace(-3, 3, 49)
    bad = 0
    for j, sign in enumerate(mono):
        if sign == 0:
            continue
        xs = np.repeat(np.asarray(X[:rows], np.float64), len(grid), axis=0)
        xs[:, j] = np.tile(grid, rows)
        d = np.diff(bst.predict(xs, raw_score=True).reshape(rows, len(grid)), axis=1)
        bad += int((d * sign < 0).sum())
    return bad


def tree_paths(tree):
    """Split features on each root-to-leaf path of a host tree."""
    out, stack = [], [(0, [])] if tree.num_leaves > 1 else []
    while stack:
        nd, path = stack.pop()
        path = path + [int(tree.split_feature[nd])]
        for c in (tree.left_child[nd], tree.right_child[nd]):
            (out.append(path) if c < 0 else stack.append((int(c), path)))
    return out


# ---------------------------------------------------------------------------
# monotone constraints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("grower", ["strict", "rounds"])
@pytest.mark.parametrize("method", ["basic", "intermediate", "advanced_penalty"])
def test_monotone_matches_jax(grower, method):
    X, y = _data("binary")
    extra = {"monotone_constraints": MONO}
    if method == "advanced_penalty":  # runs as intermediate, with the warning
        extra.update(monotone_constraints_method="advanced", monotone_penalty=1.0)
    else:
        extra.update(monotone_constraints_method=method)
    jb, tb = train_pair(params_for(grower, **extra), X, y)
    assert_same_models(jb, tb, X)
    assert monotone_violations(tb, np.nan_to_num(X), MONO) == 0


def test_monotone_intermediate_rounds_multi_split_stress():
    """tests/test_constraints.py's stress: many same-round splits on both
    sides of monotone nodes (31 leaves, min_data_in_leaf 5), so the rounds
    grower's deferral decides most admissions."""
    rng = np.random.RandomState(3)
    X = np.round(rng.randn(3000, 3) * 8) / 8
    y = (2.0 * X[:, 0] + np.sin(3 * X[:, 0]) - 1.5 * X[:, 1] - np.cos(2 * X[:, 1])
         + np.sin(2 * X[:, 2]) + 0.1 * rng.randn(3000))
    p = params_for("rounds", "regression", num_leaves=31, min_data_in_leaf=5,
                   min_gain_to_split=1.0, monotone_constraints=[1, -1, 0],
                   monotone_constraints_method="intermediate")
    jb, tb = train_pair(p, X, y)
    assert_same_models(jb, tb, X, min_leaves=16)
    assert monotone_violations(tb, X, [1, -1, 0]) == 0


# ---------------------------------------------------------------------------
# interaction constraints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("grower", ["strict", "rounds"])
@pytest.mark.parametrize("form", ["list", "string"])
def test_interaction_matches_jax(grower, form):
    X, y = _data("binary")
    spec = SETS if form == "list" else ",".join(
        "[" + ",".join(map(str, s)) + "]" for s in SETS)
    jb, tb = train_pair(params_for(grower, interaction_constraints=spec), X, y)
    assert_same_models(jb, tb, X)
    sets = [set(s) for s in SETS]
    for t in tb._gbdt.models:
        for path in tree_paths(t):
            assert any(set(path) <= s for s in sets), path


# ---------------------------------------------------------------------------
# forced splits
# ---------------------------------------------------------------------------
FORCED = {
    # nested: the root and both its children
    "nested": {"feature": 1, "threshold": 0.25,
               "left": {"feature": 2, "threshold": -0.5},
               "right": {"feature": 0, "threshold": 0.3}},
    # the left child's forced split cannot be made (a threshold above every
    # value is the last bin, no threshold): it and every later entry are
    # dropped
    "invalid": {"feature": 1, "threshold": 0.25,
                "left": {"feature": 3, "threshold": 50.0},
                "right": {"feature": 4, "threshold": 0.0}},
}


@pytest.mark.parametrize("grower", ["strict", "rounds"])
@pytest.mark.parametrize("case", ["nested", "invalid"])
def test_forced_splits_match_jax(grower, case, tmp_path):
    X, y = _data("binary")
    path = tmp_path / "forced.json"
    path.write_text(json.dumps(FORCED[case]))
    jb, tb = train_pair(params_for(grower, forcedsplits_filename=str(path)), X, y)
    assert_same_models(jb, tb, X)
    for t in tb._gbdt.models:
        assert int(t.split_feature[0]) == 1
        left, right = int(t.left_child[0]), int(t.right_child[0])
        if case == "nested":
            assert int(t.split_feature[left]) == 2 and int(t.split_feature[right]) == 0
        else:  # growth goes on by gain: the right child's entry was dropped
            assert int(t.split_feature[left]) != 3 and int(t.split_feature[right]) != 4


# ---------------------------------------------------------------------------
# CEGB
# ---------------------------------------------------------------------------
CEGB = {
    "split": {"cegb_penalty_split": 0.02},
    "coupled": {"cegb_penalty_feature_coupled": [0, 0, 40, 0, 30, 0, 0, 0],
                "cegb_tradeoff": 0.5},
    "lazy": {"cegb_penalty_feature_lazy": [0.05, 0, 0, 0.1, 0, 0, 0, 0]},
}


@pytest.mark.parametrize("grower", ["strict", "rounds"])
@pytest.mark.parametrize("kind", ["split", "coupled", "lazy"])
def test_cegb_matches_jax(grower, kind):
    X, y = _data("binary")
    jb, tb = train_pair(params_for(grower, **CEGB[kind]), X, y)
    assert_same_models(jb, tb, X)
    if kind == "lazy":  # the charges carried across trees
        np.testing.assert_array_equal(tb._gbdt._cegb_lazy_used.numpy(),
                                      np.asarray(jb._gbdt._cegb_lazy_used))
    if kind == "coupled":
        np.testing.assert_array_equal(tb._gbdt._cegb_used_global.numpy(),
                                      np.asarray(jb._gbdt._cegb_used_global))


# ---------------------------------------------------------------------------
# per-node sampling
# ---------------------------------------------------------------------------
NODE = {"extra_trees": {"extra_trees": True},
        "bynode": {"feature_fraction_bynode": 0.6},
        "both": {"extra_trees": True, "feature_fraction_bynode": 0.7}}


@pytest.mark.parametrize("grower", ["strict", "rounds"])
@pytest.mark.parametrize("opt", ["extra_trees", "bynode", "both"])
def test_node_sampling_matches_jax(grower, opt, monkeypatch):
    monkeypatch.setattr(tgbdt.GBDT, "_node_uniforms", jax_node_uniforms)
    X, y = _data("binary")
    jb, tb = train_pair(params_for(grower, **NODE[opt]), X, y)
    assert_same_models(jb, tb, X)


def test_node_uniforms_table():
    """The port's own draws: (2L - 1, 2, F) uniforms, one table a class
    tree, repeatable from extra_seed."""
    X, y = _data("binary", n=300)
    p = {**params_for("strict", extra_trees=True), "device_type": "cpu"}
    g = tlgb.Booster(params=p, train_set=tlgb.Dataset(X, label=y, params=p))._gbdt
    u = g._node_uniforms(0)
    assert u.shape == (29, 2, 8) and float(u.min()) >= 0 and float(u.max()) < 1
    assert torch.equal(u, g._node_uniforms(0)) and not torch.equal(u, g._node_uniforms(1))


# ---------------------------------------------------------------------------
# graph (fused) rounds and the gates
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("opt", ["monotone", "intermediate", "interaction", "forced"])
def test_fused_matches_eager(opt, tmp_path):
    """Monotone, interaction and forced-split rounds stay graph-eligible
    (their per-leaf state and forced cursor live in the static buffers);
    fused and eager training give the same model text."""
    X, y = _data("binary")
    path = tmp_path / "forced.json"
    path.write_text(json.dumps(FORCED["nested"]))
    extra = {"monotone": {"monotone_constraints": MONO},
             "intermediate": {"monotone_constraints": MONO,
                              "monotone_constraints_method": "intermediate"},
             "interaction": {"interaction_constraints": SETS},
             "forced": {"forcedsplits_filename": str(path)}}[opt]
    texts = []
    for fused in (True, False):
        p = {**params_for("rounds", **extra), "device_type": "cpu",
             "fused_training": fused}
        b = tlgb.train(p, tlgb.Dataset(X, label=y, params=p), ROUNDS)
        g = b._gbdt
        assert g._fused_eligible(g.train_set) == fused
        assert all((s["dispatches"] > 0) == fused for s in g.round_stats)
        texts.append(b.model_to_string())
    assert texts[0] == texts[1]
    if opt == "forced":  # the forced rounds run under their own key
        assert g.round_stats[0]["windows"][:3] == ["forced"] * 3


@pytest.mark.parametrize("extra", [
    {"cegb_penalty_feature_coupled": [1.0] * 8},
    {"cegb_penalty_feature_lazy": [1e-3] * 8},
    {"extra_trees": True},
    {"feature_fraction_bynode": 0.5},
], ids=["coupled", "lazy", "extra_trees", "bynode"])
def test_fused_gate_excludes(extra):
    """The JAX package's fused gate: CEGB coupled or lazy penalties and
    per-node sampling run eagerly (cegb_penalty_split stays eligible)."""
    X, y = _data("binary", n=300)
    p = {**params_for("rounds", **extra), "device_type": "cpu"}
    g = tlgb.Booster(params=p, train_set=tlgb.Dataset(X, label=y, params=p))._gbdt
    assert not g._fused_eligible(g.train_set)
    p = {**params_for("rounds", cegb_penalty_split=0.1), "device_type": "cpu"}
    g = tlgb.Booster(params=p, train_set=tlgb.Dataset(X, label=y, params=p))._gbdt
    assert g._fused_eligible(g.train_set)


def test_megakernel_excludes_node_rng():
    assert twin.megakernel_mode(True, node_rng=True) == (False, "node_rng")
    assert twin.megakernel_mode(False, node_rng=True, mode="1") == (False, "node_rng")
    assert twin.megakernel_mode(True, efb=True, node_rng=True) == (False, "efb")
    assert twin.megakernel_mode(False, node_rng=True) == (False, None)
