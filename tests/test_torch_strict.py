"""The strict grower (lightgbm_tpu_torch/ops/treegrow.py::grow_tree) against
the JAX package's grow_tree, and the grower GBDT picks (fault C1: auto on a
CPU device is the strict grower in both packages).

Held to: the single-split oracle exactly; the same tree structure as the
JAX grower, node for node, on fixtures with separated gains; leaf values
and predictions within 1e-5 (the JAX package sums histograms in f32, the
port in 64-bit fixed point: the rest is the same f32 arithmetic).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops.split import SplitParams as JParams
from lightgbm_tpu.ops.treegrow import grow_tree as jgrow
from lightgbm_tpu_torch.ops import hist_cuda
from lightgbm_tpu_torch.ops.split import SplitParams as TParams
from lightgbm_tpu_torch.ops.treegrow import grow_tree as tgrow
from lightgbm_tpu_torch.utils import sanitizer as san

from test_torch_train import _data

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _both(bins, grad, hess, nbins, mbins, **kw):
    """The same tree inputs through both growers -> (jax tree, jax leaf_id,
    port tree, port leaf_id), as numpy."""
    n, f = bins.shape
    p = kw.pop("params")
    jt, jl = jgrow(jnp.asarray(bins.astype(np.int32)), jnp.asarray(grad),
                   jnp.asarray(hess), jnp.ones(n, bool), jnp.ones(n, jnp.float32),
                   jnp.ones(f, bool), jnp.asarray(nbins, jnp.int32),
                   jnp.asarray(mbins, jnp.int32), params=JParams(**p), **kw)
    tt, tl = tgrow(torch.from_numpy(bins.astype(np.int16)), torch.from_numpy(grad),
                   torch.from_numpy(hess), torch.ones(n, dtype=torch.bool),
                   torch.ones(n), torch.ones(f, dtype=torch.bool),
                   torch.as_tensor(nbins, dtype=torch.int32),
                   torch.as_tensor(mbins, dtype=torch.int32), params=TParams(**p), **kw)
    return (jt, np.asarray(jl), tt.to_numpy(), tl.numpy())


def _same_structure(jt, tt):
    nl = int(jt.num_leaves)
    assert int(tt.num_leaves) == nl
    m = nl - 1
    for field in ("split_feature", "threshold_bin", "default_left", "left_child",
                  "right_child"):
        np.testing.assert_array_equal(np.asarray(getattr(tt, field))[:m],
                                      np.asarray(getattr(jt, field))[:m], err_msg=field)
    for field in ("leaf_value", "leaf_weight", "leaf_count"):
        np.testing.assert_allclose(np.asarray(getattr(tt, field))[:nl],
                                   np.asarray(getattr(jt, field))[:nl],
                                   rtol=TOL, atol=TOL, err_msg=field)


def test_single_split_oracle():
    """tests/test_split_oracle.py's crafted set: one clean split, gain 6."""
    bins = np.array([[0, 1], [0, 0], [0, 1], [1, 0], [1, 1], [1, 0]])
    grad = np.array([1.0, 1.0, 1.0, -1.0, -1.0, -1.0], np.float32)
    hess = np.ones(6, np.float32)
    p = dict(min_data_in_leaf=1, min_sum_hessian_in_leaf=0.0)
    jt, jl, tt, tl = _both(bins, grad, hess, [2, 2], [-1, -1], num_leaves=2,
                           num_bins=2, params=p)
    assert int(tt.num_leaves) == 2
    assert int(tt.split_feature[0]) == 0 and int(tt.threshold_bin[0]) == 0
    np.testing.assert_allclose(sorted(tt.leaf_value[:2]), [-1.0, 1.0], atol=1e-6)
    np.testing.assert_allclose(float(tt.split_gain[0]), 6.0, rtol=1e-6)
    np.testing.assert_array_equal(tl, [0, 0, 0, 1, 1, 1])
    _same_structure(jt, tt)
    np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize("case", ["min_data", "depth_cap", "missing_bins"])
def test_grow_tree_matches_jax(case):
    """The oracle file's min_data and depth-cap trees, and a set with
    missing bins, node for node against the JAX grower."""
    rng = np.random.RandomState({"min_data": 3, "depth_cap": 4, "missing_bins": 5}[case])
    if case == "min_data":
        n, f, b, L, depth, md = 100, 3, 10, 16, -1, 20
    elif case == "depth_cap":
        n, f, b, L, depth, md = 512, 4, 16, 31, 3, 1
    else:
        n, f, b, L, depth, md = 2000, 5, 16, 15, -1, 10
    bins = rng.randint(0, b, size=(n, f))
    grad = np.round(rng.randn(n) * 4).astype(np.float32) / 4
    hess = np.ones(n, np.float32)
    mbins = [-1] * f if case != "missing_bins" else [b - 1, -1, b - 1, -1, -1]
    p = dict(min_data_in_leaf=md, min_sum_hessian_in_leaf=0.0)
    jt, jl, tt, tl = _both(bins, grad, hess, [b] * f, mbins, num_leaves=L,
                           num_bins=b, max_depth=depth, params=p)
    nl = int(tt.num_leaves)
    if case == "min_data":
        assert (tt.leaf_count[:nl] >= 20).all()
    if case == "depth_cap":
        assert tt.leaf_depth[:nl].max() <= 3 and nl <= 8
    _same_structure(jt, tt)
    np.testing.assert_array_equal(tl, jl)


def _train(objective, package, mode, extra=None, **ds_kw):
    X, y = _data(objective)
    params = {"objective": objective, "num_leaves": 15, "min_data_in_leaf": 20,
              "learning_rate": 0.2, "max_bin": 255, "min_gain_to_split": 0.1,
              "verbosity": -1, **(extra or {})}
    if mode is not None:
        params["tree_growth_mode"] = mode
    if package is jlgb:
        return X, jlgb.train(params, jlgb.Dataset(X[:2500], label=y[:2500]), 5)
    params["device_type"] = "cpu"
    return X, tlgb.train(params, tlgb.Dataset(X[:2500], label=y[:2500], params=params), 5)


def _assert_same_models(jb, tb, X):
    jt, tt = jb._gbdt.models, tb._gbdt.models
    assert len(jt) == len(tt) == 5
    for a, b in zip(jt, tt):
        assert a.num_leaves == b.num_leaves and a.num_leaves > 4
        m = a.num_leaves - 1
        np.testing.assert_array_equal(b.split_feature[:m], a.split_feature[:m])
        np.testing.assert_array_equal(b.threshold[:m], a.threshold[:m])
        np.testing.assert_array_equal(b.left_child[:m], a.left_child[:m])
        np.testing.assert_array_equal(b.right_child[:m], a.right_child[:m])
        np.testing.assert_allclose(b.leaf_value[:a.num_leaves], a.leaf_value[:a.num_leaves],
                                   rtol=TOL, atol=TOL)
    for raw in (False, True):
        np.testing.assert_allclose(tb.predict(X, raw_score=raw), jb.predict(X, raw_score=raw),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("objective", ["binary", "regression"])
@pytest.mark.parametrize("extra", [{}, {"max_depth": 3, "path_smooth": 2.0},
                                   {"bagging_fraction": 0.7, "bagging_freq": 1,
                                    "feature_fraction": 0.8, "lambda_l2": 1.0}])
def test_strict_training_matches_jax(objective, extra):
    X, jb = _train(objective, jlgb, "strict", extra)
    _, tb = _train(objective, tlgb, "strict", extra)
    assert all(s["grower"] == "strict" for s in tb._gbdt.round_stats)
    _assert_same_models(jb, tb, X)


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_auto_on_cpu_is_the_strict_grower(objective):
    """Fault C1: tree_growth_mode left at auto, training on the CPU.  The
    JAX package runs its strict grower there (its default off the
    accelerator), and so does the port now (it ran the rounds grower, and
    tree 0 differed from node 2 on)."""
    X, jb = _train(objective, jlgb, None)
    _, tb = _train(objective, tlgb, None)
    assert tb._gbdt.cfg.tree_growth_mode == "auto"
    assert all(s["grower"] == "strict" for s in tb._gbdt.round_stats)
    _assert_same_models(jb, tb, X)


def test_strict_tree_makes_no_blocking_read():
    """Every step of a tree is queued without a host read: the sanitizer
    counts L - 1 steps and no blocking read inside a tree, the histogram is
    B1 at tile 1 once a step plus the root.  The one blocking read an
    iteration is the finish check after the tree (fault C9: the strict
    path stops at the first all-one-leaf iteration, as the JAX package's)."""
    hist_cuda.reset_counts()
    X, y = _data("binary")
    p = {"objective": "binary", "num_leaves": 15, "device_type": "cpu",
         "tree_growth_mode": "strict", "verbosity": -1}
    ds = tlgb.Dataset(X, label=y, params=p)
    with san.DispatchCounter() as c:
        bst = tlgb.Booster(params=p, train_set=ds)
        for _ in range(3):
            bst.update()
    stats = bst._gbdt.round_stats
    assert [s["host_syncs"] for s in stats] == [0, 0, 0]
    assert [s["rounds"] for s in stats] == [14, 14, 14]
    assert c.host_syncs == 3 and c.async_resolves == 0
    assert hist_cuda.plain_calls["histogram_multi"] == 3 * 15


@pytest.mark.parametrize("extra,match", [
    ({"monotone_constraints": [1, 0, 0, 0, 0, 0, 0, 0]}, "monotone_constraints"),
    ({"interaction_constraints": [[0, 1]]}, "interaction_constraints"),
    ({"extra_trees": True}, "extra_trees"),
    ({"feature_fraction_bynode": 0.5}, "feature_fraction_bynode"),
    # without cegb_tradeoff's scale-down both packages stop at a one-leaf
    # first tree (the same model since fault C9 closed, but nothing to compare)
    ({"cegb_penalty_split": 1.0, "cegb_tradeoff": 1e-3}, "cegb"),
])
def test_strict_envelope_still_raises(extra, match, monkeypatch):
    """Once refused, these options now train the JAX package's strict trees
    (the name is kept; the per-node draws are the JAX package's, injected
    into GBDT._node_uniforms; in the CEGB case cegb_tradeoff scales the
    split penalty down to one that lets trees grow): same structure, values
    within 1e-5."""
    from test_torch_constraints import assert_same_models, jax_node_uniforms, train_pair

    from lightgbm_tpu_torch.models import gbdt as tgbdt

    monkeypatch.setattr(tgbdt.GBDT, "_node_uniforms", jax_node_uniforms)
    X, y = _data("binary")
    p = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
         "learning_rate": 0.2, "min_gain_to_split": 1.0, "verbosity": -1,
         "tree_growth_mode": "strict", **extra}
    jb, tb = train_pair(p, X, y, rounds=3)
    assert_same_models(jb, tb, X, min_leaves=5)
    assert match and tb._gbdt.round_stats[0]["grower"] == "strict"


@pytest.mark.parametrize("option", ["monotone_constraints", "interaction_sets",
                                    "forced_leaf", "axis_name"])
def test_grow_tree_rejects_unported_options(option):
    """Options once refused now grow the JAX strict grower's tree (the name
    is kept); axis_name (the distributed learners, ROADMAP A13) grows, on a
    gloo group of one rank, the serial tree bit for bit."""
    if option == "axis_name":
        import tempfile

        import torch.distributed as dist

        from lightgbm_tpu_torch.parallel.mesh import RowShard, make_mesh

        rng = np.random.RandomState(3)
        n, f = 400, 3
        args = (torch.as_tensor(rng.randint(0, 4, (n, f)), dtype=torch.int16),
                torch.as_tensor(rng.randn(n), dtype=torch.float32), torch.ones(n),
                torch.ones(n, dtype=torch.bool), torch.ones(n), None,
                torch.full((f,), 4, dtype=torch.int32),
                torch.full((f,), -1, dtype=torch.int32))
        with tempfile.TemporaryDirectory() as tmp:
            dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                    rank=0, world_size=1)
            try:
                got = tgrow(*args, num_leaves=4, num_bins=4,
                            axis_name=RowShard(make_mesh(), 0, n))[0]
            finally:
                dist.destroy_process_group()
        want = tgrow(*args, num_leaves=4, num_bins=4)[0]
        assert int(want.num_leaves) == 4
        assert all(torch.equal(a, b) for a, b in zip(got, want) if a is not None)
        return
    rng = np.random.RandomState(21)
    n, f, b = 2000, 5, 32
    bins = rng.randint(0, b, (n, f))
    y = (2.0 * (bins[:, 0] > 15) + 1.0 * (bins[:, 1] > 8) + 0.7 * bins[:, 2] / b
         + 0.05 * rng.randn(n))
    grad = (-y).astype(np.float32)
    hess = (0.5 + 0.5 * rng.rand(n)).astype(np.float32)
    arrays, statics = {
        "monotone_constraints": ({"monotone_constraints": np.array([1, 1, 1, -1, 0],
                                                                   np.int32)}, {}),
        "interaction_sets": ({"interaction_sets": np.array(
            [[1, 1, 0, 0, 0], [1, 0, 1, 1, 1]], bool)}, {}),
        "forced_leaf": ({"forced_leaf": np.array([0, 0], np.int32),
                         "forced_feature": np.array([1, 0], np.int32),
                         "forced_bin": np.array([8, 15], np.int32)}, {"n_forced": 2}),
    }[option]
    n_, f_ = bins.shape
    jt, jl = jgrow(jnp.asarray(bins.astype(np.int32)), jnp.asarray(grad),
                   jnp.asarray(hess), jnp.ones(n_, bool), jnp.ones(n_, jnp.float32),
                   jnp.ones(f_, bool), jnp.full(f_, b, jnp.int32),
                   jnp.full(f_, -1, jnp.int32), params=JParams(min_data_in_leaf=20),
                   num_leaves=15, num_bins=b,
                   **{k: jnp.asarray(v) for k, v in arrays.items()}, **statics)
    tt, tl = tgrow(torch.from_numpy(bins.astype(np.int16)), torch.from_numpy(grad),
                   torch.from_numpy(hess), torch.ones(n_, dtype=torch.bool),
                   torch.ones(n_), torch.ones(f_, dtype=torch.bool),
                   torch.full((f_,), b, dtype=torch.int32),
                   torch.full((f_,), -1, dtype=torch.int32),
                   params=TParams(min_data_in_leaf=20), num_leaves=15, num_bins=b,
                   **{k: torch.from_numpy(v) for k, v in arrays.items()}, **statics)
    _same_structure(jt, tt.to_numpy())
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    if option == "forced_leaf":  # the root on feature 1, its left child on 0
        assert list(tt.split_feature[:2].numpy()) == [1, 0]


def test_wide_data_trains_float():
    """Fault C2, a deliberate departure: the JAX package switches a wide
    training (>= 256 features, max_bin > 64, the rounds grower, no explicit
    use_quantized_grad) to int8 on its device; the port trains float."""
    rng = np.random.RandomState(0)
    X = rng.randn(600, 256)
    y = (X[:, 0] + X[:, 1] > 0).astype(float)
    hist_cuda.reset_counts()
    p = {"objective": "binary", "device_type": "cpu", "verbosity": -1,
         "tree_growth_mode": "rounds", "max_bin": 255, "num_leaves": 7}
    bst = tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 2)
    assert not bst._gbdt.cfg.use_quantized_grad
    assert hist_cuda.plain_calls["histogram_multi_quantized"] == 0
    assert hist_cuda.plain_calls["histogram_multi"] > 0
    assert all(s["grower"] == "rounds" for s in bst._gbdt.round_stats)
