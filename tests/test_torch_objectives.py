"""Objectives, leaf renewal and metrics of lightgbm_tpu_torch against the
JAX package, element by element, on seeded numpy inputs.

Held to: gradients, hessians, init scores, output transforms and renewed
leaf values within f32 tolerance, 1e-6 relative (atol 1e-6 x the largest
magnitude of the reference array, for elements near zero); metrics, which
both packages compute with the same numpy code on the host, within 1e-12
relative.  The XE-NDCG draws are given to both packages (their random
streams differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu.metrics as jmet
import lightgbm_tpu.objectives as jobj
import lightgbm_tpu_torch.metrics as tmet
import lightgbm_tpu_torch.objectives as tobj
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu_torch.config import Config as TConfig

N, K = 600, 3
RTOL = 1e-6


def close(t, j, rtol=RTOL):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    atol = rtol * max(1.0, float(np.abs(j).max())) if j.size else 0.0
    np.testing.assert_allclose(t, j, rtol=rtol, atol=atol)


def _queries(rng, n):
    """Query sizes 5..40 summing to n."""
    sizes = []
    while sum(sizes) < n:
        sizes.append(int(rng.randint(5, 41)))
    sizes[-1] -= sum(sizes) - n
    if sizes[-1] <= 0:
        sizes[-2] += sizes.pop()
    return np.asarray(sizes)


def _inputs(name, seed=0, weighted=False):
    """(score, label, weight, group, params) for one objective."""
    rng = np.random.RandomState(seed)
    params = {"objective": name}
    score = rng.randn(N).astype(np.float32)
    group = None
    if name in ("multiclass", "multiclassova"):
        params["num_class"] = K
        score = rng.randn(N, K).astype(np.float32)
        label = rng.randint(0, K, N).astype(np.float32)
    elif name in ("binary",):
        label = (rng.rand(N) < 0.4).astype(np.float32)
    elif name in ("cross_entropy", "cross_entropy_lambda"):
        label = rng.rand(N).astype(np.float32)
    elif name in ("poisson", "tweedie"):
        label = rng.poisson(2.0, N).astype(np.float32)
        score = (0.5 * score).astype(np.float32)
    elif name == "gamma":
        label = rng.gamma(2.0, 1.5, N).astype(np.float32)
        score = (0.5 * score).astype(np.float32)
    elif name in ("lambdarank", "rank_xendcg"):
        label = rng.randint(0, 5, N).astype(np.float32)
        group = _queries(rng, N)
    else:
        label = (3.0 * rng.randn(N)).astype(np.float32)
    weight = rng.uniform(0.5, 2.0, N).astype(np.float32) if weighted else None
    return score, label, weight, group, params


def _pair(params):
    return jobj.create_objective(JConfig.from_dict(params)), \
        tobj.create_objective(TConfig.from_dict(params))


def _jax_draws(self, shape, device):
    key = jax.random.PRNGKey(self._seed + self._iter)
    return torch.from_numpy(np.array(jax.random.uniform(key, shape, dtype=jnp.float32)))


OBJECTIVES = sorted(jobj._REGISTRY)


def test_registry_is_the_reference_registry():
    assert sorted(tobj._REGISTRY) == OBJECTIVES and len(OBJECTIVES) == 16


# the ranking objectives take no weights
@pytest.mark.parametrize("name,weighted", [
    (o, w) for o in OBJECTIVES for w in (False, True)
    if not (w and o in ("lambdarank", "rank_xendcg"))])
def test_gradients_match_jax(name, weighted, monkeypatch):
    score, label, weight, group, params = _inputs(name, weighted=weighted)
    jo, to = _pair(params)
    if group is not None:
        qb = np.concatenate([[0], np.cumsum(group)])
        jo.set_query(qb, label)
        to.set_query(qb, label, torch.device("cpu"))
        monkeypatch.setattr(tobj.RankXENDCG, "draws", _jax_draws)
    for it in range(2):  # XE-NDCG draws anew each iteration
        jg, jh = jo.get_gradients(jnp.asarray(score), jnp.asarray(label),
                                  None if weight is None else jnp.asarray(weight))
        tg, th = to.get_gradients(torch.from_numpy(score), torch.from_numpy(label),
                                  None if weight is None else torch.from_numpy(weight))
        assert tg.shape == score.shape and tg.dtype == torch.float32
        close(tg.numpy(), jg)
        close(th.numpy(), jh)


@pytest.mark.parametrize("name", OBJECTIVES)
def test_init_score_and_output_match_jax(name):
    score, label, weight, _, params = _inputs(name, seed=1)
    jo, to = _pair(params)
    if params.get("num_class", 1) == 1:
        for w in (None, np.linspace(0.5, 1.5, N).astype(np.float32)):
            jw = None if w is None else jnp.asarray(w)
            tw = None if w is None else torch.from_numpy(w)
            close(to.boost_from_score(torch.from_numpy(label), tw),
                  jo.boost_from_score(jnp.asarray(label), jw))
    close(to.convert_output(torch.from_numpy(score)).numpy(),
          jo.convert_output(jnp.asarray(score)))


@pytest.mark.parametrize("name,q", [("regression_l1", 0.5), ("quantile", 0.9),
                                    ("quantile", 0.25), ("mape", 0.5)])
def test_leaf_renewal_matches_jax(name, q):
    """RenewTreeOutput: each leaf's weighted quantile of the residuals,
    with an empty leaf and ties among the residuals."""
    rng = np.random.RandomState(2)
    L = 7
    label = np.round(rng.randn(N) * 4).astype(np.float32) / 4 + 3.0
    score = np.round(rng.randn(N) * 2).astype(np.float32) / 4
    leaf_id = rng.randint(0, L - 1, N).astype(np.int32)  # leaf L-1 is empty
    for weight in (None, rng.uniform(0.5, 2.0, N).astype(np.float32)):
        jo, to = _pair({"objective": name, "alpha": q})
        jr = jo.renew_tree_output(None, jnp.asarray(label),
                                  None if weight is None else jnp.asarray(weight),
                                  jnp.asarray(score), jnp.asarray(leaf_id), L)
        tr = to.renew_tree_output(torch.from_numpy(label),
                                  None if weight is None else torch.from_numpy(weight),
                                  torch.from_numpy(score), torch.from_numpy(leaf_id), L)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("q", [0.5, 0.9])
def test_per_leaf_weighted_quantile_matches_jax(q):
    rng = np.random.RandomState(3)
    v = rng.randn(N).astype(np.float32)
    w = rng.uniform(0.1, 3.0, N).astype(np.float32)
    lid = rng.randint(0, 31, N).astype(np.int32)
    jr = jobj._per_leaf_weighted_quantile(jnp.asarray(v), jnp.asarray(w),
                                          jnp.asarray(lid), 31, q)
    tr = tobj.per_leaf_weighted_quantile(torch.from_numpy(v), torch.from_numpy(w),
                                         torch.from_numpy(lid), 31, q)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_xendcg_query_matches_jax():
    rng = np.random.RandomState(4)
    q, s = 40, 25
    scores = rng.randn(q, s).astype(np.float32)
    labels = rng.randint(0, 5, (q, s)).astype(np.float32)
    mask = np.arange(s)[None, :] < rng.randint(1, s + 1, q)[:, None]
    u = rng.rand(q, s).astype(np.float32)
    jg, jh = jobj._xendcg_query(jnp.asarray(scores), jnp.asarray(labels),
                                jnp.asarray(mask), jnp.asarray(u))
    tg, th = tobj.xendcg_query(*(torch.from_numpy(a) for a in (scores, labels, mask, u)))
    close(tg.numpy(), jg)
    close(th.numpy(), jh)


def test_lambdarank_blocks_equal_one_block(monkeypatch):
    """The pairwise planes are cut into blocks of queries: any cut gives
    the whole computation's lambdas bit for bit."""
    score, label, _, group, params = _inputs("lambdarank", seed=5)
    _, to = _pair(params)
    qb = np.concatenate([[0], np.cumsum(group)])
    to.set_query(qb, label, torch.device("cpu"))
    args = (torch.from_numpy(score), torch.from_numpy(label), None)
    whole = to.get_gradients(*args)
    monkeypatch.setattr(tobj, "_PAIR_BLOCK_ELEMS", 3 * 40 * 40)
    cut = to.get_gradients(*args)
    for a, b in zip(whole, cut):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
METRICS = ["l2", "rmse", "l1", "quantile", "huber", "fair", "poisson", "gamma",
           "gamma_deviance", "tweedie", "mape", "binary_logloss", "binary_error",
           "auc", "cross_entropy", "xentropy_lambda", "auc_mu", "multi_logloss",
           "multi_error", "ndcg", "map"]


def test_metric_classes_are_the_reference_classes():
    classes = {c.__name__ for c in jmet._METRICS.values()}
    assert len(METRICS) == len(classes) == 21
    assert {c.__name__ for c in tmet._METRICS.values()} == classes
    assert set(tmet._METRICS) == set(jmet._METRICS)
    assert tmet._DEFAULT_METRIC_FOR_OBJECTIVE == jmet._DEFAULT_METRIC_FOR_OBJECTIVE


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", METRICS)
def test_metric_matches_jax(name, weighted):
    rng = np.random.RandomState(6)
    params = {"metric": [name], "eval_at": [1, 3, 5], "multi_error_top_k": 1}
    qb = None
    if name in ("auc_mu", "multi_logloss", "multi_error"):
        params.update(objective="multiclass", num_class=K)
        p = rng.dirichlet(np.ones(K), N)
        y = rng.randint(0, K, N).astype(np.float64)
    elif name in ("ndcg", "map"):
        p = rng.randn(N)
        y = rng.randint(0, 5, N).astype(np.float64)
        qb = np.concatenate([[0], np.cumsum(_queries(rng, N))])
    elif name in ("binary_logloss", "binary_error", "auc", "cross_entropy",
                  "xentropy_lambda"):
        p = rng.uniform(0.01, 0.99, N)
        y = (rng.rand(N) < 0.4).astype(np.float64)
        if name in ("cross_entropy", "xentropy_lambda"):
            y = rng.rand(N)
    else:
        p = rng.uniform(0.2, 5.0, N)
        y = rng.uniform(0.0, 6.0, N)
    w = rng.uniform(0.5, 2.0, N) if weighted else None
    (jm,) = jmet.create_metrics(JConfig.from_dict(params))
    (tm,) = tmet.create_metrics(TConfig.from_dict(params))
    jr = jm.eval(p, y, w, qb)
    tr = tm.eval(p, y, w, qb)
    assert [(a, c) for a, _, c in tr] == [(a, c) for a, _, c in jr]
    np.testing.assert_allclose([v for _, v, _ in tr], [v for _, v, _ in jr], rtol=1e-12)


def test_pad_queries_matches_jax():
    qb = np.concatenate([[0], np.cumsum([3, 1, 7, 2])])
    for a, b in zip(tmet.pad_queries(qb), jmet.pad_queries(qb)):
        np.testing.assert_array_equal(a, b)
