"""Split-search parity: lightgbm_tpu_torch.ops.split.find_best_split
against lightgbm_tpu.ops.split.find_best_split, element by element.

Both evaluate the same f32 formulas over the same histogram; only the
order of the f32 cumulative sums may differ, so gains and child sums are
held to 1e-5 relative and the chosen (feature, threshold, direction) must
be identical.  Fixtures draw continuous payloads, so the best candidate is
unique well beyond that tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.ops import split as tsplit

PARAMS = {
    "default": {},
    "l1_l2": dict(lambda_l1=0.5, lambda_l2=2.0),
    "max_delta_step": dict(max_delta_step=0.3),
    "path_smooth": dict(path_smooth=5.0),
    "min_gain": dict(min_gain_to_split=3.0, min_data_in_leaf=40),
}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _leaf(rng, f, b, n=3000):
    """A leaf's histogram from real rows: (3, F, B) f32, parent sums, and
    per-feature bin counts with a missing bin on some features."""
    nbpf = rng.randint(4, b + 1, f).astype(np.int32)
    has_miss = rng.rand(f) < 0.5
    mbpf = np.where(has_miss, nbpf - 1, -1).astype(np.int32)
    bins = (rng.rand(n, f) * nbpf).astype(np.int64)
    grad = rng.randn(n) + 0.8 * (bins[:, 0] > nbpf[0] // 2)
    hess = rng.rand(n) * 0.25 + 0.01
    hist = np.zeros((3, f, b))
    for j in range(f):
        for c, v in enumerate((grad, hess, np.ones(n))):
            hist[c, j] = np.bincount(bins[:, j], weights=v, minlength=b)[:b]
    hist = hist.astype(np.float32)
    sums = hist[:, 0].sum(axis=1)
    return hist, sums, nbpf, mbpf


def _compare(jb, tb):
    for name in ("feature", "threshold_bin", "default_left", "is_cat"):
        np.testing.assert_array_equal(np.asarray(getattr(jb, name)),
                                      getattr(tb, name).numpy(), err_msg=name)
    for name in ("gain", "left_sum_g", "left_sum_h", "left_count",
                 "right_sum_g", "right_sum_h", "right_count"):
        j = np.asarray(getattr(jb, name), np.float64)
        t = getattr(tb, name).numpy().astype(np.float64)
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("pname", sorted(PARAMS))
@pytest.mark.parametrize("seed", [0, 1])
def test_find_best_split_matches_jax(pname, seed):
    rng = np.random.RandomState(seed)
    f, b = 6, 40
    hist, sums, nbpf, mbpf = _leaf(rng, f, b)
    fmask = np.ones(f, bool)
    fmask[rng.randint(f)] = False
    jp = jsplit.SplitParams(**PARAMS[pname])
    tp = tsplit.SplitParams(**PARAMS[pname])
    parent_out = np.float32(-0.05)
    jb = jsplit.find_best_split(
        jnp.asarray(hist), jnp.float32(sums[0]), jnp.float32(sums[1]),
        jnp.float32(sums[2]), jnp.asarray(nbpf), jnp.asarray(mbpf), jp,
        feature_mask=jnp.asarray(fmask), parent_output=jnp.float32(parent_out))
    tb = tsplit.find_best_split(
        torch.from_numpy(hist), float(sums[0]), float(sums[1]), float(sums[2]),
        torch.from_numpy(nbpf), torch.from_numpy(mbpf), tp,
        feature_mask=torch.from_numpy(fmask), parent_output=float(parent_out))
    _compare(jb, tb)


def test_batched_search_matches_vmapped_jax():
    rng = np.random.RandomState(7)
    f, b, c = 5, 32, 6
    leaves = [_leaf(rng, f, b, n=1500) for _ in range(c)]
    nbpf, mbpf = leaves[0][2], leaves[0][3]
    hist = np.stack([lf[0] for lf in leaves])
    sums = np.stack([lf[1] for lf in leaves])
    p = dict(lambda_l2=1.0, min_data_in_leaf=10)
    jb = jax.vmap(lambda h, g, hh, n: jsplit.find_best_split(
        h, g, hh, n, jnp.asarray(nbpf), jnp.asarray(mbpf),
        jsplit.SplitParams(**p)))(jnp.asarray(hist), jnp.asarray(sums[:, 0]),
                                  jnp.asarray(sums[:, 1]), jnp.asarray(sums[:, 2]))
    tb = tsplit.find_best_split(
        torch.from_numpy(hist), torch.from_numpy(sums[:, 0]),
        torch.from_numpy(sums[:, 1]), torch.from_numpy(sums[:, 2]),
        torch.from_numpy(nbpf), torch.from_numpy(mbpf), tsplit.SplitParams(**p))
    _compare(jb, tb)


def test_unsplittable_leaf_reports_kmin():
    rng = np.random.RandomState(3)
    hist, sums, nbpf, mbpf = _leaf(rng, 3, 16, n=30)
    tb = tsplit.find_best_split(
        torch.from_numpy(hist), float(sums[0]), float(sums[1]), float(sums[2]),
        torch.from_numpy(nbpf), torch.from_numpy(mbpf),
        tsplit.SplitParams(min_data_in_leaf=20))
    assert float(tb.gain) == float(np.float32(tsplit.KMIN_SCORE))


def test_leaf_output_matches_jax():
    g = np.array([-3.0, 0.2, 5.0], np.float32)
    h = np.array([2.0, 0.5, 0.1], np.float32)
    c = np.array([10.0, 3.0, 50.0], np.float32)
    for kw in ({}, dict(lambda_l1=0.3, lambda_l2=1.0, max_delta_step=0.7),
               dict(path_smooth=4.0)):
        j = jsplit.leaf_output_smoothed(jnp.asarray(g), jnp.asarray(h),
                                        jnp.asarray(c), jnp.float32(0.1),
                                        jsplit.SplitParams(**kw))
        t = tsplit.leaf_output_smoothed(torch.from_numpy(g), torch.from_numpy(h),
                                        torch.from_numpy(c), 0.1,
                                        tsplit.SplitParams(**kw))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)


@pytest.mark.parametrize("arg", ["out_lo", "monotone_constraints",
                                 "cegb_feature_penalty", "rng_key"])
def test_unported_arguments_raise(arg):
    """Once refused, these arguments now search as the JAX package does
    (the name is kept): the monotone output band (out_lo / out_hi with
    monotone_constraints, so clipped outputs and ordering), monotone
    constraints with monotone_penalty at depth 2, CEGB split and feature
    penalties, and a node's uniforms (extra_trees and bynode: the JAX key's
    two draws, given to the port as its (2, F) rows)."""
    rng = np.random.RandomState(5)
    f, b = 6, 40
    hist, sums, nbpf, mbpf = _leaf(rng, f, b)
    mono = np.array([1, -1, 0, 1, 0, -1], np.int32)
    key = jax.random.PRNGKey(9)
    kb, ke = jax.random.split(key)
    u = np.stack([np.asarray(jax.random.uniform(kb, (f,))),
                  np.asarray(jax.random.uniform(ke, (f,)))])
    pen = np.array([0.0, 0.5, 2.0, 0.0, 1.0, 0.3], np.float32)
    kw, jk, tk = {
        "out_lo": ({}, dict(monotone_constraints=jnp.asarray(mono),
                            out_lo=jnp.float32(-3.1), out_hi=jnp.float32(-2.7)),
                   dict(monotone_constraints=torch.from_numpy(mono), out_lo=-3.1,
                        out_hi=-2.7)),
        "monotone_constraints": (dict(monotone_penalty=1.5),
                                 dict(monotone_constraints=jnp.asarray(mono),
                                      depth=jnp.float32(2)),
                                 dict(monotone_constraints=torch.from_numpy(mono),
                                      depth=2.0)),
        "cegb_feature_penalty": (dict(cegb_penalty_split=1e-4, cegb_tradeoff=0.5),
                                 dict(cegb_feature_penalty=jnp.asarray(pen)),
                                 dict(cegb_feature_penalty=torch.from_numpy(pen))),
        "rng_key": (dict(extra_trees=True, feature_fraction_bynode=0.7),
                    dict(rng_key=key), dict(rng_key=torch.from_numpy(u))),
    }[arg]
    p = dict(lambda_l2=1.0, min_data_in_leaf=20, **kw)
    jb = jsplit.find_best_split(
        jnp.asarray(hist), jnp.float32(sums[0]), jnp.float32(sums[1]),
        jnp.float32(sums[2]), jnp.asarray(nbpf), jnp.asarray(mbpf),
        jsplit.SplitParams(**p), **jk)
    tb = tsplit.find_best_split(
        torch.from_numpy(hist), float(sums[0]), float(sums[1]), float(sums[2]),
        torch.from_numpy(nbpf), torch.from_numpy(mbpf), tsplit.SplitParams(**p), **tk)
    assert float(tb.gain) > 0
    _compare(jb, tb)
