"""Grower parity: lightgbm_tpu_torch's round-batched grow_tree_fast against
the JAX package's, with the JAX histograms from its XLA scatter
(use_pallas=False) and from its Pallas kernel in interpret mode
(use_pallas=True).

Fixtures are step functions of a few features, so every admitted split
beats its runner-up by far more than histogram rounding: trees must agree
node for node and leaf_id row for row.  Float leaf values and sums are
held to 1e-5 relative (the JAX Pallas path carries bf16x2 products, the
port 64-bit fixed point).  Quantized growth uses stochastic_rounding=False,
so both sides see the same integers.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas

from lightgbm_tpu.ops import treegrow_fast as jfast
from lightgbm_tpu.ops.split import SplitParams as JParams
from lightgbm_tpu.utils import degrade
from lightgbm_tpu_torch.convert import tree_arrays_from_numpy
from lightgbm_tpu_torch.ops import treegrow_fast as tfast
from lightgbm_tpu_torch.ops.split import SplitParams as TParams

NUM_BINS = 100  # > 64: the JAX package takes its Pallas kernel


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pallas, "pallas_call",
                        functools.partial(pallas.pallas_call, interpret=True))


def _fixture(seed, n=3000, f=6, missing=False):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, NUM_BINS - 1, (n, f)).astype(np.int16)
    nbpf = np.full(f, NUM_BINS, np.int32)
    mbpf = np.full(f, -1, np.int32)
    if missing:  # feature 1's last bin holds missing values
        bins[rng.rand(n) < 0.1, 1] = NUM_BINS - 1
        mbpf[1] = NUM_BINS - 1
    y = (4.0 * (bins[:, 0] > 50) + 2.0 * (bins[:, 1] > 30)
         + 1.0 * (bins[:, 2] > 70) + 0.5 * (bins[:, 3] > 20) * (bins[:, 0] > 50)
         + 0.05 * rng.randn(n))
    if missing:
        y = y + 1.5 * (bins[:, 1] == NUM_BINS - 1)
    grad = (-y).astype(np.float32)
    hess = (0.5 + 0.5 * rng.rand(n)).astype(np.float32)
    mask = rng.rand(n) < 0.9
    weight = np.ones(n, np.float32)
    fmask = np.ones(f, bool)
    return bins, grad, hess, mask, weight, fmask, nbpf, mbpf


def _grow_both(fx, num_leaves, use_pallas, quant=0, max_depth=-1, tile=8,
               options=None, statics=None):
    """``options``: array options given to both growers (numpy, converted
    for each); ``statics``: plain keyword options for both."""
    bins, grad, hess, mask, weight, fmask, nbpf, mbpf = fx
    kw = dict(num_leaves=num_leaves, num_bins=NUM_BINS, max_depth=max_depth,
              leaf_tile=tile, quantize_bins=quant, stochastic_rounding=False,
              **(statics or {}))
    p = dict(min_data_in_leaf=20, lambda_l2=1.0)
    options = options or {}
    jt, jl = jfast.grow_tree_fast(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(mask), jnp.asarray(weight), jnp.asarray(fmask),
        jnp.asarray(nbpf), jnp.asarray(mbpf), use_pallas=use_pallas,
        params=JParams(**p), **{k: jnp.asarray(v) for k, v in options.items()}, **kw)
    tt, tl = tfast.grow_tree_fast(
        torch.from_numpy(bins), torch.from_numpy(grad), torch.from_numpy(hess),
        torch.from_numpy(mask), torch.from_numpy(weight), torch.from_numpy(fmask),
        torch.from_numpy(nbpf), torch.from_numpy(mbpf), params=TParams(**p),
        **{k: torch.from_numpy(v) for k, v in options.items()}, **kw)
    jt = {k: (None if v is None else np.asarray(v)) for k, v in jt._asdict().items()}
    return jt, np.asarray(jl), tt.to_numpy(), tl.numpy()


def _assert_same_tree(jt, jl, tt, tl):
    nl = int(jt["num_leaves"])
    assert int(tt.num_leaves) == nl and nl > 4
    m = nl - 1
    for name in ("split_feature", "threshold_bin", "default_left",
                 "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(tt, name)[:m], jt[name][:m],
                                      err_msg=name)
    np.testing.assert_array_equal(tt.leaf_depth[:nl], jt["leaf_depth"][:nl])
    # a gain is a difference of f32 terms as large as the root's: its
    # rounding scales with the largest gain, not with its own size
    np.testing.assert_allclose(tt.split_gain[:m], jt["split_gain"][:m],
                               rtol=1e-5, atol=1e-5 * jt["split_gain"][:m].max())
    for name, n_ in (("internal_value", m),
                     ("internal_weight", m), ("internal_count", m),
                     ("leaf_value", nl), ("leaf_weight", nl),
                     ("leaf_count", nl), ("leaf_sum_g", nl)):
        np.testing.assert_allclose(getattr(tt, name)[:n_], jt[name][:n_],
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize("num_leaves,missing,max_depth", [
    (8, False, -1), (15, True, -1), (15, False, 3)])
def test_float_matches_jax_scatter(num_leaves, missing, max_depth):
    fx = _fixture(1, missing=missing)
    _assert_same_tree(*_grow_both(fx, num_leaves, False, max_depth=max_depth))


@pytest.mark.parametrize("num_leaves,tile", [(8, 8), (15, 4)])
def test_float_matches_jax_pallas_interpret(interpret, num_leaves, tile):
    fx = _fixture(2, missing=True)
    out = _grow_both(fx, num_leaves, True, tile=tile)
    assert degrade.available(degrade.HIST), "JAX fell back off its Pallas kernel"
    _assert_same_tree(*out)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_quantized_matches_jax(interpret, use_pallas):
    fx = _fixture(3)
    out = _grow_both(fx, 15, use_pallas, quant=16, tile=20)
    assert degrade.available(degrade.HIST)
    _assert_same_tree(*out)


def test_predict_leaf_arrays_on_jax_tree():
    """The port walks a JAX-grown tree (carried over with
    tree_arrays_from_numpy) to the JAX grower's own leaf ids."""
    fx = _fixture(4, missing=True)
    jt, jl, _, _ = _grow_both(fx, 15, False)
    arrays = tree_arrays_from_numpy(jt)
    leaf = tfast.predict_leaf_arrays(arrays, torch.from_numpy(fx[0]),
                                     torch.from_numpy(fx[7]))
    # the grower routes out-of-bag rows too, so every row's leaf agrees
    np.testing.assert_array_equal(leaf.numpy(), jl)
    jleaf = jfast.predict_leaf_arrays(
        jfast.TreeArrays(*[None if v is None else jnp.asarray(v) for v in jt.values()]),
        jnp.asarray(fx[0]), jnp.asarray(fx[7]))
    np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf))


@pytest.mark.parametrize("opt", ["monotone_constraints", "interaction_sets",
                                 "cegb_feature_penalty", "forced_leaf"])
def test_unported_options_raise(opt):
    """Once refused, these options now grow the JAX package's trees (the
    name is kept; tests/test_torch_constraints.py holds them through
    lgb.train): monotone (+1 on the step features, -1 on noise),
    interaction sets, coupled CEGB penalties, and a forced prefix (two
    entries, the second on the root's right child)."""
    fx = _fixture(5)
    f = fx[0].shape[1]
    options, statics = {
        "monotone_constraints": ({"monotone_constraints": np.array(
            [1, 1, 1, 1, -1, 0], np.int32)}, {}),
        "interaction_sets": ({"interaction_sets": np.array(
            [[1, 1, 1, 0, 0, 0], [1, 0, 0, 1, 1, 1]], bool)}, {}),
        "cegb_feature_penalty": ({"cegb_feature_penalty": np.array(
            [0, 40, 0, 20, 5, 5], np.float32)}, {}),
        "forced_leaf": ({"forced_leaf": np.array([0, 1], np.int32),
                         "forced_feature": np.array([0, 2], np.int32),
                         "forced_bin": np.array([50, 70], np.int32)},
                        {"n_forced": 2}),
    }[opt]
    jt, jl, tt, tl = _grow_both(fx, 15, False, options=options, statics=statics)
    _assert_same_tree(jt, jl, tt, tl)
    if opt == "interaction_sets":  # no path mixes the two sets
        paths, stack = [], [(0, set())]
        while stack:
            nd, seen = stack.pop()
            seen = seen | {int(tt.split_feature[nd])}
            for c in (int(tt.left_child[nd]), int(tt.right_child[nd])):
                (paths.append(seen) if c < 0 else stack.append((c, seen)))
        assert paths and all(p_ <= {0, 1, 2} or p_ <= {0, 3, 4, 5} for p_ in paths)
    if opt == "forced_leaf":  # the root, then its right child (leaf 1)
        assert list(tt.split_feature[:2]) == [0, 2] and list(tt.threshold_bin[:2]) == [50, 70]
        assert int(tt.right_child[0]) == 1
    assert f == 6
