"""EFB parity: lightgbm_tpu_torch's Exclusive Feature Bundling (io/efb.py,
ops/histogram.py::unbundle_hists, the rounds and windowed growers over the
bundled matrix, the leaf tile from F_b) against the JAX package's.

Fixtures are one-hot blocks of 12, 31, 7 and 40 columns plus three numeric
columns (93 features, 7 bundled columns), with a regression target of
separated per-category effects.  Tolerances: the bundle plan and the
bundled matrix are identical (the same numpy code); int32 histograms
unbundle bitwise; f32 ones within 1e-6 relative (the fill is a difference
of sums, float64 in the port, f32 in the JAX package); trees node for node,
sums and predictions within 1e-5 (the JAX package sums f32 by scatter, the
port in 64-bit fixed point).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.io.efb import apply_bundles as japply
from lightgbm_tpu.io.efb import find_bundles as jfind
from lightgbm_tpu.ops import treegrow_fast as jfast
from lightgbm_tpu.ops import treegrow_windowed as jwin
from lightgbm_tpu.ops.histogram import histogram_scatter as jscatter
from lightgbm_tpu.ops.histogram import unbundle_hists as junbundle
from lightgbm_tpu.ops.split import SplitParams as JParams
from lightgbm_tpu_torch.io.efb import apply_bundles, find_bundles
from lightgbm_tpu_torch.ops import histogram as thist
from lightgbm_tpu_torch.ops import treegrow_fast as tfast
from lightgbm_tpu_torch.ops import treegrow_windowed as twin
from lightgbm_tpu_torch.ops.graphs import RoundGraphs
from lightgbm_tpu_torch.ops.split import SplitParams as TParams

BLOCKS = (12, 31, 7, 40)
CPU = {"device_type": "cpu", "verbosity": -1}
_P = dict(min_data_in_leaf=20, lambda_l2=1.0)


def _onehot(n=3000, seed=0):
    """(CSR float32 (n, 93), target): one-hot blocks then three numeric
    columns; the target sums per-category effects and two numeric terms."""
    rng = np.random.RandomState(seed)
    cols, z = [], np.zeros(n)
    for k, b in enumerate(BLOCKS):
        c = rng.randint(0, b, n)
        m = np.zeros((n, b), np.float32)
        m[np.arange(n), c] = 1.0
        cols.append(m)
        z += rng.randn(b)[c] * (1.5 if k < 2 else 0.5)
    num = rng.randn(n, 3).astype(np.float32)
    cols.append(num)
    z += num[:, 0] - 0.5 * num[:, 1]
    return sp.csr_matrix(np.hstack(cols)), z + 0.3 * rng.randn(n)


def _dataset(n=3000, seed=0, **params):
    X, y = _onehot(n, seed)
    ds = tlgb.Dataset(X, label=y, params={**CPU, **params}).construct()
    assert ds.efb is not None and ds.efb.num_bundled == 7
    return ds, y


@pytest.mark.parametrize("cat_block", [False, True])
def test_find_and_apply_bundles_match_jax(cat_block):
    """The plan, the bundled matrix and the re-encoding of other rows are
    the JAX package's, categorical columns left out of every bundle."""
    ds, _ = _dataset()
    bins, nbpf = ds.bins, ds.binner.num_bins_per_feature
    cmask = np.zeros(bins.shape[1], bool)
    if cat_block:
        cmask[:12] = True  # the first block as if categorical
    args = (bins, nbpf, 256)
    want, got = jfind(*args, categorical_mask=cmask), find_bundles(*args, categorical_mask=cmask)
    assert want.bundles == got.bundles
    for name in ("bundled_bins", "bundled_num_bins", "gather_idx", "default_mask",
                 "default_bin"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), name)
    assert got.num_bundled == want.num_bundled
    if cat_block:
        assert all(len(m) == 1 for m in got.bundles if m[0] < 12)
    other = bins[::7]
    np.testing.assert_array_equal(apply_bundles(got, other, nbpf),
                                  japply(want, other, nbpf))


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_unbundle_hists_matches_jax_and_the_direct_histogram(dtype):
    """Unbundled bundle histograms against the JAX package's unbundling
    and against histograms of the feature bins themselves."""
    ds, _ = _dataset(n=2000)
    bundled, gather, default = ds.efb_device_tables()
    n, f = ds.bins.shape
    B = ds.max_num_bins
    rng = np.random.RandomState(3)
    if dtype == "int32":
        g = torch.from_numpy(rng.randint(-60, 60, n).astype(np.int8))
        h = torch.from_numpy(rng.randint(0, 60, n).astype(np.int8))
        fn = thist.histogram_multi_quantized
    else:
        g = torch.from_numpy(rng.randn(n).astype(np.float32))
        h = torch.from_numpy(rng.rand(n).astype(np.float32))
        fn = thist.histogram_multi
    mask = torch.from_numpy(rng.rand(n) < 0.8)
    slot = torch.from_numpy(rng.randint(-1, 3, n).astype(np.int32))
    hb = fn(bundled, g, h, mask, slot, 0, 3, B)
    got = thist.unbundle_hists(hb, gather, default, f, B)
    want = np.asarray(junbundle(jnp.asarray(hb.numpy()), jnp.asarray(ds.efb.gather_idx),
                                jnp.asarray(ds.efb.default_mask), f, B))
    direct = fn(ds.bins_device, g, h, mask, slot, 0, 3, B)
    assert got.dtype == hb.dtype and got.shape == direct.shape
    if dtype == "int32":
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(got, direct)
    else:
        scale = float(direct.abs().max())
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * scale)
        np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=1e-6,
                                   atol=1e-6 * scale)


def test_scatter_reference_unbundles_like_the_direct_histogram():
    """histogram_scatter (the CPU reference B1's float path is held to) is
    the JAX package's, within f32 summation order, and B1's plain version;
    its bundle histogram unbundles to its histogram of the feature bins
    (the JAX package's test_efb_histograms_match_unbundled)."""
    ds, _ = _dataset(n=2000)
    bundled, gather, default = ds.efb_device_tables()
    n, f = ds.bins.shape
    B = ds.max_num_bins
    rng = np.random.RandomState(1)
    g = torch.from_numpy(rng.randn(n).astype(np.float32))
    h = torch.from_numpy(rng.rand(n).astype(np.float32))
    mask = torch.from_numpy(rng.rand(n) < 0.9)
    direct = thist.histogram_scatter(ds.bins_device, g, h, mask, B)
    want = np.asarray(jscatter(jnp.asarray(ds.bins), jnp.asarray(g.numpy()),
                               jnp.asarray(h.numpy()), jnp.asarray(mask.numpy()), B))
    np.testing.assert_allclose(direct.numpy(), want, rtol=1e-5, atol=1e-4)
    b1 = thist.histogram_multi(ds.bins_device, g, h, mask,
                               torch.zeros(n, dtype=torch.int32), 0, 1, B)[0]
    np.testing.assert_allclose(direct.numpy(), b1.numpy(), rtol=1e-5, atol=1e-4)
    hb = thist.histogram_scatter(bundled, g, h, mask, B)
    got = thist.unbundle_hists(hb[None], gather, default, f, B)[0]
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=1e-5, atol=1e-4)


def _inputs(ds, y, seed=5, masked=False):
    n, f = ds.bins.shape
    rng = np.random.RandomState(seed)
    grad = (np.mean(y) - y).astype(np.float32)
    hess = np.ones(n, np.float32)
    mask = rng.rand(n) < 0.85 if masked else np.ones(n, bool)
    return (grad, hess, mask, np.ones(n, np.float32), np.ones(f, bool),
            ds.binner.num_bins_per_feature, ds.binner.missing_bin_per_feature)


def _assert_same_tree(tt, tl, jt, jl):
    jt = {k: (None if v is None else np.asarray(v)) for k, v in jt._asdict().items()}
    nl = int(jt["num_leaves"])
    assert int(tt.num_leaves) == nl and nl > 8
    m = nl - 1
    for name in ("split_feature", "threshold_bin", "default_left", "left_child",
                 "right_child"):
        np.testing.assert_array_equal(getattr(tt, name)[:m], jt[name][:m], name)
    np.testing.assert_allclose(tt.split_gain[:m], jt["split_gain"][:m], rtol=1e-5,
                               atol=1e-5 * jt["split_gain"][:m].max())
    for name, k in (("internal_count", m), ("leaf_value", nl), ("leaf_weight", nl),
                    ("leaf_count", nl), ("leaf_sum_g", nl)):
        np.testing.assert_allclose(getattr(tt, name)[:k], jt[name][:k], rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(tl, np.asarray(jl))


@pytest.mark.parametrize("quant,masked", [(0, False), (0, True), (16, False)])
def test_rounds_grower_with_efb_matches_jax(quant, masked):
    """grow_tree_fast over the bundled matrix against the JAX package's
    with its EFB tables (the scatter reference; int8 quantized growth with
    deterministic rounding, so both sides see the same integers)."""
    ds, y = _dataset()
    rest = _inputs(ds, y, masked=masked)
    kw = dict(num_leaves=15, num_bins=ds.max_num_bins, leaf_tile=8,
              quantize_bins=quant, stochastic_rounding=False, quant_renew=bool(quant))
    jt, jl = jfast.grow_tree_fast(
        jnp.asarray(ds.bins), *map(jnp.asarray, rest),
        efb_bins=jnp.asarray(ds.efb.bundled_bins), efb_gather=jnp.asarray(ds.efb.gather_idx),
        efb_default=jnp.asarray(ds.efb.default_mask), use_pallas=False,
        params=JParams(**_P), **kw)
    tt, tl = tfast.grow_tree_fast(ds.bins_device, *map(torch.from_numpy, rest),
                                  efb=ds.efb_device_tables(), params=TParams(**_P), **kw)
    _assert_same_tree(tt.to_numpy(), tl.numpy(), jt, jl)


@pytest.mark.parametrize("quant", [0, 16])
def test_windowed_three_pass_with_efb_matches_jax(quant):
    """The windowed grower's three-pass round (window pass over the
    bundled matrix, unbundled) against the JAX package's
    grow_tree_windowed(megakernel_opt="0") with its EFB tables; the port's
    tree is also its rounds grower's."""
    ds, y = _dataset()
    rest = _inputs(ds, y)
    kw = dict(num_leaves=15, num_bins=ds.max_num_bins, leaf_tile=4,
              quantize_bins=quant, stochastic_rounding=False, quant_renew=bool(quant))
    jt, jl = jwin.grow_tree_windowed(
        jnp.asarray(ds.bins.T.astype(np.int16)), *map(jnp.asarray, rest),
        efb_bins_t=jnp.asarray(ds.efb.bundled_bins.T.astype(np.int16)),
        efb_gather=jnp.asarray(ds.efb.gather_idx),
        efb_default=jnp.asarray(ds.efb.default_mask), use_pallas=False,
        megakernel_opt="0", params=JParams(**_P), **kw)
    t = list(map(torch.from_numpy, rest))
    stats = {}
    tt, tl = twin.grow_tree_windowed(ds.bins_device, *t, efb=ds.efb_device_tables(),
                                     params=TParams(**_P), stats=stats, **kw)
    _assert_same_tree(tt.to_numpy(), tl.numpy(), jt, jl)
    assert stats["megakernel"] is False
    if not quant:
        ft, fl = tfast.grow_tree_fast(ds.bins_device, *t, efb=ds.efb_device_tables(),
                                      params=TParams(**_P), **kw)
        assert torch.equal(fl, tl)
        for a, b in zip(ft.to_numpy(), tt.to_numpy()):
            if a is not None:
                np.testing.assert_array_equal(a, b)


def test_megakernel_excludes_efb_and_counts_it():
    """Asked for the megakernel, an EFB tree takes the three-pass round,
    says why and counts the fallback; without the plan the megakernel (its
    plain version on the CPU) runs."""
    ds, y = _dataset(n=2000)
    t = list(map(torch.from_numpy, _inputs(ds, y)))
    kw = dict(num_leaves=8, num_bins=ds.max_num_bins, leaf_tile=4,
              params=TParams(**_P), megakernel_opt="1")
    for efb, want in ((ds.efb_device_tables(), ("efb", False, 1)), (None, (None, True, 0))):
        stats = {}
        twin.grow_tree_windowed(ds.bins_device, *t, efb=efb, stats=stats, **kw)
        assert (stats["megakernel_excluded"], stats["megakernel"],
                stats["megakernel_fallbacks"]) == want


@pytest.mark.parametrize("objective", ["regression", "binary"])
def test_train_on_csr_bundles_by_default_like_jax(objective):
    """lgb.train on a CSR one-hot fixture at the default enable_bundle
    (rounds grower): the JAX package's trees, its predictions within 1e-5
    and its leaf tile, from the bundled column count."""
    X, y = _onehot()
    if objective == "binary":
        y = (y > np.median(y)).astype(float)
    p = {"objective": objective, "num_leaves": 15, "verbosity": -1,
         "tree_growth_mode": "rounds"}
    jb = jlgb.train(p, jlgb.Dataset(X, label=y), 5)
    tb = tlgb.train({**p, **CPU}, tlgb.Dataset(X, label=y, params={**p, **CPU}), 5)
    jts, tts = jb._gbdt.train_set, tb._gbdt.train_set
    assert tts.efb.num_bundled == jts.efb.num_bundled == 7
    assert tts.max_num_bins == jts.max_num_bins
    assert tb._gbdt._leaf_tile == jb._gbdt._leaf_tile(jts) == 8
    for a, b in zip(jb._gbdt.models, tb._gbdt.models):
        assert b.num_leaves == a.num_leaves
        np.testing.assert_array_equal(b.split_feature, a.split_feature)
        np.testing.assert_array_equal(b.threshold, a.threshold)
    Xd = X.toarray()
    np.testing.assert_allclose(tb.predict(Xd), jb.predict(Xd), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tb.predict(X), tb.predict(Xd))


def test_leaf_tile_follows_the_bundled_columns():
    """At 700 one-hot columns the tile comes from F_b in both packages, and
    from F without the plan (where the two tiles differ)."""
    rng = np.random.RandomState(1)
    n, blocks = 1500, (100, 200, 100, 300)
    cols = []
    for b in blocks:
        m = np.zeros((n, b), np.float32)
        m[np.arange(n), rng.randint(0, b, n)] = 1.0
        cols.append(m)
    X = sp.csr_matrix(np.hstack(cols))
    y = rng.randn(n)
    tiles = {}
    for bundle in (True, False):
        p = {"objective": "regression", "num_leaves": 255, "verbosity": -1,
             "enable_bundle": bundle}
        jts = jlgb.Dataset(X, label=y, params=p).construct()
        g = tlgb.Booster(params={**p, **CPU, "tree_growth_mode": "rounds"},
                         train_set=tlgb.Dataset(X, label=y, params={**p, **CPU}))._gbdt
        jg = jlgb.Booster(params=p, train_set=jts)._gbdt
        assert g._leaf_tile == jg._leaf_tile(jts)
        tiles[bundle] = g._leaf_tile
    assert tiles[True] != tiles[False]


def test_graph_rounds_with_efb_equal_eager():
    """The rounds grower through a round cache (static buffers, the bundled
    matrix and tables read where they lie) against eager rounds: the same
    model text; the cache refuses other EFB tables."""
    X, y = _onehot(n=2000)
    p = {"objective": "regression", "num_leaves": 15, "tree_growth_mode": "rounds", **CPU}
    texts = []
    for fused in (True, False):
        ds = tlgb.Dataset(X, label=y, params=p)
        bst = tlgb.train({**p, "fused_training": fused}, ds, 4)
        st = bst._gbdt.round_stats
        assert all(s["dispatches"] == (s["rounds"] if fused else 0) for s in st)
        texts.append(bst.model_to_string())
    assert texts[0] == texts[1]
    ds, yy = _dataset(n=2000)
    t = list(map(torch.from_numpy, _inputs(ds, yy)))
    graphs = RoundGraphs("cpu")
    kw = dict(num_leaves=8, num_bins=ds.max_num_bins, leaf_tile=4, params=TParams(**_P),
              graphs=graphs)
    tfast.grow_tree_fast(ds.bins_device, *t, efb=ds.efb_device_tables(), **kw)
    other = tuple(v.clone() for v in ds.efb_device_tables())
    with pytest.raises(ValueError, match="fixed inputs"):
        tfast.grow_tree_fast(ds.bins_device, *t, efb=other, **kw)


def test_unported_raises_are_gone_and_out_of_core_cites_a12(tmp_path):
    """enable_bundle=true, two_round, forced bins and save_binary no longer
    raise; nor does out_of_core since A12 was ported: it constructs, streams
    the bins, and plans no bundles (their passes scan the host matrix)."""
    X, y = _onehot(n=1000)
    forced = tmp_path / "forced.json"
    forced.write_text('[{"feature": 92, "bin_upper_bound": [-1.0, 0.0, 1.0]}]')
    ds = tlgb.Dataset(X, label=y, params={**CPU, "enable_bundle": True,
                                          "forcedbins_filename": str(forced)})
    ds.construct().save_binary(str(tmp_path / "c.bin"))
    assert ds.efb is not None
    assert np.isin([-1.0, 0.0, 1.0], ds.binner.mappers[92].upper_bounds).all()
    back = tlgb.Dataset(str(tmp_path / "c.bin"), params=CPU).construct()
    np.testing.assert_array_equal(back.bins, ds.bins)
    ooc = tlgb.Dataset(X, label=y, params={**CPU, "out_of_core": True}).construct()
    assert ooc.ooc and not ooc.ooc_spill and ooc.efb is None
    assert torch.equal(ooc.bins_device, tlgb.Dataset(
        X, label=y, params={**CPU, "enable_bundle": False}).construct().bins_device)
