"""Categorical features, feature_contri and hist_precision=bf16: the port
against the JAX package on the CPU.

The JAX side runs its own CPU paths: its XLA split search and growers, its
Pallas histogram kernel through the interpreter.  Tolerances:

* split search: the chosen feature, threshold, direction and categorical
  mask must be identical, gains within 1e-5 relative (the port's prefix
  sums are float64 rounded once, the JAX package's f32 cumsums);
* trainings: the model text's tree structure (split features, thresholds,
  decision types, children, categorical bitsets) bitwise, leaf values and
  predictions within 1e-5 relative and 5e-5 absolute (the JAX package's
  f32 prefix sums of a parent's bins round at 1e-7 of the parent's sum,
  which a leaf's output divides by the leaf's smaller hessian).  The
  fixtures have separated gains; a categorical feature with no missing
  rows in a leaf has pairs of complementary candidates whose gains tie up
  to rounding, so the fixtures give every categorical feature missing
  values and a seed whose trees never meet such a tie;
* bf16 histograms: counts bitwise, sums within 2e-4 relative to the
  channel's largest magnitude (tests/test_torch_hist.py's bound): both
  sides add the same bfloat16 values, the JAX package in f32, the port in
  fixed point.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.binning import DatasetBinner as JBinner
from lightgbm_tpu.ops import hist_pallas
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu.ops import treegrow_fast as jfast
from lightgbm_tpu.ops import treegrow_windowed as jwin
from lightgbm_tpu.ops.histogram import histogram_onehot_multi
from lightgbm_tpu_torch.binning import DatasetBinner as TBinner
from lightgbm_tpu_torch.convert import booster_from_jax_model_string
from lightgbm_tpu_torch.ops import hist_cuda
from lightgbm_tpu_torch.ops import histogram as port_hist
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops import treegrow_fast as tfast
from lightgbm_tpu_torch.ops import treegrow_windowed as twin

CPU = {"device_type": "cpu"}
CATS = [0, 1, 3]
CONTRI = [1.0, 0.5, 1.0, 0.8, 0.3]
STRUCT = ("num_leaves", "num_cat", "split_feature", "threshold",
          "decision_type", "left_child", "right_child", "cat_boundaries",
          "cat_threshold")


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


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the split search
# ---------------------------------------------------------------------------
def _cat_leaf(rng, f=6, b=40, n=3000):
    """A leaf's (3, F, B) histogram from rows with Zipf-skewed bins, so the
    features hold few and many used bins; the last bin of each is its
    missing bin and holds the Zipf tail (complementary candidates of a
    feature without missing rows tie up to rounding: the module note)."""
    nbpf = rng.randint(3, b + 1, f).astype(np.int32)
    mbpf = nbpf - 1
    bins = np.minimum(rng.zipf(1.3, (n, f)) - 1, nbpf - 1)
    eff = rng.randn(f, b)
    grad = rng.randn(n) * 0.3 + 0.5 * sum(eff[j][bins[:, j]] for j in range(f))
    hess = rng.rand(n) * 0.25 + 0.01
    hist = np.zeros((3, f, b))
    for j in range(f):
        for c, v in enumerate((grad, hess, np.ones(n))):
            hist[c, j] = np.bincount(bins[:, j], weights=v, minlength=b)[:b]
    hist = hist.astype(np.float32)
    return hist, hist[:, 0].sum(axis=1), nbpf, mbpf


SEARCH = {
    "defaults": {},
    "onehot_8": dict(max_cat_to_onehot=8),
    "threshold_3": dict(max_cat_threshold=3, max_cat_to_onehot=2),
    "l1_l2_smooth": dict(lambda_l1=0.5, lambda_l2=2.0, cat_l2=1.0, cat_smooth=3.0),
    "max_delta_step": dict(max_delta_step=0.4, min_data_in_leaf=40),
}


@pytest.mark.parametrize("pname", sorted(SEARCH))
@pytest.mark.parametrize("contri", [False, True])
def test_categorical_search_matches_jax(pname, contri):
    """One-hot and many-vs-many candidates (ascending and descending
    scans, the missing bin, the max_cat_threshold and (used + 1) / 2 caps)
    on 12 leaves, against lightgbm_tpu/ops/split.py::find_best_split."""
    kinds = set()
    for seed in range(12):
        rng = np.random.RandomState(seed)
        hist, sums, nbpf, mbpf = _cat_leaf(rng)
        cmask = rng.rand(6) < 0.7
        fmask = rng.rand(6) < 0.9
        fc = (rng.rand(6) * 1.5).astype(np.float32) if contri else None
        p = {"min_data_in_leaf": 10, **SEARCH[pname]}
        jb = jsplit.find_best_split(
            jnp.asarray(hist), jnp.float32(sums[0]), jnp.float32(sums[1]),
            jnp.float32(sums[2]), jnp.asarray(nbpf), jnp.asarray(mbpf),
            jsplit.SplitParams(**p), feature_mask=jnp.asarray(fmask),
            categorical_mask=jnp.asarray(cmask),
            feature_contri=None if fc is None else jnp.asarray(fc))
        tb = tsplit.find_best_split(
            _t(hist), float(sums[0]), float(sums[1]), float(sums[2]), _t(nbpf),
            _t(mbpf), tsplit.SplitParams(**p), feature_mask=_t(fmask),
            categorical_mask=_t(cmask), feature_contri=None if fc is None else _t(fc))
        for name in ("feature", "threshold_bin", "default_left", "is_cat", "cat_mask"):
            np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                          np.asarray(getattr(jb, name)), err_msg=name)
        for name in ("gain", "left_sum_g", "left_sum_h", "left_count"):
            np.testing.assert_allclose(float(getattr(tb, name)),
                                       float(getattr(jb, name)), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
        if bool(tb.is_cat):
            kinds.add(int(tb.cat_mask.sum()) == 1)
    assert kinds, "no leaf split on a categorical feature"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_per_feature_selection_is_the_flat_selection(seed):
    """reduce_plane_per_feature + select_from_feature_best (the round
    kernel's two halves, which find_best_split also takes on categorical
    planes) against the flat argmax of the same planes, bitwise, on planes
    with a duplicated column (ties go to the first feature and bin), and
    the replayed winner mask against the plane's own ranks."""
    rng = np.random.RandomState(seed)
    leaves = [_cat_leaf(rng, n=1500) for _ in range(4)]
    hist = np.stack([lf[0] for lf in leaves])
    hist[:, :, 5] = hist[:, :, 2]  # a duplicated column: exact ties
    nbpf, mbpf = leaves[0][2], leaves[0][3]
    nbpf[5], mbpf[5] = nbpf[2], mbpf[2]
    sums = np.stack([lf[1] for lf in leaves])
    cmask = _t(np.array([True, False, True, True, False, True]))
    p = tsplit.SplitParams(min_data_in_leaf=10)
    args = (_t(hist), _t(sums[:, 0]), _t(sums[:, 1]), _t(sums[:, 2]), _t(nbpf),
            _t(mbpf), p)
    gain, ctx = tsplit.gain_plane(*args, categorical_mask=cmask)
    got = tsplit.select_from_feature_best(
        tsplit.reduce_plane_per_feature(gain, ctx), args[1], args[2], args[3],
        hist.shape[3], categorical_mask=cmask, cand_hist=args[0],
        missing_bin_per_feature=args[5], params=p)
    for a, b in zip(got, tsplit.find_best_split(*args, categorical_mask=cmask)):
        assert torch.equal(a, b)
    c, _, b = gain.shape
    cell = torch.argmax(gain.reshape(c, -1), dim=1)
    f, t = cell // b, cell % b
    rows = torch.arange(c)
    assert torch.equal(got.feature.long(), f) and torch.equal(got.threshold_bin.long(), t)
    assert torch.equal(got.gain, gain.reshape(c, -1)[rows, cell])
    v = ctx["variant"][rows, f, t]
    bins = torch.arange(b)[None, :]
    want = torch.where(v[:, None] == 0, bins == t[:, None], torch.where(
        v[:, None] == 1, ctx["rank_asc"][rows, f] <= t[:, None],
        ctx["rank_desc"][rows, f] <= t[:, None]))
    assert torch.equal(got.cat_mask, want & cmask[f][:, None])
    assert got.is_cat.any()


# ---------------------------------------------------------------------------
# trainings through lgb.train
# ---------------------------------------------------------------------------
def _data(seed=0, n=4000):
    """Three categorical columns (12, 3 and 6 codes, each 10% missing) and
    two numerical ones on a coarse grid; separated category effects."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 5))
    X[:, 0] = rng.randint(0, 12, n)
    X[:, 1] = rng.randint(0, 3, n)
    X[:, 2] = np.round(rng.randn(n) * 4) / 4
    X[:, 3] = rng.randint(0, 6, n)
    X[:, 4] = np.round(rng.randn(n) * 4) / 4
    for j in CATS:
        X[rng.rand(n) < 0.1, j] = np.nan
    eff0 = rng.permutation(12) * 0.35 - 2
    eff3 = rng.permutation(6) * 0.5 - 1.2
    Z = np.nan_to_num(X, nan=0).astype(int)
    s = (eff0[Z[:, 0]] + 1.5 * (X[:, 1] == 2) + X[:, 2] + eff3[Z[:, 3]]
         - 1.0 * np.isnan(X[:, 0]))
    y = (s + 0.3 * rng.randn(n) > 0).astype(float)
    return X, y


def _params(mode, extra=None):
    return {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
            "learning_rate": 0.2, "tree_growth_mode": mode,
            "min_gain_to_split": 0.1, "verbosity": -1, **(extra or {})}


def _structure(text):
    return [ln for ln in text.splitlines() if ln.split("=")[0] in STRUCT]


def _train_both(mode, extra=None, rounds=5):
    X, y = _data()
    p = _params(mode, extra)
    jb = jlgb.train(dict(p), jlgb.Dataset(X, label=y, categorical_feature=CATS),
                    rounds)
    tp = {**p, **CPU}
    tb = tlgb.train(tp, tlgb.Dataset(X, label=y, categorical_feature=CATS,
                                     params=tp), rounds)
    return X, jb, tb


@pytest.mark.parametrize("mode", ["strict", "rounds"])
@pytest.mark.parametrize("contri", [False, True])
def test_training_matches_jax(mode, contri):
    X, jb, tb = _train_both(mode, {"feature_contri": CONTRI} if contri else None)
    jt, tt = jb.model_to_string(), tb.model_to_string()
    assert _structure(tt) == _structure(jt)
    assert sum(t.num_cat for t in tb._gbdt.models) > 20
    for a, b in zip(jb._gbdt.models, tb._gbdt.models):
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5, atol=5e-5)
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=1e-5, atol=5e-5)
    # the port's text reloads bitwise, and the JAX package reads it
    again = tlgb.Booster(model_str=tt, params=CPU)
    np.testing.assert_array_equal(again.predict(X), tb.predict(X))
    np.testing.assert_allclose(jlgb.Booster(model_str=tt).predict(X), tb.predict(X),
                               rtol=1e-6, atol=1e-6)


def test_contri_zero_feature_is_never_split():
    X, y = _data()
    p = {**_params("rounds", {"feature_contri": [1.0, 0.0, 1.0, 1.0, 1.0]}), **CPU}
    bst = tlgb.train(p, tlgb.Dataset(X, label=y, categorical_feature=CATS, params=p), 3)
    assert all(1 not in t.split_feature for t in bst._gbdt.models)


def test_unseen_and_missing_categories_go_right():
    X, jb, tb = _train_both("rounds")
    probe = X[:64].copy()
    probe[:16, 0] = 57.0  # never seen
    probe[16:32, 0] = np.nan
    probe[32:48, 0] = -3.0
    probe[48:, 0] = 4.5  # not an integer: truncates to 4, as the reference
    np.testing.assert_allclose(tb.predict(probe), jb.predict(probe), rtol=1e-5,
                               atol=5e-5)
    # every categorical node sends an unseen value right
    for t in tb._gbdt.models:
        for nd in np.nonzero(t.is_categorical_node())[0]:
            assert not t.cat_decision_left(int(nd), 57.0)
            assert not t.cat_decision_left(int(nd), float("nan"))


def test_jax_trained_model_predicts_in_the_port():
    X, jb, _ = _train_both("rounds")
    carried = booster_from_jax_model_string(jb.model_to_string(), device_type="cpu")
    np.testing.assert_allclose(carried.predict(X), jb.predict(X), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(carried.predict(X, pred_leaf=True),
                                  jb.predict(X, pred_leaf=True))
    contrib = carried.predict(X[:40], pred_contrib=True)
    np.testing.assert_allclose(contrib.sum(axis=1),
                               carried.predict(X[:40], raw_score=True),
                               rtol=1e-5, atol=1e-5)


def test_valid_sets_init_model_and_graphs_on_categorical_trees():
    """A late validation set and init_model replay categorical trees on the
    device bins (Dataset.predict_leaf_binned_tree); the static-buffer round
    path (fused_training) gives the eager path's model."""
    X, y = _data()
    p = {**_params("rounds"), **CPU}
    ds = tlgb.Dataset(X[:3000], label=y[:3000], categorical_feature=CATS, params=p)
    valid = tlgb.Dataset(X[3000:], label=y[3000:], reference=ds)
    bst = tlgb.train(p, ds, 4, valid_sets=[valid], keep_training_booster=True)
    score = bst._gbdt._valid_scores[0].numpy()
    np.testing.assert_allclose(score, bst.predict(X[3000:], raw_score=True),
                               rtol=1e-5, atol=1e-5)
    late = tlgb.Dataset(X[3000:], label=y[3000:], reference=ds)
    bst.add_valid(late, "late")
    np.testing.assert_allclose(bst._gbdt._valid_scores[1].numpy(), score, rtol=1e-6,
                               atol=1e-6)
    more = tlgb.train(p, tlgb.Dataset(X[:3000], label=y[:3000],
                                      categorical_feature=CATS, params=p), 2,
                      init_model=bst)
    assert more.num_trees() == 6
    eager = tlgb.train({**p, "fused_training": False},
                       tlgb.Dataset(X[:3000], label=y[:3000],
                                    categorical_feature=CATS, params=p), 4)
    fused = tlgb.train(p, tlgb.Dataset(X[:3000], label=y[:3000],
                                       categorical_feature=CATS, params=p), 4)
    assert fused.model_to_string() == eager.model_to_string()


def test_pandas_category_columns_and_names():
    pd = pytest.importorskip("pandas")
    X, y = _data()
    df = pd.DataFrame(X, columns=["a", "b", "c", "d", "e"])
    df["b"] = pd.Categorical(np.where(np.isnan(X[:, 1]), None,
                                      np.nan_to_num(X[:, 1]).astype(int).astype(str)))
    p = {**_params("rounds"), **CPU}
    by_name = tlgb.train(p, tlgb.Dataset(df, label=y, categorical_feature=["a", "b", "d"],
                                         params=p), 2)
    by_index = tlgb.train(p, tlgb.Dataset(df, label=y, categorical_feature=CATS,
                                          params=p), 2)
    assert by_name.model_to_string() == by_index.model_to_string()
    assert by_name._gbdt.binner.categorical_mask.tolist() == [True, True, False,
                                                              True, False]


# ---------------------------------------------------------------------------
# the growers, tree for tree
# ---------------------------------------------------------------------------
NUM_BINS = 100


def _grower_fixture(seed, n=3000, f=6):
    """Bins: features 0 and 3 categorical (12 and 6 codes, 10% in their
    missing bin), the rest numerical step functions."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, NUM_BINS - 1, (n, f)).astype(np.int16)
    nbpf = np.full(f, NUM_BINS, np.int32)
    mbpf = np.full(f, -1, np.int32)
    cmask = np.zeros(f, bool)
    for j, k in ((0, 12), (3, 6)):
        bins[:, j] = rng.randint(0, k, n)
        bins[rng.rand(n) < 0.1, j] = k
        nbpf[j], mbpf[j], cmask[j] = k + 1, k, True
    eff0 = np.append(rng.permutation(12) * 0.6, -2.0)
    eff3 = np.append(rng.permutation(6) * 0.8, 1.0)
    y = (eff0[bins[:, 0]] + eff3[bins[:, 3]] + 2.0 * (bins[:, 1] > 40)
         + 1.0 * (bins[:, 2] > 70) + 0.05 * rng.randn(n))
    grad = (-y).astype(np.float32)
    hess = (0.5 + 0.5 * rng.rand(n)).astype(np.float32)
    return (bins, grad, hess, np.ones(n, bool), np.ones(n, np.float32),
            np.ones(f, bool), nbpf, mbpf), cmask


def _same_tree(tt, tl, jt, jl):
    jt = {k: (None if v is None else np.asarray(v)) for k, v in jt._asdict().items()}
    nl = int(jt["num_leaves"])
    assert int(tt.num_leaves) == nl and nl > 8
    m = nl - 1
    assert jt["is_cat"][:m].any()
    for name in ("split_feature", "threshold_bin", "default_left", "left_child",
                 "right_child", "is_cat", "cat_mask"):
        np.testing.assert_array_equal(getattr(tt, name)[:m], jt[name][:m], err_msg=name)
    for name, k in (("leaf_value", nl), ("leaf_count", nl), ("internal_value", m)):
        np.testing.assert_allclose(getattr(tt, name)[:k], jt[name][:k], rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(tl, np.asarray(jl))


_GP = dict(min_data_in_leaf=20, lambda_l2=1.0)


@pytest.mark.parametrize("megakernel", ["0", "1"])
@pytest.mark.parametrize("contri", [False, True])
def test_windowed_grower_matches_jax(megakernel, contri):
    """The three-pass round and the megakernel's plain version against the
    JAX package's three-pass windowed grower (XLA)."""
    fx, cmask = _grower_fixture(5)
    fc = np.array([1.0, 0.7, 1.0, 0.9, 0.5, 1.0], np.float32) if contri else None
    kw = dict(num_leaves=14, num_bins=NUM_BINS, leaf_tile=4)
    extra = dict(categorical_mask=cmask, feature_contri=fc)
    jt, jl = jwin.grow_tree_windowed(
        jnp.asarray(fx[0].T), *map(jnp.asarray, fx[1:]), use_pallas=False,
        megakernel_opt="0", params=jsplit.SplitParams(**_GP), **kw,
        **{k: (None if v is None else jnp.asarray(v)) for k, v in extra.items()})
    tt, tl = twin.grow_tree_windowed(
        *map(_t, fx), params=tsplit.SplitParams(**_GP), megakernel_opt=megakernel,
        **kw, **{k: (None if v is None else _t(v)) for k, v in extra.items()})
    _same_tree(tt.to_numpy(), tl.numpy(), jt, jl)


def test_megakernel_equals_three_pass_bitwise():
    fx, cmask = _grower_fixture(9)
    kw = dict(num_leaves=20, num_bins=NUM_BINS, leaf_tile=6,
              params=tsplit.SplitParams(**_GP), categorical_mask=_t(cmask))
    a = twin.grow_tree_windowed(*map(_t, fx), megakernel_opt="1", **kw)
    b = twin.grow_tree_windowed(*map(_t, fx), megakernel_opt="0", **kw)
    for name, x, y in zip(a[0]._fields, a[0], b[0]):
        if x is not None:
            assert torch.equal(x, y), name
    assert torch.equal(a[1], b[1])


@pytest.mark.parametrize("contri", [False, True])
def test_rounds_grower_matches_jax(contri):
    fx, cmask = _grower_fixture(3)
    fc = np.array([1.0, 0.7, 1.0, 0.9, 0.5, 1.0], np.float32) if contri else None
    kw = dict(num_leaves=14, num_bins=NUM_BINS, leaf_tile=8)
    extra = dict(categorical_mask=cmask, feature_contri=fc)
    jt, jl = jfast.grow_tree_fast(
        *map(jnp.asarray, fx), use_pallas=False, params=jsplit.SplitParams(**_GP),
        **kw, **{k: (None if v is None else jnp.asarray(v)) for k, v in extra.items()})
    tt, tl = tfast.grow_tree_fast(
        *map(_t, fx), params=tsplit.SplitParams(**_GP), **kw,
        **{k: (None if v is None else _t(v)) for k, v in extra.items()})
    _same_tree(tt.to_numpy(), tl.numpy(), jt, jl)
    # the device walk of the tree's bins routes every row to its leaf
    leaf = tfast.predict_leaf_arrays(tt, _t(fx[0]), _t(fx[7]), categorical=True)
    assert torch.equal(leaf, tl)


# ---------------------------------------------------------------------------
# hist_precision=bf16
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,tile,n,base", [(16, 1, 1000, 0), (63, 16, 2049, 3),
                                           (255, 16, 3001, 5)])
def test_bf16_histogram_matches_jax(interpret, b, tile, n, base):
    rng = np.random.RandomState(b + tile)
    bins = rng.randint(0, b, (n, 5)).astype(np.int16)
    grad = rng.randn(n).astype(np.float32)
    hess = (rng.rand(n) * 0.25).astype(np.float32)
    mask = rng.rand(n) < 0.85
    leaf = rng.randint(-1, base + tile + 2, n).astype(np.int32)
    jargs = (jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
             jnp.asarray(mask), jnp.asarray(leaf), base, tile, b)
    refs = [np.asarray(histogram_onehot_multi(*jargs, precision="bf16")),
            np.asarray(hist_pallas.histogram_pallas_multi(*jargs, precision="bf16"))]
    hist_cuda.reset_counts()
    port = port_hist.histogram_multi(_t(bins), _t(grad), _t(hess), _t(mask),
                                     _t(leaf), base, tile, b, precision="bf16").numpy()
    assert hist_cuda.plain_calls["histogram_multi_bf16"] == 1
    # the rounded values, summed in float64: the port rounds once at the end
    g16 = torch.from_numpy(grad).to(torch.bfloat16).double().numpy()
    exact = np.zeros_like(port, np.float64)
    slot = leaf - base
    for s in range(tile):
        rows = mask & (slot == s)
        for j in range(5):
            exact[s, 0, j] = np.bincount(bins[rows, j], weights=g16[rows], minlength=b)
    np.testing.assert_allclose(port[:, 0], exact[:, 0], rtol=1e-6, atol=1e-6)
    for ref in refs:
        np.testing.assert_array_equal(port[:, 2], ref[:, 2])
        for c in range(2):
            scale = max(np.abs(ref[:, c]).max(), 1.0)
            np.testing.assert_allclose(port[:, c], ref[:, c], rtol=2e-4,
                                       atol=2e-4 * scale)
    # already-rounded payloads are read as they are
    again = port_hist.histogram_multi(
        _t(bins), _t(grad).to(torch.bfloat16), _t(hess).to(torch.bfloat16),
        _t(mask), _t(leaf), base, tile, b, precision="bf16").numpy()
    np.testing.assert_array_equal(again, port)


@pytest.mark.parametrize("f,quant,precision", [(6, False, "f32"), (6, False, "bf16"),
                                               (6, True, "f32"), (300, False, "bf16"),
                                               (300, True, "bf16"), (28, False, "bf16")])
def test_leaf_tile_is_the_jax_policy(f, quant, precision):
    for b in (16, 64, 256):
        for leaves in (7, 31, 255):
            assert hist_cuda.recommended_leaf_tile(
                b, f, leaves, quantized=quant, hist_precision=precision) == \
                hist_pallas.recommended_leaf_tile(
                    b, f, leaves, quantized=quant, hist_precision=precision)


def test_bf16_rounds_grower_matches_jax_at_its_tile(interpret):
    """The rounds grower with hist_precision=bf16 at the JAX package's bf16
    tile (16 at narrow F) against its Pallas bf16 histogram."""
    fx, cmask = _grower_fixture(4)
    tile = hist_pallas.recommended_leaf_tile(NUM_BINS, 6, 24, hist_precision="bf16")
    assert tile == 16
    kw = dict(num_leaves=24, num_bins=NUM_BINS, leaf_tile=tile, hist_precision="bf16")
    jt, jl = jfast.grow_tree_fast(
        *map(jnp.asarray, fx), use_pallas=True, params=jsplit.SplitParams(**_GP),
        categorical_mask=jnp.asarray(cmask), **kw)
    hist_cuda.reset_counts()
    tt, tl = tfast.grow_tree_fast(*map(_t, fx), params=tsplit.SplitParams(**_GP),
                                  categorical_mask=_t(cmask), **kw)
    assert hist_cuda.plain_calls["histogram_multi_bf16"] >= 3
    assert hist_cuda.plain_calls["histogram_multi"] == 0
    _same_tree(tt.to_numpy(), tl.numpy(), jt, jl)


@pytest.mark.parametrize("mode", ["strict", "rounds"])
def test_bf16_training_runs_every_grower(mode):
    X, y = _data()
    loss = {}
    for precision in ("f32", "bf16"):
        p = {**_params(mode, {"hist_precision": precision}), **CPU}
        hist_cuda.reset_counts()
        bst = tlgb.train(p, tlgb.Dataset(X, label=y, categorical_feature=CATS,
                                         params=p), 3)
        # the strict grower sums f32, as the JAX package's does
        assert ((hist_cuda.plain_calls["histogram_multi_bf16"] > 0)
                == (mode == "rounds" and precision == "bf16"))
        pr = np.clip(bst.predict(X), 1e-7, 1 - 1e-7)
        loss[precision] = -np.mean(y * np.log(pr) + (1 - y) * np.log(1 - pr))
    assert abs(loss["bf16"] - loss["f32"]) < 0.01 * loss["f32"]


# ---------------------------------------------------------------------------
# binning
# ---------------------------------------------------------------------------
def test_categorical_bins_match_the_jax_binner():
    rng = np.random.RandomState(0)
    X = np.column_stack([rng.zipf(1.4, 6000) - 4.0, rng.randint(-3, 400, 6000),
                         rng.randn(6000)]).astype(np.float64)
    X[rng.rand(6000) < 0.1, 0] = np.nan
    X[rng.rand(6000) < 0.1, 1] = np.nan
    probe = np.vstack([X, [[2.5, -1.0, 0.0], [-0.0, 1e9, 1.0], [np.inf, np.nan, 2.0],
                           [-1.0, 399.5, np.nan], [1e6, -3.0, 3.0]]])
    for mb in (255, 7):
        jbin = JBinner.fit(X, max_bin=mb, categorical_features=[0, 1])
        tbin = TBinner.fit(X, max_bin=mb, categorical_features=[0, 1])
        np.testing.assert_array_equal(tbin.transform(probe), jbin.transform(probe))
        assert tbin.categorical_mask.tolist() == [True, True, False]
