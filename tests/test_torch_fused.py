"""The one-dispatch contracts of lightgbm_tpu_torch on the CPU: the masked
fixed-tile rounds grower against the JAX package's rounds grower, the
static-buffer round (what a CUDA graph replays on the card) against the
functional one, fused_training on and off, the finish check every 32
iterations, and the sanitizer's counts.

Tolerances.  Against the JAX grower (use_pallas=False, XLA scatter sums in
f32) trees agree node for node and leaf ids row for row; sums, gains and
values are held to 1e-5 relative, as tests/test_torch_grower.py holds them
(the port adds 64-bit fixed point).  Everything inside the port is held
bitwise: the static-buffer round runs the same torch ops on the same
values, and a round admitted after convergence changes nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops import treegrow_fast as jfast
from lightgbm_tpu.ops.split import SplitParams as JParams
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.convert import tree_arrays_from_numpy
from lightgbm_tpu_torch.models.gbdt import GBDT
from lightgbm_tpu_torch.ops import hist_cuda, round_cuda
from lightgbm_tpu_torch.ops import treegrow_fast as tfast
from lightgbm_tpu_torch.ops import treegrow_windowed as twin
from lightgbm_tpu_torch.ops.graphs import RoundGraphs, _map
from lightgbm_tpu_torch.ops.split import SplitParams as TParams
from lightgbm_tpu_torch.ops.treegrow import empty_tree
from lightgbm_tpu_torch.utils import sanitizer as san

NUM_BINS = 64


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _fixture(seed, n=2500, f=6, mask_frac=0.9):
    """Step functions of four features (separated gains), feature 1 with
    missing values in its last bin."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, NUM_BINS - 1, (n, f)).astype(np.int16)
    nbpf = np.full(f, NUM_BINS, np.int32)
    mbpf = np.full(f, -1, np.int32)
    bins[rng.rand(n) < 0.1, 1] = NUM_BINS - 1
    mbpf[1] = NUM_BINS - 1
    y = (4.0 * (bins[:, 0] > 30) + 2.0 * (bins[:, 1] > 20)
         + 1.0 * (bins[:, 2] > 40) + 0.5 * (bins[:, 3] > 12) * (bins[:, 0] > 30)
         + 1.5 * (bins[:, 1] == NUM_BINS - 1) + 0.05 * rng.randn(n))
    grad = (-y).astype(np.float32)
    hess = (0.5 + 0.5 * rng.rand(n)).astype(np.float32)
    mask = rng.rand(n) < mask_frac
    return (bins, grad, hess, mask, np.ones(n, np.float32), np.ones(f, bool),
            nbpf, mbpf)


def _torch(fx):
    return [torch.from_numpy(a) for a in fx]


def _tree_np(tree):
    return {k: (None if v is None else np.asarray(v))
            for k, v in tree._asdict().items()}


def _assert_same_tree(jt, jl, tt, tl, fx, rtol=1e-5):
    """Node for node; a threshold may differ only where both thresholds
    route every training row alike (a gap in the leaf's bins makes them an
    exact tie, which the JAX side's f32 subtraction residue breaks one way
    and the port's exact fixed-point zeros the other; tests/
    test_torch_windowed.py holds the windowed grower the same way)."""
    nl = int(jt["num_leaves"])
    assert int(tt["num_leaves"]) == nl and nl > 2
    m = nl - 1
    for name in ("split_feature", "default_left", "left_child", "right_child"):
        np.testing.assert_array_equal(tt[name][:m], jt[name][:m], err_msg=name)
    if not np.array_equal(tt["threshold_bin"][:m], jt["threshold_bin"][:m]):
        bins, mbpf = torch.from_numpy(fx[0]), torch.from_numpy(fx[7])
        route = [tfast.predict_leaf_arrays(tree_arrays_from_numpy(t), bins, mbpf)
                 for t in (tt, jt)]
        assert torch.equal(route[0], route[1]), "thresholds route rows apart"
    np.testing.assert_array_equal(tt["leaf_depth"][:nl], jt["leaf_depth"][:nl])
    np.testing.assert_allclose(tt["split_gain"][:m], jt["split_gain"][:m], rtol=rtol,
                               atol=rtol * jt["split_gain"][:m].max())
    for name, k in (("internal_value", m), ("internal_weight", m),
                    ("internal_count", m), ("leaf_value", nl),
                    ("leaf_weight", nl), ("leaf_count", nl), ("leaf_sum_g", nl)):
        np.testing.assert_allclose(tt[name][:k], jt[name][:k], rtol=rtol,
                                   atol=rtol, err_msg=name)
    np.testing.assert_array_equal(tl, jl)


def _assert_bitwise(a, b, what=""):
    """Two trees of (named) tuples of tensors, bit for bit."""
    if a is None or b is None:
        assert a is None and b is None, what
    elif isinstance(a, tuple):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bitwise(x, y, f"{what}.{getattr(a, '_fields', range(len(a)))[i]}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert torch.equal(a, b), what


# ---------------------------------------------------------------------------
# the masked fixed-tile rounds grower against the JAX rounds grower
# ---------------------------------------------------------------------------
CASES = {
    # 12 leaves at a tile of 16: every round admits fewer splits than the tile
    "tile_larger_than_admitted": dict(num_leaves=12, leaf_tile=16,
                                      params=dict(min_data_in_leaf=20, lambda_l2=1.0)),
    # the gains run out before num_leaves (a high min_gain_to_split)
    "gain_exhausted": dict(num_leaves=63, leaf_tile=8,
                           params=dict(min_data_in_leaf=40, lambda_l2=1.0,
                                       min_gain_to_split=30.0)),
    # the depth limit stops growth
    "max_depth": dict(num_leaves=31, leaf_tile=8, max_depth=3,
                      params=dict(min_data_in_leaf=20, lambda_l2=1.0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rounds_grower_matches_jax(case):
    c = CASES[case]
    fx = _fixture(3 + len(case))
    kw = dict(num_leaves=c["num_leaves"], num_bins=NUM_BINS,
              max_depth=c.get("max_depth", -1), leaf_tile=c["leaf_tile"])
    jt, jl = jfast.grow_tree_fast(*map(jnp.asarray, fx), use_pallas=False,
                                  params=JParams(**c["params"]), **kw)
    stats = {}
    tt, tl = tfast.grow_tree_fast(*_torch(fx), params=TParams(**c["params"]),
                                  stats=stats, **kw)
    _assert_same_tree(_tree_np(jt), np.asarray(jl), _tree_np(tt.to_numpy()),
                      tl.numpy(), fx)
    nl = int(tt.num_leaves)
    if case == "gain_exhausted":
        assert nl < c["num_leaves"]
    if case == "max_depth":
        assert int(tt.leaf_depth[:nl].max()) == 3 and nl < c["num_leaves"]
    # one round a launch, every info vector resolved, no blocking read
    assert stats["rounds"] == stats["async_resolves"] and stats["host_syncs"] == 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_round_after_convergence_is_a_bitwise_no_op(case):
    """The one-behind driver launches one round past the last productive
    one: that round admits nothing and leaves every state tensor, the
    histogram state included, bit for bit as it was."""
    c = CASES[case]
    b = _torch(_fixture(3 + len(case)))
    params = TParams(**c["params"])
    static = dict(num_leaves=c["num_leaves"], num_bins=NUM_BINS,
                  max_depth=c.get("max_depth", -1), params=params,
                  leaf_tile=c["leaf_tile"], quantize_bins=0)
    st, inp, _, _ = tfast._f_init(b[0], b[1], b[2], b[3], b[4], b[5], b[6], b[7],
                                  num_leaves=c["num_leaves"], num_bins=NUM_BINS,
                                  params=params, quantize_bins=0,
                                  stochastic_rounding=False, generator=None)
    for _ in range(2 * c["num_leaves"]):
        st, info = tfast._round(st, b[0], inp, b[6], b[7], **static)
        if int(info[5]) == 0:  # the next round admits nothing
            break
    before = _map(torch.clone, st)
    after, info = tfast._round(st, b[0], inp, b[6], b[7], **static)
    assert int(info[0]) == 0 and int(info[5]) == 0 and int(info[4]) == 1
    _assert_bitwise(tuple(after), before, "state")


def test_predict_leaf_arrays_reads_nothing_for_a_stump():
    tree = empty_tree(8, NUM_BINS, "cpu")
    bins = torch.from_numpy(_fixture(1, n=50)[0])
    leaf = tfast.predict_leaf_arrays(tree, bins, torch.full((6,), -1, dtype=torch.int32))
    assert leaf.dtype == torch.int32 and torch.equal(leaf, torch.zeros(50, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the static-buffer round (what a graph replays) against the functional one
# ---------------------------------------------------------------------------
def _windowed_round_pair(quant, mk):
    """One windowed round from the same root state: functional, and through
    the static buffers of a CPU RoundGraphs."""
    b = _torch(_fixture(21 + quant, n=1500))
    params = TParams(min_data_in_leaf=20, lambda_l2=1.0)
    kw = dict(num_leaves=15, num_bins=NUM_BINS, params=params, quantize_bins=quant,
              stochastic_rounding=False, generator=None)
    static = dict(num_leaves=15, num_bins=NUM_BINS, max_depth=-1, params=params,
                  leaf_tile=4, quantize_bins=quant, megakernel=mk)
    fixed = (b[0], b[6], b[7])

    def round_fn(st, inp, W):
        return twin._round_fused(st, b[0], inp.grad, inp.hess, inp.gq, inp.hq,
                                 inp.quant_scale, inp.row_mask, b[6], b[7],
                                 inp.feature_mask, W=W, shift=inp.shift, **static)

    def init():
        return twin._w_init(b[0], b[1], b[2], b[3], b[4], b[6], b[7], b[5], **kw)

    st, inp, _, _ = init()
    want = twin.round_runner(round_fn, st, inp, fixed, ("w",), None)(st, 8192)
    graphs = RoundGraphs("cpu")
    st, inp, _, _ = init()
    got = twin.round_runner(round_fn, st, inp, fixed, ("w",), graphs)(None, 8192)
    assert got[0] is graphs.buffers[0] and got[1] is graphs.buffers[2]
    return want, got


@pytest.mark.parametrize("quant,mk", [(0, False), (0, True), (16, False)])
def test_static_buffer_round_equals_the_functional_round(quant, mk):
    (w_state, w_info), (g_state, g_info) = _windowed_round_pair(quant, mk)
    assert torch.equal(w_info, g_info) and int(w_info[0]) > 0
    _assert_bitwise(tuple(g_state), tuple(w_state), "state")


@pytest.mark.parametrize("quant,mk", [(0, "0"), (0, "1"), (16, "0")])
def test_static_buffer_trees_equal_the_functional_trees(quant, mk):
    """Two trees through one cache (the second loads new gradients into the
    same buffers) against two functional trees: trees and leaf ids bitwise;
    one dispatch a round, one blocking read a tree."""
    fx = _fixture(31 + quant, n=2000)
    b = _torch(fx)
    kw = dict(num_leaves=15, num_bins=NUM_BINS, leaf_tile=4, quantize_bins=quant,
              stochastic_rounding=False, megakernel_opt=mk,
              params=TParams(min_data_in_leaf=20, lambda_l2=1.0))
    graphs = RoundGraphs("cpu")
    for k, g in enumerate((b[1], b[1] * 0.5 - 0.3)):
        args = (b[0], g, *b[2:])
        want = twin.grow_tree_windowed(*args, **kw)
        stats = {}
        got = twin.grow_tree_windowed(*args, graphs=graphs, stats=stats, **kw)
        _assert_bitwise(got, want, f"tree {k}")
        assert stats["dispatches"] == stats["rounds"] and stats["replays"] == 0
        assert stats["host_syncs"] == 1 and stats["captures"] == 0


def test_static_buffers_refuse_other_inputs():
    b = _torch(_fixture(41, n=600))
    kw = dict(num_leaves=8, num_bins=NUM_BINS, leaf_tile=4,
              params=TParams(min_data_in_leaf=20))
    graphs = RoundGraphs("cpu")
    tfast.grow_tree_fast(*b, graphs=graphs, **kw)
    with pytest.raises(ValueError, match="fixed inputs"):
        tfast.grow_tree_fast(b[0].clone(), *b[1:], graphs=graphs, **kw)
    with pytest.raises(ValueError):
        tfast.grow_tree_fast(*b, graphs=graphs, **{**kw, "num_leaves": 9})


# ---------------------------------------------------------------------------
# the exponent pair as a tensor
# ---------------------------------------------------------------------------
def test_round_plain_takes_the_exponents_as_a_tensor():
    """B3's plain version (and the histogram's) with the exponent pair as an
    int32[2] tensor equals its results with the pair as ints, bit for bit;
    the device-side pair equals the host one."""
    g = torch.Generator().manual_seed(5)
    n, f, b, T = 3000, 7, 32, 3
    bins = torch.randint(0, b, (n, f), generator=g, dtype=torch.int16)
    order = torch.randperm(n, generator=g).to(torch.int32)
    go = torch.rand(n, generator=g) < 0.4
    seg_start = torch.tensor([0, 1000, 2500], dtype=torch.int32)
    seg_len = torch.tensor([1000, 1200, 300], dtype=torch.int32)
    n_left = torch.stack([go[int(s):int(s + k)].sum() for s, k in
                          zip(seg_start, seg_len)]).to(torch.int32)
    small_left = (2 * n_left <= seg_len).to(torch.int32)
    win_start = torch.where(small_left > 0, seg_start, seg_start + n_left)
    win_cnt = torch.where(small_left > 0, n_left, seg_len - n_left)
    grad, hess = torch.randn(n, generator=g) * 5, torch.rand(n, generator=g)
    mask = torch.rand(n, generator=g) < 0.9
    args = [bins, order, go, grad, hess, mask, seg_start, seg_len, n_left,
            win_start, win_cnt, small_left, torch.rand((T, 3, f, b), generator=g) * 40,
            torch.rand((4, 2 * T), generator=g) * 300,
            torch.full((f,), b, dtype=torch.int32), torch.full((f,), -1, dtype=torch.int32),
            torch.ones(f, dtype=torch.bool)]
    pair = hist_cuda.fixed_shift_pair(grad, hess)
    tensor = hist_cuda.fixed_shift_tensor(grad, hess)
    assert tensor.dtype == torch.int32 and tensor.tolist() == list(pair)
    kw = dict(params=TParams(min_data_in_leaf=5, lambda_l2=1.0), W=4096)
    a = round_cuda.round_megakernel_plain(*args, shift=pair, **kw)
    t = round_cuda.round_megakernel_plain(*args, shift=tensor, **kw)
    _assert_bitwise(tuple(a[:3]) + tuple(a[3]), tuple(t[:3]) + tuple(t[3]), "round")
    slot = torch.randint(-1, 4, (n,), generator=g, dtype=torch.int32)
    h = [hist_cuda.histogram_multi(bins, grad, hess, mask, slot, 0, 4, b, shift=s)
         for s in (pair, tensor, None)]
    assert torch.equal(h[0], h[1]) and torch.equal(h[0], h[2])
    with pytest.raises(TypeError):
        hist_cuda.shift_on(tensor.long(), "cpu")


# ---------------------------------------------------------------------------
# through lgt.train: fused_training on and off, the finish check, the gate
# ---------------------------------------------------------------------------
def _data(objective, seed=11, n=3000, f=8):
    """tests/test_torch_train.py's fixture: values on a coarse grid, 5%
    missing."""
    rng = np.random.RandomState(seed)
    X = np.round(rng.randn(n, f) * 8) / 8
    X[rng.rand(n, f) < 0.05] = np.nan
    Z = np.nan_to_num(X)
    s = (2.0 * (Z[:, 0] > 0.3) + 1.5 * Z[:, 1] - 1.0 * (Z[:, 2] < -0.5)
         + 0.5 * Z[:, 3] * (Z[:, 4] > 0))
    if objective == "binary":
        return X, (s + 0.5 * rng.randn(n) > 0.6).astype(np.float64)
    return X, s + 0.1 * rng.randn(n)


@pytest.mark.parametrize("objective,extra", [
    ("binary", {}), ("regression", {}),
    ("binary", {"bagging_fraction": 0.7, "bagging_freq": 1, "feature_fraction": 0.8}),
    ("regression", {"max_depth": 3, "path_smooth": 2.0}),
])
def test_fused_training_on_and_off_give_the_same_model_text(objective, extra):
    X, y = _data(objective)
    texts, stats = [], []
    for fused in (True, False):
        p = {"objective": objective, "num_leaves": 15, "min_data_in_leaf": 20,
             "learning_rate": 0.2, "min_gain_to_split": 0.1, "verbosity": -1,
             "device_type": "cpu", "tree_growth_mode": "rounds",
             "fused_training": fused, **extra}
        bst = tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 5)
        texts.append(bst.model_to_string())
        stats.append(bst._gbdt.round_stats)
    assert texts[0] == texts[1]
    assert all(s["dispatches"] == s["rounds"] for s in stats[0])
    assert all(s["dispatches"] == 0 for s in stats[1])


def test_parameter_reset_that_resizes_the_state_starts_a_new_cache():
    """reset_parameter(num_leaves=...) mid-training: the fused path takes a
    new cache for the new state shapes and grows what the eager path
    grows."""
    X, y = _data("regression")
    texts = []
    for fused in (True, False):
        p = {"objective": "regression", "num_leaves": 15, "min_data_in_leaf": 20,
             "verbosity": -1, "device_type": "cpu", "tree_growth_mode": "rounds",
             "fused_training": fused}
        bst = tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 4,
                         callbacks=[tlgb.reset_parameter(num_leaves=[15, 15, 7, 7])])
        texts.append(bst.model_to_string())
    assert texts[0] == texts[1] and "num_leaves=7" in texts[0]


@pytest.mark.parametrize("fused", [True, False])
def test_finish_check_fires_on_the_jax_iteration(fused):
    """No split clears min_gain_to_split, so every tree is one leaf: both
    packages read that every 32 iterations and stop at the 32nd."""
    X, y = _data("binary", n=600)
    p = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
         "min_gain_to_split": 1e9, "tree_growth_mode": "rounds",
         "fused_training": fused}
    jb = jlgb.train(dict(p), jlgb.Dataset(X, label=y), 40)
    tp = {**p, "device_type": "cpu"}
    tb = tlgb.train(tp, tlgb.Dataset(X, label=y, params=tp), 40)
    assert jb.current_iteration() == tb.current_iteration() == 32


def test_fused_gate():
    """GBDT._fused_eligible: the JAX package's conditions as far as the
    port has them."""
    X, y = _data("binary", n=200)

    def gate(**extra):
        p = {"objective": "binary", "device_type": "cpu", "verbosity": -1,
             "tree_growth_mode": "rounds", **extra}
        g = GBDT(Config.from_dict(p))
        ds = tlgb.Dataset(X, label=y, params=p)
        ds.construct()
        return g._fused_eligible(ds)

    assert gate()
    assert not gate(fused_training=False)
    assert not gate(use_quantized_grad=True)
    assert gate(num_leaves=12_500)  # 12,500 x 8 features = 100,000
    assert not gate(num_leaves=12_501)


def test_sanitizer_counts_one_dispatch_a_round_and_no_blocking_read():
    """The rounds grower through a CPU cache: one dispatch a round, every
    info vector resolved one round behind, no blocking read inside the
    tree; the windowed grower its one read a tree (the maxima, checked
    finite)."""
    b = _torch(_fixture(51, n=1500))
    kw = dict(num_leaves=15, num_bins=NUM_BINS, leaf_tile=4,
              params=TParams(min_data_in_leaf=20, lambda_l2=1.0))
    for grow, syncs in ((tfast.grow_tree_fast, 0), (twin.grow_tree_windowed, 1)):
        graphs = RoundGraphs("cpu")
        with san.DispatchCounter() as c:
            stats = {}
            grow(*b, graphs=graphs, stats=stats, **kw)
        assert c.dispatches == c.rounds == stats["rounds"] >= 4
        assert c.host_syncs == syncs and c.async_resolves == c.rounds
        assert c.captures == c.replays == 0
