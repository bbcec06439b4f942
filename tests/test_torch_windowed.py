"""Windowed grower parity: lightgbm_tpu_torch's grow_tree_windowed (the
three-pass round, plain kernel versions on the CPU) against the JAX
package's grow_tree_windowed (megakernel_opt="0"), against the port's own
rounds grower, and its round-driver protocol.

Tolerances.  Fixtures are step functions of a few features with separated
gains, so every split beats its runner-up by far more than f32 rounding:
trees must agree node for node and leaf ids row for row.  Sums and values
are held to 1e-5 relative: the JAX side sums f32 by scatter (or bf16x2
products in its Pallas kernel), the port in 64-bit fixed point.  Against
the port's rounds grower the windowed tree is bitwise equal without
bagging (same fixed-point exponents, same admission, same child chosen for
the direct histogram); with a bagging mask the directly histogrammed child
is chosen by physical rather than in-bag counts, so the subtraction rounds
differently and values are held to 1e-5 relative.  Quantized growth uses
stochastic_rounding=False, so both sides see the same integers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas
from jax.experimental.pallas import tpu as pltpu

from lightgbm_tpu.ops import treegrow_windowed as jwin
from lightgbm_tpu.ops.split import SplitParams as JParams
from lightgbm_tpu.utils import degrade
from lightgbm_tpu_torch.convert import tree_arrays_from_numpy
from lightgbm_tpu_torch.ops import partition_cuda
from lightgbm_tpu_torch.ops import treegrow_fast as tfast
from lightgbm_tpu_torch.ops import treegrow_windowed as twin
from lightgbm_tpu_torch.ops.split import SplitParams as TParams
from lightgbm_tpu_torch.utils.guards import NonFiniteError

NUM_BINS = 100  # > 64: the JAX package takes its Pallas kernel


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def interpret(monkeypatch):
    """JAX's Pallas kernels through the interpreter; the installed JAX names
    the compiler parameters CompilerParams, the JAX package asks for
    TPUCompilerParams."""
    call = pallas.pallas_call
    monkeypatch.setattr(pallas, "pallas_call",
                        lambda *a, **k: call(*a, **{**k, "interpret": True}))
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)
    degrade.reset()
    yield
    degrade.reset()


def _fixture(seed, n=3000, f=8, masked=False):
    """Step functions of four features (tests/test_torch_grower.py's
    fixture), feature 1 with missing values in its last bin."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, NUM_BINS - 1, (n, f)).astype(np.int16)
    nbpf = np.full(f, NUM_BINS, np.int32)
    mbpf = np.full(f, -1, np.int32)
    bins[rng.rand(n) < 0.1, 1] = NUM_BINS - 1
    mbpf[1] = NUM_BINS - 1
    y = (4.0 * (bins[:, 0] > 50) + 2.0 * (bins[:, 1] > 30)
         + 1.0 * (bins[:, 2] > 70) + 0.5 * (bins[:, 3] > 20) * (bins[:, 0] > 50)
         + 1.5 * (bins[:, 1] == NUM_BINS - 1) + 0.05 * rng.randn(n))
    grad = (-y).astype(np.float32)
    hess = (0.5 + 0.5 * rng.rand(n)).astype(np.float32)
    mask = rng.rand(n) < 0.85 if masked else np.ones(n, bool)
    return (bins, grad, hess, mask, np.ones(n, np.float32), np.ones(f, bool),
            nbpf, mbpf)


_P = dict(min_data_in_leaf=20, lambda_l2=1.0)


def _kw(num_leaves, tile, quant, **extra):
    return dict(num_leaves=num_leaves, num_bins=NUM_BINS, leaf_tile=tile,
                quantize_bins=quant, stochastic_rounding=False,
                quant_renew=bool(quant), **extra)


def _port(fx, grower=twin.grow_tree_windowed, params=_P, **kw):
    t = [torch.from_numpy(a) for a in fx]
    tree, leaf = grower(*t, params=TParams(**params), **kw)
    return tree.to_numpy(), leaf.numpy()


def _jax(fx, use_pallas, params=_P, **kw):
    bins, *rest = fx
    tree, leaf = jwin.grow_tree_windowed(
        jnp.asarray(bins.T), *map(jnp.asarray, rest), use_pallas=use_pallas,
        megakernel_opt="0", params=JParams(**params), **kw)
    return ({k: (None if v is None else np.asarray(v))
             for k, v in tree._asdict().items()}, np.asarray(leaf))


def _assert_same_tree(got, want, fx, rtol=1e-5):
    """Node for node; a threshold may differ only where both thresholds
    route every training row alike (a gap in the leaf's bins makes them an
    exact tie, which the JAX side's f32 subtraction residue breaks one way
    and the port's exact fixed-point zeros the other)."""
    (tt, tl), (jt, jl) = got, want
    if not isinstance(jt, dict):
        jt = jt._asdict()
    nl = int(jt["num_leaves"])
    assert int(tt.num_leaves) == nl and nl > 8
    m = nl - 1
    for name in ("split_feature", "default_left", "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(tt, name)[:m], jt[name][:m],
                                      err_msg=name)
    if not np.array_equal(tt.threshold_bin[:m], jt["threshold_bin"][:m]):
        bins, mbpf = torch.from_numpy(fx[0]), torch.from_numpy(fx[7])
        route = [tfast.predict_leaf_arrays(tree_arrays_from_numpy(t), bins, mbpf)
                 for t in (tt._asdict(), jt)]
        assert torch.equal(route[0], route[1]), "thresholds route rows apart"
    np.testing.assert_array_equal(tt.leaf_depth[:nl], jt["leaf_depth"][:nl])
    # a gain is a difference of f32 terms as large as the root's
    np.testing.assert_allclose(tt.split_gain[:m], jt["split_gain"][:m], rtol=rtol,
                               atol=rtol * jt["split_gain"][:m].max())
    for name, k in (("internal_value", m), ("internal_weight", m),
                    ("internal_count", m), ("leaf_value", nl),
                    ("leaf_weight", nl), ("leaf_count", nl), ("leaf_sum_g", nl)):
        np.testing.assert_allclose(getattr(tt, name)[:k], jt[name][:k],
                                   rtol=rtol, atol=rtol, err_msg=name)
    np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize("quant,tile,masked", [
    (0, 8, False), (0, 4, True), (16, 8, False), (16, 12, True)])
def test_matches_jax_three_pass_xla(quant, tile, masked):
    fx = _fixture(1 + quant + tile, masked=masked)
    kw = _kw(12, tile, quant)
    _assert_same_tree(_port(fx, megakernel_opt="0", **kw), _jax(fx, False, **kw),
                      fx)


@pytest.mark.parametrize("quant,tile", [(0, 8), (16, 12)])
def test_matches_jax_three_pass_pallas_interpret(interpret, quant, tile):
    """The JAX side's Pallas histogram and partition kernels (interpret
    mode), as its TPU path runs them: float, and int8 on the exact int
    kernel."""
    fx = _fixture(7 + quant)
    kw = _kw(12, tile, quant)
    want = _jax(fx, True, **kw)
    assert degrade.available(degrade.HIST) and degrade.available(degrade.PARTITION)
    _assert_same_tree(_port(fx, megakernel_opt="0", **kw), want, fx)


@pytest.mark.parametrize("quant", [0, 16])
def test_bitwise_equal_to_rounds_grower_without_bagging(quant):
    fx = _fixture(11 + quant)
    kw = _kw(31, 8, quant, generator=None)
    t_fast, l_fast = _port(fx, grower=tfast.grow_tree_fast, **kw)
    t_win, l_win = _port(fx, megakernel_opt="0", **kw)
    assert int(t_win.num_leaves) > 8
    for name in t_fast._fields:
        a, b = getattr(t_fast, name), getattr(t_win, name)
        if a is not None:
            np.testing.assert_array_equal(b, a, err_msg=name)
    np.testing.assert_array_equal(l_win, l_fast)


def test_matches_rounds_grower_with_bagging():
    fx = _fixture(13, masked=True)
    kw = _kw(31, 8, 0)
    t_fast, l_fast = _port(fx, grower=tfast.grow_tree_fast, **kw)
    got = _port(fx, megakernel_opt="0", **kw)
    _assert_same_tree(got, (t_fast._asdict(), l_fast), fx)


def test_round_protocol_stats(monkeypatch):
    """One launch a round, one blocking read a tree (the fixed-point
    exponents, before the first round) and none inside the rounds, every
    info vector resolved one round behind (the last one drained), no retry,
    and the partition went through the kernel's dispatcher (plain version
    here)."""
    fx = _fixture(17)
    stats = {}
    partition_cuda.reset_counts()
    real = twin._run_fused_rounds
    in_rounds = []

    def counted(*a, **k):
        with twin._san.DispatchCounter() as c:
            out = real(*a, **k)
        in_rounds.append(c.host_syncs)
        return out

    monkeypatch.setattr(twin, "_run_fused_rounds", counted)
    tree, _ = _port(fx, stats=stats, megakernel_opt="0", **_kw(63, 8, 0))
    assert stats["retries"] == 0 and stats["host_syncs"] == 1
    assert in_rounds == [0]
    assert stats["rounds"] == stats["async_resolves"]
    # 62 splits at <= 8 a round take >= 8 rounds, plus the one that admits 0
    # or the one in flight when the budget is reached
    assert stats["rounds"] >= 8 and len(stats["windows"]) == stats["rounds"]
    assert stats["megakernel"] is False
    assert partition_cuda.plain_calls["partition_segments"] == stats["rounds"]
    assert partition_cuda.launches["partition_segments"] == 0


def test_window_breach_is_retried_with_the_same_tree(monkeypatch):
    """A first window predicted too small: the device skips the round, the
    host retries at the reported size, and the tree does not change."""
    fx = _fixture(19)
    kw = _kw(31, 8, 0)
    want = _port(fx, megakernel_opt="0", **kw)
    real = twin._window_size
    calls = []

    def first_too_small(x, n, floor=8192):
        calls.append(x)
        return 64 if len(calls) == 1 else real(x, n, floor)

    monkeypatch.setattr(twin, "_window_size", first_too_small)
    stats = {}
    got = _port(fx, stats=stats, megakernel_opt="0", **kw)
    assert stats["retries"] >= 1 and stats["windows"][0] == 64
    for name in want[0]._fields:
        a = getattr(want[0], name)
        if a is not None:
            np.testing.assert_array_equal(getattr(got[0], name), a, err_msg=name)
    np.testing.assert_array_equal(got[1], want[1])


def test_ladder_matches_jax():
    for n in (1000, 400_000, 1_000_003):
        assert list(twin._ladder(n)) == list(jwin._ladder(n))
        for x in (1, 8192, 9000, 150_000, n // 2):
            assert twin._window_size(x, n) == jwin._window_size(x, n)


def test_non_finite_gradients_raise():
    fx = list(_fixture(23, n=500))
    fx[1] = fx[1].copy()
    fx[1][7] = np.nan
    with pytest.raises(NonFiniteError):
        _port(tuple(fx), **_kw(15, 4, 0))


@pytest.mark.parametrize("opt", ["rng_key"])
def test_unported_options_raise(opt):
    """Per-node sampling, once refused, now grows the JAX package's
    three-pass tree (the name is kept): extra_trees and
    feature_fraction_bynode from the JAX package's threefry draws, given to
    the port as its (2L - 1, 2, F) table of node uniforms."""
    from test_torch_constraints import jax_table

    import jax

    fx = _fixture(29)
    key = jax.random.PRNGKey(5)
    p = dict(_P, extra_trees=True, feature_fraction_bynode=0.7)
    want = _jax(fx, False, params=p, **{opt: key}, **_kw(15, 4, 0))
    got = _port(fx, params=p, **{opt: torch.from_numpy(jax_table(key, 15, 8))},
                **_kw(15, 4, 0))
    _assert_same_tree(got, want, fx)


def test_megakernel_mode():
    assert twin.megakernel_mode(True) == (True, None)  # auto on the card
    assert twin.megakernel_mode(False) == (False, None)  # auto on the CPU
    assert twin.megakernel_mode(False, mode="1") == (True, None)
    assert twin.megakernel_mode(True, mode="0") == (False, None)
    assert twin.megakernel_mode(True, quantize_bins=16) == (False, "quantized")
    assert twin.megakernel_mode(False, quantize_bins=16, mode="1") == (True, None)
    assert twin.megakernel_mode(True, efb=True) == (False, "efb")
    assert twin.megakernel_mode(False, efb=True, mode="1") == (False, "efb")
    assert twin.megakernel_mode(False, efb=True) == (False, None)  # not asked for
    assert twin.megakernel_mode(True, node_rng=True) == (False, "node_rng")
    with pytest.raises(ValueError):
        twin.megakernel_mode(True, mode="interpret")


def test_booster_gate():
    """GBDT._use_windowed: the card, windowed_growth=true, >= 512 features
    and >= 64 leaves (the JAX package's gate with "on the accelerator"
    read as "training on the card")."""
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.models.gbdt import GBDT

    rng = np.random.RandomState(0)
    X = rng.randn(200, 512)
    y = (X[:, 0] > 0).astype(float)
    base = {"objective": "binary", "device_type": "cpu", "verbosity": -1,
            "num_leaves": 64}

    def gate(extra, device="cuda"):
        p = {**base, **extra}
        g = GBDT(Config.from_dict(p))
        ds = tlgb.Dataset(X, label=y, params=p)
        ds.construct()
        g.device = torch.device(device)
        return g._use_windowed(ds)

    assert gate({"windowed_growth": True})
    assert gate({"windowed_growth": "true"})
    assert not gate({"windowed_growth": "false"})
    assert not gate({})
    assert not gate({"windowed_growth": True, "num_leaves": 63})
    assert not gate({"windowed_growth": True}, device="cpu")
