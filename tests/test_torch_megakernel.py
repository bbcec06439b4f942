"""The round megakernel's plain version (lightgbm_tpu_torch/ops/round_cuda.py)
against the port's three-pass round and the JAX package's megakernel.

Tolerances.  On the CPU the megakernel's plain version and the three-pass
round do the same arithmetic (same fixed-point window histograms, same
subtraction, same gain planes), and the per-feature-then-cross-feature
selection picks the same first maximum as the flat argmax, so trees are
pinned bitwise.  Against the JAX megakernel (interpret mode) the split
search sums in f32 where the port's prefix sums are float64 rounded to f32,
and histograms are f32 scatter sums against the port's fixed point: trees
agree node for node (thresholds up to exact ties, see
tests/test_torch_windowed.py), values within 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas
from jax.experimental.pallas import tpu as pltpu

from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu.ops import treegrow_windowed as jwin
from lightgbm_tpu.ops.split import SplitParams as JParams
from lightgbm_tpu.utils import degrade
from lightgbm_tpu_torch.ops import round_cuda
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops import treegrow_windowed as twin
from lightgbm_tpu_torch.ops.split import SplitParams as TParams

from test_torch_windowed import NUM_BINS, _assert_same_tree, _fixture, _kw, _port


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _assert_bitwise(a, b):
    (ta, la), (tb, lb) = a, b
    for name in ta._fields:
        x = getattr(ta, name)
        if x is not None:
            np.testing.assert_array_equal(getattr(tb, name), x, err_msg=name)
    np.testing.assert_array_equal(lb, la)


@pytest.mark.parametrize("masked,params", [
    (False, dict(min_data_in_leaf=20, lambda_l2=1.0)),
    (True, dict(min_data_in_leaf=20, lambda_l2=1.0)),
    (False, dict(min_data_in_leaf=10, lambda_l1=0.5, max_delta_step=4.0,
                 min_gain_to_split=0.01, min_sum_hessian_in_leaf=2.0)),
    (True, dict(min_data_in_leaf=10, lambda_l2=0.3, path_smooth=5.0)),
])
def test_megakernel_plain_bitwise_three_pass(masked, params):
    fx = _fixture(31, masked=masked)
    kw = _kw(31, 8, 0)
    round_cuda.reset_counts()
    st = {}
    mk = _port(fx, params=params, megakernel_opt="1", stats=st, **kw)
    assert st["megakernel"] is True
    assert round_cuda.plain_calls["round_megakernel"] == st["rounds"]
    three = _port(fx, params=params, megakernel_opt="0", **kw)
    assert int(three[0].num_leaves) > 8
    _assert_bitwise(three, mk)


def test_megakernel_plain_matches_jax_megakernel_interpret(monkeypatch):
    """The JAX megakernel round (Pallas interpret mode; its on-core split
    search is ops/split.py's gain_plane + reduce_plane_per_feature) against
    the port's megakernel plain version."""
    call = pallas.pallas_call
    monkeypatch.setattr(pallas, "pallas_call",
                        lambda *a, **k: call(*a, **{**k, "interpret": True}))
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)
    degrade.reset()
    fx = _fixture(37, n=1500, f=6)
    kw = _kw(10, 4, 0)
    bins, *rest = fx
    jt, jl = jwin.grow_tree_windowed(
        jnp.asarray(bins.T), *map(jnp.asarray, rest), use_pallas=False,
        megakernel_opt="interpret", params=JParams(min_data_in_leaf=20, lambda_l2=1.0),
        **kw)
    want = ({k: (None if v is None else np.asarray(v))
             for k, v in jt._asdict().items()}, np.asarray(jl))
    degrade.reset()
    _assert_same_tree(_port(fx, megakernel_opt="1", **kw), want, fx)


def _planes(seed, c=4, f=12, b=32, dup=False):
    r = np.random.RandomState(seed)
    hist = np.abs(r.randn(c, 3, f, b)).astype(np.float32)
    hist[:, 0] = r.randn(c, f, b)
    hist[:, 2] = np.round(hist[:, 2] * 20)
    if dup:  # duplicated columns -> exact cross-feature ties
        hist[:, :, 1] = hist[:, :, 0]
        hist[:, :, 7] = hist[:, :, 0]
    nbpf = np.full(f, b, np.int32)
    nbpf[5] = b // 2
    mbpf = np.full(f, b - 1, np.int32)
    mbpf[::3] = -1
    return hist, nbpf, mbpf


@pytest.mark.parametrize("seed,dup", [(0, False), (1, True), (2, True), (3, False)])
def test_per_feature_selection_is_the_flat_selection(seed, dup):
    """reduce_plane_per_feature + select_from_feature_best == select_from_plane,
    bitwise, including exact ties across duplicated columns and candidates
    with no valid split (tests/test_megakernel.py:138, :184)."""
    hist, nbpf, mbpf = _planes(seed, dup=dup)
    h = torch.from_numpy(hist)
    pg, ph, pc = (h[:, i].sum((1, 2)) / 3 for i in range(3))
    params = TParams(min_data_in_leaf=5, path_smooth=1.0 if seed % 2 else 0.0)
    fmask = torch.ones(hist.shape[2], dtype=torch.bool)
    fmask[3] = False
    po = torch.linspace(-0.2, 0.2, hist.shape[0])
    gain, ctx = tsplit.gain_plane(h, pg, ph, pc, torch.from_numpy(nbpf),
                                  torch.from_numpy(mbpf), params,
                                  feature_mask=fmask, parent_output=po)
    gain[-1] = tsplit.KMIN_SCORE  # a candidate with nothing to split
    want = tsplit.select_from_plane(gain, ctx)
    fb = tsplit.reduce_plane_per_feature(gain, ctx)
    got = tsplit.select_from_feature_best(fb, pg, ph, pc, hist.shape[3])
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    # feature-block separable: slices of the plane reduce to slices
    for lo, hi in ((0, 5), (5, 12)):
        g2, c2 = tsplit.gain_plane(h[:, :, lo:hi], pg, ph, pc,
                                   torch.from_numpy(nbpf[lo:hi]),
                                   torch.from_numpy(mbpf[lo:hi]), params,
                                   feature_mask=fmask[lo:hi], parent_output=po)
        part = tsplit.reduce_plane_per_feature(g2, c2)
        full = tsplit.reduce_plane_per_feature(*tsplit.gain_plane(
            h, pg, ph, pc, torch.from_numpy(nbpf), torch.from_numpy(mbpf), params,
            feature_mask=fmask, parent_output=po))
        for name in part._fields:
            assert torch.equal(getattr(part, name), getattr(full, name)[:, lo:hi]), name


@pytest.mark.parametrize("seed", [4, 5])
def test_per_feature_reduction_matches_jax(seed):
    """Per feature against the JAX package's reduce_plane_per_feature on the
    same planes: thresholds equal, gains and left sums within 1e-5 relative
    (f32 cumsum there, float64 prefix sums rounded to f32 here)."""
    hist, nbpf, mbpf = _planes(seed)
    params = dict(min_data_in_leaf=5)
    for c in range(hist.shape[0]):
        hj = jnp.asarray(hist[c])
        pg, ph, pc = (jnp.float32(float(hist[c, i].sum()) / 3) for i in range(3))
        g, ctx = jsplit.gain_plane(hj, pg, ph, pc, jnp.asarray(nbpf),
                                   jnp.asarray(mbpf), JParams(**params))
        want = jsplit.reduce_plane_per_feature(g, ctx)
        tg, tctx = tsplit.gain_plane(
            torch.from_numpy(hist[c:c + 1]), torch.tensor([float(pg)]),
            torch.tensor([float(ph)]), torch.tensor([float(pc)]),
            torch.from_numpy(nbpf), torch.from_numpy(mbpf), TParams(**params))
        got = tsplit.reduce_plane_per_feature(tg, tctx)
        np.testing.assert_array_equal(got.threshold_bin[0].numpy(),
                                      np.asarray(want.threshold_bin))
        np.testing.assert_array_equal(got.use_left[0].numpy(), np.asarray(want.use_left))
        for name in ("gain", "left_g", "left_h", "left_c"):
            w = np.asarray(getattr(want, name))
            np.testing.assert_allclose(getattr(got, name)[0].numpy(), w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_round_plain_on_a_ragged_round():
    """One round's plain version on hand-made geometry: an empty segment,
    an all-left segment, windows of zero rows; left/right are the window
    histograms and their siblings, new_order the stable partition."""
    rng = np.random.RandomState(8)
    n, f, b, T = 997, 5, NUM_BINS, 4
    bins = torch.from_numpy(rng.randint(0, b, (n, f)).astype(np.int16))
    order = torch.from_numpy(rng.permutation(n).astype(np.int32))
    go = torch.from_numpy(rng.rand(n) < 0.3)
    go[500:600] = True
    seg_start = torch.tensor([0, 500, 700, 700], dtype=torch.int32)
    seg_len = torch.tensor([400, 100, 0, 297], dtype=torch.int32)
    n_left = torch.tensor([int(go[:400].sum()), 100, 0, int(go[700:].sum())],
                          dtype=torch.int32)
    small_left = (2 * n_left <= seg_len).to(torch.int32)
    win_start = torch.where(small_left > 0, seg_start, seg_start + n_left)
    win_cnt = torch.where(small_left > 0, n_left, seg_len - n_left)
    grad = torch.from_numpy(rng.randn(n).astype(np.float32))
    hess = torch.from_numpy(rng.rand(n).astype(np.float32))
    mask = torch.from_numpy(rng.rand(n) < 0.9)
    parent = torch.from_numpy(np.abs(rng.randn(T, 3, f, b)).astype(np.float32))
    cand = torch.from_numpy(np.abs(rng.randn(4, 2 * T)).astype(np.float32) * 50)
    nbpf = torch.full((f,), b, dtype=torch.int32)
    mbpf = torch.full((f,), -1, dtype=torch.int32)
    fmask = torch.ones(f, dtype=torch.bool)
    shift = (40, 40)
    out = round_cuda.round_megakernel(
        bins, order, go, grad, hess, mask, seg_start, seg_len, n_left, win_start,
        win_cnt, small_left, parent, cand, nbpf, mbpf, fmask,
        params=TParams(min_data_in_leaf=1), W=512, shift=shift)
    new_order, left, right, fb = out
    # partition: each segment's go-left rows first, stably
    for s in range(T):
        lo, ln = int(seg_start[s]), int(seg_len[s])
        seg = order[lo:lo + ln]
        want = torch.cat([seg[go[lo:lo + ln]], seg[~go[lo:lo + ln]]])
        assert torch.equal(new_order[lo:lo + ln], want)
    assert torch.equal(new_order[400:500], order[400:500])  # untouched
    from lightgbm_tpu_torch.ops import hist_cuda

    for s in range(T):
        rows = new_order[int(win_start[s]):int(win_start[s] + win_cnt[s])].long()
        fresh = hist_cuda.histogram_multi_plain(
            bins[rows], grad[rows], hess[rows], mask[rows],
            torch.zeros(len(rows), dtype=torch.int32), 0, 1, b, shift=shift)[0]
        small, big = (left, right) if small_left[s] else (right, left)
        assert torch.equal(small[s], fresh)
        assert torch.equal(big[s], parent[s] - fresh)
    assert fb.gain.shape == (2 * T, f) and bool((fb.variant == -1).all())


def test_round_wrapper_checks_inputs():
    n, f, b, T = 10, 2, 4, 2
    i32 = torch.int32
    tv = [torch.zeros(T, dtype=i32) for _ in range(6)]
    good = dict(bins=torch.zeros((n, f), dtype=torch.int16),
                order=torch.zeros(n, dtype=i32), go_left=torch.zeros(n, dtype=torch.bool),
                grad=torch.zeros(n), hess=torch.zeros(n),
                row_mask=torch.zeros(n, dtype=torch.bool), tvecs=tv,
                parent=torch.zeros((T, 3, f, b)), cand_tab=torch.zeros((4, 2 * T)),
                nbpf=torch.zeros(f, dtype=i32), mbpf=torch.zeros(f, dtype=i32),
                fmask=torch.zeros(f, dtype=torch.bool))
    round_cuda._check(**good)
    for key, bad in (("order", torch.zeros(n, dtype=torch.int64)),
                     ("cand_tab", torch.zeros((4, T))),
                     ("bins", torch.zeros((n, f), dtype=torch.int32)),
                     ("tvecs", tv[:5] + [torch.zeros(T + 1, dtype=i32)])):
        with pytest.raises(TypeError):
            round_cuda._check(**{**good, key: bad})
    with pytest.raises(ValueError):
        round_cuda._check(**{**good, "parent": torch.zeros((T, 3, b, f)).transpose(2, 3)})


def test_window_rows_layout():
    order = torch.arange(100, dtype=torch.int32).flip(0)
    rows, slot, valid = round_cuda.window_rows(
        order, torch.tensor([10, 0, 50]), torch.tensor([3, 0, 2]), 8)
    assert valid.tolist() == [True] * 5 + [False] * 3
    assert rows[:5].tolist() == [89, 88, 87, 49, 48]
    assert slot[:5].tolist() == [0, 0, 0, 2, 2]


def test_quantized_megakernel_is_excluded_on_the_card_only():
    assert twin.megakernel_mode(True, quantize_bins=16, mode="1") == (False, "quantized")
    fx = _fixture(41)
    st = {}
    _port(fx, megakernel_opt="1", stats=st, **_kw(15, 4, 16))
    assert st["megakernel"] is True and st["megakernel_excluded"] is None
