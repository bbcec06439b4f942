"""The booster fleet of the port (models/fleet.py, ops/treegrow_fleet.py,
lgb.train_fleet) on the CPU, against the port's own solo windowed run and
the JAX package's fleet.

The port's pin: every lane of a 16-lane fleet is bitwise the port's solo
windowed run (lgb.train with tree_growth_mode=windowed and megakernel=0,
the three-pass windowed grower) of the same labels and weights, model text
and final scores, float and int8, graph (the CPU runs the rounds on the
static buffers) and eager.
Against the JAX package: the same tree structure (split features,
thresholds, children) and leaf values and predictions within 1e-5, on
values on a coarse grid so gains are well apart.  The lane modes' plain
versions are the solo plain versions looped over the lanes, bitwise.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import FleetError
from lightgbm_tpu_torch.convert import fleet_from_numpy
from lightgbm_tpu_torch.obs import metrics as obs
from lightgbm_tpu_torch.ops import hist_cuda, partition_cuda
from lightgbm_tpu_torch.ops.partition import segment_ids, stable_partition_ranges
from lightgbm_tpu_torch.ops.hist_cuda import window_rows

PARAMS = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
          "min_data_in_leaf": 5, "seed": 3}
CPU = {"device_type": "cpu"}
TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread, and a clean metrics registry (a counter another
    test left would turn /healthz unhealthy and the server would shed)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    obs.reset()
    yield
    obs.reset()
    torch.set_num_threads(prev)


def _data(b, n, f, seed=0):
    rng = np.random.RandomState(seed)
    X = np.round(rng.randn(n, f) * 8) / 8
    y = (X[None, :, 0] + X[None, :, 1] * rng.randn(b, 1)
         + 0.7 * rng.randn(b, n) > 0).astype(np.float64)
    return X, y


def _ds(X, y, **params):
    return tlgb.Dataset(X, label=y, params={**CPU, "verbosity": -1, **params})


def _fleet(params, X, labels, num_boost_round, **kw):
    return tlgb.train_fleet({**params, **CPU}, _ds(X, labels[0]), labels,
                            num_boost_round=num_boost_round, **kw)


def _solo(params, X, label, rounds, weight=None):
    """The port's solo windowed run: train() on the three-pass windowed
    grower."""
    p = {**params, **CPU, "tree_growth_mode": "windowed", "megakernel": "0"}
    return tlgb.train(p, tlgb.Dataset(X, label=label, weight=weight,
                                      params={**CPU, "verbosity": -1}), rounds)


def _assert_lane_is_solo(fb, lane, X, labels, params, rounds, weight=None):
    solo = _solo(params, X, labels[lane], rounds, weight=weight)
    assert fb.booster(lane).model_to_string() == solo.model_to_string(), lane
    assert torch.equal(fb._score[lane], solo._gbdt._score), lane


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("fused", [True, False], ids=["graph", "eager"])
def test_sixteen_lanes_are_bitwise_their_solo_runs(quant, fused):
    B, N, F, R = 16, 300, 6, 3 if not quant else 2
    params = dict(PARAMS, fused_training=fused)
    if quant:
        params.update(use_quantized_grad=True, num_grad_quant_bins=16)
    X, labels = _data(B, N, F)
    fb = _fleet(params, X, labels, R)
    # every round ran all lanes in one lane-mode launch of B1 and of B2
    assert all(s["rounds"] >= 1 for s in fb.round_stats)
    for lane in range(B):
        _assert_lane_is_solo(fb, lane, X, labels, params, R)


def test_weighted_lanes_are_bitwise_their_solo_runs_and_weights_flow():
    B, N, F, R = 4, 250, 5, 2
    X, labels = _data(B, N, F, seed=11)
    w = 0.25 + np.random.RandomState(12).rand(B, N)
    w[2:, np.random.RandomState(13).rand(N) < 0.2] = 0.0  # one tenant's rows
    fb = _fleet(PARAMS, X, labels, R, weights=w)
    for lane in range(B):
        _assert_lane_is_solo(fb, lane, X, labels, PARAMS, R, weight=w[lane])
    unw = _fleet(PARAMS, X, labels[:1], R)
    assert not np.array_equal(fb.booster(0).predict(X, raw_score=True),
                              unw.booster(0).predict(X, raw_score=True))


def test_per_lane_rounds_stop_early_and_match_solo_runs_of_that_length():
    B, N, F = 4, 250, 5
    rounds = [1, 4, 2, 4]
    X, labels = _data(B, N, F, seed=21)
    fb = _fleet(PARAMS, X, labels, 4, rounds=rounds)
    assert list(fb.num_iterations) == rounds
    for lane in range(B):
        assert fb.booster(lane).num_trees() == rounds[lane]
        solo = _solo(PARAMS, X, labels[lane], rounds[lane])
        assert fb.booster(lane).model_to_string() == solo.model_to_string()
    # a finished lane rides as a no-op lane: its score stops moving
    assert torch.equal(fb._score[0], _solo(PARAMS, X, labels[0], 1)._gbdt._score)


def _trees(text):
    return text.split("\nTree=", 1)[1].split("end of trees")[0]


def test_lane_boosters_predict_save_round_trip_and_serve(tmp_path):
    B, N, F, R = 3, 300, 6, 3
    X, labels = _data(B, N, F, seed=31)
    fb = _fleet(PARAMS, X, labels, R)
    Q = np.round(np.random.RandomState(32).randn(80, F) * 8) / 8
    for lane in range(B):
        bst = fb.booster(lane)
        got = bst.predict(Q, raw_score=True)
        assert got.shape == (80,)
        text = bst.model_to_string()
        again = tlgb.Booster(model_str=text, params=CPU)
        np.testing.assert_array_equal(again.predict(Q, raw_score=True), got)
        path = tmp_path / f"lane{lane}.txt"
        bst.save_model(str(path))
        loaded = tlgb.Booster(model_file=str(path), params=CPU)
        np.testing.assert_array_equal(loaded.predict(Q, raw_score=True), got)
        assert _trees(loaded.model_to_string()) == _trees(text)
        with pytest.raises(FleetError):
            bst._gbdt.train_one_iter()
    rt = tlgb.serve(fb.booster(1), {**CPU, "serve_max_wait_ms": 2})
    try:
        np.testing.assert_array_equal(rt.predict(Q[:20], timeout=60),
                                      fb.booster(1).predict(Q[:20]))
    finally:
        rt.stop()


def test_envelope_and_shape_refusals():
    B, N, F = 2, 120, 4
    X, labels = _data(B, N, F, seed=41)

    def fleet(params, **kw):
        return _fleet(params, X, labels, 2, **kw)

    with pytest.raises(FleetError, match="multiclass"):
        fleet({"objective": "multiclass", "num_class": 3, "verbosity": -1})
    with pytest.raises(FleetError, match="GOSS"):
        fleet(dict(PARAMS, data_sample_strategy="goss"))
    with pytest.raises(FleetError, match="monotone"):
        fleet(dict(PARAMS, monotone_constraints=[1, 0, 0, 0]))
    with pytest.raises(FleetError, match="feature sampling"):
        fleet(dict(PARAMS, feature_fraction=0.5))
    with pytest.raises(FleetError, match="fleet_size"):
        fleet(dict(PARAMS, fleet_size=B + 1))
    with pytest.raises(FleetError, match="labels must be"):
        tlgb.train_fleet({**PARAMS, **CPU}, _ds(X, labels[0]), labels[0])
    with pytest.raises(FleetError, match="weights must match"):
        fleet(dict(PARAMS), weights=np.ones((B + 1, N)))
    with pytest.raises(FleetError, match="rounds must be"):
        fleet(dict(PARAMS), rounds=[1])
    assert fleet(dict(PARAMS, fleet_size=B)).fleet_size == B  # a matching guard passes


def test_windowed_growth_mode_takes_the_windowed_grower_within_its_envelope():
    """tree_growth_mode=windowed (the solo run a lane reproduces) grows on
    the windowed grower at any width, and raises outside its envelope."""
    X, labels = _data(1, 200, 4, seed=71)
    bst = _solo(PARAMS, X, labels[0], 2)
    assert [s["grower"] for s in bst._gbdt.round_stats] == ["windowed", "windowed"]
    with pytest.raises(ValueError, match="rounds grower"):
        _solo(dict(PARAMS, monotone_constraints=[1, 0, 0, 0]), X, labels[0], 1)
    with pytest.raises(ValueError, match="auto/strict/rounds/windowed"):
        tlgb.train({**PARAMS, **CPU, "tree_growth_mode": "window"}, _ds(X, labels[0]), 1)


def test_train_fleet_refuses_without_a_card_unless_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    X, labels = _data(2, 100, 4)
    with pytest.raises(RuntimeError, match="device_type"):
        tlgb.train_fleet(dict(PARAMS), tlgb.Dataset(X, label=labels[0]), labels,
                         num_boost_round=1)


def test_lane_plain_versions_are_the_solo_plain_versions_looped():
    rng = np.random.RandomState(5)
    L, n, f, b, w, T = 4, 700, 6, 31, 260, 5
    bins = torch.as_tensor(rng.randint(0, b, (n, f)), dtype=torch.int16)
    grad = torch.as_tensor(rng.randn(L, n) * 3, dtype=torch.float32)
    hess = torch.as_tensor(rng.rand(L, n), dtype=torch.float32)
    mask = torch.as_tensor(rng.rand(L, n) < 0.8)
    shift = torch.stack([hist_cuda.fixed_shift_tensor(grad[l], hess[l]) for l in range(L)])
    orders, win_start, win_cnt = [], [], []
    for l in range(L):
        orders.append(torch.as_tensor(rng.permutation(n), dtype=torch.int32))
        cut = np.sort(rng.choice(n, 2 * T, replace=False))
        win_start.append(torch.as_tensor(cut[0::2], dtype=torch.int32))
        win_cnt.append(torch.as_tensor(np.minimum(cut[1::2] - cut[0::2], 60),
                                       dtype=torch.int32))
    rows, slots = [], []
    for l in range(L):
        r, s, valid = window_rows(orders[l], win_start[l], win_cnt[l], w)
        rows.append(r.to(torch.int32))
        slots.append(torch.where(valid, s, -1))
    rows, slots = torch.stack(rows), torch.stack(slots)
    for prec in ("f32", "bf16"):
        lanes = hist_cuda.histogram_multi_lanes(bins, grad, hess, mask, rows, slots,
                                                shift, T, b, precision=prec)
        for l in range(L):
            solo = hist_cuda.histogram_window_plain(bins, grad[l], hess[l], mask[l],
                                                    orders[l], win_start[l], win_cnt[l],
                                                    T, b, W=w, shift=shift[l],
                                                    precision=prec)
            assert torch.equal(lanes[l], solo)
    gq = torch.as_tensor(rng.randint(-8, 9, (L, n)), dtype=torch.int8)
    hq = torch.as_tensor(rng.randint(0, 9, (L, n)), dtype=torch.int8)
    lanes = hist_cuda.histogram_multi_quantized_lanes(bins, gq, hq, mask, rows, slots, T, b)
    for l in range(L):
        solo = hist_cuda.histogram_window_quantized_plain(bins, gq[l], hq[l], mask[l],
                                                          orders[l], win_start[l],
                                                          win_cnt[l], T, b, W=w)
        assert torch.equal(lanes[l], solo)
    # B2: every lane's partition equals the solo partition of that lane
    order = torch.stack(orders)
    go = torch.as_tensor(rng.rand(L, n) < 0.5)
    seg_len = torch.stack(win_cnt)
    got, n_left = partition_cuda.partition_segments_lanes(order, torch.stack(win_start),
                                                          seg_len, go)
    for l in range(L):
        want = stable_partition_ranges(order[l], segment_ids(win_start[l], seg_len[l], n),
                                       win_start[l], seg_len[l], go[l])
        assert torch.equal(got[l], want[0]) and torch.equal(n_left[l], want[1])


def _jax_fleet(params, X, labels, num_boost_round, **kw):
    ds = jlgb.Dataset(X, label=labels[0], params={"verbosity": -1})
    return jlgb.train_fleet(dict(params), ds, labels, num_boost_round=num_boost_round,
                            **kw)


def _same_structure(jt, tt):
    assert len(jt) == len(tt)
    for a, b in zip(jt, tt):
        assert a.num_leaves == b.num_leaves
        m = a.num_leaves - 1
        for f in ("split_feature", "threshold", "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(b, f)[:m], getattr(a, f)[:m], err_msg=f)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=TOL, atol=TOL)


def test_port_lanes_agree_with_jax_fleet_lanes():
    B, N, F, R = 4, 300, 6, 3
    X, labels = _data(B, N, F, seed=51)
    w = 0.5 + np.random.RandomState(52).rand(B, N)
    jf = _jax_fleet(PARAMS, X, labels, R, weights=w, rounds=[3, 2, 3, 1])
    tf = _fleet(PARAMS, X, labels, R, weights=w, rounds=[3, 2, 3, 1])
    for lane in range(B):
        jb, tb = jf.booster(lane), tf.booster(lane)
        _same_structure(jb._gbdt.models, tb._gbdt.models)
        np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=TOL, atol=TOL)


def test_a_jax_fleet_carried_into_the_port_predicts_the_same():
    B, N, F, R = 3, 300, 6, 3
    X, labels = _data(B, N, F, seed=61)
    jf = _jax_fleet(PARAMS, X, labels, R)
    iters = [{k: np.asarray(v) for k, v in jf._host_iter(i)._asdict().items()
              if v is not None} for i in range(R)]
    tf = fleet_from_numpy(iters, _ds(X, labels[0]), {**PARAMS, **CPU},
                          init_scores=jf.init_scores,
                          shrinkages=[s for _, s in jf._iters])
    for lane in range(B):
        np.testing.assert_allclose(tf.booster(lane).predict(X, raw_score=True),
                                   jf.booster(lane).predict(X, raw_score=True),
                                   rtol=TOL, atol=TOL)
        _same_structure(jf.booster(lane)._gbdt.models, tf.booster(lane)._gbdt.models)
