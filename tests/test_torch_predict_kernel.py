"""The traversal kernel's wrapper on the CPU (ops/predict_cuda.py): the
checks it makes before a launch, the plain route a CPU tensor takes (the
launch count unchanged), the node table against every field of the stacked
ensemble it packs, numerical and categorical, and the traced probe's
counts as the kernel restates them.  The kernel itself runs on the card
only: tests/test_torch_gpu.py holds it bitwise to the plain walk and sum.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.models import gbdt as gm
from lightgbm_tpu_torch.ops import predict as tpredict
from lightgbm_tpu_torch.ops import predict_cuda as pc

CPU = {"device_type": "cpu", "verbosity": -1}


def _booster(categorical: bool, k: int = 1):
    rng = np.random.RandomState(11)
    X = rng.randn(3000, 5)
    if categorical:
        X[:, 0] = rng.randint(0, 70, 3000)
        X[rng.rand(3000) < 0.1, 0] = np.nan
    X[rng.rand(3000, 5) < 0.05] = np.nan
    s = np.nan_to_num(X[:, 1]) + (np.nan_to_num(X[:, 0]) % 3 == 1)
    p = {**CPU, "num_leaves": 15, "min_data_in_leaf": 5}
    if k > 1:
        p.update(objective="multiclass", num_class=k)
        y = np.digitize(s, [0.0, 1.0])
    else:
        p["objective"] = "binary"
        y = (s > 0.5).astype(float)
    ds = tlgb.Dataset(X, label=y, params=p,
                      categorical_feature=[0] if categorical else "auto")
    return tlgb.train(p, ds, 6), X.astype(np.float32)


@pytest.fixture(scope="module")
def numerical():
    return _booster(False)


def _walk(bst):
    return bst._gbdt._packed(0, -1)["walk"]


@pytest.mark.parametrize("categorical", [False, True])
def test_node_table_round_trips_every_field(categorical):
    bst, _ = _booster(categorical)
    w = _walk(bst)
    t, m = w["split_feature"].shape
    words = w["nodes"].numpy()
    rec = words[:t * m * pc.RECORD_WORDS].reshape(t, m, pc.RECORD_WORDS)
    meta = rec[..., 0].astype(np.int64) & 0xFFFFFFFF
    assert np.array_equal(meta & ((1 << pc.FEATURE_BITS) - 1), w["split_feature"].numpy())
    assert np.array_equal((meta >> pc.MISS_SHIFT) & 3, w["missing_type"].numpy())
    assert np.array_equal(((meta >> pc.DEFAULT_LEFT_BIT) & 1).astype(bool),
                          w["default_left"].numpy())
    assert np.array_equal(rec[..., 2], w["left_child"].numpy())
    assert np.array_equal(rec[..., 3], w["right_child"].numpy())
    is_cat = ((meta >> pc.CAT_BIT) & 1).astype(bool)
    thr = w["threshold"].numpy()
    assert np.array_equal(rec[..., 1][~is_cat], thr[~is_cat].view(np.int32))
    assert (w["cat"] is not None) == categorical
    assert w["features"] == max(int(tr.split_feature.max()) + 1
                                for tr in bst._gbdt.models if tr.num_internal)
    if not categorical:
        assert not is_cat.any() and words.size == t * m * pc.RECORD_WORDS
        return
    flag, base, nwords, flat = (a.numpy() for a in w["cat"])
    assert np.array_equal(is_cat, flag) and is_cat.any()
    for ti, j in zip(*np.nonzero(is_cat)):
        off = rec[ti, j, 1]
        assert words[off] == nwords[ti, j]
        got = words[off + 1:off + 1 + nwords[ti, j]].view(np.uint32)
        want = flat[base[ti, j]:base[ti, j] + nwords[ti, j]].astype(np.uint32)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("k", [1, 3])
def test_a_cpu_tensor_takes_the_plain_route(k):
    bst, X = _booster(False, k)
    w = _walk(bst)
    x = torch.as_tensor(X[:257])
    pc.reset_counts()
    got = pc.predict_trees(x, w, k)
    assert pc.launches == {"predict_trees": 0} and pc.plain_calls == {"predict_trees": 1}
    want = tpredict.leaf_sum(tpredict.leaf_index(x, **tpredict.walk_args(w)),
                             w["leaf_value"], k)
    assert torch.equal(got, want)
    # the window mode: every window from zeros is the whole prediction
    t = w["num_leaves"].shape[0]
    base = torch.zeros_like(want)
    active = torch.ones(x.shape[0], dtype=torch.bool)
    for lo in range(0, t, 2 * k):
        base = pc.predict_trees(x, w, k, tree_lo=lo, window=min(2 * k, t - lo),
                                base=base, active=active)
    assert torch.equal(base, want) and pc.launches == {"predict_trees": 0}


def test_the_wrapper_refuses_what_the_kernel_does_not_take(numerical):
    bst, X = numerical
    w = _walk(bst)
    x = torch.as_tensor(X[:64])
    n, t = x.shape[0], w["num_leaves"].shape[0]
    pc._check(x, w, 1, 0, t, None, None, None)  # the good call passes
    bad = [
        (TypeError, dict(x=x.double())),
        (TypeError, dict(x=x[0])),
        (ValueError, dict(x=x[:, :w["features"] - 1])),
        (ValueError, dict(x=x.t().contiguous().t())),
        (TypeError, dict(walk={**w, "nodes": w["nodes"].long()})),
        (TypeError, dict(walk={**w, "leaf_value": w["leaf_value"].double()})),
        (ValueError, dict(walk={**w, "nodes": w["nodes"].to("meta")})),
        (ValueError, dict(walk={**w, "leaf_value": w["leaf_value"].t().contiguous().t()})),
        (TypeError, dict(base=torch.zeros(n + 1))),
        (TypeError, dict(base=torch.zeros(n, dtype=torch.float64))),
        (TypeError, dict(active=torch.ones(n))),
        (TypeError, dict(counts=torch.zeros(2, dtype=torch.int32))),
        (ValueError, dict(counts=torch.zeros(2, dtype=torch.int64, device="meta"))),
        (ValueError, dict(k=0)),
        (ValueError, dict(k=4)),  # not whole iterations of 4 classes
        (ValueError, dict(tree_lo=-1, window=2)),
        (ValueError, dict(window=t + 1)),
    ]
    for err, change in bad:
        a = dict(x=x, walk=w, k=1, tree_lo=0, window=t, base=None, active=None,
                 counts=None)
        a.update(change)
        with pytest.raises(err):
            pc._check(**a)
    with pytest.raises(ValueError):  # the window mode's arguments go together
        pc.predict_trees(x, w, window=2)
    with pytest.raises(ValueError):
        pc.predict_trees(x, w, tree_lo=2)
    with pytest.raises(ValueError):  # the counts are the kernel's
        pc.predict_trees(x, w, counts=torch.zeros(2, dtype=torch.int64))


def test_node_table_refuses_features_past_its_field():
    one = np.ones((1, 1))
    with pytest.raises(ValueError):
        pc.node_table(np.full((1, 1), 1 << pc.FEATURE_BITS), one.astype(np.float32),
                      one.astype(bool), one.astype(np.int32), -one.astype(np.int32),
                      -one.astype(np.int32))


def test_cpu_predict_calls_no_kernel_wrapper(numerical):
    bst, X = numerical
    pc.reset_counts()
    raw = bst.predict(X, raw_score=True)
    assert pc.launches == {"predict_trees": 0} and pc.plain_calls == {"predict_trees": 0}
    es = bst.predict(X, raw_score=True, pred_early_stop=True, pred_early_stop_freq=2,
                     pred_early_stop_margin=1e9)
    # no row stops: every window's plain route, then the full prediction
    assert pc.plain_calls["predict_trees"] == bst._gbdt.early_stop_stats["chunks"] >= 2
    assert np.array_equal(es, raw)


@pytest.mark.parametrize("issued,useful", [(0, 0), (640, 512), (3200, 3199)])
def test_the_kernel_probe_reads_the_share_of_its_counts(issued, useful):
    probe = gm._WalkProbe(torch.device("cpu"), gm._PinnedBuffers())
    assert probe.counts.dtype == torch.int64 and probe.counts.tolist() == [0, 0]
    probe.counts += torch.tensor([issued, useful])
    probe.walked()
    probe.summed()
    probe.close()
    r = probe.readings()
    assert (r["walk_steps"], r["walk_useful_steps"]) == (issued, useful)
    assert r["walk_useful_share"] == (useful / issued if issued else 0.0)
    assert "walk_device_ms" not in r  # no device clock on the CPU
