"""parallel/launcher.py: train_distributed on gloo loopback ranks (2 worker
processes that import only lightgbm_tpu_torch) against the port's serial
training, the watchdog, the cache feed, and what stays for A13b.

Bar.  Each rank's Dataset holds its rows only (consecutive blocks, no
padding), bins on the serial run's sample of the whole
(basic.py::_sync_binning_sample), starts from the global init score and
merges exactly, so the ranks' models carry the serial model's trees bit for
bit (the model text differs only in its parameter record
[tree_learner: ...]); their metrics are evaluated over every rank's rows in
the serial order, so they are the serial values.  Every launch runs under a
wall limit below 90 s.
"""

import json
import os

import numpy as np
import pytest

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.io import stream as jstream
from lightgbm_tpu_torch.io import stream as tstream
from lightgbm_tpu_torch.parallel import launcher
from lightgbm_tpu_torch.parallel.launcher import WorkerFailure, train_distributed

CPU = {"device_type": "cpu", "verbosity": -1}
LIMIT_S = 80


def _data(n=3000, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8)
    X[rng.rand(n) < 0.05, 2] = np.nan
    y = ((X[:, 0] + X[:, 1] * X[:, 3] + 0.3 * rng.randn(n)) > 0).astype(float)
    return X, y


def _trees(text: str) -> str:
    return text[text.index("Tree=0"):text.index("end of trees")]


def _serial(p, X, y, rounds, **kw):
    return tlgb.train(p, tlgb.Dataset(X, label=y, params=p), rounds, **kw)


@pytest.mark.parametrize("extra", [
    # rounds grower; the bin sample is a part of the rows (the serial draw)
    {"tree_learner": "data", "tree_growth_mode": "rounds",
     "bin_construct_sample_cnt": 1000},
    # strict grower with bagging (each rank keeps its slice of the serial draw)
    {"tree_learner": "data", "tree_growth_mode": "strict", "bagging_fraction": 0.7,
     "bagging_freq": 1},
    # int8 on the rounds grower (global scales, the serial stochastic draws)
    {"tree_learner": "data", "tree_growth_mode": "rounds", "use_quantized_grad": True},
    # features sharded, rows replicated
    {"tree_learner": "feature", "tree_growth_mode": "strict"},
    # GOSS's selection and L1's leaf renewal over every rank's rows
    {"tree_learner": "data", "tree_growth_mode": "rounds", "objective": "regression_l1",
     "data_sample_strategy": "goss", "learning_rate": 0.5},
])
def test_train_distributed_is_the_serial_model(extra):
    X, y = _data()
    p = {**CPU, "objective": "binary", "num_leaves": 15, "min_data_in_leaf": 10,
         **extra}
    serial = _serial({**p, "tree_learner": "serial"}, X, y, 4)
    bst, paths = train_distributed(p, X, y, 4, num_machines=2, timeout_s=LIMIT_S)
    texts = [open(pth).read() for pth in paths]
    assert texts[0] == texts[1]
    assert _trees(texts[0]) == _trees(serial.model_to_string())
    assert f"[tree_learner: {p['tree_learner']}]" in texts[0]
    np.testing.assert_array_equal(bst.predict(X), serial.predict(X))
    meta = bst._distributed_meta
    st = meta["mesh_stats"]
    if p["tree_learner"] == "feature":
        assert st["merges"] == 0 and st["collectives"] > 0
    else:
        assert st["merges"] >= 4 and st["merge_bytes"] > 0
    assert [s["grower"] for s in meta["round_stats"]] == (
        ["strict" if p["tree_growth_mode"] == "strict" else "rounds"] * 4)
    for name in ("events", "metrics"):
        assert os.path.exists(getattr(bst, f"_fleet_{name}"))


def test_eval_sets_and_ranking_are_the_serial_ones():
    """LambdaRank with its queries kept whole on a rank, an eval set sharded
    the same way: the trees and every recorded NDCG are the serial ones,
    and early stopping stops where the serial run's does."""
    rng = np.random.RandomState(4)
    sizes = rng.randint(5, 30, 120)
    n = int(sizes.sum())
    X = rng.randn(n, 6)
    y = np.clip(np.round(X[:, 0] + X[:, 1] * X[:, 2] + 1.5), 0, 4)
    tr, ntr = sizes[:90], int(sizes[:90].sum())
    p = {**CPU, "objective": "lambdarank", "metric": "ndcg", "eval_at": [3, 5],
         "num_leaves": 7, "min_data_in_leaf": 5, "tree_learner": "data"}
    train = tlgb.Dataset(X[:ntr], label=y[:ntr], group=tr, params=p)
    valid = tlgb.Dataset(X[ntr:], label=y[ntr:], group=sizes[90:], reference=train)
    rec = {}
    serial = tlgb.train({**p, "tree_learner": "serial"}, train, 12, valid_sets=[valid],
                        valid_names=["v"], callbacks=[tlgb.record_evaluation(rec),
                                                      tlgb.early_stopping(3, verbose=False)])
    bst, paths = train_distributed(p, X[:ntr], y[:ntr], 12, num_machines=2, group=tr,
                                   eval_set=[(X[ntr:], y[ntr:])],
                                   eval_group=[sizes[90:]], eval_names=["v"],
                                   early_stopping_rounds=3, timeout_s=LIMIT_S)
    assert _trees(open(paths[0]).read()) == _trees(serial.model_to_string())
    assert bst.best_iteration == serial.best_iteration
    got = bst._distributed_evals_result["v"]
    for k in rec["v"]:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(rec["v"][k]), k)


def test_killed_worker_raises_worker_failure():
    """worker_death on rank 1 at iteration 2 (utils/faults.py): the launch
    fails with that rank and its exit code, every worker is gone."""
    X, y = _data(n=800)
    p = {**CPU, "objective": "binary", "num_leaves": 7, "tree_learner": "data"}
    with pytest.raises(WorkerFailure, match="rank 1 died with exit code 113") as ei:
        train_distributed(p, X, y, 5, num_machines=2, timeout_s=LIMIT_S,
                          env_extra={"LGBMTPU_FAULT": "worker_death:1:2"})
    assert ei.value.rank == 1 and not ei.value.timed_out


def test_cache_feed_reads_each_ranks_rows(tmp_path):
    """data_cache=: each rank reads rows [lo, hi) of one save_binary cache
    (bin_cache_shard); the model is the serial one trained from the cache.
    read_cache_shard and cache_shard_fingerprint agree with the JAX
    package's on that cache."""
    X, y = _data(n=2000, seed=3)
    p = {**CPU, "objective": "binary", "num_leaves": 15, "tree_learner": "data",
         "tree_growth_mode": "rounds"}
    path = str(tmp_path / "train.bin")
    tlgb.Dataset(X, label=y, params=p).construct().save_binary(path)
    serial = tlgb.train({**p, "tree_learner": "serial"}, tlgb.Dataset(path, params=p), 3)
    bst, paths = train_distributed(p, None, None, 3, num_machines=2, data_cache=path,
                                   timeout_s=LIMIT_S)
    assert _trees(open(paths[1]).read()) == _trees(serial.model_to_string())
    np.testing.assert_array_equal(tstream.read_cache_shard(path, 300, 1700),
                                  jstream.read_cache_shard(path, 300, 1700))
    fp = tstream.cache_shard_fingerprint(path, 0, 1000)
    assert fp and fp == jstream.cache_shard_fingerprint(path, 0, 1000)
    assert fp != tstream.cache_shard_fingerprint(path, 1000, 2000)
    part = tlgb.Dataset(path, params={**p, "bin_cache_shard": (500, 900)}).construct()
    assert part.num_data() == 400
    np.testing.assert_array_equal(part.get_label(), y[500:900])


def test_shard_plan_keeps_queries_whole():
    group = np.array([5, 7, 3, 9, 4, 6, 2])
    slices, groups = launcher._shard_plan(int(group.sum()), 3, group)
    assert slices[0][0] == 0 and slices[-1][1] == group.sum()
    bounds = set(np.concatenate([[0], np.cumsum(group)]).tolist())
    for (lo, hi), g in zip(slices, groups):
        assert lo in bounds and hi in bounds and int(g.sum()) == hi - lo
    slices, groups = launcher._shard_plan(10, 3, None)
    assert slices == [(0, 4), (4, 8), (8, 10)] and groups == [None] * 3


@pytest.mark.parametrize("kw", [{"max_restarts": 1}, {"num_slices": 2},
                                {"params": {"snapshot_freq": 1}}])
def test_recovery_stays_for_a13b(kw):
    """The launcher's recovery is ported (ROADMAP A13b; the fault cases in
    tests/test_torch_recovery.py): max_restarts relaunches a fleet whose
    rank died (from scratch without snapshots), num_slices runs slice
    worlds (one rank each here: the serial model), snapshot_freq keeps
    fleet-valid manifests; each ends with the serial model's trees."""
    from lightgbm_tpu_torch.obs import metrics as obs
    from lightgbm_tpu_torch.utils import checkpoint as ckpt

    X, y = _data(n=600)
    p = {**CPU, "objective": "binary", "num_leaves": 7, "tree_learner": "data",
         **kw.pop("params", {})}
    serial = _serial({k: v for k, v in p.items() if k != "snapshot_freq"}, X, y, 3)
    env = {"LGBMTPU_FAULT": "worker_death:1:2"} if kw.get("max_restarts") else None
    try:
        bst, paths = train_distributed(p, X, y, 3, num_machines=2, timeout_s=LIMIT_S,
                                       restart_backoff_s=0.1, env_extra=env, **kw)
    finally:
        obs.unregister_collector("fleet_live")
    texts = [open(pth).read() for pth in paths]
    assert texts[0] == texts[1] and _trees(texts[0]) == _trees(serial.model_to_string())
    kinds = [json.loads(line)["kind"] for line in open(bst._fleet_events)]
    assert kinds.count("fleet_relaunch") == (1 if env else 0)
    if "snapshot_freq" in p:
        found = ckpt.latest_valid_fleet_manifest(launcher._LAST_LAUNCH_DIR, 2)
        assert found is not None and found[0] == 3
