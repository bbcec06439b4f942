"""Continual training in the port (continual/refit.py, continual/runtime.py,
lgb.continual_train) on the CPU, against the port's offline updates and
the JAX package's refit.

The port's pins: the device refit agrees with the host Booster.refit
within 1e-5 (binary, multiclass, weighted); fleet_refit_leaves in one
call is each lane's refit_leaves bit for bit; each rollover's model text
is bitwise the offline application of the same update to the same window;
a crash between a rollover's checkpoint and its publication leaves the
previous model serving and resumes from the manifest.  Against the JAX
package's refit_leaves: leaf values within 1e-6.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu.continual import refit_leaves as jax_refit_leaves
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.continual import (ContinualError, ContinualRunner,
                                          fleet_refit_leaves, refit_leaves)
from lightgbm_tpu_torch.obs import metrics as obs
from lightgbm_tpu_torch.obs import server as obs_server
from lightgbm_tpu_torch.obs import trace as trc
from lightgbm_tpu_torch.utils import faults as flt
from lightgbm_tpu_torch.utils import locktrace as lt

ROOT = Path(__file__).resolve().parents[1]
CPU = {"device_type": "cpu"}
P = {"objective": "binary", "num_leaves": 7, "learning_rate": 0.2,
     "verbosity": -1, **CPU}


@pytest.fixture(autouse=True)
def _fresh_state():
    """One torch thread; a clean registry (a counter another test left
    would turn /healthz unhealthy and the server would shed), trace and
    fault spec; the port's lock tracer strict, as the serving tests run."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    obs.reset()
    trc.reset_trace()
    os.environ.pop("LGBMTPU_FAULT", None)
    flt.reset()
    lt.reset()
    lt.enable(True, strict=True)
    yield
    lt.enable(False)
    flt.reset()
    obs_server.stop_server()
    obs.reset()
    trc.reset_trace()
    torch.set_num_threads(prev)


def _data(n=2000, f=6, seed=0, k=None):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    s = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.randn(n)
    y = (s > 0).astype(float) if k is None else np.digitize(s, [-0.5, 0.5]).astype(float)
    return X, y


def _model(params=P, n=2000, seed=0, rounds=5, k=None):
    X, y = _data(n, seed=seed, k=k)
    ds = tlgb.Dataset(X, label=y, params=params)
    return tlgb.train(params, ds, rounds), ds


def _clone(bst):
    c = tlgb.Booster(params=CPU, model_str=bst.model_to_string())
    c._gbdt.cfg = bst._gbdt.cfg
    return c


@pytest.mark.parametrize("kind", ["binary", "multiclass", "weighted"])
def test_device_refit_agrees_with_host_refit(kind):
    params = P if kind != "multiclass" else {**P, "objective": "multiclass",
                                              "num_class": 3}
    bst, _ = _model(params, k=3 if kind == "multiclass" else None)
    Xn, yn = _data(700, seed=1, k=3 if kind == "multiclass" else None)
    w = np.random.RandomState(2).rand(700) + 0.5 if kind == "weighted" else None
    dev = _clone(bst)
    refit_leaves(dev._gbdt, Xn, yn, weight=w)
    host = bst.refit(Xn, yn, decay_rate=0.9, weight=w)
    np.testing.assert_allclose(dev.predict(Xn, raw_score=True),
                               host.predict(Xn, raw_score=True), rtol=1e-5, atol=1e-5)
    again = _clone(bst)  # the refit repeats bit for bit
    refit_leaves(again._gbdt, Xn, yn, weight=w)
    assert again.model_to_string() == dev.model_to_string()


def test_fleet_refit_in_one_call_equals_each_lanes_refit():
    X, _ = _data(600, seed=3)
    rng = np.random.RandomState(4)
    labels = (X[None, :, 0] + rng.randn(4, 600) > 0).astype(float)
    fb = tlgb.train_fleet(dict(P), tlgb.Dataset(X, label=labels[0], params=CPU), labels,
                          num_boost_round=3)
    Xn, _ = _data(300, seed=5)
    ln = (Xn[None, :, 0] + rng.randn(4, 300) > 0).astype(float)
    solo = [_clone(fb.booster(b)) for b in range(4)]
    for b in range(4):
        refit_leaves(solo[b]._gbdt, Xn, ln[b])
    lanes = [_clone(fb.booster(b)) for b in range(4)]
    assert fleet_refit_leaves(lanes, Xn, ln) == 300
    for b in range(4):
        assert lanes[b].model_to_string() == solo[b].model_to_string()
    # a FleetBooster itself refits in place
    fleet_refit_leaves(fb, Xn, ln)
    np.testing.assert_array_equal(fb.booster(2).predict(Xn), lanes[2].predict(Xn))


def _runner(bst, ds, tmp_path, rt=None, **kw):
    return ContinualRunner(bst, runtime=rt, reference=ds, state_dir=str(tmp_path / "st"),
                           **{"update_every_rows": 400, "append_trees": 2, **kw})


def test_rollovers_are_bitwise_their_offline_updates_and_serving_follows(tmp_path):
    bst, ds = _model()
    rt = tlgb.serve(bst, {**CPU, "serve_max_wait_ms": 2})
    try:
        cr = _runner(bst, ds, tmp_path, rt)
        Xn, yn = _data(500, seed=6)
        cr.ingest(Xn[:250], yn[:250])
        cr.ingest(Xn[250:], yn[250:])
        live0 = cr.booster
        assert cr.update("refit") == "refit"
        offline = _clone(live0)
        refit_leaves(offline._gbdt, Xn, yn)
        assert cr.booster.model_to_string() == offline.model_to_string()
        np.testing.assert_array_equal(rt.predict(Xn[:40], timeout=60),
                                      offline.predict(Xn[:40]))
        live1 = cr.booster
        assert cr.update("append") == "append"
        want = tlgb.train(cr._train_params(), tlgb.Dataset(
            Xn, label=yn, reference=ds, params={"verbosity": -1, **CPU}), 2,
            init_model=live1)
        assert cr.booster.model_to_string() == want.model_to_string()
        assert cr.booster.num_trees() == bst.num_trees() + 2 and cr.seq == 2
        np.testing.assert_array_equal(rt.predict(Xn[:40], timeout=60),
                                      want.predict(Xn[:40]))
        assert obs.snapshot()["gauges"]["model_staleness_rows"] == 0.0
    finally:
        rt.stop()


_CRASH = """
import sys
sys.path.insert(0, {repo!r})
import numpy as np
import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.continual import ContinualRunner

rng = np.random.RandomState(0)
X = rng.randn(2000, 6)
y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.randn(2000) > 0).astype(float)
p = {{"objective": "binary", "num_leaves": 7, "learning_rate": 0.2, "verbosity": -1,
      "device_type": "cpu"}}
ds = lgb.Dataset(X, label=y, params=p)
bst = lgb.train(p, ds, 5)
bst.save_model({model!r})
rt = lgb.serve(bst, {{"device_type": "cpu", "serve_max_wait_ms": 2}})
cr = ContinualRunner(bst, runtime=rt, reference=ds, state_dir={state!r})
Xn = rng.randn(500, 6)
cr.ingest(Xn, (Xn[:, 0] > 0).astype(float))
before = rt.predict(Xn[:20], timeout=60)
assert np.array_equal(before, bst.predict(Xn[:20]))
print("SERVING_PREVIOUS", flush=True)
cr.update("refit")
print("COMPLETED_WITHOUT_FAULT", flush=True)
"""


def test_a_crash_mid_rollover_resumes_with_the_previous_model_serving(tmp_path):
    from lightgbm_tpu_torch.utils.faults import CRASH_EXIT_CODE

    state, model = str(tmp_path / "st"), str(tmp_path / "m.txt")
    env = {**os.environ, "LGBMTPU_FAULT": "continual_swap:1"}
    env.pop("PYTEST_CURRENT_TEST", None)
    r = subprocess.run([sys.executable, "-c", _CRASH.format(repo=str(ROOT), model=model,
                                                            state=state)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == CRASH_EXIT_CODE, (r.stdout, r.stderr)
    assert "SERVING_PREVIOUS" in r.stdout and "COMPLETED_WITHOUT_FAULT" not in r.stdout
    # the restarted runner serves the previous model until it resumes the
    # checkpointed update from the manifest
    prev = tlgb.Booster(params=CPU, model_file=model)
    rt = tlgb.serve(prev, {**CPU, "serve_max_wait_ms": 2})
    try:
        rng = np.random.RandomState(0)
        rng.randn(2000, 6), rng.randn(2000)
        Xn = rng.randn(500, 6)
        np.testing.assert_array_equal(rt.predict(Xn[:20], timeout=60), prev.predict(Xn[:20]))
        cr = ContinualRunner(prev, runtime=rt, state_dir=state, resume=True)
        assert cr.seq == 1
        offline = _clone(prev)
        refit_leaves(offline._gbdt, Xn, (Xn[:, 0] > 0).astype(float))
        np.testing.assert_array_equal(cr.booster.predict(Xn), offline.predict(Xn))
        np.testing.assert_array_equal(rt.predict(Xn[:20], timeout=60),
                                      offline.predict(Xn[:20]))
    finally:
        rt.stop()


def test_ingest_clamps_against_the_frozen_mappers_and_counts(tmp_path):
    bst, ds = _model()
    cr = _runner(bst, ds, tmp_path, cache_path=str(tmp_path / "ingest.bin"))
    X, y = _data(100, seed=7)
    X = np.clip(X, -1.0, 1.0)  # within the training range
    X[:5, 0] = 1e6  # past every bin
    X[5:8, 1] = -1e6
    before = obs.snapshot()["counters"].get("continual_clamped_values_total", 0)
    assert cr.ingest(X, y)["clamped"] == 8
    assert obs.snapshot()["counters"]["continual_clamped_values_total"] - before == 8
    from lightgbm_tpu_torch.io.stream import read_bin_cache

    cached = read_bin_cache(str(tmp_path / "ingest.bin"))
    np.testing.assert_array_equal(cached["bins"], ds.binner.transform(X))
    top = ds.binner.transform(np.full((1, 6), 1e9))[0, 0]
    assert (cached["bins"][:5, 0] == top).all()


def test_the_staleness_slo_turns_healthz_degraded(tmp_path):
    bst, ds = _model()
    cr = _runner(bst, ds, tmp_path, staleness_slo_s=0.05, update_every_rows=0)
    X, y = _data(50, seed=8)
    cr.ingest(X, y)
    time.sleep(0.1)
    cr._publish_staleness()
    status, body = obs_server.health()
    assert body["status"] != "ok" and any(
        p.get("gauge") == "continual_staleness_exceeded" for p in body["problems"])
    cr.update("refit")
    status, body = obs_server.health()
    assert not any(p.get("gauge") == "continual_staleness_exceeded"
                   for p in body["problems"])


def test_row_and_time_policies(tmp_path):
    bst, ds = _model()
    X, y = _data(300, seed=9)
    rows = _runner(bst, ds, tmp_path, update_every_rows=250)
    rows.ingest(X[:200], y[:200])
    assert not rows._due()
    rows.ingest(X[200:], y[200:])
    assert rows._due()
    timed = _runner(bst, ds, tmp_path, update_every_rows=0, update_every_s=0.05)
    timed.ingest(X, y)
    assert not timed._due()
    time.sleep(0.08)
    assert timed._due()
    # started, the runner's thread updates on its own within its tick
    auto = _runner(bst, ds, tmp_path, update_every_rows=100)
    with auto:
        auto.ingest(X, y)
        t0 = time.monotonic()
        while auto.seq == 0 and time.monotonic() - t0 < 30:
            time.sleep(0.02)
    assert auto.seq >= 1


def test_envelope_refusals(tmp_path):
    X, y = _data(600, seed=10)
    lin = {**P, "linear_tree": True}
    lb = tlgb.train(lin, tlgb.Dataset(X, label=y, params=lin), 2)
    with pytest.raises(ContinualError, match="linear"):
        refit_leaves(lb._gbdt, X, y)
    rf = {**P, "boosting": "rf", "bagging_freq": 1, "bagging_fraction": 0.7}
    rb = tlgb.train(rf, tlgb.Dataset(X, label=y, params=rf), 2)
    with pytest.raises(ContinualError, match="random-forest"):
        refit_leaves(rb._gbdt, X, y)
    bst, ds = _model()
    cr = ContinualRunner(bst, append_trees=0)
    cr.ingest(X[:10], y[:10])
    with pytest.raises(ContinualError, match="append_trees=0"):
        cr.update("append")
    with pytest.raises(ContinualError, match="reference"):
        ContinualRunner(tlgb.Booster(params=CPU, model_str=bst.model_to_string()),
                        cache_path=str(tmp_path / "c.bin"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device_type"):
            tlgb.continual_train(bst, {"update_every_rows": 10}, start=False)


def test_port_refit_agrees_with_jax_refit_leaves():
    bst, _ = _model()
    Xn, yn = _data(700, seed=11)
    port = _clone(bst)
    refit_leaves(port._gbdt, Xn, yn)
    jb = jlgb.Booster(model_str=bst.model_to_string())
    jax_refit_leaves(jb._gbdt, Xn, yn)
    for a, b in zip(jb._gbdt.models, port._gbdt.models):
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-6, atol=1e-6)
