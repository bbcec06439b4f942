"""The serving runtime of lightgbm_tpu_torch (serve/runtime.py, a torch
rewrite of the JAX package's; serve/fleet.py, a copy) and the packed
ensemble cache under it (models/gbdt.py::GBDT._packed), on the CPU.

Held to the JAX package's serving pins (tests/test_serve.py,
tests/test_serve_fleet.py): every coalesced response is bitwise the
``Booster.predict`` of its own rows (binary, multiclass, random forest;
raw and converted), a coalesced batch is one traversal and one blocking
read, shedding and quotas raise a typed Overloaded, a hot swap never cools
the cache, the HTTP front door maps its errors to the same codes, and the
fleet loses no request when a replica dies or hangs.  The packed cache
builds the stacked ensemble once a model version, and every mutation bumps
the version.  Every threaded test bounds its waits (result and join
timeouts), and the port's lock tracer runs strict around each test.
"""

import ast
import json
import os
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.models import gbdt as tgbdt
from lightgbm_tpu_torch.obs import metrics as obs
from lightgbm_tpu_torch.obs import server as srv
from lightgbm_tpu_torch.obs import trace as trc
from lightgbm_tpu_torch.serve import (MAX_BATCH_ROWS, Overloaded, ServingFleet,
                                      ServingRuntime)
from lightgbm_tpu_torch.utils import faults as flt
from lightgbm_tpu_torch.utils import locktrace as lt
from lightgbm_tpu_torch.utils.sanitizer import DispatchCounter

CPU = {"device_type": "cpu", "verbosity": -1}
WAIT = 60  # seconds: the bound of every blocking wait here


@pytest.fixture(autouse=True)
def _fresh_state():
    """A clean registry, trace and fault spec; the port's own lock tracer
    strict (tests/conftest.py arms only the JAX package's)."""
    obs.reset()
    trc.reset_trace()
    os.environ.pop("LGBMTPU_FAULT", None)
    flt.reset()
    lt.reset()
    lt.enable(True, strict=True)
    yield
    lt.enable(False)
    os.environ.pop("LGBMTPU_FAULT", None)
    flt.reset()
    srv.stop_server()
    obs.reset()
    trc.reset_trace()


def _binary_booster(n=400, f=6, rounds=4, seed=0, **extra):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float)
    params = {"objective": "binary", "num_leaves": 7, **CPU, **extra}
    bst = tlgb.Booster(params=params, train_set=tlgb.Dataset(X, label=y, params=params))
    for _ in range(rounds):
        bst.update()
    return bst, X


def _multiclass_booster(n=300, f=5, k=3, rounds=3, seed=1):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = rng.randint(0, k, n).astype(float)
    params = {"objective": "multiclass", "num_class": k, "num_leaves": 7, **CPU}
    bst = tlgb.Booster(params=params, train_set=tlgb.Dataset(X, label=y, params=params))
    for _ in range(rounds):
        bst.update()
    return bst, X


def _rf_booster(n=400, f=6, rounds=4, seed=2):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, 0] - X[:, 2] > 0).astype(float)
    params = {"objective": "binary", "boosting": "rf", "num_leaves": 7,
              "bagging_freq": 1, "bagging_fraction": 0.7, **CPU}
    bst = tlgb.Booster(params=params, train_set=tlgb.Dataset(X, label=y, params=params))
    for _ in range(rounds):
        bst.update()
    return bst, X


def _queue_then_start(rt, parts, **kw):
    """Enqueue every request on the unstarted runtime, then start it: the
    coalescer finds them all queued (no wall-clock races)."""
    handles = [rt.submit(p, **kw) for p in parts]
    rt.start()
    return [rt.result(h, timeout=WAIT) for h in handles]


# ---------------------------------------------------------------------------
# the packed ensemble cache
# ---------------------------------------------------------------------------

def test_warm_predict_builds_the_ensemble_once_a_version(monkeypatch):
    """_stacked runs once a model version: warm calls (any row count, raw
    or converted) hit the cache; each mutation bumps the version and the
    next call packs again, with the new trees."""
    bst, X = _binary_booster()
    calls = []
    real = tgbdt.GBDT._stacked
    g = bst._gbdt

    def counted(self, trees, dev):
        if self is g:
            calls.append(len(trees))
        return real(self, trees, dev)

    monkeypatch.setattr(tgbdt.GBDT, "_stacked", counted)
    first = bst.predict(X[:7])
    for n in (1, 7, 64, 300):
        bst.predict(X[:n], raw_score=True)
        bst.predict(X[:n])
    assert calls == [4]
    assert np.array_equal(bst.predict(X[:7]), first)
    v = g._pack_version
    bst.update()  # a pending tree appended: the version moves at once
    assert g._pack_version > v and g._pending
    bst.predict(X[:5])
    assert calls == [4, 5]
    for mutate in (lambda: bst.set_leaf_output(0, 0, 0.25),
                   lambda: bst.shuffle_models(0, 3),
                   lambda: bst.rollback_one_iter(),
                   lambda: setattr(g, "models", list(g.models))):
        v = g._pack_version
        mutate()
        assert g._pack_version > v
        got = bst.predict(X, raw_score=True)
        again = tlgb.Booster(model_str=bst.model_to_string(), params=CPU)
        assert np.array_equal(got, again.predict(X, raw_score=True))
    assert len(calls) == 6
    refit = bst.refit(X, (X[:, 0] > 0).astype(float))
    assert refit._gbdt._pack_version > 0


def test_previous_version_stays_servable_and_older_ones_are_evicted():
    bst, X = _binary_booster()
    g = bst._gbdt
    bst.predict(X[:4])
    s0 = g._packed(0, -1)
    g._invalidate_pred_cache("test")
    assert any(key[0] == g._pack_version - 1 for key in g._pred_cache)
    assert g._packed(0, -1) is not s0  # the new version packs anew
    g._invalidate_pred_cache("test")
    g._invalidate_pred_cache("test")
    assert all(key[0] > g._pack_version - g._PACKED_KEEP_VERSIONS
               for key in g._pred_cache)
    assert obs.counter("predict_stale_pack_evictions_total").value >= 1


def test_warm_predict_is_one_traversal_and_one_read():
    bst, X = _binary_booster()
    bst.predict(X[:10])
    for raw in (False, True):
        with DispatchCounter() as d:
            bst.predict(X[:10], raw_score=raw)
        assert (d.predicts, d.host_syncs) == (1, 1)
    assert obs.histogram("predict_warm_latency_ms").count >= 1
    assert obs.histogram(obs.labeled("predict_warm_latency_ms", bucket=16)).count >= 1


# ---------------------------------------------------------------------------
# bitwise parity: coalesced == individual
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["binary", "multiclass", "rf"])
def test_coalesced_bitwise_parity(kind):
    bst, X = {"binary": _binary_booster, "multiclass": _multiclass_booster,
              "rf": _rf_booster}[kind]()
    parts = [X[0:10], X[10:17], X[17:40], X[40:41]]
    want_raw = [bst.predict(p, raw_score=True) for p in parts]
    want_cvt = [bst.predict(p) for p in parts]
    rt = ServingRuntime(bst, max_wait_ms=200, start=False, shed_unhealthy=False)
    try:
        got_raw = _queue_then_start(rt, parts, raw_score=True)
        got_cvt = [rt.result(h, timeout=WAIT) for h in [rt.submit(p) for p in parts]]
    finally:
        rt.stop()
    for w, got in zip(want_raw + want_cvt, got_raw + got_cvt):
        assert w.dtype == got.dtype and np.array_equal(w, got), kind
    assert obs.counter("serve_batches_total").value >= 2
    assert obs.counter("serve_uncoalesced_total").value == 0


def test_concurrent_callers_parity():
    bst, X = _binary_booster()
    slices = [X[i * 16:(i + 1) * 16] for i in range(8)]
    want = [bst.predict(s, raw_score=True) for s in slices]
    errs = []
    with ServingRuntime(bst, max_wait_ms=20, shed_unhealthy=False) as rt:
        def call(i):
            try:
                got = rt.predict(slices[i], raw_score=True, timeout=WAIT)
                assert np.array_equal(got, want[i]), i
            except BaseException as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert rt.stats()["queue_depth"] == 0
    assert not errs, errs


def test_coalesced_batch_is_one_traversal_and_one_read_with_telemetry_on():
    server = srv.start_server(0)
    bst, X = _binary_booster()
    parts = [X[0:8], X[8:16], X[16:24], X[24:32]]  # 32 rows: a whole rung

    def run_once():
        rt = ServingRuntime(bst, max_wait_ms=200, start=False, shed_unhealthy=False)
        try:
            return _queue_then_start(rt, parts, raw_score=True)
        finally:
            rt.stop()

    run_once()
    with DispatchCounter() as d:
        got = run_once()
    assert obs.counter("serve_batches_total").value == 2
    assert (d.predicts, d.host_syncs, d.rounds) == (1, 1, 0)
    d.assert_round_budget(1, syncs_per_round=1, what="coalesced batch")
    for w, g in zip([bst.predict(p, raw_score=True) for p in parts], got):
        assert np.array_equal(w, g)
    prom = urllib.request.urlopen(server.url("/metrics"), timeout=10).read().decode()
    for name in ("lgbmtpu_serve_batches_total", "lgbmtpu_serve_queue_depth",
                 "lgbmtpu_serve_batch_occupancy", "lgbmtpu_device_host_syncs_total"):
        assert name in prom, name
    assert trc.spans("serve.batch") and trc.spans("predict.coalesced")
    for ph in ("queue", "coalesce", "staging", "dispatch", "sliceout"):
        assert obs.histogram(obs.labeled("serve_phase_ms", phase=ph)).count >= 1, ph


def test_staged_batch_holds_its_rows_and_no_rung_padding(monkeypatch):
    """A batch of 21 rows (rung 32) reaches predict_coalesced as its 21
    rows: the rung's padding is neither filled nor handed on."""
    bst, X = _binary_booster()
    seen = []
    real = tgbdt.GBDT.predict_coalesced

    def spy(self, x, **kw):
        seen.append(tuple(x.shape))
        return real(self, x, **kw)

    monkeypatch.setattr(tgbdt.GBDT, "predict_coalesced", spy)
    parts = [X[0:5], X[5:12], X[12:21]]
    rt = ServingRuntime(bst, max_wait_ms=200, start=False, shed_unhealthy=False)
    try:
        got = _queue_then_start(rt, parts)
    finally:
        rt.stop()
    assert seen == [(21, X.shape[1])]
    for p, g in zip(parts, got):
        assert np.array_equal(bst.predict(p), g)


def test_rung_fill_flushes_before_the_admission_window():
    bst, X = _binary_booster()
    rt = ServingRuntime(bst, max_wait_ms=30_000, start=False, shed_unhealthy=False)
    t0 = time.monotonic()
    try:
        _queue_then_start(rt, [X[0:16], X[16:32]], raw_score=True)
    finally:
        rt.stop()
    assert time.monotonic() - t0 < 10


def test_max_batch_rows_caps_one_batch():
    bst, X = _binary_booster(n=64)
    big = np.tile(X, (MAX_BATCH_ROWS // 64 + 1, 1))
    want = bst.predict(big, raw_score=True)
    rt = ServingRuntime(bst, max_wait_ms=5, start=False, shed_unhealthy=False)
    try:
        got = _queue_then_start(rt, [big], raw_score=True)[0]
    finally:
        rt.stop()
    assert np.array_equal(want, got)
    # the request over the cap was served alone through predict: the
    # runtime staged nothing larger than MAX_BATCH_ROWS rows
    assert obs.counter("serve_uncoalesced_total").value == 1
    assert all(k[0] <= MAX_BATCH_ROWS for k in rt._staging)


def test_early_stop_model_serves_serially_and_matches_predict():
    bst, X = _binary_booster(rounds=8, pred_early_stop=True, pred_early_stop_freq=2,
                             pred_early_stop_margin=0.5)
    want = bst.predict(X[:64])
    with ServingRuntime(bst, max_wait_ms=20, shed_unhealthy=False) as rt:
        got = rt.predict(X[:64], timeout=WAIT)
    assert np.array_equal(want, got)
    assert obs.counter("serve_uncoalesced_total").value >= 1


# ---------------------------------------------------------------------------
# shedding, quotas, timeouts, tenants, hot swap
# ---------------------------------------------------------------------------

def test_queue_bound_sheds_with_typed_error_and_healthz_state():
    bst, X = _binary_booster()
    rt = ServingRuntime(bst, max_queue=2, start=False, shed_unhealthy=False)
    try:
        rt.submit(X[:4])
        rt.submit(X[:4])
        with pytest.raises(Overloaded) as ei:
            rt.submit(X[:4])
        assert (ei.value.reason, ei.value.tenant) == ("queue_full", "default")
        assert obs.counter("serve_shed_total").value == 1
        assert obs.gauge("serve_shedding").value == 1.0
        code, body = srv.health()
        assert code == 200 and body["status"] == "degraded" and body["shedding"]
        rt.start()
        assert rt.predict(X[:4], timeout=WAIT).shape == (4,)
        assert obs.gauge("serve_shedding").value == 0.0
    finally:
        rt.stop()


def test_slo_p99_sheds_under_queue_pressure_only():
    bst, X = _binary_booster()
    bst.predict(X[:8], raw_score=True)  # cold: builds the pack
    bst.predict(X[:8], raw_score=True)  # warm: feeds the reservoir
    assert obs.histogram("predict_warm_latency_ms").count >= 1
    rt = ServingRuntime(bst, slo_p99_ms=1e-6, start=False, shed_unhealthy=False)
    try:
        rt.submit(X[:4])  # an empty queue: the SLO alone does not shed
        with pytest.raises(Overloaded) as ei:
            rt.submit(X[:4])
        assert ei.value.reason == "slo_p99"
        rt.start()
    finally:
        rt.stop()


def test_unhealthy_process_sheds_when_enabled():
    bst, X = _binary_booster()
    obs.counter("train_nonfinite_errors_total").inc()
    rt = ServingRuntime(bst, start=False)
    rt2 = ServingRuntime(bst, start=False, shed_unhealthy=False)
    try:
        with pytest.raises(Overloaded) as ei:
            rt.submit(X[:4])
        assert ei.value.reason == "unhealthy"
        rt2.submit(X[:4])
        rt2.start()
    finally:
        rt2.stop()
        rt.stop()


def test_result_timeout_never_hangs():
    bst, X = _binary_booster()
    rt = ServingRuntime(bst, start=False, shed_unhealthy=False)
    h = rt.submit(X[:4])
    with pytest.raises(TimeoutError):
        rt.result(h, timeout=0.05)
    rt.stop()
    with pytest.raises(tlgb.LightGBMError):
        rt.result(h, timeout=5)


def test_multi_model_routing_and_tenant_quota():
    b1, X = _binary_booster(rounds=2, seed=3)
    b2, _ = _binary_booster(rounds=6, seed=4)
    rt = ServingRuntime(models={"a": b1, "b": b2}, max_wait_ms=100, tenant_quota=1,
                        start=False, shed_unhealthy=False)
    try:
        ha = rt.submit(X[:12], model="a", raw_score=True)
        with pytest.raises(Overloaded) as ei:
            rt.submit(X[:4], model="a")
        assert (ei.value.reason, ei.value.tenant) == ("tenant_quota", "a")
        hb = rt.submit(X[:12], model="b", raw_score=True)
        rt.start()
        got_a, got_b = rt.result(ha, timeout=WAIT), rt.result(hb, timeout=WAIT)
    finally:
        rt.stop()
    assert np.array_equal(got_a, b1.predict(X[:12], raw_score=True))
    assert np.array_equal(got_b, b2.predict(X[:12], raw_score=True))
    assert obs.counter(obs.labeled("serve_requests_total", tenant="b")).value == 1


def test_hot_swap_serves_new_model_and_never_cools_the_cache():
    b1, X = _binary_booster(rounds=2, seed=5)
    b2, _ = _binary_booster(rounds=7, seed=6)
    with ServingRuntime(b1, max_wait_ms=20, shed_unhealthy=False) as rt:
        got1 = rt.predict(X[:16], raw_score=True, timeout=WAIT)
        assert np.array_equal(got1, b1.predict(X[:16], raw_score=True))
        assert not b2._gbdt._pred_cache
        rt.swap_model("default", b2)
        assert b2._gbdt._pred_cache, "swap published a cold pack"
        got2 = rt.predict(X[:16], raw_score=True, timeout=WAIT)
        assert np.array_equal(got2, b2.predict(X[:16], raw_score=True))
        assert b1._gbdt._pred_cache
    assert obs.counter("serve_model_swaps_total").value == 1


# ---------------------------------------------------------------------------
# the entry point and the module's shape
# ---------------------------------------------------------------------------

def test_engine_serve_entry_starts_runtime_or_fleet_and_endpoint():
    bst, X = _binary_booster()
    rt = tlgb.serve(bst, {**CPU, "serve_max_wait_ms": 1, "metrics_port": 0})
    try:
        assert isinstance(rt, ServingRuntime) and not isinstance(rt, ServingFleet)
        assert np.array_equal(rt.predict(X[:8], raw_score=True, timeout=WAIT),
                              bst.predict(X[:8], raw_score=True))
        hz = json.load(urllib.request.urlopen(srv.get_server().url("/healthz"),
                                              timeout=10))
        assert hz["status"] in ("ok", "degraded")
    finally:
        rt.stop()
    fl = tlgb.serve(bst, {**CPU, "serve_replicas": 2, "serve_max_wait_ms": 10})
    try:
        assert isinstance(fl, ServingFleet)
        assert np.array_equal(fl.predict(X[:8], raw_score=True, timeout=WAIT),
                              bst.predict(X[:8], raw_score=True))
        assert fl.stats()["replicas"] == {0: "active", 1: "active"}
    finally:
        fl.stop()


def test_serve_loads_model_files_and_needs_a_card_unless_cpu(tmp_path, monkeypatch):
    import torch

    bst, X = _binary_booster()
    path = str(tmp_path / "m.txt")
    bst.save_model(path)
    rt = tlgb.serve(path, {**CPU, "serve_max_wait_ms": 1})
    try:
        assert np.array_equal(rt.predict(X[:8], timeout=WAIT), bst.predict(X[:8]))
    finally:
        rt.stop()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tlgb.serve(path, {"verbosity": -1})


def test_serve_module_launches_nothing_of_its_own():
    """The serve package stages, enqueues and calls GBDT.predict_coalesced
    (or GBDT.predict): no torch op, no kernel, no device function of its
    own.  The torch calls it may make are the staging ones."""
    import lightgbm_tpu_torch.serve.runtime as serve_rt

    allowed = {"empty", "zeros", "from_numpy", "cuda", "Event", "float32", "bool",
               "device", "to", "copy_", "zero_", "record", "synchronize"}
    serve_dir = Path(serve_rt.__file__).resolve().parent
    for py in serve_dir.glob("*.py"):
        tree = ast.parse(py.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
                    and node.value.id == "torch":
                assert node.attr in allowed, f"{py.name}:{node.lineno} torch.{node.attr}"
            if isinstance(node, ast.Attribute):
                assert node.attr not in {"_raw_of", "predict_raw", "_stacked",
                                         "traverse", "launch"}, (py.name, node.lineno)
    src = Path(serve_rt.__file__).read_text()
    assert "predict_coalesced(" in src
    imported = {n.module for n in ast.walk(ast.parse(src))
                if isinstance(n, ast.ImportFrom) and n.module}
    assert not any(m.startswith("ops") for m in imported), imported


def test_serve_name_is_both_entry_point_and_namespace():
    import importlib

    assert callable(tlgb.serve)
    assert tlgb.serve.ServingRuntime is ServingRuntime
    assert tlgb.serve.Overloaded is Overloaded
    assert tlgb.serve.MAX_BATCH_ROWS == MAX_BATCH_ROWS
    assert importlib.import_module("lightgbm_tpu_torch.serve").ServingFleet is ServingFleet
    assert tlgb.serve.runtime.ServingRuntime is ServingRuntime


# ---------------------------------------------------------------------------
# the HTTP front door
# ---------------------------------------------------------------------------

def _post(url, body, timeout=WAIT):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def test_http_predict_codes_and_parity():
    server = srv.start_server(0)
    bst, X = _binary_booster()
    rt = ServingRuntime(bst, max_wait_ms=10, shed_unhealthy=False)
    try:
        code, body = _post(server.url("/predict"), {"rows": X[:8].tolist(),
                                                    "raw_score": True})
        assert code == 200 and body["rows"] == 8
        assert np.array_equal(np.asarray(body["predictions"]),
                              bst.predict(X[:8], raw_score=True))
        code, body = _post(server.url("/predict"), {"nope": 1})
        assert code == 400 and body["error"] == "bad_request"
    finally:
        rt.stop()
    code, _ = _post(server.url("/predict"), {"rows": X[:2].tolist()})
    assert code == 503  # a stopped runtime unregisters its route
    fl = ServingFleet(bst, replicas=2, max_queue=2, deadline_ms=300, hedge_ms=0,
                      shed_unhealthy=False, start=False)
    srv.set_predict_handler(fl._http_predict)
    try:
        code, body = _post(server.url("/predict"), {"rows": X[:4].tolist()})
        assert code == 504 and body["error"] == "deadline_exceeded"
        fl.submit(X[:4])
        code, body = _post(server.url("/predict"), {"rows": X[:4].tolist()})
        assert code == 429 and body["reason"] == "queue_full"
    finally:
        fl.stop()


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------

def _fleet(bst, replicas=2, **kw):
    kw.setdefault("max_wait_ms", 20)
    kw.setdefault("shed_unhealthy", False)
    kw.setdefault("hang_timeout_ms", 30_000)
    kw.setdefault("hedge_ms", 0)
    return ServingFleet(bst, replicas=replicas, **kw)


@pytest.mark.parametrize("stage", [0, 1], ids=["stageA", "stageB"])
@pytest.mark.parametrize("site", ["replica_death", "replica_hang"])
def test_fleet_chaos_matrix_two_replicas_zero_loss_bitwise(site, stage):
    """A replica killed or wedged at either side of its dispatch loses no
    admitted request: the batch requeues onto the healthy replica and
    every response is bitwise Booster.predict."""
    bst, X = _binary_booster()
    slices = [X[i * 8:(i + 1) * 8] for i in range(4)]
    want = [bst.predict(s, raw_score=True) for s in slices]
    fl = _fleet(bst, replicas=2, hang_timeout_ms=1_500, restart_backoff_ms=50,
                max_wait_ms=60)
    try:
        assert fl.predict(X[:16], raw_score=True, timeout=WAIT).shape == (16,)
        os.environ["LGBMTPU_FAULT"] = f"{site}:{stage}"
        handles = [fl.submit(s, raw_score=True) for s in slices]
        got = [fl.result(h, timeout=WAIT) for h in handles]
        for w, g in zip(want, got):
            assert np.array_equal(w, g), f"{site}@{stage}"
        assert obs.counter("faults_injected_total").value == 1
        dead = ("serve_replica_hangs_total" if site == "replica_hang"
                else "serve_replica_deaths_total")
        assert obs.counter(dead).value == 1
        assert obs.counter("serve_requeues_total").value >= 1
    finally:
        t0 = time.monotonic()
        fl.stop()
        assert time.monotonic() - t0 < 20


def test_fleet_swap_publish_fault_keeps_old_model_serving():
    b1, X = _binary_booster(rounds=2, seed=5)
    b2, _ = _binary_booster(rounds=7, seed=6)
    fl = _fleet(b1)
    try:
        fl.predict(X[:16], raw_score=True, timeout=WAIT)
        os.environ["LGBMTPU_FAULT"] = "swap_publish:0"
        with pytest.raises(flt.InjectedFault):
            fl.swap_model("default", b2)
        os.environ.pop("LGBMTPU_FAULT", None)
        assert np.array_equal(fl.predict(X[:16], raw_score=True, timeout=WAIT),
                              b1.predict(X[:16], raw_score=True))
    finally:
        fl.stop()


def test_degradation_fault_sites_are_not_wired():
    """The JAX package's kernel-failure sites drive its degradation net
    (utils/degrade.py), which the port does not have (no kernel fallback):
    arming them changes nothing in a training, and no fault fires."""
    X = np.random.RandomState(3).randn(600, 5)
    y = X[:, 0] + 0.1 * X[:, 1]
    p = {"objective": "regression", "num_leaves": 7, "tree_growth_mode": "rounds",
         **CPU}
    want = tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 3).model_to_string()
    os.environ["LGBMTPU_FAULT"] = "pallas_hist:0,pallas_partition:0,pallas_round:0"
    flt.reset()
    got = tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 3).model_to_string()
    assert got == want
    assert obs.counter("faults_injected_total").value == 0
