"""The runtime layers of lightgbm_tpu_torch on the CPU, against the JAX
package where both compute the same thing: fault C9 (the strict grower
stops at the first all-one-leaf iteration), the copied obs/ package (the
same snapshot renders the same through both CLIs), the windowed round
loop's telemetry (the same counters and histograms as the JAX package's
on one fixture), train()'s metrics_file / trace_file / metrics_port and
the span, event and heartbeat vocabulary, utils/profiling.py (obs spans,
mirrored into torch.profiler's trace while a profiler records), the
sanitizer's collector and budget,
and the copied lock tracer.
"""

import difflib
import json
import os
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.obs import metrics as jobs
from lightgbm_tpu.ops import treegrow_windowed as jwin
from lightgbm_tpu.ops.split import SplitParams as JParams
from lightgbm_tpu_torch.obs import metrics as obs
from lightgbm_tpu_torch.obs import server as srv
from lightgbm_tpu_torch.obs import trace as trc
from lightgbm_tpu_torch.ops import treegrow_windowed as twin
from lightgbm_tpu_torch.ops.split import SplitParams as TParams
from lightgbm_tpu_torch.utils import locktrace as lt
from lightgbm_tpu_torch.utils import profiling
from lightgbm_tpu_torch.utils import sanitizer as san

ROOT = Path(__file__).resolve().parent.parent
CPU = {"device_type": "cpu", "verbosity": -1}


@pytest.fixture(autouse=True)
def _fresh():
    obs.reset()
    trc.reset_trace()
    yield
    srv.stop_server()
    obs.reset()
    trc.reset_trace()


# ---------------------------------------------------------------------------
# fault C9
# ---------------------------------------------------------------------------

def assert_same_text(got: str, want: str, tol: float = 1e-6) -> None:
    """The same model text line for line: every token equal, but numbers,
    held to ``tol`` relative and one unit of their last printed digit
    (split gains to ``tol`` times the tree's largest; a
    boost_from_average init score is the logit of an f32
    label mean, whose summation order differs between the packages by an
    ulp), the device_type parameter line, which names each package's
    device, and the tree_sizes line, the lengths of tree blocks whose
    numbers may print with other digits."""
    a, b = got.splitlines(), want.splitlines()
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x == y or any(x.startswith(k) and y.startswith(k)
                         for k in ("[device_type:", "tree_sizes=")):
            continue
        tx, ty = x.replace("=", " ").split(), y.replace("=", " ").split()
        assert len(tx) == len(ty), (x, y)
        # a split gain is a difference of f32 terms as large as the root's
        scale = (max(abs(float(v)) for v in ty[1:]) if x.startswith("split_gain=")
                 else 1.0)
        for u, v in zip(tx, ty):
            if u != v:
                fu, fv = float(u), float(v)
                # relative, plus one unit of the last printed digit (%g)
                last = 10.0 ** (np.floor(np.log10(abs(fv))) - 5) if fv else 0.0
                assert abs(fu - fv) <= tol * max(scale, abs(fv)) + last, (x, y)


@pytest.mark.parametrize("boost_from_average", [True, False])
def test_c9_strict_stops_at_the_first_one_leaf_iteration(boost_from_average):
    """ROADMAP C9's fixture: no split can pass min_gain_to_split.  Both
    packages at tree_growth_mode=auto (the strict grower on the CPU) stop
    after the first iteration: one tree each, the same model text, and
    predictions within 1e-6 (they differed by up to 4.69e-3 without
    boost_from_average while the port trained on)."""
    rng = np.random.RandomState(0)
    X = rng.randn(2000, 6)
    y = (X[:, 0] + 0.3 * rng.randn(2000) > 0).astype(float)
    p = {"objective": "binary", "min_gain_to_split": 1e9, "verbosity": -1,
         "boost_from_average": boost_from_average}
    jb = jlgb.train(dict(p), jlgb.Dataset(X, label=y), 10)
    tp = {**p, **CPU}
    with san.DispatchCounter() as c:
        tb = tlgb.train(tp, tlgb.Dataset(X, label=y, params=tp), 10)
    assert tb._gbdt.round_stats[0]["grower"] == "strict"
    assert jb.num_trees() == tb.num_trees() == 1
    assert c.host_syncs == 1  # the finish check of the one iteration
    assert_same_text(tb.model_to_string(), jb.model_to_string())
    for raw in (False, True):
        np.testing.assert_allclose(tb.predict(X, raw_score=raw),
                                   jb.predict(X, raw_score=raw), rtol=0, atol=1e-6)


def test_rounds_grower_still_reads_every_32_iterations():
    rng = np.random.RandomState(0)
    X = rng.randn(600, 4)
    y = (X[:, 0] > 0).astype(float)
    p = {"objective": "binary", "min_gain_to_split": 1e9, "num_leaves": 7,
         "tree_growth_mode": "rounds", **CPU}
    with san.DispatchCounter() as c:
        bst = tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 40)
    # the one-leaf iterations go on until the check at iteration 32
    assert bst.num_trees() == 32
    assert sum(s["host_syncs"] for s in bst._gbdt.round_stats) + 1 == c.host_syncs


# ---------------------------------------------------------------------------
# obs/: the copy renders as the original
# ---------------------------------------------------------------------------

def test_obs_cli_renders_a_snapshot_as_the_jax_one(tmp_path, capsys):
    obs.counter("train_boost_rounds_total").inc(3)
    obs.gauge("heartbeat_done").set(1.0)
    h = obs.histogram(obs.labeled("predict_warm_latency_ms", bucket=16))
    for v in (0.5, 1.5, 2.5):
        h.observe(v)
    path = str(tmp_path / "m.json")
    obs.write_snapshot(path, obs.snapshot())
    from lightgbm_tpu.obs.__main__ import main as jax_main

    for fmt in ("lightgbm", "prometheus"):
        env = {**os.environ, "PYTHONPATH": str(ROOT)}
        r = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch.obs", path,
                            "--format", fmt], capture_output=True, text=True,
                           timeout=120, env=env, cwd=str(ROOT))
        assert r.returncode == 0, r.stderr
        capsys.readouterr()
        assert jax_main([path, "--format", fmt]) in (0, None)
        assert r.stdout == capsys.readouterr().out
        assert "train_boost_rounds_total" in r.stdout


def _code_lines(text):
    """A module's code, docstrings and comments left out, a statement a line."""
    import ast

    tree = ast.parse(text)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.unparse(tree).splitlines()


def test_obs_modules_are_the_jax_ones_but_for_their_names():
    """obs/, utils/{faults,locktrace,checkpoint}.py and serve/fleet.py are
    copies: line for line the JAX package's once the package name is
    mapped, but for at most three lines each (docstrings naming modules
    the port does not have, two comments reworded) and, in the fleet,
    exactly the four lines of the runtime's torch staging (a batch's
    payload without the row mask, the call that takes it, and the
    staging buffer a hung replica's replacement gets).  obs/trace.py's
    docstrings describe the port's torch.profiler mirror; its code is the
    JAX package's but for exactly the mirror's gate (the gate beside the
    factory, ``_live_factory``, ``mirror_active``, and a span's enter
    asking for the live factory)."""
    fleet_lines = {
        "            g, x_dev, total, nb, skey, pair = payload",
        "                    res = g.predict_coalesced(x_dev, convert=convert,",
        "                self._staging[infl.skey].put(self._new_staging(infl.skey))",
        "                self._return_staging(payload[4], payload[5])",
    }
    trace_lines = [
        "_annotation_gate: Optional[Callable[[], bool]] = None",
        "def set_annotation_factory(fn: Optional[Callable[[str, Dict[str, Any]], "
        "ContextManager]], gate: Optional[Callable[[], bool]]=None) -> None:",
        "    global _annotation_factory, _annotation_gate",
        "    _annotation_factory, _annotation_gate = (fn, gate)",
        "",
        "def _live_factory() -> Optional[Callable[[str, Dict[str, Any]], ContextManager]]:",
        "    fac, gate = (_annotation_factory, _annotation_gate)",
        "    return fac if fac is not None and (gate is None or gate()) else None",
        "",
        "def mirror_active() -> bool:",
        "    return _live_factory() is not None",
        "        fac = _live_factory()",
    ]
    ja = _code_lines((ROOT / "lightgbm_tpu" / "obs" / "trace.py").read_text())
    tb = _code_lines((ROOT / "lightgbm_tpu_torch" / "obs" / "trace.py").read_text())
    ops = difflib.SequenceMatcher(a=ja, b=tb, autojunk=False).get_opcodes()
    assert [line for tag, _i1, _i2, j1, j2 in ops if tag != "equal"
            for line in tb[j1:j2]] == trace_lines
    assert [line for tag, i1, i2, _j1, _j2 in ops if tag != "equal"
            for line in ja[i1:i2]] == [
        "def set_annotation_factory(fn: Optional[Callable[[str, Dict[str, Any]], "
        "ContextManager]]) -> None:",
        "    global _annotation_factory", "    _annotation_factory = fn",
        "        fac = _annotation_factory"]
    pairs = [(f"obs/{m}.py", f"obs/{m}.py")
             for m in ("__init__", "metrics", "server", "__main__")]
    pairs += [(f"utils/{m}.py", f"utils/{m}.py")
              for m in ("faults", "locktrace", "checkpoint")]
    pairs += [("serve/fleet.py", "serve/fleet.py")]
    for a, b in pairs:
        ja = (ROOT / "lightgbm_tpu" / a).read_text().replace(
            "lightgbm_tpu.", "lightgbm_tpu_torch.").replace(
            "lightgbm_tpu/", "lightgbm_tpu_torch/").splitlines()
        tb = (ROOT / "lightgbm_tpu_torch" / b).read_text().splitlines()
        ops = difflib.SequenceMatcher(a=ja, b=tb, autojunk=False).get_opcodes()
        changed = [tb[j1:j2] for tag, _i1, _i2, j1, j2 in ops if tag != "equal"]
        if a == "serve/fleet.py":
            assert {line for c in changed for line in c} == fleet_lines, changed
            assert sum(max(len(c), 1) for c in changed) <= 4, changed
        else:
            assert sum(max(len(c), 1) for c in changed) <= 3, (a, changed)


# ---------------------------------------------------------------------------
# the windowed round loop's telemetry against the JAX package's
# ---------------------------------------------------------------------------

def _fixture(seed, n=3000, f=8, nb=100):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, nb - 1, (n, f)).astype(np.int16)
    y = (4.0 * (bins[:, 0] > 50) + 2.0 * (bins[:, 1] > 30) + 1.0 * (bins[:, 2] > 70)
         + 0.5 * (bins[:, 3] > 20) * (bins[:, 0] > 50) + 0.05 * rng.randn(n))
    return (bins, (-y).astype(np.float32), (0.5 + 0.5 * rng.rand(n)).astype(np.float32),
            np.ones(n, bool), np.ones(n, np.float32), np.ones(f, bool),
            np.full(f, nb, np.int32), np.full(f, -1, np.int32))


def _rounds(spans):
    """(rows, admitted) of every resolved round, the trailing no-op rounds
    (nothing admitted) cut off, and how many there were."""
    seq = [(sp["attrs"]["rows"], sp["attrs"]["k_acc"]) for sp in spans]
    n = len(seq)
    while seq and seq[-1] == (0, 0):
        seq.pop()
    return seq, n - len(seq)


@pytest.mark.parametrize("num_leaves,tile", [(31, 8), (15, 4), (63, 16)])
def test_windowed_telemetry_equals_the_jax_package(num_leaves, tile):
    """The same trees grow on both sides (the fixture's gains are
    separated), so the round loops resolve the same rounds: the same rows
    and admissions round by round (the windowed_round spans and the
    train_window_rows histogram), the same retries.  Where a tree ends
    because nothing more is admissible, the JAX loop resolves two no-op
    rounds (the one that admitted nothing, and the one in flight) and the
    port's one: its round info carries what the next round admits, so it
    stops a launch earlier; train_windowed_rounds_total differs by that."""
    fx = _fixture(num_leaves + tile)
    kw = dict(num_leaves=num_leaves, num_bins=100, leaf_tile=tile)
    p = dict(min_data_in_leaf=20, lambda_l2=1.0)
    from lightgbm_tpu.obs import trace as jtrc

    jobs.reset()
    jtrc.reset_trace()
    bins, *rest = fx
    jt, _ = jwin.grow_tree_windowed(jnp.asarray(bins.T), *map(jnp.asarray, rest),
                                    use_pallas=False, megakernel_opt="0",
                                    params=JParams(**p), **kw)
    stats = {}
    tt, _ = twin.grow_tree_windowed(*[torch.from_numpy(a) for a in fx],
                                    params=TParams(**p), megakernel_opt="0",
                                    stats=stats, **kw)
    assert int(tt.num_leaves) == int(jt.num_leaves) > 8
    (jseq, jnoop), (tseq, tnoop) = (_rounds(jtrc.spans("windowed_round")),
                                    _rounds(trc.spans("windowed_round")))
    assert tseq == jseq and tnoop <= jnoop <= tnoop + 1
    jc, tc = jobs.snapshot(), obs.snapshot()
    assert (tc["counters"]["train_windowed_rounds_total"]
            == jc["counters"]["train_windowed_rounds_total"] - (jnoop - tnoop)
            == stats["rounds"])
    assert (tc["counters"]["train_windowed_retries_total"]
            == jc["counters"]["train_windowed_retries_total"] == 0)
    for name in ("train_window_rows",):
        assert tc["histograms"][name]["sum"] == jc["histograms"][name]["sum"]
        assert tc["histograms"][name]["max"] == jc["histograms"][name]["max"]
    assert len(trc.spans("windowed_tree")) == 1
    assert obs.events("windowed_tree")[0]["rounds"] == stats["rounds"]
    jobs.reset()
    jtrc.reset_trace()


def test_megakernel_counters():
    fx = [torch.from_numpy(a) for a in _fixture(5, n=1500)]
    kw = dict(num_leaves=15, num_bins=100, leaf_tile=8, params=TParams(min_data_in_leaf=20))
    twin.grow_tree_windowed(*fx, megakernel_opt="1", **kw)
    assert obs.counter("train_megakernel_trees_total").value == 1
    assert obs.counter("megakernel_envelope_fallbacks_total").value == 0
    twin.megakernel_mode(False, efb=True, mode="1")
    assert obs.counter("megakernel_envelope_fallbacks_total").value == 1
    assert obs.events("megakernel_fallback")[0]["reason"] == "efb"


# ---------------------------------------------------------------------------
# train(): metrics_file, trace_file, metrics_port, spans and heartbeat
# ---------------------------------------------------------------------------

def _data(n=1500, f=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    return X, (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] > 0).astype(float)


def test_train_writes_metrics_and_trace_files_and_serves_the_endpoint(tmp_path):
    X, y = _data()
    mf, tf = str(tmp_path / "metrics.json"), str(tmp_path / "trace.json")
    p = {"objective": "binary", "num_leaves": 7, "metrics_file": mf, "trace_file": tf,
         "metrics_port": 0, **CPU}
    seen = {}

    def scrape(env):
        if env.iteration == 1:
            server = srv.get_server()
            seen["prom"] = urllib.request.urlopen(server.url("/metrics"),
                                                  timeout=10).read().decode()
            seen["done"] = obs.gauge("heartbeat_done").value

    bst = tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 4, callbacks=[scrape])
    assert bst.num_trees() == 4
    snap = json.load(open(mf))
    assert snap["counters"]["train_boost_rounds_total"] == 4
    assert snap["counters"]["device_host_syncs_total"] >= 4  # C9: one an iteration
    assert snap["gauges"]["heartbeat_done"] == 1.0 and seen["done"] == 0.0
    assert "lgbmtpu_train_boost_rounds_total" in seen["prom"]
    names = [e["name"] for e in json.load(open(tf))["traceEvents"] if e.get("ph") == "X"]
    assert names.count("boost_round") == 4 and names.count("train") == 1
    ev = obs.events("boost_round")
    assert [e["iteration"] for e in ev] == [0, 1, 2, 3]
    assert all(e["host_syncs"] == 1 for e in ev)  # the strict path's one read


def test_telemetry_false_disables_the_registry(tmp_path):
    X, y = _data()
    mf = str(tmp_path / "m.json")
    p = {"objective": "binary", "num_leaves": 7, "telemetry": False, "metrics_file": mf,
         **CPU}
    try:
        tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 2)
        assert not obs.enabled() and not os.path.exists(mf)
        assert obs.counter("train_boost_rounds_total").value == 0
    finally:
        obs.set_enabled(True)


# ---------------------------------------------------------------------------
# utils/profiling.py, the sanitizer, the lock tracer
# ---------------------------------------------------------------------------

def test_profiling_spans_timers_and_device_trace(tmp_path):
    with profiling.timed_section("fit", sync=True):
        torch.ones(4).sum()
    assert obs.histogram(f"{obs.SECTION_PREFIX}fit").count == 1
    assert trc.spans("fit")
    assert set(profiling.log_timings()) == {"fit"}
    assert obs.histogram(f"{obs.SECTION_PREFIX}fit").count == 0  # reset
    t = profiling.DeviceTimer().start()
    t.stop()
    assert t.elapsed_ms() >= 0.0
    assert not trc.mirror_active()  # no profiler recording: nothing entered
    with profiling.device_trace(str(tmp_path / "prof")):
        assert trc.mirror_active()
        with trc.span("boost_round", iteration=3):
            torch.ones(8) * 2
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    notes = [e for e in events if e.get("cat") == "user_annotation"]
    assert [e["name"] for e in notes] == ["boost_round"]
    assert trc.spans("boost_round")[-1]["attrs"] == {"iteration": 3}


def test_sanitizer_collector_and_round_budget():
    with san.DispatchCounter() as d:
        san.record_predict()
        san.sync_pull(torch.ones(3))
    assert (d.predicts, d.host_syncs) == (1, 1)
    d.assert_round_budget(1, syncs_per_round=1)
    with pytest.raises(san.BudgetError):
        d.assert_round_budget(2)
    c = obs.snapshot()["counters"]
    assert c["device_dispatches_total"] >= 1 and c["device_host_syncs_total"] >= 1
    buf = torch.zeros(8)
    assert np.array_equal(san.sync_pull(torch.arange(3.0), out=buf), [0.0, 1.0, 2.0])


def test_port_lock_tracer_is_its_own_and_catches_an_inversion():
    lt.reset()
    lt.enable(True, strict=True)
    try:
        a, b = lt.lock("test.a"), lt.lock("test.b")
        with a, b:
            pass
        with pytest.raises(lt.LockOrderError):
            with b, a:
                pass
    finally:
        lt.enable(False)
        lt.reset()
    from lightgbm_tpu.utils import locktrace as jlt

    assert jlt is not lt and jlt.enabled()  # tests/conftest.py arms the JAX one


def test_threads_record_into_one_registry():
    def work():
        for _ in range(200):
            obs.counter("t_total").inc()

    ts = [threading.Thread(target=work) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert obs.counter("t_total").value == 800
