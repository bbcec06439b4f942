"""Fleet recovery of lightgbm_tpu_torch: coordinated fleet checkpoints
(utils/checkpoint.py: rank 0's snapshot and manifest, every other rank's
acknowledgement), engine.train's ``resume=<fleet manifest>``, and the
launcher's relaunch, hang and slice-granular recovery
(parallel/launcher.py).  The port's mirror of tests/test_fleet_recovery.py
and tests/test_launcher.py's recovery cases.

Bars.  A resumed fleet's final model text is the uninterrupted run's bit
for bit (the serial model's trees: the merge is exact).  The launcher
cases are held on their events and exit codes, not on timing: where the
round a respawned slice resumes from depends on how far the surviving
slice had got, only its being a round the survivors confirmed is
asserted, and the model is bitwise either way.  Every launch runs under a
wall limit below 90 s.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.basic import LightGBMError
from lightgbm_tpu_torch.parallel import launcher
from lightgbm_tpu_torch.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = {"objective": "binary", "num_leaves": 8, "verbosity": -1, "min_data_in_leaf": 5,
          "device_type": "cpu"}
LIMIT_S = 85


def _data(n=400, f=5, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X @ rng.randn(f) > 0).astype(np.float64)
    return X, y


def _train(X, y, rounds, **kw):
    return tlgb.train(PARAMS, tlgb.Dataset(X, label=y, params=PARAMS), rounds, **kw)


_TEXTS = {}


def _model_text(rounds=2):
    if rounds not in _TEXTS:
        X, y = _data()
        _TEXTS[rounds] = _train(X, y, rounds).model_to_string(raw_deltas=True)
    return _TEXTS[rounds]


# ---------------------------------------------------------------------------
# the manifest protocol, simulated ranks
# ---------------------------------------------------------------------------
def test_manifest_schema_and_roundtrip(tmp_path):
    d, text = str(tmp_path), _model_text()
    mpath = ckpt.write_fleet_checkpoint(d, text, 4, 3, {"0": "fp0", "1": "fp1", "2": "fp2"})
    raw = json.load(open(mpath))
    assert raw["schema"] == "lgbmtpu-fleet-ckpt-v1"
    assert raw["round"] == 4 and raw["world_size"] == 3
    assert raw["ensemble_sha256"] == ckpt.ensemble_digest(text)
    assert raw["shards"] == {"0": "fp0", "1": "fp1", "2": "fp2"}
    assert ckpt.verify_file(ckpt.fleet_snapshot_path(d, 4)) is True


def test_unconfirmed_round_is_not_fleet_valid(tmp_path):
    d, text = str(tmp_path), _model_text()
    mpath = ckpt.write_fleet_checkpoint(d, text, 2, 3, {})
    assert ckpt.fleet_manifest_valid(mpath) is None
    ckpt.confirm_fleet_checkpoint(d, 2, 1, text)
    assert ckpt.fleet_manifest_valid(mpath) is None
    ckpt.confirm_fleet_checkpoint(d, 2, 2, text)
    assert ckpt.fleet_manifest_valid(mpath)["round"] == 2
    assert ckpt.latest_valid_fleet_manifest(d, 3)[0] == 2
    assert ckpt.fleet_manifest_valid(mpath, world_size=2) is None


def test_diverged_ack_torn_manifest_and_torn_snapshot_are_refused(tmp_path):
    d, text = str(tmp_path), _model_text()
    mpath = ckpt.write_fleet_checkpoint(d, text, 2, 2, {})
    ckpt.confirm_fleet_checkpoint(d, 2, 1, text + "# divergent\n")
    assert ckpt.fleet_manifest_valid(mpath) is None
    ckpt.confirm_fleet_checkpoint(d, 2, 1, text)
    assert ckpt.fleet_manifest_valid(mpath) is not None
    spath = ckpt.fleet_snapshot_path(d, 2)
    snap = open(spath).read()
    open(spath, "w").write(snap[: len(snap) // 2])
    assert ckpt.fleet_manifest_valid(mpath) is None
    open(spath, "w").write(snap)
    mtext = open(mpath).read()
    open(mpath, "w").write(mtext[: len(mtext) // 2])
    assert ckpt.fleet_manifest_valid(mpath) is None
    assert ckpt.latest_valid_fleet_manifest(d, 2) is None


def test_latest_valid_skips_a_torn_round_and_retention_keeps_it(tmp_path):
    d = str(tmp_path)
    for k in (2, 4, 6):
        ckpt.write_fleet_checkpoint(d, _model_text(k), k, 1, {})
    os.unlink(ckpt.fleet_manifest_path(d, 6))  # crashed before the publish
    assert ckpt.latest_valid_fleet_manifest(d, 1)[0] == 4
    assert 4 not in ckpt.prune_fleet_checkpoints(d, keep=1)
    assert ckpt.latest_valid_fleet_manifest(d, 1)[0] == 4


def test_slice_valid_manifest_excludes_lost_ranks(tmp_path):
    d, text2, text4 = str(tmp_path), _model_text(2), _model_text(4)
    slices = {"0": 0, "1": 0, "2": 1, "3": 1}
    ckpt.write_fleet_checkpoint(d, text2, 2, 4, {}, slices=slices)
    for r in (1, 2, 3):
        ckpt.confirm_fleet_checkpoint(d, 2, r, text2)
    ckpt.write_fleet_checkpoint(d, text4, 4, 4, {}, slices=slices)
    ckpt.confirm_fleet_checkpoint(d, 4, 1, text4)
    assert ckpt.latest_valid_fleet_manifest(d, 4)[0] == 2
    assert ckpt.latest_slice_valid_fleet_manifest(d, 4, (2, 3))[0] == 4
    assert ckpt.latest_slice_valid_fleet_manifest(d, 4, (3,))[0] == 2
    ckpt.confirm_fleet_checkpoint(d, 4, 3, text4 + "# fork\n")
    assert ckpt.latest_slice_valid_fleet_manifest(d, 4, (2, 3))[0] == 2


# ---------------------------------------------------------------------------
# engine.train(resume=<manifest>)
# ---------------------------------------------------------------------------
def test_engine_refuses_unconfirmed_diverged_resharded_overshooting_and_torn(tmp_path,
                                                                         monkeypatch):
    d = str(tmp_path)
    X, y = _data()
    text = _model_text()
    mpath = ckpt.write_fleet_checkpoint(d, text, 2, 2, {"0": "fp-original"})
    with pytest.raises(LightGBMError, match="not fleet-valid"):
        _train(X, y, 6, resume=mpath)
    ckpt.confirm_fleet_checkpoint(d, 2, 1, text + "# diverged\n")
    with pytest.raises(LightGBMError, match="not fleet-valid"):
        _train(X, y, 6, resume=mpath)
    ckpt.confirm_fleet_checkpoint(d, 2, 1, text)
    monkeypatch.setenv("LIGHTGBM_TPU_RANK", "0")
    monkeypatch.setenv("LGBMTPU_SHARD_FINGERPRINT", "fp-changed")
    with pytest.raises(LightGBMError, match="fingerprint"):
        _train(X, y, 6, resume=mpath)
    monkeypatch.setenv("LGBMTPU_SHARD_FINGERPRINT", "fp-original")
    with pytest.raises(LightGBMError, match="beyond the requested"):
        _train(X, y, 1, resume=mpath)
    assert _train(X, y, 6, resume=mpath).num_trees() == 6
    # a respawned slice's manifest: the lost rank's ack is not required
    mpath3 = ckpt.write_fleet_checkpoint(d, _model_text(4), 4, 3, {})
    ckpt.confirm_fleet_checkpoint(d, 4, 1, _model_text(4))
    with pytest.raises(LightGBMError, match="not fleet-valid"):
        _train(X, y, 6, resume=mpath3)
    monkeypatch.setenv("LGBMTPU_RESUME_EXCLUDE_RANKS", "2")
    assert _train(X, y, 6, resume=mpath3).num_trees() == 6
    open(mpath3, "w").write("{")
    with pytest.raises(LightGBMError, match="not fleet-valid"):
        _train(X, y, 6, resume=mpath3)


def test_manifest_resume_is_bitwise_and_emits_fleet_resume(tmp_path):
    from lightgbm_tpu_torch.obs import metrics as obs

    d = str(tmp_path)
    X, y = _data()
    full = _train(X, y, 6)

    def cb(env):
        it = env.model.current_iteration()
        if it % 2 == 0:
            ckpt.write_fleet_checkpoint(d, env.model.model_to_string(raw_deltas=True),
                                        it, 1, {})
    cb.order = 100
    _train(X, y, 2, callbacks=[cb])
    before = obs.counter("fleet_resumes_total").value
    resumed = _train(X, y, 6, resume=ckpt.fleet_manifest_path(d, 2), callbacks=[cb])
    assert resumed.model_to_string() == full.model_to_string()
    assert ckpt.latest_valid_fleet_manifest(d, 1)[0] == 6  # the global numbering
    assert obs.counter("fleet_resumes_total").value == before + 1
    ev = [e for e in obs.events() if e["kind"] == "fleet_resume"]
    assert ev and ev[-1]["round"] == 2


_MANIFEST_CRASH = """
import sys
import numpy as np
sys.path.insert(0, {repo!r})
import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.utils import checkpoint as ckpt

rng = np.random.RandomState(3)
X = rng.randn(400, 5)
y = (X @ rng.randn(5) > 0).astype(np.float64)

def cb(env):
    it = env.model.current_iteration()
    if it % 2 == 0:
        ckpt.write_fleet_checkpoint({d!r}, env.model.model_to_string(raw_deltas=True),
                                    it, 1, {{}})
cb.order = 100
lgb.train({params!r}, lgb.Dataset(X, label=y, params={params!r}), 6, callbacks=[cb])
print("COMPLETED_WITHOUT_FAULT", flush=True)
"""


def test_manifest_write_crash_leaves_the_previous_round_authoritative(tmp_path):
    from lightgbm_tpu_torch.utils.faults import CRASH_EXIT_CODE

    d = str(tmp_path)
    env = dict(os.environ, LGBMTPU_FAULT="manifest_write:4")
    env.pop("PYTEST_CURRENT_TEST", None)
    r = subprocess.run([sys.executable, "-c", _MANIFEST_CRASH.format(
        repo=REPO, d=d, params=PARAMS)], env=env, capture_output=True, text=True,
        timeout=120)
    assert r.returncode == CRASH_EXIT_CODE, (r.stdout, r.stderr)
    assert os.path.exists(ckpt.fleet_snapshot_path(d, 4))
    assert not os.path.exists(ckpt.fleet_manifest_path(d, 4))
    found = ckpt.latest_valid_fleet_manifest(d, 1)
    assert found is not None and found[0] == 2
    X, y = _data()
    assert (_train(X, y, 6, resume=found[1]).model_to_string()
            == _train(X, y, 6).model_to_string())


# ---------------------------------------------------------------------------
# the launcher's recovery
# ---------------------------------------------------------------------------
def _events(tmp):
    with open(os.path.join(tmp, "fleet_events.jsonl"), encoding="utf-8") as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _trees(text: str) -> str:
    return text[text.index("Tree=0"):text.index("end of trees")]


def _fleet_params(X):
    return dict(PARAMS, bin_construct_sample_cnt=len(X), snapshot_freq=2,
                tree_growth_mode="rounds")


@pytest.fixture(scope="module")
def reference():
    X, y = _data(n=2000, f=6, seed=11)
    p = _fleet_params(X)
    return X, y, _trees(tlgb.train({k: v for k, v in p.items() if k != "snapshot_freq"},
                                   tlgb.Dataset(X, label=y, params=p), 6).model_to_string())


def test_worker_death_resumes_from_the_newest_fleet_valid_round_bitwise(monkeypatch,
                                                                       reference):
    """Rank 1 dies at the start of iteration 4 of 6 under max_restarts=1:
    the fleet relaunches from round 2's manifest (both ranks confirmed it)
    and both ranks end with the uninterrupted (serial) model's trees."""
    X, y, want = reference
    monkeypatch.setenv("LGBMTPU_FAULT", "worker_death:1:4")
    _, paths = launcher.train_distributed(
        {**_fleet_params(X), "tree_learner": "data"}, X, y, 6, num_machines=2,
        max_restarts=1, restart_backoff_s=0.1, timeout_s=LIMIT_S)
    texts = [open(p).read() for p in paths]
    assert texts[0] == texts[1] and _trees(texts[0]) == want
    ev = _events(launcher._LAST_LAUNCH_DIR)
    kinds = [e["kind"] for e in ev]
    assert kinds.count("worker_death") == 1 and kinds.count("fleet_relaunch") == 1
    resumes = [e for e in ev if e["kind"] == "fleet_resume"]
    assert resumes and all(e["round"] == 2 for e in resumes)
    assert [e["worker_rank"] for e in ev if e["kind"] == "worker_spawn"] == [0, 1, 0, 1]
    relaunch = max(e["ts"] for e in ev if e["kind"] == "fleet_relaunch")
    post = [e for e in ev if e["kind"] == "boost_round" and e["ts"] > relaunch]
    assert len(post) == 2 * 4  # each rank trained rounds 3-6 only


def test_hung_rank_is_detected_killed_and_resumed_bitwise(monkeypatch):
    """worker_hang: a rank that sleeps inside its round loop is caught by
    the heartbeat watchdog (its heartbeat seen to change, then stale past
    the timeout), killed, and the relaunch resumes bitwise.  The 100 rounds
    before the hang span several of the watchdog's 1 s reads (longer on a
    loaded host), so the heartbeat is seen to move whatever the load; the
    15 s timeout sits far above a loaded host's round (a fraction of a
    second), so only the hang trips it."""
    rng = np.random.RandomState(11)
    X = rng.randn(4000, 6)
    y = (X @ rng.randn(6) > 0).astype(float)
    p = dict(PARAMS, bin_construct_sample_cnt=len(X))
    want = _trees(tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 104).model_to_string())
    timeout = 15.0
    monkeypatch.setenv("LGBMTPU_FAULT", "worker_hang:0:101")
    _, paths = launcher.train_distributed(
        dict(p, snapshot_freq=10), X, y, 104, num_machines=1, max_restarts=1,
        restart_backoff_s=0.1, heartbeat_timeout_s=timeout, timeout_s=LIMIT_S,
        env_extra={"LGBMTPU_METRICS_SNAPSHOT_PERIOD_S": "0.1"})
    assert _trees(open(paths[0]).read()) == want
    ev = _events(launcher._LAST_LAUNCH_DIR)
    hangs = [e for e in ev if e["kind"] == "worker_hang"]
    assert len(hangs) == 1 and hangs[0]["worker_rank"] == 0
    assert hangs[0]["stale_s"] > timeout
    assert [e["round"] for e in ev if e["kind"] == "fleet_resume"] == [100, 100]
    assert any(e["kind"] == "fleet_relaunch" and e.get("hung") for e in ev)


def test_slice_granular_recovery_survivors_never_restart(monkeypatch, reference):
    """Two slices of one rank each, slice 1 lost at iteration 5: only slice
    1 is killed and respawned, from a round the survivor confirmed (or
    from scratch if it had confirmed none); slice 0's one process runs on
    (one spawn, its pid unchanged, no fleet relaunch); every model is the
    uninterrupted one bit for bit."""
    from lightgbm_tpu_torch.obs import metrics as obs

    X, y, want = reference
    monkeypatch.setenv("LGBMTPU_FAULT", "worker_death:1:5")
    c0 = obs.counter("fleet_slice_resumes_total").value
    try:
        _, paths = launcher.train_distributed(
            _fleet_params(X), X, y, 6, num_machines=2, num_slices=2, max_restarts=1,
            restart_backoff_s=0.1, timeout_s=LIMIT_S)
    finally:
        obs.unregister_collector("fleet_live")
    tmp = launcher._LAST_LAUNCH_DIR
    texts = [open(p).read() for p in paths]
    assert texts[0] == texts[1] and _trees(texts[0]) == want
    assert obs.counter("fleet_slice_resumes_total").value == c0 + 1
    ev = _events(tmp)
    kinds = [e["kind"] for e in ev]
    assert "fleet_relaunch" not in kinds
    assert [e["worker_rank"] for e in ev if e["kind"] == "worker_death"] == [1]
    (res,) = [e for e in ev if e["kind"] == "fleet_slice_resume"]
    assert res["slice"] == 1 and res["ranks"] == [1]
    assert res["round"] in (None, 2, 4, 6)
    spawns = [(e["worker_rank"], e["pid"]) for e in ev if e["kind"] == "worker_spawn"]
    assert [r for r, _ in spawns].count(0) == 1 and [r for r, _ in spawns].count(1) == 2
    exits = [e["worker_rank"] for e in ev if e["kind"] == "worker_exit"]
    assert sorted(exits) == [0, 1]
    found = ckpt.latest_valid_fleet_manifest(tmp, 2)
    assert found is not None and found[2]["slices"] == {"0": 0, "1": 1}
