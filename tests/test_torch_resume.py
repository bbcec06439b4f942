"""Snapshots and resume in lightgbm_tpu_torch (engine.train's
snapshot_freq, snapshot_keep, resume="auto" and init_model=<snapshot>, on
the copied utils/checkpoint.py), on the CPU.

The pin is the JAX package's (tests/test_resume.py): a run resumed from a
snapshot gives the uninterrupted run's model text, bitwise, on the strict
grower (the CPU's default) and on the rounds grower (the card's), for a
multiclass model too; the snapshot's training score is rebuilt from the
same f32 values the training added (engine._replay_scores).  Against the
JAX package: a snapshot either package writes verifies and loads in the
other (the trailers agree), and both resume to the same model on a fixture
with separated gains.  The faults host_crash and snapshot_write kill a
training in a subprocess, as the JAX package's tests do.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.utils import checkpoint as jckpt
from lightgbm_tpu_torch.basic import CorruptModelError
from lightgbm_tpu_torch.obs import metrics as obs
from lightgbm_tpu_torch.utils import checkpoint

from test_torch_runtime import assert_same_text

ROOT = Path(__file__).resolve().parent.parent
CPU = {"device_type": "cpu", "verbosity": -1}
PARAMS = {"objective": "binary", "num_leaves": 7, "learning_rate": 0.2, **CPU}


def _data(n=2000, f=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.randn(n) > 0).astype(float)
    return X, y


def _train(params, X, y, rounds, **kw):
    return tlgb.train(params, tlgb.Dataset(X, label=y, params=params), rounds, **kw)


@pytest.mark.parametrize("case", ["strict", "rounds", "multiclass", "l2_bagging"])
def test_resume_matches_uninterrupted_bitwise(tmp_path, case):
    X, y = _data()
    p = dict(PARAMS, num_leaves=15, tree_growth_mode="rounds" if case == "rounds"
             else "auto")
    if case == "multiclass":
        y = np.digitize(X[:, 0] + X[:, 1], [-1.0, 0.5]).astype(float)
        p.update(objective="multiclass", num_class=3)
    if case == "l2_bagging":
        y = X[:, 0] * 2.0 + np.sin(X[:, 1])
        p.update(objective="regression", bagging_fraction=0.7, bagging_freq=1,
                 feature_fraction=0.8)
    full = _train(p, X, y, 8)
    out = str(tmp_path / "m.txt")
    run = {**p, "snapshot_freq": 3, "output_model": out}
    _train(run, X, y, 5)  # "crashed" after iteration 5: snapshot 3 is the newest
    resumed = _train(run, X, y, 8, resume="auto")
    assert resumed.num_trees() == full.num_trees()
    assert resumed.model_to_string() == full.model_to_string()
    assert np.array_equal(resumed.predict(X), full.predict(X))
    # the resumed run continued the global numbering: 6, never 3 again
    assert [it for it, _ in checkpoint.snapshot_family(out)] == [6, 3]


def test_linear_tree_resume_replays_the_leaf_models(tmp_path):
    X, _ = _data(n=1500)
    y = X[:, 0] + 0.5 * X[:, 1] + 0.1 * X[:, 2]
    p = {**PARAMS, "objective": "regression", "linear_tree": True}
    full = _train(p, X, y, 6)
    out = str(tmp_path / "m.txt")
    _train({**p, "snapshot_freq": 3, "output_model": out}, X, y, 3)
    resumed = _train(p, X, y, 3, init_model=f"{out}.snapshot_iter_3")
    assert resumed.num_trees() == 6
    np.testing.assert_allclose(resumed.predict(X), full.predict(X), rtol=1e-5, atol=1e-5)


def test_resumed_model_matches_the_jax_package(tmp_path):
    """Both packages snapshot at 2, resume from it and finish 5 rounds:
    the same model text (numbers within 1e-5: the packages sum histograms
    in different orders), the same predictions within 1e-5."""
    X, y = _data(seed=3)
    y = (4.0 * (X[:, 0] > 0.3) + 2.0 * (X[:, 1] > -0.5) + X[:, 2] > 2.5).astype(float)
    jp = {"objective": "binary", "num_leaves": 7, "learning_rate": 0.2,
          "verbosity": -1, "min_data_in_leaf": 40}
    tp = {**jp, **CPU}
    texts = []
    for pkg, p in ((jlgb, jp), (tlgb, tp)):
        out = str(tmp_path / f"{pkg.__name__}.txt")
        run = {**p, "snapshot_freq": 2, "output_model": out}
        ds = (lambda: tlgb.Dataset(X, label=y, params=p)) if pkg is tlgb else (
            lambda: jlgb.Dataset(X, label=y))
        pkg.train(run, ds(), 3)
        bst = pkg.train(run, ds(), 5, resume="auto")
        assert bst.num_trees() == 5
        texts.append(bst.model_to_string())
    assert_same_text(texts[1], texts[0], tol=1e-5)


def test_snapshots_cross_between_the_packages(tmp_path):
    """A snapshot the port writes verifies with the JAX package's
    checkpoint reader and loads there; one the JAX package writes verifies
    and loads in the port, with the same init scores and trees."""
    X, y = _data(seed=4)
    out_t, out_j = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    tb = _train({**PARAMS, "snapshot_freq": 2, "output_model": out_t}, X, y, 2)
    snap_t = f"{out_t}.snapshot_iter_2"
    text, ok = jckpt.read_and_verify(snap_t)
    assert ok is True and "init_scores=" in text
    jb_from_t = jlgb.Booster(model_file=snap_t)
    np.testing.assert_allclose(jb_from_t.predict(X), tb.predict(X), rtol=1e-6, atol=1e-7)

    jp = {"objective": "binary", "num_leaves": 7, "learning_rate": 0.2, "verbosity": -1,
          "snapshot_freq": 2, "output_model": out_j}
    jb = jlgb.train(jp, jlgb.Dataset(X, label=y), 2)
    snap_j = f"{out_j}.snapshot_iter_2"
    assert checkpoint.verify_file(snap_j) is True
    tb_from_j = tlgb.Booster(model_file=snap_j, params=CPU)
    assert tb_from_j._gbdt.init_scores == jb._gbdt.init_scores
    np.testing.assert_allclose(tb_from_j.predict(X), jb.predict(X), rtol=1e-6, atol=1e-7)
    # and the port resumes from the JAX package's snapshot
    resumed = _train(PARAMS, X, y, 2, init_model=snap_j)
    assert resumed.num_trees() == 4


def test_snapshot_carries_a_trailer_and_loads_verified(tmp_path):
    X, y = _data(seed=5)
    out = str(tmp_path / "m.txt")
    bst = _train({**PARAMS, "snapshot_freq": 1, "output_model": out}, X, y, 2)
    snap = f"{out}.snapshot_iter_2"
    lines = open(snap).read().splitlines()
    assert lines[-1].startswith("# lgbm-tpu-checkpoint v1 sha256=")
    again = tlgb.Booster(model_file=snap, params=CPU)
    assert np.array_equal(again.predict(X), bst.predict(X))
    plain = str(tmp_path / "plain.txt")
    bst.save_model(plain)  # a plain model file has no trailer and loads
    assert np.array_equal(tlgb.Booster(model_file=plain, params=CPU).predict(X),
                          bst.predict(X))


def test_torn_snapshot_falls_back_to_an_older_valid_one(tmp_path):
    X, y = _data(seed=6)
    out = str(tmp_path / "m.txt")
    run = {**PARAMS, "snapshot_freq": 2, "output_model": out}
    _train(run, X, y, 6)  # snapshots 2, 4, 6 (6: a stale newer one)
    snap4 = f"{out}.snapshot_iter_4"
    text = open(snap4).read()
    open(snap4, "w").write(text[: len(text) // 2])
    with pytest.raises(CorruptModelError):
        tlgb.Booster(model_file=snap4, params=CPU)
    resumed = _train(PARAMS, X, y, 2, init_model=snap4)
    ref = _train(PARAMS, X, y, 2, init_model=f"{out}.snapshot_iter_2")
    assert resumed.num_trees() == 4  # from 2, never forward to 6
    assert resumed.model_to_string() == ref.model_to_string()
    assert obs.counter("checkpoint_fallbacks_total").value >= 1
    open(snap4, "wb").write(b"\xff\xfe\x00garbage" * 50)  # bit rot: not UTF-8
    assert _train(PARAMS, X, y, 2, init_model=snap4).num_trees() == 4


def test_no_valid_fallback_raises_and_a_pre_trailer_snapshot_loads(tmp_path):
    X, y = _data(seed=7)
    bst = _train(PARAMS, X, y, 2)
    torn = str(tmp_path / "t.txt.snapshot_iter_2")
    checkpoint.save_snapshot(torn, bst.model_to_string(raw_deltas=True), 2)
    text = open(torn).read()
    open(torn, "w").write(text[: len(text) // 3])
    with pytest.raises(CorruptModelError):
        _train(PARAMS, X, y, 1, init_model=torn)
    legacy = str(tmp_path / "old.txt.snapshot_iter_2")
    open(legacy, "w").write(bst.model_to_string())  # whole, without a trailer
    with pytest.raises(CorruptModelError):
        tlgb.Booster(model_file=legacy, params=CPU)
    assert _train(PARAMS, X, y, 2, init_model=legacy).num_trees() == 4


def test_auto_resume_skips_a_torn_newest_snapshot_and_starts_fresh(tmp_path):
    X, y = _data(seed=8)
    out = str(tmp_path / "m.txt")
    run = {**PARAMS, "snapshot_freq": 2, "output_model": out, "resume": "auto"}
    assert _train(run, X, y, 4).num_trees() == 4  # nothing to resume: fresh
    snap4 = f"{out}.snapshot_iter_4"
    text = open(snap4).read()
    open(snap4, "w").write(text[: int(len(text) * 0.6)])
    full = _train(PARAMS, X, y, 6)
    resumed = _train(run, X, y, 6)  # from 2, four more
    assert resumed.model_to_string() == full.model_to_string()
    assert _train(run, X, y, 2).num_trees() == 2  # the target reached already


def test_snapshot_keep_prunes_the_oldest(tmp_path):
    X, y = _data(seed=9)
    out = str(tmp_path / "m.txt")
    run = {**PARAMS, "snapshot_freq": 1, "snapshot_keep": 2, "output_model": out}
    _train(run, X, y, 5)
    assert [it for it, _ in checkpoint.snapshot_family(out)] == [5, 4]
    assert _train(run, X, y, 6, resume="auto").num_trees() == 6


def test_resume_modes_the_port_refuses(tmp_path):
    X, y = _data(n=300, seed=10)
    with pytest.raises(tlgb.LightGBMError, match="not supported"):
        _train(PARAMS, X, y, 2, resume="latest")
    manifest = tmp_path / "fleet.json"
    manifest.write_text("{}")
    with pytest.raises(NotImplementedError, match="A13"):
        _train(PARAMS, X, y, 2, resume=str(manifest))


_CRASH = """
import sys
import numpy as np
sys.path.insert(0, {repo!r})
import lightgbm_tpu_torch as lgb

rng = np.random.RandomState(0)
X = rng.randn(2000, 5)
y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.randn(2000) > 0).astype(float)
p = {{"objective": "binary", "num_leaves": 7, "learning_rate": 0.2,
     "device_type": "cpu", "verbosity": -1, "snapshot_freq": 2,
     "output_model": {out!r}}}
lgb.train(p, lgb.Dataset(X, label=y, params=p), 6)
print("COMPLETED_WITHOUT_FAULT", flush=True)
"""


def _crashing_train(tmp_path, fault):
    out = str(tmp_path / "m.txt")
    env = {**os.environ, "LGBMTPU_FAULT": fault}
    env.pop("PYTEST_CURRENT_TEST", None)
    r = subprocess.run([sys.executable, "-c", _CRASH.format(repo=str(ROOT), out=out)],
                       env=env, capture_output=True, text=True, timeout=300)
    return out, r


@pytest.mark.parametrize("fault", ["host_crash:4", "snapshot_write:4"])
def test_a_killed_training_resumes_to_the_uninterrupted_model(tmp_path, fault):
    """host_crash kills the process at the start of iteration 4,
    snapshot_write in the middle of snapshot 4's write: snapshot 2 is the
    newest valid one, no torn snapshot survives, and resume="auto" gives
    the uninterrupted 6-round model text."""
    from lightgbm_tpu_torch.utils.faults import CRASH_EXIT_CODE

    out, r = _crashing_train(tmp_path, fault)
    assert r.returncode == CRASH_EXIT_CODE, (r.stdout, r.stderr)
    assert "COMPLETED_WITHOUT_FAULT" not in r.stdout
    for _it, snap in checkpoint.snapshot_family(out):
        assert checkpoint.verify_file(snap) is True
    assert checkpoint.latest_valid_snapshot(out)[0] == 2
    X, y = _data()
    run = {**PARAMS, "snapshot_freq": 2, "output_model": out}
    resumed = _train(run, X, y, 6, resume="auto")
    assert resumed.model_to_string() == _train(PARAMS, X, y, 6).model_to_string()
