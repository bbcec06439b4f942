"""Fault C21: the port's CPU trainings do not depend on MKL's code path.

torch's CPU exp (and log2) call MKL's vector math, whose code path MKL
picks per process at run time; a loaded host gave one process another path
than its neighbour, and the trees parted in the last bits (C21: 6 of 42
resumed distributed launches, one serial run).  MKL_CBWR pins that path
for a process, so two processes with two paths reproduce the fault
deterministically: the objectives take numpy's exp and log2 (in float64,
rounded) on the CPU (objectives.py::_host_exact), and the models must
agree bit for bit.
"""

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

import lightgbm_tpu_torch as tlgb
import chip_smoke

ROOT = Path(__file__).resolve().parent.parent
PATHS = ("COMPATIBLE", "AVX2")
BASE = {"objective": "binary", "max_bin": 255, "num_leaves": 31, "learning_rate": 0.1,
        "seed": 7, "device_type": "cpu", "verbosity": -1}
# the C21 fixture (chip_smoke.higgs_like(6000, 1)), cut to 3,000 rows
CASES = {
    "binary strict": ({}, 6),
    "binary rounds": ({"tree_growth_mode": "rounds"}, 3),
    "poisson": ({"objective": "poisson"}, 3),
    "lambdarank": ({"objective": "lambdarank", "num_leaves": 15}, 2),
}
SCRIPT = r'''
import hashlib, json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
torch.set_num_threads(2)
import chip_smoke
import lightgbm_tpu_torch as lgb
cases, base = json.loads(sys.argv[2]), json.loads(sys.argv[3])
X, y = chip_smoke.higgs_like(3000, 1)
out = {}
for name, (extra, rounds) in cases.items():
    p = {**base, **extra}
    label = (np.round(np.abs(np.nan_to_num(X[:, 21])) * 2)
             if p["objective"] == "poisson" else y)
    kw = {"group": np.full(30, 100)} if p["objective"] == "lambdarank" else {}
    b = lgb.train(p, lgb.Dataset(X, label=label, params=p, **kw), rounds)
    out[name] = hashlib.sha256(b.model_to_string().encode()).hexdigest()
print(json.dumps(out))
'''


def _shas(cbwr: str):
    env = {**os.environ, "MKL_CBWR": cbwr}
    return subprocess.Popen([sys.executable, "-c", SCRIPT, str(ROOT), json.dumps(CASES),
                             json.dumps(BASE)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def test_cpu_models_do_not_depend_on_mkls_code_path():
    """The same trainings in two processes, MKL pinned to two code paths
    (MKL_CBWR), give the same model texts: the strict and rounds growers,
    a log-link objective and LambdaRank's lambdas."""
    procs = [_shas(c) for c in PATHS]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
    got = [json.loads(o[0].strip().splitlines()[-1]) for o in outs]
    assert got[0] == got[1]
    assert set(got[0]) == set(CASES)


def test_objectives_exp_is_numpys_on_the_cpu():
    """The binary gradient's exp on the CPU is numpy's float64 exp rounded
    to float32, element for element (the last bits that MKL's paths part
    on)."""
    import torch

    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.objectives import create_objective

    rng = np.random.RandomState(0)
    score = (rng.randn(20_000) * 0.3 + 0.12).astype(np.float32)
    label = (rng.rand(20_000) < 0.5).astype(np.float32)
    g, h = create_objective(Config.from_dict({"objective": "binary"})).get_gradients(
        torch.from_numpy(score), torch.from_numpy(label), None)
    y = np.where(label > 0, np.float32(1), np.float32(-1))
    e = np.exp((y * np.float32(1) * score).astype(np.float64)).astype(np.float32)
    resp = -y * np.float32(1) / (np.float32(1) + e)
    np.testing.assert_array_equal(g.numpy(), resp)
    np.testing.assert_array_equal(h.numpy(), np.abs(resp) * (np.float32(1) - np.abs(resp)))


def test_resumed_strict_data_parallel_launch_is_the_serial_run():
    """C21's own shape: tree_learner=data on the strict grower over 2 gloo
    ranks pinned to another MKL code path than this process, rank 1 killed
    at iteration 7 and the fleet resumed from round 6, ends on this
    process's serial model bit for bit."""
    from lightgbm_tpu_torch.parallel.launcher import train_distributed

    X, y = chip_smoke.higgs_like(3000, 1)
    p = {**BASE, "tree_learner": "data", "snapshot_freq": 3}
    bst, paths = train_distributed(
        p, X, y, 10, num_machines=2, timeout_s=85, max_restarts=1,
        restart_backoff_s=0.2,
        env_extra={"MKL_CBWR": "COMPATIBLE", "LGBMTPU_FAULT": "worker_death:1:7"})
    events = [json.loads(line) for line in open(bst._fleet_events) if line.strip()]
    assert [e.get("round") for e in events if e["kind"] == "fleet_resume"][-1] == 6
    texts = [Path(q).read_text() for q in paths]
    serial = tlgb.train(BASE, tlgb.Dataset(X, label=y, params=BASE), 10)
    want = serial.model_to_string()
    for t in texts:
        got = t.replace("[tree_learner: data]", "[tree_learner: serial]")
        assert hashlib.sha256(got.encode()).hexdigest() == \
            hashlib.sha256(want.encode()).hexdigest()
