"""lightgbm_tpu_torch stands alone: it imports neither JAX nor the JAX
package, never trains quietly on the CPU when it was asked for the card,
and on CPU tensors takes only the plain histogram versions."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.ops import hist_cuda

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "lightgbm_tpu_torch"


def test_import_pulls_in_no_jax():
    code = ("import sys, lightgbm_tpu_torch, lightgbm_tpu_torch.convert; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'lightgbm_tpu' or "
            "m.startswith('lightgbm_tpu.')); print(bad); sys.exit(1 if bad else 0)")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_reference_no_jax():
    pat = re.compile(r"^\s*(import jax|from jax\b)|\blightgbm_tpu(?!_torch)(\.|\s+import)",
                     re.M)
    files = sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    hits = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
            for p in files for m in pat.finditer(p.read_text())]
    assert not hits, hits


def _small():
    rng = np.random.RandomState(0)
    X = rng.randn(300, 4)
    return X, (X[:, 0] > 0).astype(float)


@pytest.mark.parametrize("device_type", [None, "cuda", "gpu"])
def test_no_card_raises_instead_of_cpu(monkeypatch, device_type):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _small()
    params = {"objective": "binary", "verbosity": -1}
    if device_type is not None:
        params["device_type"] = device_type
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tlgb.Dataset(X, label=y, params=params).construct()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tlgb.train(params, tlgb.Dataset(X, label=y), 1)


def test_unknown_device_type_rejected():
    X, y = _small()
    with pytest.raises(ValueError, match="device_type"):
        tlgb.train({"device_type": "tpu", "verbosity": -1},
                   tlgb.Dataset(X, label=y), 1)


def test_cpu_training_never_counts_a_launch():
    hist_cuda.reset_counts()
    X, y = _small()
    p = {"objective": "binary", "device_type": "cpu", "verbosity": -1,
         "num_leaves": 4, "min_data_in_leaf": 5}
    tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 2)
    assert hist_cuda.launches == {"histogram_multi": 0,
                                  "histogram_multi_quantized": 0}
    assert hist_cuda.plain_calls["histogram_multi"] >= 2


def test_wrappers_have_no_fallback():
    """The kernel wrappers branch on the tensor's device alone: no try/except
    that could turn a failed build or launch into the plain path."""
    src = (PORT / "ops" / "hist_cuda.py").read_text()
    assert "except" not in src
    assert "run_with_fallback" not in "".join(
        p.read_text() for p in PORT.rglob("*.py"))
