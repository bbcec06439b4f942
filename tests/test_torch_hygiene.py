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


def test_runtime_subpackages_import_no_jax():
    """obs/, serve/, parallel/ (the 2-D and hierarchical meshes too), the
    runtime utilities (copies of the JAX package's stdlib modules, and the
    torch rewrites beside them), dask.py, cli.py and plotting.py import
    neither JAX nor the JAX package, and the source scan above reads every
    file of theirs."""
    mods = ["lightgbm_tpu_torch.obs", "lightgbm_tpu_torch.obs.__main__",
            "lightgbm_tpu_torch.serve", "lightgbm_tpu_torch.serve.fleet",
            "lightgbm_tpu_torch.serve.runtime", "lightgbm_tpu_torch.utils.checkpoint",
            "lightgbm_tpu_torch.utils.faults", "lightgbm_tpu_torch.utils.locktrace",
            "lightgbm_tpu_torch.utils.profiling", "lightgbm_tpu_torch.parallel.mesh",
            "lightgbm_tpu_torch.parallel.collectives",
            "lightgbm_tpu_torch.parallel.distributed",
            "lightgbm_tpu_torch.parallel.data_parallel",
            "lightgbm_tpu_torch.parallel.feature_parallel",
            "lightgbm_tpu_torch.parallel.launcher",
            "lightgbm_tpu_torch.parallel.feature2d",
            "lightgbm_tpu_torch.parallel.hierarchy", "lightgbm_tpu_torch.dask",
            "lightgbm_tpu_torch.cli", "lightgbm_tpu_torch.plotting"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'lightgbm_tpu' or m.startswith('lightgbm_tpu.'))\n"
            "print(bad); sys.exit(1 if bad else 0)")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    scanned = {p.relative_to(PORT).parts[0] for p in PORT.rglob("*.py")}
    assert {"obs", "serve", "utils", "parallel"} <= scanned
    assert len(list((PORT / "obs").glob("*.py"))) == 5
    assert len(list((PORT / "serve").glob("*.py"))) == 3
    assert len(list((PORT / "parallel").glob("*.py"))) == 9
    assert {"dask.py", "cli.py", "plotting.py", "__main__.py"} <= {
        p.name for p in PORT.glob("*.py")}


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
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tlgb.serve(None, dict(params), models={})


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
    # every mode's launch count, the lane and carried modes' too, stays 0
    assert {"histogram_multi", "histogram_multi_bf16",
            "histogram_multi_quantized"} <= set(hist_cuda.launches)
    assert hist_cuda.launches == dict.fromkeys(hist_cuda.launches, 0)
    assert hist_cuda.plain_calls["histogram_multi"] >= 2


def test_wrappers_have_no_fallback():
    """The kernel wrappers, their builder and the growers that call them
    branch on the tensor's device alone: no try/except that could turn a
    failed build or launch into the plain path."""
    for module in ("hist_cuda.py", "partition_cuda.py", "round_cuda.py",
                   "cuda_build.py", "partition.py", "treegrow_fast.py",
                   "treegrow_windowed.py", "graphs.py"):
        assert "except" not in (PORT / "ops" / module).read_text(), module
    assert "run_with_fallback" not in "".join(
        p.read_text() for p in PORT.rglob("*.py"))


def test_cpu_windowed_growth_never_counts_a_launch():
    """The windowed grower on CPU tensors, three-pass and megakernel: every
    kernel's plain version runs, no kernel launch is counted."""
    from lightgbm_tpu_torch.ops import partition_cuda, round_cuda
    from lightgbm_tpu_torch.ops.split import SplitParams
    from lightgbm_tpu_torch.ops.treegrow_windowed import grow_tree_windowed

    rng = np.random.RandomState(0)
    n, f = 600, 6
    bins = torch.from_numpy(rng.randint(0, 16, (n, f)).astype(np.int16))
    grad = torch.from_numpy(rng.randn(n).astype(np.float32))
    args = (bins, grad, torch.ones(n), torch.ones(n, dtype=torch.bool),
            torch.ones(n), torch.ones(f, dtype=torch.bool),
            torch.full((f,), 16, dtype=torch.int32),
            torch.full((f,), -1, dtype=torch.int32))
    for d in (hist_cuda, partition_cuda, round_cuda):
        d.reset_counts()
    for mode in ("0", "1"):
        grow_tree_windowed(*args, num_leaves=8, num_bins=16, leaf_tile=4,
                           params=SplitParams(min_data_in_leaf=5),
                           megakernel_opt=mode)
    for d in (hist_cuda, partition_cuda, round_cuda):
        assert not any(d.launches.values()), d.launches
    assert partition_cuda.plain_calls["partition_segments"] > 0
    assert round_cuda.plain_calls["round_megakernel"] > 0
    assert hist_cuda.plain_calls["histogram_multi"] > 0


def _c_declarations(text: str) -> dict:
    """name -> its parameter list with whitespace normalized, for every
    LGBM_* function a C header declares."""
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return {m.group(2): " ".join(m.group(3).split())
            for m in re.finditer(r"(int|const char\*)\s+(LGBM_\w+)\(((?:[^()]|\([^()]*\))*)\);",
                                 text)}


def test_c_api_forwards_to_the_port_with_the_jax_librarys_entry_points():
    """The port's C library embeds CPython and imports the port's
    capi_helpers, never the JAX package's; its header declares the JAX
    library's LGBM_* entry points with the same signatures, so a C host
    links against either."""
    capi = PORT / "csrc" / "capi"
    src = (capi / "lightgbm_tpu_torch_c_api.cpp").read_text()
    hdr = (capi / "lightgbm_tpu_torch_c_api.h").read_text()
    assert '"lightgbm_tpu_torch.capi_helpers"' in src
    assert '"lightgbm_tpu.' not in src + hdr
    ours = _c_declarations(hdr)
    assert ours == _c_declarations((ROOT / "src" / "capi" / "lightgbm_tpu_c_api.h")
                                   .read_text())
    assert len(ours) == 95 and "LGBM_NetworkInit" in ours
    # every declared entry point is defined in the source
    assert all(re.search(rf"\b{name}\(", src) for name in ours)
