"""The port's C API (lightgbm_tpu_torch/csrc/capi/, built by
native.c_api_library()) against the JAX package's Python API and the
port's own, on the CPU (device_type=cpu).

Mirrors tests/test_c_api.py case for case.  Each case drives the LGBM_*
surface through ctypes and holds the result twice: to the port's Python
API on the same inputs bit for bit (model text, predictions), and to the
JAX package's Python API at the parity bar (the same trees, leaf values
and predictions within TOL; test_torch_constraints.assert_same_models).
Besides: the per-call finish report against a JAX Booster with
_report_finish_every_iter, the no-fallback rule, and two gloo ranks
brought up through LGBM_NetworkInit training the serial model.
"""

import ctypes
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import native

from test_torch_constraints import TOL, assert_same_models

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device_type": "cpu"}


def load_lib():
    lib = ctypes.CDLL(native.c_api_library())
    lib.LGBM_GetLastError.restype = ctypes.c_char_p
    return lib


@pytest.fixture(scope="module")
def lib():
    return load_lib()


def check(rc, lib):
    assert rc == 0, lib.LGBM_GetLastError()


def model_string(lib, bh) -> str:
    """LGBM_BoosterSaveModelToString's size call, then its fill call."""
    need = ctypes.c_int64()
    check(lib.LGBM_BoosterSaveModelToString(bh, 0, -1, 0, ctypes.c_int64(0),
                                            ctypes.byref(need), None), lib)
    buf = ctypes.create_string_buffer(need.value)
    check(lib.LGBM_BoosterSaveModelToString(bh, 0, -1, 0, need, ctypes.byref(need),
                                            buf), lib)
    return buf.value.decode()


def params_bytes(params: dict) -> bytes:
    return " ".join(f"{k}={v}" for k, v in params.items()).encode()


def dense_handle(lib, X, y, params=None):
    """A Dataset from a row-major f64 matrix with its f32 labels set."""
    h = ctypes.c_void_p()
    Xc = np.ascontiguousarray(X, np.float64)
    check(lib.LGBM_DatasetCreateFromMat(
        Xc.ctypes.data_as(ctypes.c_void_p), 1, Xc.shape[0], Xc.shape[1], 1,
        params_bytes({"max_bin": 63, **CPU, **(params or {})}), None, ctypes.byref(h)),
        lib)
    yc = np.ascontiguousarray(y, np.float32)
    check(lib.LGBM_DatasetSetField(h, b"label", yc.ctypes.data_as(ctypes.c_void_p),
                                   len(yc), 0), lib)
    return h


def c_train(lib, ds_handle, params, iters):
    """LGBM_BoosterCreate + ``iters`` LGBM_BoosterUpdateOneIter: (handle,
    the is_finished flags)."""
    bh = ctypes.c_void_p()
    check(lib.LGBM_BoosterCreate(ds_handle, params_bytes({**params, **CPU}),
                                 ctypes.byref(bh)), lib)
    fin, flags = ctypes.c_int(), []
    for _ in range(iters):
        check(lib.LGBM_BoosterUpdateOneIter(bh, ctypes.byref(fin)), lib)
        flags.append(fin.value)
    return bh, flags


def py_pair(X, y, params, iters, dataset_params=None):
    """The same training through both packages' Python APIs (Booster +
    update, as the C API trains): (JAX booster, port booster)."""
    dp = {"max_bin": 63, **(dataset_params or {})}
    jb = jlgb.Booster(params=dict(params), train_set=jlgb.Dataset(X, label=y,
                                                                  params=dict(dp)))
    tb = tlgb.Booster(params={**params, **CPU},
                      train_set=tlgb.Dataset(X, label=y, params={**dp, **CPU}))
    for _ in range(iters):
        jb.update()
        tb.update()
    return jb, tb


def assert_jax_parity(jb, text: str, X):
    """A model text of the port's C API at the parity bar of the JAX
    booster ``jb``: both read back from their texts (the init score folded
    into the first tree, as the reference writes it)."""
    assert_same_models(jlgb.Booster(model_str=jb.model_to_string()),
                       tlgb.Booster(params=CPU, model_str=text), X)


def c_predict(lib, bh, X, predict_type=0):
    Xc = np.ascontiguousarray(X, np.float64)
    n = ctypes.c_int64()
    nt = ctypes.c_int()
    check(lib.LGBM_BoosterNumberOfTotalModel(bh, ctypes.byref(nt)), lib)
    out = np.zeros(len(X) * (nt.value if predict_type == 2 else 1)
                   * (X.shape[1] + 1 if predict_type == 3 else 1))
    check(lib.LGBM_BoosterPredictForMat(
        bh, Xc.ctypes.data_as(ctypes.c_void_p), 1, Xc.shape[0], Xc.shape[1], 1,
        predict_type, 0, -1, b"", ctypes.byref(n),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))), lib)
    return out[:n.value]


def test_c_api_roundtrip(tmp_path, lib):
    rng = np.random.RandomState(0)
    X = rng.randn(500, 4)
    y = ((X @ rng.randn(4)) > 0).astype(np.float64)
    jb, tb = py_pair(X, y, {"objective": "binary", "num_leaves": 7, "verbosity": -1}, 3)
    model_path = str(tmp_path / "m.txt")
    tb.save_model(model_path)
    expect = tb.predict(X)

    handle = ctypes.c_void_p()
    out_iters = ctypes.c_int()
    check(lib.LGBM_BoosterCreateFromModelfile(model_path.encode(),
                                              ctypes.byref(out_iters),
                                              ctypes.byref(handle)), lib)
    assert out_iters.value == 3
    ncls = ctypes.c_int()
    check(lib.LGBM_BoosterGetNumClasses(handle, ctypes.byref(ncls)), lib)
    assert ncls.value == 1

    out = c_predict(lib, handle, X)
    np.testing.assert_array_equal(out, expect)
    np.testing.assert_allclose(out, jb.predict(X), rtol=TOL, atol=TOL)

    # save through the C surface: the text the port's load + save writes
    out_path = str(tmp_path / "m2.txt")
    check(lib.LGBM_BoosterSaveModel(handle, 0, -1, 0, out_path.encode()), lib)
    loaded = tlgb.Booster(params=CPU, model_file=model_path)
    assert open(out_path).read() == loaded.model_to_string()
    np.testing.assert_array_equal(tlgb.Booster(params=CPU, model_file=out_path)
                                  .predict(X), expect)

    # error path: a bad file reports through LGBM_GetLastError
    h2 = ctypes.c_void_p()
    assert lib.LGBM_BoosterCreateFromModelfile(b"/nonexistent/model.txt",
                                               ctypes.byref(out_iters),
                                               ctypes.byref(h2)) == -1
    assert lib.LGBM_GetLastError()
    check(lib.LGBM_BoosterFree(handle), lib)


def test_c_api_training_workflow(lib):
    """Train from C: dataset from mat + label + booster create + update +
    eval + save to string, rollback, importance, reset_parameter and a
    custom-gradient update (reference: tests/c_api_test/test_.py)."""
    rng = np.random.RandomState(1)
    X = rng.randn(400, 5)
    y = ((X[:, 0] + X[:, 1]) > 0).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
              "metric": "binary_logloss"}
    ds = dense_handle(lib, X, y, {"min_data_in_leaf": 5})
    nd, nf = ctypes.c_int32(), ctypes.c_int32()
    check(lib.LGBM_DatasetGetNumData(ds, ctypes.byref(nd)), lib)
    check(lib.LGBM_DatasetGetNumFeature(ds, ctypes.byref(nf)), lib)
    assert (nd.value, nf.value) == (400, 5)

    bst, _ = c_train(lib, ds, params, 5)
    jb, tb = py_pair(X, y, params, 5, {"min_data_in_leaf": 5})
    text = model_string(lib, bst)
    assert text == tb.model_to_string()
    assert_jax_parity(jb, text, X)

    it = ctypes.c_int()
    check(lib.LGBM_BoosterGetCurrentIteration(bst, ctypes.byref(it)), lib)
    assert it.value == 5
    check(lib.LGBM_BoosterRollbackOneIter(bst), lib)
    tb.rollback_one_iter()
    check(lib.LGBM_BoosterGetCurrentIteration(bst, ctypes.byref(it)), lib)
    assert it.value == 4
    ntot, nfeat = ctypes.c_int(), ctypes.c_int()
    check(lib.LGBM_BoosterNumberOfTotalModel(bst, ctypes.byref(ntot)), lib)
    check(lib.LGBM_BoosterGetNumFeature(bst, ctypes.byref(nfeat)), lib)
    assert (ntot.value, nfeat.value) == (4, 5)

    # eval on the training set: the port's metric, bitwise
    cnt = ctypes.c_int()
    check(lib.LGBM_BoosterGetEvalCounts(bst, ctypes.byref(cnt)), lib)
    vals = np.zeros(cnt.value)
    out_len = ctypes.c_int()
    check(lib.LGBM_BoosterGetEval(bst, 0, ctypes.byref(out_len),
                                  vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double))),
          lib)
    assert out_len.value == cnt.value >= 1
    assert vals[0] == tb.eval_train()[0][2]
    assert 0 < vals[0] < 1.0

    imp = np.zeros(5)
    check(lib.LGBM_BoosterFeatureImportance(
        bst, 0, 0, imp.ctypes.data_as(ctypes.POINTER(ctypes.c_double))), lib)
    np.testing.assert_array_equal(imp, tb.feature_importance("split"))
    assert imp.sum() > 0

    check(lib.LGBM_BoosterResetParameter(bst, b"learning_rate=0.25"), lib)
    tb.reset_parameter({"learning_rate": 0.25})

    # custom objective update: the same gradients through both surfaces
    p = 1.0 / (1.0 + np.exp(-tb.predict(X, raw_score=True)))
    grad = np.ascontiguousarray((p - y).astype(np.float32))
    hess = np.ascontiguousarray((p * (1 - p)).astype(np.float32))
    fin = ctypes.c_int()
    check(lib.LGBM_BoosterUpdateOneIterCustom(
        bst, grad.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        hess.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctypes.byref(fin)), lib)
    tb._gbdt.train_one_iter(grad.astype(np.float64), hess.astype(np.float64))
    check(lib.LGBM_BoosterGetCurrentIteration(bst, ctypes.byref(it)), lib)
    assert it.value == 5
    assert model_string(lib, bst) == tb.model_to_string()
    check(lib.LGBM_BoosterFree(bst), lib)
    check(lib.LGBM_DatasetFree(ds), lib)


def test_c_api_push_rows_streaming(lib):
    """Streamed construction == bulk construction (reference:
    tests/cpp_tests/test_stream.cpp pattern)."""
    rng = np.random.RandomState(3)
    X = rng.randn(300, 4)
    y = (X[:, 0] > 0).astype(np.float64)
    ref = ctypes.c_void_p()
    Xc = np.ascontiguousarray(X)
    check(lib.LGBM_DatasetCreateFromMat(Xc.ctypes.data_as(ctypes.c_void_p), 1, 300, 4,
                                        1, b"max_bin=31 device_type=cpu", None,
                                        ctypes.byref(ref)), lib)
    ds = ctypes.c_void_p()
    check(lib.LGBM_DatasetCreateByReference(ref, ctypes.c_int64(300), ctypes.byref(ds)),
          lib)
    for s in (0, 100, 200):
        blk = np.ascontiguousarray(X[s:s + 100])
        check(lib.LGBM_DatasetPushRows(ds, blk.ctypes.data_as(ctypes.c_void_p), 1, 100,
                                       4, ctypes.c_int32(s)), lib)
    yc = y.astype(np.float32)
    check(lib.LGBM_DatasetSetField(ds, b"label", yc.ctypes.data_as(ctypes.c_void_p),
                                   300, 0), lib)
    nd = ctypes.c_int32()
    check(lib.LGBM_DatasetGetNumData(ds, ctypes.byref(nd)), lib)
    assert nd.value == 300
    # separated gains (the parity bar): min_gain_to_split keeps the splits
    # of gain ~0 out, on which the two packages' f32 sums pick different
    # features (ROADMAP C23)
    params = {"objective": "binary", "verbosity": -1, "num_leaves": 7,
              "min_gain_to_split": 1e-3}
    bst, _ = c_train(lib, ds, params, 3)
    streamed = model_string(lib, bst)

    # the model trained on the bulk dataset with the same parameters
    dp = {"max_bin": 31}
    t_ref = tlgb.Dataset(X, label=y, params={**dp, **CPU})
    tb = tlgb.train({**params, **dp, **CPU},
                    tlgb.Dataset(X, label=y, reference=t_ref, params={**dp, **CPU}), 3)
    j_ref = jlgb.Dataset(X, label=y, params=dict(dp))
    jb = jlgb.train({**params, **dp}, jlgb.Dataset(X, label=y, reference=j_ref,
                                                   params=dict(dp)), 3)
    loaded = tlgb.Booster(params=CPU, model_str=streamed)
    np.testing.assert_array_equal(loaded.predict(X), tb.predict(X))
    assert_jax_parity(jb, streamed, X)
    lib.LGBM_BoosterFree(bst)
    lib.LGBM_DatasetFree(ds)
    lib.LGBM_DatasetFree(ref)


def test_c_api_dump_model_json(lib):
    rng = np.random.RandomState(2)
    X = rng.randn(200, 3)
    y = (X[:, 0] > 0).astype(np.float64)
    ds = dense_handle(lib, X, y, {"max_bin": 31})
    # separated gains, as in test_c_api_push_rows_streaming
    params = {"objective": "binary", "verbosity": -1, "num_leaves": 7,
              "min_gain_to_split": 1e-3}
    bst, _ = c_train(lib, ds, params, 1)
    need = ctypes.c_int64()
    check(lib.LGBM_BoosterDumpModel(bst, 0, -1, 0, ctypes.c_int64(0), ctypes.byref(need),
                                    None), lib)
    buf = ctypes.create_string_buffer(need.value)
    check(lib.LGBM_BoosterDumpModel(bst, 0, -1, 0, need, ctypes.byref(need), buf), lib)
    model = json.loads(buf.value.decode())
    assert model["num_class"] == 1 and len(model["tree_info"]) == 1
    jb, tb = py_pair(X, y, params, 1, {"max_bin": 31})
    assert model == json.loads(json.dumps(tb.dump_model(), default=float))
    assert_jax_parity(jb, model_string(lib, bst), X)
    lib.LGBM_BoosterFree(bst)
    lib.LGBM_DatasetFree(ds)


def test_c_api_csr_and_single_row_fast(lib):
    sp = pytest.importorskip("scipy.sparse")
    rng = np.random.RandomState(1)
    Xd = rng.randn(600, 6)
    Xd[rng.rand(600, 6) < 0.6] = 0.0
    X = sp.csr_matrix(Xd)
    y = ((Xd @ rng.randn(6)) > 0).astype(np.float64)
    indptr = np.asarray(X.indptr, np.int32)
    indices = np.asarray(X.indices, np.int32)
    data = np.asarray(X.data, np.float64)

    dsh = ctypes.c_void_p()
    check(lib.LGBM_DatasetCreateFromCSR(
        indptr.ctypes.data_as(ctypes.c_void_p), 2, indices.ctypes.data_as(ctypes.c_void_p),
        data.ctypes.data_as(ctypes.c_void_p), 1, ctypes.c_int64(len(indptr)),
        ctypes.c_int64(len(data)), ctypes.c_int64(6), b"max_bin=63 device_type=cpu",
        None, ctypes.byref(dsh)), lib)
    yv = y.astype(np.float32)
    check(lib.LGBM_DatasetSetField(dsh, b"label", yv.ctypes.data_as(ctypes.c_void_p),
                                   len(yv), 0), lib)
    params = {"objective": "binary", "num_leaves": 7, "verbosity": -1}
    bh, _ = c_train(lib, dsh, params, 5)
    jb, tb = py_pair(Xd, y, params, 5)
    expect = tb.predict(Xd)

    out = np.zeros(600)
    out_len = ctypes.c_int64()
    check(lib.LGBM_BoosterPredictForCSR(
        bh, indptr.ctypes.data_as(ctypes.c_void_p), 2,
        indices.ctypes.data_as(ctypes.c_void_p), data.ctypes.data_as(ctypes.c_void_p), 1,
        ctypes.c_int64(len(indptr)), ctypes.c_int64(len(data)), ctypes.c_int64(6), 0, 0,
        -1, b"", ctypes.byref(out_len),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))), lib)
    assert out_len.value == 600
    np.testing.assert_array_equal(out, expect)
    np.testing.assert_allclose(out, jb.predict(Xd), rtol=TOL, atol=TOL)

    # single-row plain + Fast == the batch predictions, bitwise
    one = np.zeros(1)
    row = np.ascontiguousarray(Xd[17])
    check(lib.LGBM_BoosterPredictForMatSingleRow(
        bh, row.ctypes.data_as(ctypes.c_void_p), 1, 6, 1, 0, 0, -1, b"",
        ctypes.byref(out_len), one.ctypes.data_as(ctypes.POINTER(ctypes.c_double))), lib)
    assert one[0] == expect[17]
    fch = ctypes.c_void_p()
    check(lib.LGBM_BoosterPredictForMatSingleRowFastInit(bh, 0, 0, -1, 1, 6, b"",
                                                         ctypes.byref(fch)), lib)
    for i in (3, 99, 400):
        row = np.ascontiguousarray(Xd[i])
        check(lib.LGBM_BoosterPredictForMatSingleRowFast(
            fch, row.ctypes.data_as(ctypes.c_void_p), ctypes.byref(out_len),
            one.ctypes.data_as(ctypes.POINTER(ctypes.c_double))), lib)
        assert one[0] == expect[i]
    check(lib.LGBM_FastConfigFree(fch), lib)
    check(lib.LGBM_BoosterFree(bh), lib)
    check(lib.LGBM_DatasetFree(dsh), lib)


@pytest.mark.parametrize("mode", ["rounds", "strict"])
def test_update_reports_finish_as_the_jax_booster(lib, mode):
    """LGBM_BoosterUpdateOneIter's is_finished: off the strict grower one
    iteration late (the previous iteration's pinned copy), on the strict
    grower at once; the same flags, iteration for iteration, as a JAX
    Booster with _report_finish_every_iter (the C API's setting there)."""
    rng = np.random.RandomState(4)
    X = rng.randn(400, 3)
    X[:, 0] = np.where(X[:, 0] > 0, 1.0, -1.0)
    y = X[:, 0].copy()
    # one split fits y exactly at learning_rate 1: the second tree is one leaf
    params = {"objective": "regression", "num_leaves": 4, "learning_rate": 1.0,
              "min_gain_to_split": 1e-3, "verbosity": -1, "tree_growth_mode": mode}
    ds = dense_handle(lib, X, y)
    bh, flags = c_train(lib, ds, params, 4)
    jb = jlgb.Booster(params=dict(params), train_set=jlgb.Dataset(X, label=y,
                                                                  params={"max_bin": 63}))
    jb._gbdt._report_finish_every_iter = True
    jflags = [int(jb.update()) for _ in range(4)]
    assert flags == jflags
    assert flags == ([0, 0, 1, 1] if mode == "rounds" else [0, 1, 1, 1])
    assert model_string(lib, bh).count("num_leaves=1\n") == 3
    # the port's Python API keeps its every-32 check off the strict grower
    tb = tlgb.Booster(params={**params, **CPU},
                      train_set=tlgb.Dataset(X, label=y, params={"max_bin": 63, **CPU}))
    assert [int(tb.update()) for _ in range(4)] == ([0, 0, 0, 0] if mode == "rounds"
                                                    else [0, 1, 1, 1])
    assert model_string(lib, bh) == tb.model_to_string()
    # a rollback leaves the copy stale: the next answer waits a turn
    check(lib.LGBM_BoosterRollbackOneIter(bh), lib)
    fin = ctypes.c_int()
    check(lib.LGBM_BoosterUpdateOneIter(bh, ctypes.byref(fin)), lib)
    assert fin.value == (0 if mode == "rounds" else 1)
    lib.LGBM_BoosterFree(bh)
    lib.LGBM_DatasetFree(ds)


def test_no_fallback_without_device_type(lib):
    """With no card, a Dataset or a Booster that does not say device_type=
    cpu fails with resolve_device's message (models/gbdt.py), never
    carries on on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device resolves")
    X = np.ascontiguousarray(np.random.RandomState(5).randn(100, 3))
    h = ctypes.c_void_p()
    assert lib.LGBM_DatasetCreateFromMat(X.ctypes.data_as(ctypes.c_void_p), 1, 100, 3,
                                         1, b"max_bin=63", None, ctypes.byref(h)) == -1
    assert b"Pass device_type='cpu'" in lib.LGBM_GetLastError()
    ds = dense_handle(lib, X, (X[:, 0] > 0).astype(np.float64))
    bh = ctypes.c_void_p()
    assert lib.LGBM_BoosterCreate(ds, b"objective=binary verbosity=-1",
                                  ctypes.byref(bh)) == -1
    assert b"torch.cuda.is_available() is False" in lib.LGBM_GetLastError()
    check(lib.LGBM_BoosterCreate(ds, b"objective=binary verbosity=-1 device_type=cpu",
                                 ctypes.byref(bh)), lib)
    lib.LGBM_BoosterFree(bh)
    lib.LGBM_DatasetFree(ds)


def test_network_init_without_a_cpu_request_raises_instead_of_gloo():
    """Fault C26: LGBM_NetworkInit probes for no card.  Without one, a
    Dataset or a training made after it that does not ask for the CPU
    raises, and no gloo group comes up behind the caller's back."""
    import torch
    import torch.distributed as dist

    from lightgbm_tpu_torch import capi_helpers as ch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device resolves")
    ports = free_ports(2)
    machines = ",".join(f"127.0.0.1:{p}" for p in ports)
    X = np.random.RandomState(7).randn(200, 3)
    try:
        assert ch.network_init(machines, ports[0], 2, 2)
        assert not dist.is_initialized()
        with pytest.raises(Exception, match="device_type"):
            ch._dataset_params("max_bin=63")
        ds = tlgb.Dataset(X, label=(X[:, 0] > 0).astype(float),
                          params={"device_type": "cpu", "verbosity": -1})
        with pytest.raises(RuntimeError, match="needs CUDA"):
            ch.booster_create(ds, "objective=binary verbosity=-1")
        assert not dist.is_initialized()
    finally:
        ch.network_free()


RANK_SCRIPT = r'''
import ctypes, os, sys
import numpy as np
sys.path.insert(0, os.environ["REPO"])
import torch
torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
from lightgbm_tpu_torch import native
rank = int(sys.argv[1])
ports = [int(p) for p in sys.argv[2].split(",")]
lib = ctypes.CDLL(native.c_api_library())
lib.LGBM_GetLastError.restype = ctypes.c_char_p
def check(rc):
    if rc != 0:
        raise SystemExit(lib.LGBM_GetLastError().decode())
machines = ",".join(f"127.0.0.1:{p}" for p in ports).encode()
check(lib.LGBM_NetworkInit(machines, ports[rank], 2, 2))
d = np.load(sys.argv[3])
X = np.ascontiguousarray(np.array_split(d["X"], 2)[rank])
y = np.ascontiguousarray(np.array_split(d["y"], 2)[rank], np.float32)
ds = ctypes.c_void_p()
check(lib.LGBM_DatasetCreateFromMat(X.ctypes.data_as(ctypes.c_void_p), 1, X.shape[0],
      X.shape[1], 1, sys.argv[4].encode() + b" pre_partition=true", None,
      ctypes.byref(ds)))
check(lib.LGBM_DatasetSetField(ds, b"label", y.ctypes.data_as(ctypes.c_void_p),
      len(y), 0))
bh = ctypes.c_void_p()
check(lib.LGBM_BoosterCreate(ds, sys.argv[4].encode(), ctypes.byref(bh)))
fin = ctypes.c_int()
for _ in range(10):
    check(lib.LGBM_BoosterUpdateOneIter(bh, ctypes.byref(fin)))
check(lib.LGBM_BoosterSaveModel(bh, 0, -1, 0, sys.argv[5].encode()))
check(lib.LGBM_NetworkFree())
'''


def free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def test_network_init_two_gloo_ranks_train_the_serial_model(tmp_path):
    """Two processes that import only the port each load the library, call
    LGBM_NetworkInit with a local machine list (the rank from
    local_listen_port), build their half with pre_partition and train
    tree_learner=data for 10 rounds: the serial model bit for bit (C16),
    the [tree_learner: ...] record read as serial."""
    rng = np.random.RandomState(6)
    X = rng.randn(2000, 6)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(np.float64)
    np.savez(tmp_path / "d.npz", X=X, y=y)
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1, "max_bin": 63,
              "tree_learner": "data", "num_machines": 2, **CPU}
    (tmp_path / "rank.py").write_text(RANK_SCRIPT)
    ports = ",".join(str(p) for p in free_ports(2))
    env = {**os.environ, "REPO": REPO}
    env.pop("LIGHTGBM_TPU_RANK", None)
    procs = [subprocess.Popen([sys.executable, str(tmp_path / "rank.py"), str(r), ports,
                               str(tmp_path / "d.npz"),
                               params_bytes(params).decode(),
                               str(tmp_path / f"m{r}.txt")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=85)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    texts = [(tmp_path / f"m{r}.txt").read_text() for r in range(2)]
    assert texts[0] == texts[1]
    serial = {k: v for k, v in params.items() if k not in ("tree_learner", "num_machines")}
    ser = tlgb.Booster(params=serial, train_set=tlgb.Dataset(X, label=y, params=serial))
    for _ in range(10):
        ser.update()
    assert texts[0].replace("[tree_learner: data]", "[tree_learner: serial]") == \
        ser.model_to_string()
