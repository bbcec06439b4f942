"""The port's C API under threads, on the CPU (device_type=cpu): the last
error is per thread (reference: thread_local in c_api.cpp), and a
prediction from a second thread while a first one trains sees a whole
model (reference: the Booster's shared mutex; here the embedded CPython
GIL serializes the entry points).  Mirrors tests/test_c_api_concurrency.py,
whose one test is split in its two parts; the trained model is held to
the port's Python API bitwise and to the JAX package at the parity bar.
"""

import ctypes
import threading

import numpy as np

from test_torch_capi import (assert_jax_parity, c_train, check, dense_handle, load_lib,
                             model_string, py_pair)

PARAMS = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
          "min_gain_to_split": 1e-3}


def _data():
    rng = np.random.RandomState(0)
    X = rng.randn(2000, 6)
    y = ((X @ rng.randn(6)) > 0).astype(np.float64)
    return X, y


def test_get_last_error_is_thread_local():
    lib = load_lib()
    errors = []

    def failer(tag):
        # each thread's failure names its own file; another thread's
        # message must never show in this thread's slot
        bad, it = ctypes.c_void_p(), ctypes.c_int()
        for _ in range(15):
            rc = lib.LGBM_BoosterCreateFromModelfile(
                f"/nonexistent/{tag}_thread_only.txt".encode(), ctypes.byref(it),
                ctypes.byref(bad))
            msg = lib.LGBM_GetLastError().decode()
            if rc != -1 or f"{tag}_thread_only" not in msg:
                errors.append((tag, rc, msg))

    def succeeder():
        # a thread whose calls succeed keeps its own (untouched) slot
        n = ctypes.c_int()
        for _ in range(15):
            if lib.LGBM_GetMaxThreads(ctypes.byref(n)) != 0:
                errors.append(("succeeder", lib.LGBM_GetLastError()))
        msg = lib.LGBM_GetLastError().decode()
        if "thread_only" in msg:
            errors.append(("succeeder", msg))

    threads = [threading.Thread(target=failer, args=(t,)) for t in ("first", "second")]
    threads.append(threading.Thread(target=succeeder))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert "thread_only" not in lib.LGBM_GetLastError().decode()


def test_predict_during_update_sees_whole_models():
    """10 updates on one thread, 10 predictions on another: every
    prediction is the port's Python model after some whole number of
    iterations, bitwise, and the final model is the Python API's."""
    X, y = _data()
    lib = load_lib()
    dsh = dense_handle(lib, X, y)
    bh, _ = c_train(lib, dsh, PARAMS, 1)
    Xc = np.ascontiguousarray(X)
    errors, results = [], []

    def trainer():
        fin = ctypes.c_int()
        for _ in range(10):
            if lib.LGBM_BoosterUpdateOneIter(bh, ctypes.byref(fin)) != 0:
                errors.append(("train", lib.LGBM_GetLastError()))

    def predictor():
        out, n_out = np.zeros(2000), ctypes.c_int64()
        for _ in range(10):
            rc = lib.LGBM_BoosterPredictForMat(
                bh, Xc.ctypes.data_as(ctypes.c_void_p), 1, 2000, 6, 1, 0, 0, -1, b"",
                ctypes.byref(n_out), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
            if rc != 0:
                errors.append(("predict", lib.LGBM_GetLastError()))
            else:
                results.append(out.copy())

    threads = [threading.Thread(target=trainer), threading.Thread(target=predictor)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    jb, tb = py_pair(X, y, PARAMS, 0)
    whole = []
    for _ in range(11):
        tb.update()
        jb.update()
        whole.append(tb.predict(X))
    assert results and all(any(np.array_equal(r, w) for w in whole) for r in results)
    text = model_string(lib, bh)
    assert text == tb.model_to_string()
    assert_jax_parity(jb, text, X)
    check(lib.LGBM_BoosterFree(bh), lib)
    check(lib.LGBM_DatasetFree(dsh), lib)
