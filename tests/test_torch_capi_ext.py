"""The rest of the port's C API surface against the JAX package and the
port's own Python API, on the CPU (device_type=cpu): CSC / Mats / sampled
column ingestion, field and name introspection, streaming with metadata,
serialized references and ByteBuffer, model surgery, refit, score
introspection, file predict, the global configuration, sparse SHAP output
and the C++ CSRFunc caller.  Mirrors tests/test_c_api_ext.py case for
case; each case also holds the result to the port's Python API bit for
bit, and to the JAX package (its Python API, or its capi_helpers called
from Python on a JAX Booster) at that piece's bar.
"""

import ctypes
import json
import os
import subprocess

import numpy as np
import pytest
import scipy.sparse as sp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu import capi_helpers as jcapi
from lightgbm_tpu_torch import capi_helpers as tcapi
from lightgbm_tpu_torch import native

from test_torch_capi import (CPU, TOL, assert_jax_parity, c_predict, c_train, check,
                             dense_handle, model_string, py_pair)

# separated gains (the parity bar; ROADMAP C23)
TRAIN = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
         "min_gain_to_split": 1e-3}


@pytest.fixture(scope="module")
def lib():
    from test_torch_capi import load_lib

    return load_lib()


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(7)
    X = rng.randn(400, 5)
    y = ((X @ rng.randn(5)) > 0).astype(np.float64)
    return X, y


def _train(lib, h, iters=3, params=None):
    return c_train(lib, h, params or TRAIN, iters)[0]


def _ptr(a, ctype=ctypes.c_void_p):
    return a.ctypes.data_as(ctype)


def test_csc_dataset_and_predict(lib, data):
    X, y = data
    csc = sp.csc_matrix(X)
    colptr, idx = csc.indptr.astype(np.int32), csc.indices.astype(np.int32)
    vals = csc.data.astype(np.float64)
    h = ctypes.c_void_p()
    check(lib.LGBM_DatasetCreateFromCSC(
        _ptr(colptr), 2, _ptr(idx), _ptr(vals), 1, ctypes.c_int64(len(colptr)),
        ctypes.c_int64(csc.nnz), ctypes.c_int64(X.shape[0]),
        b"max_bin=63 device_type=cpu", None, ctypes.byref(h)), lib)
    yc = y.astype(np.float32)
    check(lib.LGBM_DatasetSetField(h, b"label", _ptr(yc), len(yc), 0), lib)
    bh = _train(lib, h)
    dh = dense_handle(lib, X, y)
    bh2 = _train(lib, dh)
    s1 = model_string(lib, bh)
    assert s1 == model_string(lib, bh2)
    jb, tb = py_pair(X, y, TRAIN, 3)
    assert s1 == tb.model_to_string()
    assert_jax_parity(jb, s1, X)

    out = np.zeros(X.shape[0])
    n_out = ctypes.c_int64()
    check(lib.LGBM_BoosterPredictForCSC(
        bh, _ptr(colptr), 2, _ptr(idx), _ptr(vals), 1, ctypes.c_int64(len(colptr)),
        ctypes.c_int64(csc.nnz), ctypes.c_int64(X.shape[0]), 0, 0, -1, b"",
        ctypes.byref(n_out), _ptr(out, ctypes.POINTER(ctypes.c_double))), lib)
    np.testing.assert_array_equal(out, c_predict(lib, bh, X))
    np.testing.assert_array_equal(out, tb.predict(X))
    for b in (bh, bh2):
        lib.LGBM_BoosterFree(b)
    lib.LGBM_DatasetFree(h)
    lib.LGBM_DatasetFree(dh)


def test_mats_dataset_and_predict(lib, data):
    X, y = data
    halves = [np.ascontiguousarray(X[:200]), np.ascontiguousarray(X[200:])]
    ptrs = (ctypes.c_void_p * 2)(*[b.ctypes.data for b in halves])
    nrows = (ctypes.c_int32 * 2)(200, 200)
    h = ctypes.c_void_p()
    check(lib.LGBM_DatasetCreateFromMats(2, ptrs, 1, nrows, X.shape[1], 1,
                                         b"max_bin=63 device_type=cpu", None,
                                         ctypes.byref(h)), lib)
    yc = y.astype(np.float32)
    check(lib.LGBM_DatasetSetField(h, b"label", _ptr(yc), len(yc), 0), lib)
    bh = _train(lib, h)
    text = model_string(lib, bh)
    assert text == model_string(lib, _train(lib, dense_handle(lib, X, y)))
    jb, tb = py_pair(X, y, TRAIN, 3)
    assert text == tb.model_to_string()
    out = np.zeros(X.shape[0])
    n_out = ctypes.c_int64()
    check(lib.LGBM_BoosterPredictForMats(bh, ptrs, 1, 2, nrows, X.shape[1], 0, 0, -1,
                                         b"", ctypes.byref(n_out),
                                         _ptr(out, ctypes.POINTER(ctypes.c_double))), lib)
    assert n_out.value == X.shape[0]
    np.testing.assert_array_equal(out, tb.predict(X))
    np.testing.assert_allclose(out, jb.predict(X), rtol=TOL, atol=TOL)
    lib.LGBM_BoosterFree(bh)
    lib.LGBM_DatasetFree(h)


def test_get_field_and_names(lib, data):
    X, y = data
    h = dense_handle(lib, X, y)
    w = np.linspace(0.5, 1.5, len(y)).astype(np.float32)
    check(lib.LGBM_DatasetSetField(h, b"weight", _ptr(w), len(w), 0), lib)
    out_len, out_ptr, out_type = ctypes.c_int(), ctypes.c_void_p(), ctypes.c_int()
    check(lib.LGBM_DatasetGetField(h, b"weight", ctypes.byref(out_len),
                                   ctypes.byref(out_ptr), ctypes.byref(out_type)), lib)
    assert out_type.value == 0 and out_len.value == len(w)
    got = np.frombuffer((ctypes.c_float * out_len.value).from_address(out_ptr.value),
                        np.float32)
    np.testing.assert_array_equal(got, w)

    # group sizes in -> cumulative boundaries out (reference convention),
    # as the JAX package's helper returns them
    g = np.asarray([100, 150, 150], np.int32)
    check(lib.LGBM_DatasetSetField(h, b"group", _ptr(g), len(g), 2), lib)
    check(lib.LGBM_DatasetGetField(h, b"group", ctypes.byref(out_len),
                                   ctypes.byref(out_ptr), ctypes.byref(out_type)), lib)
    assert out_type.value == 2
    bounds = np.frombuffer((ctypes.c_int32 * out_len.value).from_address(out_ptr.value),
                           np.int32)
    np.testing.assert_array_equal(bounds, [0, 100, 250, 400])
    jds = jlgb.Dataset(X, label=y, group=g)
    ja, jn, jt = jcapi.dataset_get_field(jds, "group")
    np.testing.assert_array_equal(
        np.frombuffer((ctypes.c_int32 * jn).from_address(ja), np.int32), bounds)

    names = [b"alpha", b"beta", b"gamma", b"delta", b"eps"]
    arr = (ctypes.c_char_p * 5)(*names)
    check(lib.LGBM_DatasetSetFeatureNames(h, arr, 5), lib)
    bufs = [ctypes.create_string_buffer(64) for _ in range(5)]
    out_strs = (ctypes.c_char_p * 5)(*[ctypes.addressof(b) for b in bufs])
    n_names, need = ctypes.c_int(), ctypes.c_size_t()
    check(lib.LGBM_DatasetGetFeatureNames(
        h, 5, ctypes.byref(n_names), 64, ctypes.byref(need),
        ctypes.cast(out_strs, ctypes.POINTER(ctypes.c_char_p))), lib)
    assert n_names.value == 5
    assert [b.value for b in bufs] == names
    assert need.value == len(b"gamma") + 1

    # clear group (zero-length clears) so the binary objective trains;
    # booster-side names flow from the dataset
    check(lib.LGBM_DatasetSetField(h, b"group", None, 0, 2), lib)
    bh = _train(lib, h)
    check(lib.LGBM_BoosterGetFeatureNames(
        bh, 5, ctypes.byref(n_names), 64, ctypes.byref(need),
        ctypes.cast(out_strs, ctypes.POINTER(ctypes.c_char_p))), lib)
    assert [b.value for b in bufs] == names
    check(lib.LGBM_BoosterValidateFeatureNames(bh, arr, 5), lib)
    bad = (ctypes.c_char_p * 5)(b"a", b"b", b"c", b"d", b"e")
    assert lib.LGBM_BoosterValidateFeatureNames(bh, bad, 5) == -1
    assert b"Expected feature names" in lib.LGBM_GetLastError()
    n_eval = ctypes.c_int()
    check(lib.LGBM_BoosterGetEvalNames(
        bh, 5, ctypes.byref(n_eval), 64, ctypes.byref(need),
        ctypes.cast(out_strs, ctypes.POINTER(ctypes.c_char_p))), lib)
    assert n_eval.value >= 1 and bufs[0].value == b"binary_logloss"
    # the weighted model: the port's Python API, bitwise
    tb = tlgb.Booster(params={**TRAIN, **CPU}, train_set=tlgb.Dataset(
        X, label=y, weight=w, feature_name=[n.decode() for n in names],
        params={"max_bin": 63, **CPU}))
    for _ in range(3):
        tb.update()
    assert model_string(lib, bh) == tb.model_to_string()
    lib.LGBM_BoosterFree(bh)
    lib.LGBM_DatasetFree(h)


def test_save_binary_dump_text_subset(lib, data, tmp_path):
    X, y = data
    h = dense_handle(lib, X, y)
    binpath = str(tmp_path / "d.bin").encode()
    check(lib.LGBM_DatasetSaveBinary(h, binpath), lib)
    assert os.path.getsize(binpath) > 0
    # the cache reloads into the same bins
    re_ds = tlgb.Dataset(binpath.decode(), params=CPU).construct()
    np.testing.assert_array_equal(re_ds._host_bins("test"),
                                  tlgb.Dataset(X, label=y, params={"max_bin": 63, **CPU})
                                  .construct()._host_bins("test"))

    txtpath = str(tmp_path / "d.txt")
    check(lib.LGBM_DatasetDumpText(h, txtpath.encode()), lib)
    lines = open(txtpath).read().splitlines()
    assert len(lines) == 1 + X.shape[0]
    # the JAX package's helper dumps the same text
    jpath = str(tmp_path / "j.txt")
    jcapi.dataset_dump_text(jlgb.Dataset(X, label=y, params={"max_bin": 63},
                                         free_raw_data=False), jpath)
    assert open(jpath).read() == open(txtpath).read()

    idx = np.arange(0, 400, 2, dtype=np.int32)
    sh = ctypes.c_void_p()
    check(lib.LGBM_DatasetGetSubset(h, _ptr(idx, ctypes.POINTER(ctypes.c_int32)),
                                    len(idx), b"", ctypes.byref(sh)), lib)
    n = ctypes.c_int32()
    check(lib.LGBM_DatasetGetNumData(sh, ctypes.byref(n)), lib)
    assert n.value == 200
    lib.LGBM_DatasetFree(sh)
    lib.LGBM_DatasetFree(h)


def test_add_features_and_param_checking(lib, data):
    X, y = data
    h1 = dense_handle(lib, X[:, :3], y)
    h2 = dense_handle(lib, X[:, 3:], y)
    check(lib.LGBM_DatasetAddFeaturesFrom(h1, h2), lib)
    nf = ctypes.c_int32()
    check(lib.LGBM_DatasetGetNumFeature(h1, ctypes.byref(nf)), lib)
    assert nf.value == 5
    lib.LGBM_DatasetFree(h1)
    lib.LGBM_DatasetFree(h2)

    check(lib.LGBM_DatasetUpdateParamChecking(b"max_bin=63 verbosity=-1",
                                              b"max_bin=63 learning_rate=0.2"), lib)
    assert jcapi.dataset_update_param_checking("max_bin=63 verbosity=-1",
                                               "max_bin=63 learning_rate=0.2")
    assert lib.LGBM_DatasetUpdateParamChecking(b"max_bin=63", b"max_bin=255") == -1
    msg = lib.LGBM_GetLastError().decode()
    with pytest.raises(ValueError) as e:
        jcapi.dataset_update_param_checking("max_bin=63", "max_bin=255")
    assert msg == str(e.value) and "max_bin" in msg


def test_push_rows_by_csr_streaming(lib, data):
    X, y = data
    ref = dense_handle(lib, X, y)
    sh = ctypes.c_void_p()
    check(lib.LGBM_DatasetCreateByReference(ref, len(y), ctypes.byref(sh)), lib)
    csr = sp.csr_matrix(X)
    for lo in range(0, 400, 100):
        blk = csr[lo:lo + 100]
        check(lib.LGBM_DatasetPushRowsByCSR(
            sh, _ptr(blk.indptr.astype(np.int32)), 2, _ptr(blk.indices.astype(np.int32)),
            _ptr(blk.data.astype(np.float64)), 1, ctypes.c_int64(len(blk.indptr)),
            ctypes.c_int64(blk.nnz), ctypes.c_int64(X.shape[1]), lo), lib)
    yc = y.astype(np.float32)
    check(lib.LGBM_DatasetSetField(sh, b"label", _ptr(yc), len(yc), 0), lib)
    text = model_string(lib, _train(lib, sh))
    assert text == model_string(lib, _train(lib, ref))
    jb, tb = py_pair(X, y, TRAIN, 3)
    assert text == tb.model_to_string()
    assert_jax_parity(jb, text, X)
    lib.LGBM_DatasetFree(sh)
    lib.LGBM_DatasetFree(ref)


def test_sampled_column_schema(lib, data):
    X, y = data
    n, f = X.shape
    cols = [np.ascontiguousarray(X[:, c]) for c in range(f)]
    idxs = [np.arange(n, dtype=np.int32) for _ in range(f)]
    col_ptrs = (ctypes.POINTER(ctypes.c_double) * f)(
        *[_ptr(c, ctypes.POINTER(ctypes.c_double)) for c in cols])
    idx_ptrs = (ctypes.POINTER(ctypes.c_int) * f)(
        *[_ptr(i, ctypes.POINTER(ctypes.c_int)) for i in idxs])
    counts = (ctypes.c_int * f)(*([n] * f))
    h = ctypes.c_void_p()
    check(lib.LGBM_DatasetCreateFromSampledColumn(
        col_ptrs, idx_ptrs, f, counts, n, n, ctypes.c_int64(n),
        b"max_bin=63 device_type=cpu", ctypes.byref(h)), lib)
    Xc = np.ascontiguousarray(X)
    check(lib.LGBM_DatasetPushRows(h, _ptr(Xc), 1, n, f, 0), lib)
    yc = y.astype(np.float32)
    check(lib.LGBM_DatasetSetField(h, b"label", _ptr(yc), len(yc), 0), lib)
    text = model_string(lib, _train(lib, h))
    assert text == model_string(lib, _train(lib, dense_handle(lib, X, y)))
    assert text == py_pair(X, y, TRAIN, 3)[1].model_to_string()
    lib.LGBM_DatasetFree(h)


def test_streaming_with_metadata(lib, data):
    X, y = data
    ref = dense_handle(lib, X, y)
    sh = ctypes.c_void_p()
    check(lib.LGBM_DatasetCreateByReference(ref, len(y), ctypes.byref(sh)), lib)
    check(lib.LGBM_DatasetInitStreaming(sh, 1, 0, 1, 1, 1, 1), lib)
    check(lib.LGBM_DatasetSetWaitForManualFinish(sh, 1), lib)
    qid = np.repeat(np.arange(8), 50).astype(np.int32)
    for lo in range(0, 400, 100):
        blk = np.ascontiguousarray(X[lo:lo + 100])
        lab = y[lo:lo + 100].astype(np.float32)
        w = np.full(100, 2.0, np.float32)
        q = qid[lo:lo + 100]
        check(lib.LGBM_DatasetPushRowsWithMetadata(
            sh, _ptr(blk), 1, 100, X.shape[1], lo, _ptr(lab, ctypes.POINTER(ctypes.c_float)),
            _ptr(w, ctypes.POINTER(ctypes.c_float)), None,
            _ptr(q, ctypes.POINTER(ctypes.c_int32)), 0), lib)
    check(lib.LGBM_DatasetMarkFinished(sh), lib)
    rank = {"objective": "lambdarank", "num_leaves": 7, "verbosity": -1}
    bh = _train(lib, sh, params=rank)
    it = ctypes.c_int()
    check(lib.LGBM_BoosterGetCurrentIteration(bh, ctypes.byref(it)), lib)
    assert it.value == 3
    # the same rows, weights and queries through the port's Python API
    dp = {"max_bin": 63, **CPU}
    t_ref = tlgb.Dataset(X, label=y, params=dp)
    tds = tlgb.Dataset(X, label=y, weight=np.full(400, 2.0), group=np.full(8, 50),
                       reference=t_ref, params=dp)
    tb = tlgb.Booster(params={**rank, **CPU}, train_set=tds)
    for _ in range(3):
        tb.update()
    assert model_string(lib, bh) == tb.model_to_string()
    lib.LGBM_BoosterFree(bh)
    lib.LGBM_DatasetFree(sh)
    lib.LGBM_DatasetFree(ref)


def test_serialized_reference_bytebuffer(lib, data):
    X, y = data
    ref = dense_handle(lib, X, y)
    buf_h, buf_len = ctypes.c_void_p(), ctypes.c_int32()
    check(lib.LGBM_DatasetSerializeReferenceToBinary(ref, ctypes.byref(buf_h),
                                                     ctypes.byref(buf_len)), lib)
    assert buf_len.value > 0
    raw = bytearray(buf_len.value)
    v = ctypes.c_uint8()
    for i in range(buf_len.value):
        check(lib.LGBM_ByteBufferGetAt(buf_h, i, ctypes.byref(v)), lib)
        raw[i] = v.value
    assert lib.LGBM_ByteBufferGetAt(buf_h, buf_len.value, ctypes.byref(v)) == -1
    assert bytes(raw) == tcapi.dataset_serialize_reference(
        tlgb.Dataset(X, label=y, params={"max_bin": 63, **CPU}))

    carr = (ctypes.c_uint8 * len(raw)).from_buffer(raw)
    h2 = ctypes.c_void_p()
    check(lib.LGBM_DatasetCreateFromSerializedReference(
        carr, len(raw), ctypes.c_int64(len(y)), 1, b"", ctypes.byref(h2)), lib)
    Xc = np.ascontiguousarray(X)
    check(lib.LGBM_DatasetPushRows(h2, _ptr(Xc), 1, len(y), X.shape[1], 0), lib)
    yc = y.astype(np.float32)
    check(lib.LGBM_DatasetSetField(h2, b"label", _ptr(yc), len(yc), 0), lib)
    # schema round-tripped through bytes -> identical bins -> identical model
    assert model_string(lib, _train(lib, h2)) == model_string(lib, _train(lib, ref))
    lib.LGBM_ByteBufferFree(buf_h)
    lib.LGBM_DatasetFree(h2)
    lib.LGBM_DatasetFree(ref)


def test_model_surgery(lib, data):
    X, y = data
    h = dense_handle(lib, X, y)
    bh = _train(lib, h, iters=2)
    bh2 = _train(lib, h, iters=3)
    n_models = ctypes.c_int()
    check(lib.LGBM_BoosterMerge(bh, bh2), lib)
    check(lib.LGBM_BoosterNumberOfTotalModel(bh, ctypes.byref(n_models)), lib)
    assert n_models.value == 5
    k, lin = ctypes.c_int(), ctypes.c_int()
    check(lib.LGBM_BoosterNumModelPerIteration(bh, ctypes.byref(k)), lib)
    check(lib.LGBM_BoosterGetLinear(bh, ctypes.byref(lin)), lib)
    assert (k.value, lin.value) == (1, 0)
    lo, hi = ctypes.c_double(), ctypes.c_double()
    check(lib.LGBM_BoosterGetLowerBoundValue(bh, ctypes.byref(lo)), lib)
    check(lib.LGBM_BoosterGetUpperBoundValue(bh, ctypes.byref(hi)), lib)
    assert lo.value < hi.value
    # the merged model: the port's Python boosters of both runs, merged
    merged, t3 = (py_pair(X, y, TRAIN, n)[1] for n in (2, 3))
    tcapi.booster_merge(merged, t3)
    assert lo.value == merged.lower_bound() and hi.value == merged.upper_bound()
    assert model_string(lib, bh) == merged.model_to_string()

    val, val2 = ctypes.c_double(), ctypes.c_double()
    check(lib.LGBM_BoosterGetLeafValue(bh, 0, 1, ctypes.byref(val)), lib)
    assert val.value == merged.get_leaf_output(0, 1)
    check(lib.LGBM_BoosterSetLeafValue(bh, 0, 1, ctypes.c_double(val.value + 0.25)), lib)
    check(lib.LGBM_BoosterGetLeafValue(bh, 0, 1, ctypes.byref(val2)), lib)
    assert val2.value == val.value + 0.25
    check(lib.LGBM_BoosterShuffleModels(bh, 0, -1), lib)

    n64 = ctypes.c_int64()
    for ptype, want in ((0, 10), (2, 50), (3, 60)):  # normal, leaf x 5, contrib
        check(lib.LGBM_BoosterCalcNumPredict(bh, 10, ptype, 0, -1, ctypes.byref(n64)), lib)
        assert n64.value == want
    n = ctypes.c_int64()
    check(lib.LGBM_BoosterGetLoadedParam(bh, ctypes.c_int64(0), ctypes.byref(n), None),
          lib)
    pbuf = ctypes.create_string_buffer(n.value)
    check(lib.LGBM_BoosterGetLoadedParam(bh, ctypes.c_int64(n.value), ctypes.byref(n),
                                         pbuf), lib)
    assert json.loads(pbuf.value)["num_leaves"] == 7
    lib.LGBM_BoosterFree(bh)
    lib.LGBM_BoosterFree(bh2)
    lib.LGBM_DatasetFree(h)


def _leaf_matrix(lib, bh, X):
    nt = ctypes.c_int()
    check(lib.LGBM_BoosterNumberOfTotalModel(bh, ctypes.byref(nt)), lib)
    return np.ascontiguousarray(c_predict(lib, bh, X, 2).reshape(len(X), nt.value)
                                .astype(np.int32))


def test_refit_and_get_predict(lib, data):
    """LGBM_BoosterRefit against the JAX package's refit (its capi_helpers
    on a JAX Booster trained the same way) within 1e-6, and against the
    port's helper called from Python bitwise; GetPredict == the port's
    training score."""
    X, y = data
    h = dense_handle(lib, X, y)
    bh = _train(lib, h, iters=3)
    jb, tb = py_pair(X, y, TRAIN, 3)
    n64 = ctypes.c_int64()
    check(lib.LGBM_BoosterGetNumPredict(bh, 0, ctypes.byref(n64)), lib)
    assert n64.value == len(y)
    scores = np.zeros(len(y))
    check(lib.LGBM_BoosterGetPredict(bh, 0, ctypes.byref(n64),
                                     _ptr(scores, ctypes.POINTER(ctypes.c_double))), lib)
    np.testing.assert_array_equal(scores, tb._gbdt._score.numpy().astype(np.float64))

    leaf = _leaf_matrix(lib, bh, X)
    pred_before = c_predict(lib, bh, X)
    for labels in (y, 1.0 - y):  # its own labels, then flipped ones
        yf = labels.astype(np.float32)
        check(lib.LGBM_DatasetSetField(h, b"label", _ptr(yf), len(yf), 0), lib)
        tb._train_set.set_field("label", labels)
        jb._train_set.set_field("label", labels)
        check(lib.LGBM_BoosterRefit(bh, _ptr(leaf, ctypes.POINTER(ctypes.c_int32)),
                                    len(y), leaf.shape[1]), lib)
        tcapi.booster_refit_leaf_preds(tb, leaf.ctypes.data, len(y), leaf.shape[1])
        jcapi.booster_refit_leaf_preds(jb, leaf.ctypes.data, len(y), leaf.shape[1])
        assert model_string(lib, bh) == tb.model_to_string()
        for jt, tt in zip(jb._gbdt.models, tb._gbdt.models):
            np.testing.assert_allclose(tt.leaf_value, jt.leaf_value, rtol=0, atol=1e-6)
        if labels is y:  # its own assignments on the same data: ~ a fixed point
            pred_after = c_predict(lib, bh, X)
            np.testing.assert_allclose(pred_after, pred_before, rtol=1e-3, atol=1e-5)
    assert not np.allclose(c_predict(lib, bh, X), pred_after)
    lib.LGBM_BoosterFree(bh)
    lib.LGBM_DatasetFree(h)


def test_predict_for_file(lib, data, tmp_path):
    X, y = data
    h = dense_handle(lib, X, y)
    bh = _train(lib, h)
    datafile = tmp_path / "rows.csv"
    np.savetxt(datafile, np.column_stack([y, X]), delimiter=",")
    result = tmp_path / "preds.txt"
    check(lib.LGBM_BoosterPredictForFile(bh, str(datafile).encode(), 0, 0, 0, -1, b"",
                                         str(result).encode()), lib)
    got = np.loadtxt(result)
    tb = py_pair(X, y, TRAIN, 3)[1]
    # the file holds the values as repr writes them: the same doubles
    np.testing.assert_array_equal(got, tb.predict(np.loadtxt(datafile, delimiter=",")
                                                  [:, 1:]))
    np.testing.assert_allclose(got, c_predict(lib, bh, X), rtol=1e-12)
    lib.LGBM_BoosterFree(bh)
    lib.LGBM_DatasetFree(h)


def test_csr_single_row_and_fast(lib, data):
    X, y = data
    h = dense_handle(lib, X, y)
    bh = _train(lib, h)
    expect = py_pair(X, y, TRAIN, 3)[1].predict(X[:1])
    row = sp.csr_matrix(X[:1])
    rp, ri = row.indptr.astype(np.int32), row.indices.astype(np.int32)
    rv = row.data.astype(np.float64)
    out, n = np.zeros(1), ctypes.c_int64()
    check(lib.LGBM_BoosterPredictForCSRSingleRow(
        bh, _ptr(rp), 2, _ptr(ri), _ptr(rv), 1, ctypes.c_int64(len(rp)),
        ctypes.c_int64(row.nnz), ctypes.c_int64(X.shape[1]), 0, 0, -1, b"",
        ctypes.byref(n), _ptr(out, ctypes.POINTER(ctypes.c_double))), lib)
    np.testing.assert_array_equal(out, expect)
    fc = ctypes.c_void_p()
    check(lib.LGBM_BoosterPredictForCSRSingleRowFastInit(
        bh, 0, 0, -1, 1, ctypes.c_int64(X.shape[1]), b"", ctypes.byref(fc)), lib)
    out2 = np.zeros(1)
    check(lib.LGBM_BoosterPredictForCSRSingleRowFast(
        fc, _ptr(rp), 2, _ptr(ri), _ptr(rv), ctypes.c_int64(len(rp)),
        ctypes.c_int64(row.nnz), ctypes.byref(n),
        _ptr(out2, ctypes.POINTER(ctypes.c_double))), lib)
    np.testing.assert_array_equal(out2, expect)
    lib.LGBM_FastConfigFree(fc)
    lib.LGBM_BoosterFree(bh)
    lib.LGBM_DatasetFree(h)


def test_global_config_entries(lib):
    n = ctypes.c_int64()
    check(lib.LGBM_DumpParamAliases(ctypes.c_int64(0), ctypes.byref(n), None), lib)
    buf = ctypes.create_string_buffer(n.value)
    check(lib.LGBM_DumpParamAliases(ctypes.c_int64(n.value), ctypes.byref(n), buf), lib)
    aliases = json.loads(buf.value)
    assert "num_threads" in aliases and "nthread" in aliases["num_threads"]
    assert aliases == json.loads(tcapi.dump_param_aliases())

    nt = ctypes.c_int()
    check(lib.LGBM_GetMaxThreads(ctypes.byref(nt)), lib)
    assert nt.value == -1
    check(lib.LGBM_SetMaxThreads(4), lib)
    check(lib.LGBM_GetMaxThreads(ctypes.byref(nt)), lib)
    assert nt.value == 4
    check(lib.LGBM_SetMaxThreads(-1), lib)

    cnt = ctypes.c_int()
    check(lib.LGBM_GetSampleCount(1000, b"bin_construct_sample_cnt=200",
                                  ctypes.byref(cnt)), lib)
    assert cnt.value == 200
    idx = np.zeros(200, np.int32)
    got = ctypes.c_int32()
    check(lib.LGBM_SampleIndices(1000, b"bin_construct_sample_cnt=200", _ptr(idx),
                                 ctypes.byref(got)), lib)
    assert got.value == 200
    jidx = np.zeros(200, np.int32)
    jcapi.sample_indices_into(1000, "bin_construct_sample_cnt=200", jidx.ctypes.data)
    np.testing.assert_array_equal(idx, jidx)

    # the log callback receives warning lines (the verbosity is the
    # process-global level, as the reference's Log::ResetLogLevel)
    from lightgbm_tpu_torch.utils import log as _log

    prev = _log._verbosity
    _log.set_verbosity(1)
    seen = []
    cb = ctypes.CFUNCTYPE(None, ctypes.c_char_p)(lambda msg: seen.append(msg))
    check(lib.LGBM_RegisterLogCallback(cb), lib)
    try:
        # network: a single machine is a no-op bring-up; WithFunctions warns
        check(lib.LGBM_NetworkInit(b"127.0.0.1:12400", 12400, 120, 1), lib)
        check(lib.LGBM_NetworkFree(), lib)
        check(lib.LGBM_NetworkInitWithFunctions(2, 0, None, None), lib)
        assert any(b"torch.distributed collectives" in m for m in seen)
        check(lib.LGBM_NetworkFree(), lib)
        # real collective fn pointers for a multi-machine run FAIL without
        # the explicit opt-in (the JAX package's variable)
        fake_fn = ctypes.c_void_p(1)
        assert lib.LGBM_NetworkInitWithFunctions(2, 0, fake_fn, fake_fn) == -1
        assert b"LIGHTGBM_TPU_ACCEPT_XLA_TRANSPORT=1" in lib.LGBM_GetLastError()
    finally:
        _log.set_verbosity(prev)
        _log.register_logger(None)


def test_reset_training_data(lib):
    """LGBM_BoosterResetTrainingData: trees kept, later updates train on the
    new data.  As in the JAX package, the new data's score starts at the
    init score without the kept trees (ROADMAP C22, unlike LightGBM's
    GBDT::ResetTrainingData): GetPredict right after the reset is the JAX
    booster's score, and the next tree the JAX booster's at the parity bar."""
    rng = np.random.RandomState(31)
    X1 = rng.randn(400, 4)
    y1 = (X1 @ rng.randn(4) > 0).astype(np.float64)
    X2 = rng.randn(300, 4)
    y2 = (X2 @ rng.randn(4) > 0).astype(np.float64)
    h1, h2 = dense_handle(lib, X1, y1), dense_handle(lib, X2, y2)
    bh = _train(lib, h1, iters=2)
    jb, tb = py_pair(X1, y1, TRAIN, 2)
    check(lib.LGBM_BoosterResetTrainingData(bh, h2), lib)
    tcapi.booster_reset_training_data(tb, tlgb.Dataset(X2, label=y2,
                                                       params={"max_bin": 63, **CPU}))
    jcapi.booster_reset_training_data(jb, jlgb.Dataset(X2, label=y2,
                                                       params={"max_bin": 63}))
    n64 = ctypes.c_int64()
    score = np.zeros(300)
    check(lib.LGBM_BoosterGetPredict(bh, 0, ctypes.byref(n64),
                                     _ptr(score, ctypes.POINTER(ctypes.c_double))), lib)
    np.testing.assert_array_equal(score, np.asarray(jb._gbdt._score, np.float64))
    assert len(set(score)) == 1  # the init score, no tree in it
    fin = ctypes.c_int()
    check(lib.LGBM_BoosterUpdateOneIter(bh, ctypes.byref(fin)), lib)
    tb.update()
    jb.update()
    it = ctypes.c_int()
    check(lib.LGBM_BoosterGetCurrentIteration(bh, ctypes.byref(it)), lib)
    assert it.value == 3  # two original iterations + one on the new data
    text = model_string(lib, bh)
    assert text == tb.model_to_string()
    assert_jax_parity(jb, text, X2)
    lib.LGBM_BoosterFree(bh)


def _sparse_contrib(lib, bh, X, dtype_code, np_dtype, ctype):
    Xs = sp.csr_matrix(np.asarray(X, np_dtype))
    indptr = np.ascontiguousarray(Xs.indptr, np.int32)
    indices = np.ascontiguousarray(Xs.indices, np.int32)
    data = np.ascontiguousarray(Xs.data, np_dtype)
    out_len = (ctypes.c_int64 * 2)()
    o_indptr, o_data = ctypes.c_void_p(), ctypes.c_void_p()
    o_indices = ctypes.POINTER(ctypes.c_int32)()

    def call(ptype, dcode):
        return lib.LGBM_BoosterPredictSparseOutput(
            bh, _ptr(indptr), 2, _ptr(indices, ctypes.POINTER(ctypes.c_int32)),
            _ptr(data), dcode, ctypes.c_int64(len(indptr)), ctypes.c_int64(len(data)),
            ctypes.c_int64(X.shape[1]), ptype, 0, -1, b"", 0, out_len,
            ctypes.byref(o_indptr), ctypes.byref(o_indices), ctypes.byref(o_data))

    check(call(3, dtype_code), lib)  # C_API_PREDICT_CONTRIB, CSR
    n_indptr, nnz = out_len[0], out_len[1]
    assert n_indptr == X.shape[0] + 1
    got = sp.csr_matrix((np.ctypeslib.as_array(ctypes.cast(o_data, ctypes.POINTER(ctype)),
                                               (nnz,)).astype(np.float64),
                         np.ctypeslib.as_array(o_indices, (nnz,)).copy(),
                         np.ctypeslib.as_array(ctypes.cast(o_indptr, ctypes.POINTER(
                             ctypes.c_int32)), (n_indptr,)).copy()),
                        shape=(X.shape[0], X.shape[1] + 1)).toarray()
    check(lib.LGBM_BoosterFreePredictSparse(o_indptr, o_indices, o_data, 2, dtype_code),
          lib)
    return got, call


def test_predict_sparse_output_contrib(lib):
    """CSR SHAP output == the port's dense pred_contrib bitwise (f64), the
    JAX package's within TOL; FreePredictSparse releases the buffers."""
    rng = np.random.RandomState(32)
    X = rng.randn(300, 5)
    y = (X @ rng.randn(5) > 0).astype(np.float64)
    bh = _train(lib, dense_handle(lib, X, y))
    got, call = _sparse_contrib(lib, bh, X, 1, np.float64, ctypes.c_double)
    jb, tb = py_pair(X, y, TRAIN, 3)
    np.testing.assert_array_equal(got, tb.predict(X, pred_contrib=True))
    np.testing.assert_allclose(got, jb.predict(X, pred_contrib=True), rtol=TOL,
                               atol=TOL)
    assert call(0, 1) == -1  # non-contrib predict_type (reference: same check)


def test_dataset_create_from_csr_func(lib, tmp_path):
    """LGBM_DatasetCreateFromCSRFunc: a std::function cannot be built from
    Python, so a tiny C++ caller, linked against the port's library,
    wraps a row callback; the Dataset is the one the same rows give."""
    src = tmp_path / "csrfunc_caller.cpp"
    so = tmp_path / "csrfunc_caller.so"
    src.write_text(r'''
#include <functional>
#include <utility>
#include <vector>
extern "C" int LGBM_DatasetCreateFromCSRFunc(void*, int, long long,
    const char*, void*, void**);
extern "C" int LGBM_DatasetGetNumData(void*, int*);
extern "C" int LGBM_DatasetGetNumFeature(void*, int*);
extern "C" int LGBM_DatasetGetFeatureNumBin(void*, int, int*);
using RowFn = std::function<void(int, std::vector<std::pair<int,double>>&)>;
extern "C" int drive(int num_rows, long long num_col, int* out_rows,
                     int* out_cols, int* out_bins) {
  RowFn fn = [num_col](int i, std::vector<std::pair<int,double>>& row) {
    for (int j = 0; j < num_col; ++j)
      if ((i + j) % 3 == 0) row.emplace_back(j, 0.25 * i + j);
  };
  void* ds = nullptr;
  int rc = LGBM_DatasetCreateFromCSRFunc(&fn, num_rows, num_col,
                                         "max_bin=15 device_type=cpu", nullptr, &ds);
  if (rc != 0) return rc;
  if (LGBM_DatasetGetNumData(ds, out_rows) != 0) return -2;
  if (LGBM_DatasetGetNumFeature(ds, out_cols) != 0) return -3;
  for (int j = 0; j < num_col; ++j)
    if (LGBM_DatasetGetFeatureNumBin(ds, j, out_bins + j) != 0) return -4;
  return 0;
}
''')
    so_path = native.c_api_library()
    subprocess.run(["g++", "-O1", "-shared", "-fPIC", "-std=c++17", str(src), "-o",
                    str(so), so_path, f"-Wl,-rpath,{os.path.dirname(so_path)}"],
                   check=True, capture_output=True, text=True)
    drv = ctypes.CDLL(str(so))
    rows, cols, bins = ctypes.c_int(), ctypes.c_int(), (ctypes.c_int * 7)()
    assert drv.drive(60, 7, ctypes.byref(rows), ctypes.byref(cols), bins) == 0, \
        lib.LGBM_GetLastError()
    assert rows.value == 60 and cols.value == 7
    dense = np.zeros((60, 7))
    for i in range(60):
        for j in range(7):
            if (i + j) % 3 == 0:
                dense[i, j] = 0.25 * i + j
    ref = tlgb.Dataset(dense, params={"max_bin": 15, **CPU}).construct()
    assert list(bins) == [ref.feature_num_bin(j) for j in range(7)]


def test_dataset_get_feature_num_bin(lib):
    rng = np.random.RandomState(33)
    X = rng.randn(500, 3)
    y = (X[:, 0] > 0).astype(np.float64)
    h = dense_handle(lib, X, y, {"max_bin": 15})
    _train(lib, h, iters=1)  # forces construction
    nb = ctypes.c_int()
    got = []
    for j in range(3):
        check(lib.LGBM_DatasetGetFeatureNumBin(h, j, ctypes.byref(nb)), lib)
        got.append(nb.value)
    jds = jlgb.Dataset(X, label=y, params={"max_bin": 15}).construct()
    assert got == [jcapi.dataset_get_feature_num_bin(jds, j) for j in range(3)]
    assert all(2 <= b <= 16 for b in got)
    assert lib.LGBM_DatasetGetFeatureNumBin(h, 99, ctypes.byref(nb)) == -1


def test_predict_sparse_output_contrib_f32(lib):
    """An f32 request gets f32 output buffers (the reference allocates per
    data_type): the port's dense contributions rounded to f32, bitwise;
    an integer data_type is rejected."""
    rng = np.random.RandomState(33)
    X = rng.randn(250, 4)
    y = (X @ rng.randn(4) > 0).astype(np.float64)
    bh = _train(lib, dense_handle(lib, X, y))
    got, call = _sparse_contrib(lib, bh, X, 0, np.float32, ctypes.c_float)
    tb = py_pair(X, y, TRAIN, 3)[1]
    want = tb.predict(np.asarray(X, np.float32).astype(np.float64), pred_contrib=True)
    np.testing.assert_array_equal(got, want.astype(np.float32).astype(np.float64))
    assert call(3, 2) == -1  # C_API_DTYPE_INT32
