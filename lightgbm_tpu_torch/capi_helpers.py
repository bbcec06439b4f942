"""Python side of the port's C API shim
(csrc/capi/lightgbm_tpu_torch_c_api.cpp; build it with
native.c_api_library()).

Counterpart of lightgbm_tpu/capi_helpers.py, function for function.  The C
layer passes raw pointers as integers; numpy wraps them zero-copy via
ctypes, mirroring the reference's c_api.cpp which operates directly on the
caller's buffers.  Kept deliberately thin: every function takes/returns
plain scalars, strings or Booster objects so the C side needs no numpy ABI.

Training and prediction run on the card unless the parameters say
device_type=cpu; with no card visible a Booster or a Dataset that does
not say so raises (models/gbdt.py::resolve_device), and the C entry point
returns -1 with that message.  Where the JAX module reads its GBDT's
internals, this one reads the port's: ``booster_update`` turns on the
per-call finish report (GBDT._report_finish_every_iter, one iteration
late off the strict grower), the refit takes its gradients from the
port's objectives on the booster's device and its per-leaf sums from B1,
and the network calls bring up a torch.distributed process group.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .basic import Booster, Dataset, LightGBMError, _read_model_file

_PREDICT_NORMAL = 0
_PREDICT_RAW_SCORE = 1
_PREDICT_LEAF_INDEX = 2
_PREDICT_CONTRIB = 3

# reference: C_API_DTYPE_* in include/LightGBM/c_api.h
_DTYPES = {0: np.float32, 1: np.float64, 2: np.int32, 3: np.int64}
_CTYPES = {0: ctypes.c_float, 1: ctypes.c_double, 2: ctypes.c_int32, 3: ctypes.c_int64}


def _parse_params(parameters: str) -> dict:
    """reference: Config::Str2Map — 'k1=v1 k2=v2' (space/newline separated)."""
    out = {}
    for tok in parameters.replace("\n", " ").split():
        if "=" not in tok:
            continue
        k, v = tok.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if isinstance(v, str):
            # bool-likes must not stay truthy strings ('header=false' would
            # otherwise drop the first data row); mirror Config._coerce
            low = v.lower()
            if low in ("true", "+", "yes"):
                v = True
            elif low in ("false", "-", "no"):
                v = False
        out[k] = v
    return out


def _dataset_params(parameters: str) -> dict:
    """A new Dataset's parameters, its device resolved now: without
    device_type=cpu and with no card visible this raises (no fallback),
    so the C entry point returns -1 with resolve_device's message."""
    from .config import Config
    from .models.gbdt import resolve_device

    params = _parse_params(parameters)
    resolve_device(Config.from_dict(params))
    return params


def _loaded_params(model_str: str) -> dict:
    """The device a model text records in its parameters ([device_type:
    ...]), which a C host has no other way to pass to the loaders
    (reference: the loaded model's config, loaded_parameter_)."""
    import re

    m = re.search(r"^\[device_type: (cuda|gpu|cpu)\]$", model_str, re.M)
    return {"device_type": m.group(1)} if m else {}


def booster_from_file(filename: str) -> Booster:
    model_str = _read_model_file(filename)  # a snapshot's trailer verified
    return Booster(params=_loaded_params(model_str), model_str=model_str)


def booster_from_string(model_str: str) -> Booster:
    return Booster(params=_loaded_params(model_str), model_str=model_str)


def num_classes(bst: Booster) -> int:
    return int(getattr(bst._gbdt, "num_tree_per_iteration", 1))


def save_model(bst: Booster, filename: str, start_iteration: int,
               num_iteration: int) -> bool:
    bst.save_model(filename, num_iteration=num_iteration,
                   start_iteration=start_iteration)
    return True


def _wrap(addr: int, shape, dtype=np.float64) -> np.ndarray:
    size = int(np.prod(shape))
    ctype = ctypes.c_double if dtype == np.float64 else ctypes.c_float
    buf = (ctype * size).from_address(addr)
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


# -- dataset surface (reference: LGBM_Dataset*) --------------------------

def _wrap_typed(addr: int, shape, dtype_code: int) -> np.ndarray:
    size = int(np.prod(shape))
    buf = (_CTYPES[dtype_code] * size).from_address(addr)
    return np.frombuffer(buf, dtype=_DTYPES[dtype_code]).reshape(shape)


def dataset_from_mat(data_addr: int, dtype_code: int, nrow: int, ncol: int,
                     is_row_major: int, parameters: str, reference) -> Dataset:
    if is_row_major:
        x = _wrap_typed(data_addr, (nrow, ncol), dtype_code)
    else:
        x = _wrap_typed(data_addr, (ncol, nrow), dtype_code).T
    # copy: the Dataset outlives the caller's buffer (reference copies into
    # its own bins during construction as well)
    ds = Dataset(np.array(x, np.float64), params=_dataset_params(parameters),
                 reference=reference if isinstance(reference, Dataset) else None,
                 free_raw_data=False)
    return ds


def dataset_from_file(filename: str, parameters: str, reference) -> Dataset:
    from .io.parser import load_data_file

    params = _dataset_params(parameters)
    loaded = load_data_file(
        filename,
        header=bool(params.get("header", False)),
        label_column=str(params.get("label_column", "")),
        weight_column=str(params.get("weight_column", "")),
        group_column=str(params.get("group_column", "")),
        ignore_column=str(params.get("ignore_column", "")),
    )
    ds = Dataset(loaded["data"], label=loaded.get("label"),
                 weight=loaded.get("weight"), group=loaded.get("group"),
                 params=params,
                 reference=reference if isinstance(reference, Dataset) else None,
                 free_raw_data=False)
    return ds


def dataset_set_field(ds, field_name: str, data_addr: int,
                      num_element: int, dtype_code: int) -> bool:
    if num_element == 0 or data_addr == 0:
        ds.set_field(field_name, None)  # reference: zero-length clears
        return True
    arr = np.array(_wrap_typed(data_addr, (num_element,), dtype_code))
    ds.set_field(field_name, arr)  # Dataset and StreamingDataset both accept
    return True


def dataset_get_num_data(ds) -> int:
    return int(_as_dataset(ds).num_data())


def dataset_get_num_feature(ds) -> int:
    return int(_as_dataset(ds).num_feature())


def dataset_get_feature_num_bin(ds, feature_idx: int) -> int:
    """reference: LGBM_DatasetGetFeatureNumBin -> Dataset::FeatureNumBin."""
    d = _as_dataset(ds)
    d.construct()
    nbpf = d.binner.num_bins_per_feature
    if not (0 <= feature_idx < len(nbpf)):
        raise IndexError(f"feature index {feature_idx} out of range")
    return int(nbpf[feature_idx])


class StreamingDataset:
    """Push-rows accumulator (reference: LGBM_DatasetCreateByReference +
    LGBM_DatasetPushRows streaming construction).  Rows stream into a
    preallocated buffer; the real Dataset materializes bin-aligned to the
    reference once all rows have arrived."""

    def __init__(self, reference: Dataset, num_total_row: int):
        reference.construct()
        self.reference = reference
        self.num_total = int(num_total_row)
        self.ncol = reference.num_feature()
        self.buf = np.full((self.num_total, self.ncol), np.nan, np.float64)
        self.fields = {}
        self.pushed = 0
        self._ds = None

    def push(self, rows: np.ndarray, start_row: int) -> None:
        n = rows.shape[0]
        self.buf[start_row: start_row + n] = rows
        self.pushed += n

    def set_field(self, name, arr):
        self.fields[name] = arr

    def dataset(self) -> Dataset:
        if self._ds is None:
            if self.pushed < self.num_total and not getattr(self, "_finished", False):
                raise ValueError(
                    f"only {self.pushed}/{self.num_total} rows pushed")
            names = list(getattr(self.reference, "feature_names", []) or [])
            # the reference's parameters carry its device_type
            self._ds = Dataset(self.buf, reference=self.reference,
                              params=dict(self.reference.params),
                              feature_name=names or "auto",
                              free_raw_data=False)
            for k, v in self.fields.items():
                self._ds.set_field(k, v)
        return self._ds


def _as_dataset(ds) -> Dataset:
    return ds.dataset() if isinstance(ds, StreamingDataset) else ds


def dataset_create_by_reference(reference: Dataset, num_total_row: int) -> StreamingDataset:
    return StreamingDataset(_as_dataset(reference), num_total_row)


def dataset_push_rows(ds: StreamingDataset, data_addr: int, dtype_code: int,
                      nrow: int, ncol: int, start_row: int) -> bool:
    rows = np.array(_wrap_typed(data_addr, (nrow, ncol), dtype_code), np.float64)
    ds.push(rows, start_row)
    return True


# -- booster training surface (reference: LGBM_Booster*) ------------------

def booster_create(train_set, parameters: str) -> Booster:
    params = _parse_params(parameters)
    if _NETWORK_PARAMS:  # LGBM_NetworkInit state is global, like the reference
        params = dict(_NETWORK_PARAMS, **params)
    return Booster(params=params, train_set=_as_dataset(train_set))


def booster_add_valid(bst: Booster, valid_set) -> bool:
    valid_set = _as_dataset(valid_set)
    name = f"valid_{len(getattr(bst._gbdt, 'valid_sets', []))}"
    bst.add_valid(valid_set, name)
    return True


def booster_update(bst: Booster) -> int:
    # the reference's LGBM_BoosterUpdateOneIter reports is_finished per call;
    # flip the rounds and windowed paths from their deferred (every-32)
    # check to the one-iteration-late pinned copy (the strict path answers
    # at once)
    bst._gbdt._report_finish_every_iter = True
    return 1 if bst.update() else 0


def booster_update_custom(bst: Booster, grad_addr: int, hess_addr: int) -> int:
    n = bst._train_set.num_data() * num_classes(bst)
    grad = np.array(_wrap_typed(grad_addr, (n,), 0), np.float64)
    hess = np.array(_wrap_typed(hess_addr, (n,), 0), np.float64)
    return 1 if bst._gbdt.train_one_iter(grad, hess) else 0


def booster_rollback(bst: Booster) -> bool:
    bst.rollback_one_iter()
    return True


def booster_current_iteration(bst: Booster) -> int:
    return int(bst.current_iteration())


def booster_num_total_model(bst: Booster) -> int:
    return int(bst.num_trees())


def booster_num_feature(bst: Booster) -> int:
    return int(bst.num_feature())


def booster_reset_parameter(bst: Booster, parameters: str) -> bool:
    bst.reset_parameter(_parse_params(parameters))
    return True


def booster_reset_training_data(bst: Booster, train_set) -> bool:
    """reference: LGBM_BoosterResetTrainingData -> GBDT::ResetTrainingData
    (existing trees kept; subsequent updates train on the new data).  As in
    the JAX package, the new data's score starts at its Dataset's
    init_score, without the kept trees (ROADMAP C22)."""
    ds = _as_dataset(train_set)
    bst._train_set = ds
    bst._gbdt.reset_training_data(ds)
    return True


def booster_eval_counts(bst: Booster) -> int:
    res = bst.eval_train()
    return len(res)


def booster_get_eval_into(bst: Booster, data_idx: int, out_addr: int) -> int:
    """data_idx 0 = train, i>0 = i-th valid set (reference:
    LGBM_BoosterGetEval)."""
    res = bst.eval_train() if data_idx == 0 else bst.eval_valid()
    if data_idx > 0:
        # filter to the requested valid set (eval_valid returns all); the
        # reference indexes valid sets by REGISTRATION order, and sorting
        # would misorder >=10 auto-named sets ('valid_10' < 'valid_2')
        names = list(getattr(bst._gbdt, "valid_names", []))
        if data_idx - 1 >= len(names):
            return 0  # out-of-range index must not spill all sets' metrics
        want = names[data_idx - 1]
        res = [r for r in res if r[0] == want]
    vals = np.asarray([r[2] for r in res], np.float64)
    dest = _wrap(out_addr, (len(vals),))
    dest[:] = vals
    return len(vals)


def booster_save_string(bst: Booster, start_iteration: int,
                        num_iteration: int) -> str:
    return bst.model_to_string(num_iteration=num_iteration,
                               start_iteration=start_iteration)


def booster_dump_json(bst: Booster, start_iteration: int,
                      num_iteration: int) -> str:
    import json

    return json.dumps(bst.dump_model(num_iteration=num_iteration,
                                     start_iteration=start_iteration),
                      default=float)


def booster_feature_importance_into(bst: Booster, importance_type: int,
                                    out_addr: int) -> int:
    imp = bst.feature_importance("gain" if importance_type == 1 else "split")
    dest = _wrap(out_addr, (len(imp),))
    dest[:] = np.asarray(imp, np.float64)
    return len(imp)


def predict_into(bst: Booster, data_addr: int, data_type: int, nrow: int,
                 ncol: int, is_row_major: int, predict_type: int,
                 start_iteration: int, num_iteration: int, parameter: str,
                 out_addr: int) -> int:
    if is_row_major:
        x = _wrap_typed(data_addr, (nrow, ncol), data_type)
    else:
        x = _wrap_typed(data_addr, (ncol, nrow), data_type).T
    return _predict_any_into(bst, x, predict_type, out_addr,
                             **_predict_kw(start_iteration, num_iteration,
                                           parameter))


# ---- CSR surface (reference: LGBM_DatasetCreateFromCSR /
#      LGBM_BoosterPredictForCSR in src/c_api.cpp) ----

def _wrap_csr(indptr_addr: int, indptr_type: int, indices_addr: int,
              data_addr: int, data_type: int, nindptr: int, nelem: int,
              num_col: int):
    import scipy.sparse as sp

    indptr = np.array(_wrap_typed(indptr_addr, (nindptr,), indptr_type))
    indices = np.array(_wrap_typed(indices_addr, (nelem,), 2))  # int32
    data = np.array(_wrap_typed(data_addr, (nelem,), data_type))
    return sp.csr_matrix((data, indices, indptr),
                         shape=(nindptr - 1, num_col))


def dataset_from_csr(indptr_addr: int, indptr_type: int, indices_addr: int,
                     data_addr: int, data_type: int, nindptr: int,
                     nelem: int, num_col: int, parameters: str,
                     reference) -> Dataset:
    x = _wrap_csr(indptr_addr, indptr_type, indices_addr, data_addr,
                  data_type, nindptr, nelem, num_col)
    return Dataset(x, params=_dataset_params(parameters),
                   reference=reference if isinstance(reference, Dataset) else None,
                   free_raw_data=False)


def predict_csr_into(bst: Booster, indptr_addr: int, indptr_type: int,
                     indices_addr: int, data_addr: int, data_type: int,
                     nindptr: int, nelem: int, num_col: int,
                     predict_type: int, start_iteration: int,
                     num_iteration: int, parameter: str,
                     out_addr: int) -> int:
    x = _wrap_csr(indptr_addr, indptr_type, indices_addr, data_addr,
                  data_type, nindptr, nelem, num_col)
    return _predict_any_into(bst, x, predict_type, out_addr,
                             **_predict_kw(start_iteration, num_iteration,
                                           parameter))


def _predict_kw(start_iteration: int = 0, num_iteration: int = -1,
                parameter: str = "") -> dict:
    """Predict kwargs from the reference C predict-entry triple
    (start_iteration, num_iteration, parameter).  The explicit C arguments
    win over any duplicates inside the parameter string (reference:
    LGBM_BoosterPredictForMat passes them straight into the Config).
    Predict-MODE keys are dropped too: the C predict_type argument is
    authoritative and _predict_any_into passes the matching kwarg
    explicitly — forwarding a duplicate from the string would raise
    TypeError where the reference Config just tolerates it."""
    kw = _parse_params(parameter or "")
    for mode_key in ("raw_score", "predict_raw_score", "pred_leaf",
                     "predict_leaf_index", "pred_contrib", "predict_contrib",
                     "leaf_index", "contrib", "is_predict_raw_score",
                     "is_predict_leaf_index", "is_predict_contrib"):
        kw.pop(mode_key, None)
    kw["start_iteration"] = int(start_iteration)
    kw["num_iteration"] = int(num_iteration)
    return kw


def _predict_any_into(bst: Booster, x, predict_type: int, out_addr: int,
                      **kw) -> int:
    if predict_type == _PREDICT_LEAF_INDEX:
        out = bst.predict(x, pred_leaf=True, **kw).astype(np.float64)
    elif predict_type == _PREDICT_CONTRIB:
        out = bst.predict(x, pred_contrib=True, **kw)
    elif predict_type == _PREDICT_RAW_SCORE:
        out = bst.predict(x, raw_score=True, **kw)
    else:
        out = bst.predict(x, **kw)
    out = np.ascontiguousarray(out, np.float64).ravel()
    dest = _wrap(out_addr, (out.size,))
    dest[:] = out
    return int(out.size)


# ---- single-row fast predict (reference: SingleRowPredictor +
#      LGBM_BoosterPredictForMatSingleRowFast / FastConfigHandle) ----

class _FastConfig:
    """Opaque FastConfig handle: booster + frozen predict settings
    (reference: FastConfig in src/c_api.cpp — caches everything so the
    per-call path only reads one row and writes one result)."""

    def __init__(self, bst: Booster, predict_type: int, data_type: int,
                 ncol: int, parameters: str = ""):
        self.bst = bst
        self.predict_type = predict_type
        self.data_type = data_type
        self.ncol = ncol
        p = _parse_params(parameters)
        self.num_iteration = int(p.pop("num_iteration", -1))
        self.start_iteration = int(p.pop("start_iteration", 0))
        self.kwargs = p  # e.g. predict_disable_shape_check


def predict_single_row_fast_init(bst: Booster, predict_type: int,
                                 start_iteration: int, num_iteration: int,
                                 data_type: int, ncol: int,
                                 parameters: str = "") -> _FastConfig:
    cfg = _FastConfig(bst, predict_type, data_type, ncol, parameters)
    # the explicit C arguments win over duplicates in the parameter string
    cfg.start_iteration = int(start_iteration)
    cfg.num_iteration = int(num_iteration)
    # serving warm-up: pack the ensemble into the device-resident cache
    # NOW, so the steady-state per-call path is one warm traversal — init
    # pays the cold cost once (reference: SingleRowPredictor caches its
    # Predictor the same way)
    if predict_type in (_PREDICT_NORMAL, _PREDICT_RAW_SCORE,
                        _PREDICT_LEAF_INDEX):
        try:
            # one dummy predict packs the exact (start, num) ensemble the
            # per-call path will serve
            bst.predict(np.zeros((1, ncol)),
                        start_iteration=cfg.start_iteration,
                        num_iteration=cfg.num_iteration,
                        raw_score=cfg.predict_type == _PREDICT_RAW_SCORE,
                        pred_leaf=cfg.predict_type == _PREDICT_LEAF_INDEX,
                        **cfg.kwargs)
        except Exception:  # noqa: BLE001 — warm-up must never fail init
            pass
    return cfg


def predict_single_row_fast(cfg: _FastConfig, data_addr: int,
                            out_addr: int) -> int:
    x = np.array(_wrap_typed(data_addr, (1, cfg.ncol), cfg.data_type),
                 np.float64)
    return _predict_any_into(cfg.bst, x, cfg.predict_type, out_addr,
                             num_iteration=cfg.num_iteration,
                             start_iteration=cfg.start_iteration,
                             **cfg.kwargs)


def predict_single_row_into(bst: Booster, data_addr: int, ncol: int,
                            data_type: int, predict_type: int,
                            start_iteration: int, num_iteration: int,
                            parameter: str, out_addr: int) -> int:
    x = np.array(_wrap_typed(data_addr, (1, ncol), data_type), np.float64)
    return _predict_any_into(bst, x, predict_type, out_addr,
                             **_predict_kw(start_iteration, num_iteration,
                                           parameter))


# ---- CSC surface (reference: LGBM_DatasetCreateFromCSC /
#      LGBM_BoosterPredictForCSC in src/c_api.cpp) ----

def _wrap_csc(colptr_addr: int, colptr_type: int, indices_addr: int,
              data_addr: int, data_type: int, ncolptr: int, nelem: int,
              num_row: int):
    import scipy.sparse as sp

    colptr = np.array(_wrap_typed(colptr_addr, (ncolptr,), colptr_type))
    indices = np.array(_wrap_typed(indices_addr, (nelem,), 2))  # int32
    data = np.array(_wrap_typed(data_addr, (nelem,), data_type))
    return sp.csc_matrix((data, indices, colptr),
                         shape=(num_row, ncolptr - 1))


def dataset_from_csc(colptr_addr: int, colptr_type: int, indices_addr: int,
                     data_addr: int, data_type: int, ncolptr: int,
                     nelem: int, num_row: int, parameters: str,
                     reference) -> Dataset:
    x = _wrap_csc(colptr_addr, colptr_type, indices_addr, data_addr,
                  data_type, ncolptr, nelem, num_row)
    return Dataset(x, params=_dataset_params(parameters),
                   reference=reference if isinstance(reference, Dataset) else None,
                   free_raw_data=False)


def predict_sparse_output(bst: Booster, indptr_addr: int, indptr_type: int,
                          indices_addr: int, data_addr: int, data_type: int,
                          nindptr: int, nelem: int, num_col_or_row: int,
                          predict_type: int, start_iteration: int,
                          num_iteration: int, parameter: str,
                          matrix_type: int) -> tuple:
    """reference: LGBM_BoosterPredictSparseOutput — SHAP contributions as a
    library-allocated sparse matrix (CSR for matrix_type 0, CSC for 1; the
    input shares the same layout).  Only C_API_PREDICT_CONTRIB is legal,
    matching the reference's check.  Returns
    (indptr_addr, indices_addr, data_addr, n_indptr, nnz) where the three
    buffers are malloc()'d here (libc) so LGBM_BoosterFreePredictSparse can
    free() them from C; indptr is written in indptr_type, data in the
    REQUESTED data_type — f32 or f64, exactly like the reference
    allocates per data_type.  Multiclass contribs are laid out as
    (nrow, num_class*(num_feature+1)), the reference's dense flattening."""
    import ctypes.util
    import scipy.sparse as sp

    if predict_type != _PREDICT_CONTRIB:
        raise ValueError(
            "LGBM_BoosterPredictSparseOutput only supports predict_type="
            "C_API_PREDICT_CONTRIB (reference: c_api.cpp same check)")
    if matrix_type == 0:  # CSR input/output
        x = _wrap_csr(indptr_addr, indptr_type, indices_addr, data_addr,
                      data_type, nindptr, nelem, num_col_or_row)
    else:  # CSC
        x = _wrap_csc(indptr_addr, indptr_type, indices_addr, data_addr,
                      data_type, nindptr, nelem, num_col_or_row)
    contrib = bst.predict(
        x, pred_contrib=True,
        **_predict_kw(start_iteration, num_iteration, parameter))
    # sparsify in f64 (exact zero detection on the model's own outputs),
    # then narrow the kept values to the caller's requested dtype
    contrib = np.ascontiguousarray(
        np.asarray(contrib, np.float64).reshape(x.shape[0], -1))
    mat = (sp.csr_matrix(contrib) if matrix_type == 0
           else sp.csc_matrix(contrib))
    out_indptr = np.asarray(
        mat.indptr, np.int64 if indptr_type == 3 else np.int32)
    out_indices = np.asarray(mat.indices, np.int32)
    out_data = np.asarray(
        mat.data, np.float32 if data_type == 0 else np.float64)

    libc = ctypes.CDLL(None)
    libc.malloc.restype = ctypes.c_void_p
    libc.malloc.argtypes = [ctypes.c_size_t]

    def _to_c(arr):
        nb = max(arr.nbytes, 1)
        addr = libc.malloc(nb)
        if not addr:
            raise MemoryError(f"malloc({nb}) failed")
        ctypes.memmove(addr, arr.ctypes.data, arr.nbytes)
        return addr

    return (_to_c(out_indptr), _to_c(out_indices), _to_c(out_data),
            int(len(out_indptr)), int(len(out_data)))


def predict_csc_into(bst: Booster, colptr_addr: int, colptr_type: int,
                     indices_addr: int, data_addr: int, data_type: int,
                     ncolptr: int, nelem: int, num_row: int,
                     predict_type: int, start_iteration: int,
                     num_iteration: int, parameter: str,
                     out_addr: int) -> int:
    x = _wrap_csc(colptr_addr, colptr_type, indices_addr, data_addr,
                  data_type, ncolptr, nelem, num_row)
    return _predict_any_into(bst, x, predict_type, out_addr,
                             **_predict_kw(start_iteration, num_iteration,
                                           parameter))


# ---- multi-block matrices (reference: LGBM_DatasetCreateFromMats /
#      LGBM_BoosterPredictForMats) ----

def _wrap_mats(nmat: int, data_ptrs_addr: int, dtype_code: int,
               nrow_addr: int, ncol: int, is_row_major: int) -> np.ndarray:
    ptrs = np.array(_wrap_typed(data_ptrs_addr, (nmat,), 3))  # void** as i64
    nrows = np.array(_wrap_typed(nrow_addr, (nmat,), 2))
    blocks = []
    for p, nr in zip(ptrs, nrows):
        if is_row_major:
            b = _wrap_typed(int(p), (int(nr), ncol), dtype_code)
        else:
            b = _wrap_typed(int(p), (ncol, int(nr)), dtype_code).T
        blocks.append(np.array(b, np.float64))
    return np.vstack(blocks)


def dataset_from_mats(nmat: int, data_ptrs_addr: int, dtype_code: int,
                      nrow_addr: int, ncol: int, is_row_major: int,
                      parameters: str, reference) -> Dataset:
    x = _wrap_mats(nmat, data_ptrs_addr, dtype_code, nrow_addr, ncol,
                   is_row_major)
    return Dataset(x, params=_dataset_params(parameters),
                   reference=reference if isinstance(reference, Dataset) else None,
                   free_raw_data=False)


def predict_mats_into(bst: Booster, nmat: int, data_ptrs_addr: int,
                      dtype_code: int, nrow_addr: int, ncol: int,
                      predict_type: int, start_iteration: int,
                      num_iteration: int, parameter: str,
                      out_addr: int) -> int:
    x = _wrap_mats(nmat, data_ptrs_addr, dtype_code, nrow_addr, ncol, 1)
    return _predict_any_into(bst, x, predict_type, out_addr,
                             **_predict_kw(start_iteration, num_iteration,
                                           parameter))


# ---- sampled-column schema construction (reference:
#      LGBM_DatasetCreateFromSampledColumn → DatasetLoader::
#      ConstructFromSampleData: bin mappers come from the per-column value
#      sample; rows stream in afterwards via PushRows) ----

def dataset_from_sampled_column(sample_ptrs_addr: int, indices_ptrs_addr: int,
                                ncol: int, num_per_col_addr: int,
                                num_sample_row: int, num_local_row: int,
                                parameters: str) -> "StreamingDataset":
    col_ptrs = np.array(_wrap_typed(sample_ptrs_addr, (ncol,), 3))
    idx_ptrs = np.array(_wrap_typed(indices_ptrs_addr, (ncol,), 3))
    counts = np.array(_wrap_typed(num_per_col_addr, (ncol,), 2))
    sample = np.zeros((num_sample_row, ncol), np.float64)
    for c in range(ncol):
        k = int(counts[c])
        if k == 0:
            continue
        vals = np.array(_wrap_typed(int(col_ptrs[c]), (k,), 1))
        rows = np.array(_wrap_typed(int(idx_ptrs[c]), (k,), 2))
        sample[rows, c] = vals
    schema = Dataset(sample, params=_dataset_params(parameters),
                     free_raw_data=False)
    schema.construct()
    return StreamingDataset(schema, num_local_row)


# ---- dataset field / name / persistence surface ------------------------

# reference: LGBM_DatasetGetField returns a pointer into dataset-owned
# memory typed per field (label/weight float32, init_score float64,
# group int32 boundaries).
_FIELD_OUT_TYPES = {"label": 0, "weight": 0, "init_score": 1,
                    "group": 2, "query": 2, "position": 2}


def dataset_get_field(ds, field_name: str):
    """Returns (addr, num_element, dtype_code); the array stays alive on the
    dataset (reference hands out internal pointers the same way)."""
    ds = _as_dataset(ds)
    val = ds.get_field(field_name)
    code = _FIELD_OUT_TYPES.get(field_name)
    if code is None:
        raise ValueError(f"Unknown field: {field_name}")
    if val is None:
        return (0, 0, code)
    if field_name in ("group", "query"):
        # sizes -> cumulative boundaries, as the reference returns
        val = ds.query_boundaries
    arr = np.ascontiguousarray(val, _DTYPES[code])
    if not hasattr(ds, "_capi_field_cache"):
        ds._capi_field_cache = {}
    ds._capi_field_cache[field_name] = arr
    return (int(arr.ctypes.data), int(arr.size), code)


def dataset_set_feature_names(ds, names) -> bool:
    _as_dataset(ds).set_feature_name(list(names))
    return True


def dataset_feature_names(ds):
    return list(_as_dataset(ds).get_feature_name())


def dataset_save_binary(ds, filename: str) -> bool:
    _as_dataset(ds).save_binary(filename)
    return True


def dataset_dump_text(ds, filename: str) -> bool:
    """reference: LGBM_DatasetDumpText — human-readable dataset dump."""
    ds = _as_dataset(ds)
    ds.construct()
    with open(filename, "w") as f:
        f.write("\t".join(ds.get_feature_name()) + "\n")
        data = ds.get_data()
        if data is not None:
            arr = np.asarray(data if not hasattr(data, "toarray") else data.toarray())
            for row in arr:
                f.write("\t".join(repr(float(v)) for v in row) + "\n")
        else:  # raw freed: dump binned values (still row-per-line)
            for row in ds._host_bins("dump_text"):
                f.write("\t".join(str(int(v)) for v in row) + "\n")
    return True


def dataset_get_subset(ds, indices_addr: int, num_indices: int,
                       parameters: str) -> Dataset:
    idx = np.array(_wrap_typed(indices_addr, (num_indices,), 2))
    return _as_dataset(ds).subset(idx, params=_parse_params(parameters))


def dataset_add_features_from(target, source) -> bool:
    _as_dataset(target).add_features_from(_as_dataset(source))
    return True


# params that change the binned representation; changing them between a
# reference dataset and a dependent one is the conflict the reference's
# LGBM_DatasetUpdateParamChecking exists to catch
_DATASET_PARAMS = (
    "max_bin", "min_data_in_bin", "bin_construct_sample_cnt",
    "zero_as_missing", "use_missing", "enable_bundle", "max_bin_by_feature",
    "categorical_feature", "feature_pre_filter", "two_round", "header",
    "label_column", "weight_column", "group_column", "ignore_column",
    "precise_float_parser", "forcedbins_filename", "linear_tree",
)


def dataset_update_param_checking(old_parameters: str,
                                  new_parameters: str) -> bool:
    from .config import Config

    old = _parse_params(old_parameters)
    new = _parse_params(new_parameters)
    # compare EFFECTIVE values: a new param restating the default the old
    # config already had is not a conflict (reference builds Configs from
    # both strings and diffs them)
    cfg_old = Config.from_dict(old)
    cfg_new = Config.from_dict(dict(old, **new))

    def effective(cfg, key):
        return getattr(cfg, key, cfg.extra.get(key))

    for k in _DATASET_PARAMS:
        if effective(cfg_old, k) != effective(cfg_new, k):
            raise ValueError(
                f"Cannot change {k} after constructed Dataset handle")
    return True


def dataset_push_rows_by_csr(ds: "StreamingDataset", indptr_addr: int,
                             indptr_type: int, indices_addr: int,
                             data_addr: int, data_type: int, nindptr: int,
                             nelem: int, num_col: int, start_row: int) -> bool:
    x = _wrap_csr(indptr_addr, indptr_type, indices_addr, data_addr,
                  data_type, nindptr, nelem, num_col)
    ds.push(np.asarray(x.todense(), np.float64), start_row)
    return True


# ---- streaming metadata (reference: LGBM_DatasetInitStreaming /
#      LGBM_DatasetPushRows*WithMetadata / LGBM_DatasetMarkFinished) ----

def dataset_init_streaming(ds: "StreamingDataset", has_weights: int,
                           has_init_scores: int, has_queries: int,
                           nclasses: int) -> bool:
    n = ds.num_total
    ds.fields["label"] = np.zeros(n, np.float64)
    if has_weights:
        ds.fields["weight"] = np.zeros(n, np.float64)
    if has_init_scores:
        ds.fields["init_score"] = np.zeros((n, max(nclasses, 1)) if nclasses > 1
                                           else n, np.float64)
    if has_queries:
        ds._stream_qids = np.zeros(n, np.int64)
    ds._manual_finish = True
    return True


def dataset_push_rows_with_metadata(ds: "StreamingDataset", data_addr: int,
                                    dtype_code: int, nrow: int, ncol: int,
                                    start_row: int, label_addr: int,
                                    weight_addr: int, init_score_addr: int,
                                    query_addr: int) -> bool:
    rows = np.array(_wrap_typed(data_addr, (nrow, ncol), dtype_code),
                    np.float64)
    ds.push(rows, start_row)
    sl = slice(start_row, start_row + nrow)
    if label_addr:
        ds.fields.setdefault("label", np.zeros(ds.num_total, np.float64))[sl] = \
            np.array(_wrap_typed(label_addr, (nrow,), 0))
    if weight_addr:
        ds.fields.setdefault("weight", np.zeros(ds.num_total, np.float64))[sl] = \
            np.array(_wrap_typed(weight_addr, (nrow,), 0))
    if init_score_addr:
        _push_init_scores(ds, init_score_addr, nrow, sl)
    if query_addr:
        if not hasattr(ds, "_stream_qids"):
            ds._stream_qids = np.zeros(ds.num_total, np.int64)
        ds._stream_qids[sl] = np.array(_wrap_typed(query_addr, (nrow,), 2))
    return True


def _push_init_scores(ds, init_score_addr, nrow, sl):
    """Multiclass pushes nrow*k doubles class-major (reference:
    Metadata::InsertInitScores layout)."""
    buf = ds.fields.setdefault("init_score", np.zeros(ds.num_total, np.float64))
    if buf.ndim == 2:
        k = buf.shape[1]
        vals = np.array(_wrap_typed(init_score_addr, (k, nrow), 1))
        buf[sl] = vals.T
    else:
        buf[sl] = np.array(_wrap_typed(init_score_addr, (nrow,), 1))


def dataset_push_rows_by_csr_with_metadata(ds: "StreamingDataset",
                                           indptr_addr: int, indptr_type: int,
                                           indices_addr: int, data_addr: int,
                                           data_type: int, nindptr: int,
                                           nelem: int, num_col: int,
                                           start_row: int, label_addr: int,
                                           weight_addr: int,
                                           init_score_addr: int,
                                           query_addr: int) -> bool:
    x = _wrap_csr(indptr_addr, indptr_type, indices_addr, data_addr,
                  data_type, nindptr, nelem, num_col)
    nrow = x.shape[0]
    ds.push(np.asarray(x.todense(), np.float64), start_row)
    sl = slice(start_row, start_row + nrow)
    if label_addr:
        ds.fields.setdefault("label", np.zeros(ds.num_total, np.float64))[sl] = \
            np.array(_wrap_typed(label_addr, (nrow,), 0))
    if weight_addr:
        ds.fields.setdefault("weight", np.zeros(ds.num_total, np.float64))[sl] = \
            np.array(_wrap_typed(weight_addr, (nrow,), 0))
    if init_score_addr:
        _push_init_scores(ds, init_score_addr, nrow, sl)
    if query_addr:
        if not hasattr(ds, "_stream_qids"):
            ds._stream_qids = np.zeros(ds.num_total, np.int64)
        ds._stream_qids[sl] = np.array(_wrap_typed(query_addr, (nrow,), 2))
    return True


def dataset_mark_finished(ds: "StreamingDataset") -> bool:
    if hasattr(ds, "_stream_qids"):
        qid = ds._stream_qids
        change = np.nonzero(np.diff(qid) != 0)[0] + 1
        bounds = np.concatenate([[0], change, [len(qid)]])
        ds.fields["group"] = np.diff(bounds).astype(np.int64)
    ds._finished = True
    ds.dataset()
    return True


def dataset_set_wait_for_manual_finish(ds: "StreamingDataset",
                                       wait: int) -> bool:
    ds._manual_finish = bool(wait)
    return True


# ---- serialized reference + ByteBuffer (reference:
#      LGBM_DatasetSerializeReferenceToBinary /
#      LGBM_DatasetCreateFromSerializedReference / LGBM_ByteBuffer*) ----

_SCHEMA_MAGIC = b"LGBMTPU-SCHEMA\x01"  # magic + format version byte


def dataset_serialize_reference(ds) -> bytes:
    """Schema-only serialization: bin mappers + names, enough for a remote
    worker to construct a bin-aligned streaming dataset.

    The buffer crosses process/machine boundaries (SynapseML-style hosts
    forward it over the network), so it is inert data — a magic/version
    header, a JSON descriptor and np.savez numeric arrays — never pickled
    code (the reference's counterpart is a plain binary schema dump)."""
    import io
    import json

    ds = _as_dataset(ds)
    ds.construct()
    mappers = ds.binner.mappers
    arrays = {
        "missing_type": np.array([m.missing_type for m in mappers], np.int32),
        "is_categorical": np.array([m.is_categorical for m in mappers],
                                   np.bool_),
        "min_value": np.array([m.min_value for m in mappers], np.float64),
        "max_value": np.array([m.max_value for m in mappers], np.float64),
    }
    for i, m in enumerate(mappers):
        ub = m.upper_bounds if m.upper_bounds is not None else np.zeros(0)
        arrays[f"ub{i}"] = np.asarray(ub, np.float64)
        if m.categories is not None:
            arrays[f"cat{i}"] = np.asarray(m.categories, np.float64)
    header = json.dumps({
        "n_features": len(mappers),
        "feature_names": list(ds.get_feature_name()),
        "params": {k: v for k, v in (ds.params or {}).items()
                   if isinstance(v, (int, float, str, bool))},
    }).encode()
    buf = io.BytesIO()
    np.savez(buf, header=np.frombuffer(header, np.uint8), **arrays)
    return _SCHEMA_MAGIC + buf.getvalue()


def dataset_from_serialized_reference(buf_addr: int, buf_size: int,
                                      num_row: int,
                                      parameters: str) -> "StreamingDataset":
    import io
    import json

    from .binning import BinMapper, DatasetBinner

    raw = bytes((ctypes.c_uint8 * buf_size).from_address(buf_addr))
    if not raw.startswith(_SCHEMA_MAGIC):
        raise ValueError(
            "serialized reference: bad magic or unsupported schema version")
    with np.load(io.BytesIO(raw[len(_SCHEMA_MAGIC):]),
                 allow_pickle=False) as data:
        header = json.loads(bytes(data["header"]).decode())
        mappers = []
        for i in range(int(header["n_features"])):
            mappers.append(BinMapper(
                upper_bounds=data[f"ub{i}"],
                missing_type=int(data["missing_type"][i]),
                is_categorical=bool(data["is_categorical"][i]),
                categories=(data[f"cat{i}"] if f"cat{i}" in data.files
                            else None),
                min_value=float(data["min_value"][i]),
                max_value=float(data["max_value"][i]),
            ))
    # minimal constructed schema carrier: mappers + names (StreamingDataset
    # only reads binner/feature metadata from its reference)
    n_feat = len(mappers)
    schema = Dataset(None, params=dict(header["params"], **_parse_params(parameters)))
    schema.__dict__.update({
        "binner": DatasetBinner(mappers=mappers),
        "feature_names": header["feature_names"],
        "_constructed": True, "_num_feature": n_feat, "_num_data": 0,
    })
    schema.bins = np.zeros((0, n_feat), np.int16)
    return StreamingDataset(schema, num_row)


# ---- booster model-surgery surface -------------------------------------

def booster_merge(bst: Booster, other: Booster) -> bool:
    """reference: LGBM_BoosterMerge — append other's trees.  Deep-copied:
    later leaf mutations on either booster must not corrupt the other."""
    import copy

    gbdt = bst._gbdt
    gbdt.models = gbdt.models + [copy.deepcopy(t) for t in other._gbdt.models]
    return True


def booster_refit_leaf_preds(bst: Booster, leaf_addr: int, nrow: int,
                             ncol: int) -> bool:
    """reference: LGBM_BoosterRefit(leaf_preds) — renew leaf values of each
    tree from the attached training data, rows assigned per the caller's
    leaf-index matrix.  The JAX package's semantics: the score starts at
    the init scores plus the Dataset's init_score, a leaf's new value is
    -G / (H + lambda_l2 + 1e-15) * shrinkage blended by refit_decay_rate,
    and a leaf no row reaches (H 0) keeps its value.  The gradients come
    from the port's objective on the booster's device at the f32 running
    score; the per-leaf sums are B1's (one int16 feature whose bin is the
    leaf id, as continual/refit.py sums them: 64-bit fixed point rounded
    once to f32, so they do not depend on the order of the rows); the
    blend and the running score are f64, as the JAX package's host arrays."""
    import torch

    from .objectives import create_objective
    from .ops.hist_cuda import histogram_multi

    leaf = np.array(_wrap_typed(leaf_addr, (nrow, ncol), 2))
    gbdt = bst._gbdt
    ds = bst._train_set
    if ds is None:
        raise ValueError("Refit requires the training dataset to be attached")
    dsc = _as_dataset(ds)
    dev = gbdt.device
    cfg = gbdt.cfg
    obj = create_objective(cfg)
    k = gbdt.num_tree_per_iteration
    decay = float(cfg.refit_decay_rate)
    label = torch.as_tensor(np.asarray(dsc.label, np.float64), dtype=torch.float32,
                            device=dev)
    # training weights flow through the objective, so the per-leaf g/h sums
    # below aggregate weighted gradients exactly as training did
    weight = (None if dsc.weight is None else torch.as_tensor(
        np.asarray(dsc.weight, np.float64), dtype=torch.float32, device=dev))
    # start the running score where training did: boost_from_average init
    # scores plus any dataset init_score (reference: RefitTree recomputes
    # gradients at the model's current score, not at zero)
    score = np.zeros((nrow, k), np.float64) if k > 1 else np.zeros(nrow, np.float64)
    if gbdt.init_scores and any(s != 0.0 for s in gbdt.init_scores):
        if k > 1:
            score += np.asarray(gbdt.init_scores, np.float64)[None, :]
        else:
            score += float(gbdt.init_scores[0])
    if dsc.init_score is not None:
        score += np.asarray(dsc.init_score, np.float64).reshape(score.shape)
    score = torch.as_tensor(score, device=dev)
    leaves = torch.as_tensor(leaf, device=dev)
    ones = torch.ones(nrow, dtype=torch.bool, device=dev)
    slot = torch.zeros(nrow, dtype=torch.int32, device=dev)
    # compute every renewed leaf table WITHOUT touching the live trees
    # (holding the pack lock through the loop would stall concurrent
    # serving lookups for the whole refit); the sequential score uses the
    # renewed local table, so the math is unchanged
    renewed = []
    v0 = gbdt._pack_version  # structural-mutation guard for the write-back
    for t_i, tree in enumerate(gbdt.models):
        if t_i >= ncol:
            break
        c = t_i % k
        if c == 0:  # gradients refresh once per boosting iteration
            g, h = obj.get_gradients(score.float(), label, weight)
        gc = g[:, c] if g.dim() > 1 else g
        hc = h[:, c] if h.dim() > 1 else h
        li = leaves[:, t_i]
        n_leaf = int(tree.num_leaves)
        sums = histogram_multi(li.to(torch.int16)[:, None].contiguous(),
                               gc.float().contiguous(), hc.float().contiguous(),
                               ones, slot, 0, 1, n_leaf)[0]
        sum_g, sum_h = sums[0, 0].double(), sums[1, 0].double()
        old = torch.as_tensor(np.asarray(tree.leaf_value, np.float64), device=dev)
        new_vals = -sum_g / (sum_h + cfg.lambda_l2 + 1e-15) * tree.shrinkage
        lv_new = decay * old + (1.0 - decay) * torch.where(sum_h > 0, new_vals, old)
        renewed.append(lv_new)
        pred = lv_new[li.long()]
        if k > 1:
            score[:, c] += pred
        else:
            score += pred
    renewed = [v.cpu().numpy() for v in renewed]
    # write-back + version bump in ONE pack-lock section: a serving pack
    # build racing this either completes before (consistent pre-refit
    # state) or observes the bump at insert time and rebuilds — it can
    # never cache a half-renewed ensemble under the old version
    with gbdt._plock():
        if gbdt._pack_version != v0:
            raise RuntimeError(
                "the ensemble mutated while LGBM_BoosterRefit ran — the "
                "renewed leaf tables no longer map onto the current "
                "trees; refit aborted, model unchanged")
        for tree, lv_new in zip(gbdt.models, renewed):
            tree.leaf_value = lv_new
        gbdt._invalidate_pred_cache("capi_refit_leaf")  # renewed in place
    return True


def booster_get_leaf_value(bst: Booster, tree_idx: int, leaf_idx: int) -> float:
    return bst.get_leaf_output(tree_idx, leaf_idx)


def booster_set_leaf_value(bst: Booster, tree_idx: int, leaf_idx: int,
                           value: float) -> bool:
    bst.set_leaf_output(tree_idx, leaf_idx, value)
    return True


def booster_get_linear(bst: Booster) -> int:
    return 1 if getattr(bst._gbdt.cfg, "linear_tree", False) else 0


def booster_num_model_per_iteration(bst: Booster) -> int:
    return int(bst.num_model_per_iteration())


def booster_lower_bound(bst: Booster) -> float:
    return float(bst.lower_bound())


def booster_upper_bound(bst: Booster) -> float:
    return float(bst.upper_bound())


def booster_eval_names(bst: Booster):
    """Metric names without evaluating (reference: GetEvalNames is static
    metadata; hosts call it every iteration)."""
    names = []
    for m in bst._gbdt.metrics:
        if m.name in ("ndcg", "map"):
            names.extend(f"{m.name}@{k}" for k in m.cfg.eval_at)
        else:
            names.append(m.name)
    return names


def booster_feature_names(bst: Booster):
    return list(bst.feature_name())


def booster_loaded_param(bst: Booster) -> str:
    import json

    cfg = bst._gbdt.cfg
    return json.dumps({k: v for k, v in cfg.to_dict().items()
                       if isinstance(v, (int, float, str, bool))},
                      default=str)


def booster_validate_feature_names(bst: Booster, names) -> bool:
    model_names = list(bst.feature_name())
    names = list(names)
    if len(names) != len(model_names) or any(
            a != b for a, b in zip(names, model_names)):
        raise ValueError(
            "Expected feature names %r, got %r" % (model_names, names))
    return True


def booster_shuffle_models(bst: Booster, start_iter: int,
                           end_iter: int) -> bool:
    bst.shuffle_models(start_iter, end_iter)
    return True


def booster_get_num_predict(bst: Booster, data_idx: int) -> int:
    gbdt = bst._gbdt
    score = gbdt._score if data_idx == 0 else gbdt._valid_scores[data_idx - 1]
    return int(score.numel())


def booster_get_predict_into(bst: Booster, data_idx: int,
                             out_addr: int) -> int:
    """reference: LGBM_BoosterGetPredict — current raw scores of the
    train (0) or (i-1)-th valid dataset."""
    gbdt = bst._gbdt
    score = gbdt._score if data_idx == 0 else gbdt._valid_scores[data_idx - 1]
    out = np.ascontiguousarray(score.cpu().numpy(), np.float64).ravel()
    dest = _wrap(out_addr, (out.size,))
    dest[:] = out
    return int(out.size)


def booster_calc_num_predict(bst: Booster, num_row: int, predict_type: int,
                             start_iteration: int, num_iteration: int) -> int:
    gbdt = bst._gbdt
    k = gbdt.num_tree_per_iteration
    total_iters = len(gbdt.models) // max(k, 1)
    if num_iteration <= 0:
        num_iteration = total_iters - start_iteration
    num_iteration = max(0, min(num_iteration, total_iters - start_iteration))
    if predict_type == _PREDICT_LEAF_INDEX:
        return num_row * num_iteration * k
    if predict_type == _PREDICT_CONTRIB:
        return num_row * k * (bst.num_feature() + 1)
    return num_row * k


def predict_for_file(bst: Booster, data_filename: str, data_has_header: int,
                     predict_type: int, start_iteration: int,
                     num_iteration: int, parameter: str,
                     result_filename: str) -> bool:
    """reference: LGBM_BoosterPredictForFile via Predictor — batch predict a
    data file to a result file, one row per line."""
    from .io.parser import load_data_file

    p = _parse_params(parameter)
    loaded = load_data_file(data_filename, header=bool(data_has_header),
                            label_column=str(p.get("label_column", "")))
    kw = dict(num_iteration=num_iteration if num_iteration > 0 else -1,
              start_iteration=start_iteration)
    if predict_type == _PREDICT_LEAF_INDEX:
        out = bst.predict(loaded["data"], pred_leaf=True, **kw)
    elif predict_type == _PREDICT_CONTRIB:
        out = bst.predict(loaded["data"], pred_contrib=True, **kw)
    elif predict_type == _PREDICT_RAW_SCORE:
        out = bst.predict(loaded["data"], raw_score=True, **kw)
    else:
        out = bst.predict(loaded["data"], **kw)
    out = np.atleast_2d(np.asarray(out, np.float64))
    if out.shape[0] == 1 and len(loaded["data"]) != 1:
        out = out.T
    with open(result_filename, "w") as f:
        for row in out:
            f.write("\t".join(repr(float(v)) for v in np.atleast_1d(row)) + "\n")
    return True


def predict_csr_single_row_into(bst: Booster, indptr_addr: int,
                                indptr_type: int, indices_addr: int,
                                data_addr: int, data_type: int, nindptr: int,
                                nelem: int, num_col: int, predict_type: int,
                                start_iteration: int, num_iteration: int,
                                parameter: str, out_addr: int) -> int:
    x = _wrap_csr(indptr_addr, indptr_type, indices_addr, data_addr,
                  data_type, nindptr, nelem, num_col)
    return _predict_any_into(bst, x, predict_type, out_addr,
                             **_predict_kw(start_iteration, num_iteration,
                                           parameter))


def predict_csr_single_row_fast_init(bst: Booster, predict_type: int,
                                     start_iteration: int, num_iteration: int,
                                     data_type: int, num_col: int,
                                     parameters: str = "") -> _FastConfig:
    cfg = _FastConfig(bst, predict_type, data_type, num_col, parameters)
    cfg.start_iteration = int(start_iteration)
    cfg.num_iteration = int(num_iteration)
    return cfg


def predict_csr_single_row_fast(cfg: _FastConfig, indptr_addr: int,
                                indptr_type: int, indices_addr: int,
                                data_addr: int, nindptr: int, nelem: int,
                                out_addr: int) -> int:
    x = _wrap_csr(indptr_addr, indptr_type, indices_addr, data_addr,
                  cfg.data_type, nindptr, nelem, cfg.ncol)
    return _predict_any_into(cfg.bst, x, cfg.predict_type, out_addr,
                             num_iteration=cfg.num_iteration,
                             start_iteration=cfg.start_iteration,
                             **cfg.kwargs)


# ---- Arrow C-data-interface surface (reference:
#      LGBM_DatasetCreateFromArrow / LGBM_DatasetSetFieldFromArrow /
#      LGBM_BoosterPredictForArrow over include/LightGBM/arrow.h).
#      Chunks arrive as a contiguous array of struct ArrowArray (the C data
#      interface fixed 80-byte layout); pyarrow imports them zero-copy and
#      takes ownership (release is called per the spec). ----

_ARROW_ARRAY_STRUCT_SIZE = 80  # 5 int64 + 5 pointers, fixed by the spec


def _release_arrow_arrays(chunks_addr: int, start: int, n_chunks: int) -> None:
    """Call the C-data-interface release callback on chunks [start, n_chunks)
    that were never imported (the contract transfers ownership to us even on
    failure).  release fn lives at struct offset 64; NULL means already
    released."""
    fn_type = ctypes.CFUNCTYPE(None, ctypes.c_void_p)
    for i in range(start, n_chunks):
        base = chunks_addr + i * _ARROW_ARRAY_STRUCT_SIZE
        fn_addr = ctypes.c_void_p.from_address(base + 64).value
        if fn_addr:
            fn_type(fn_addr)(base)


def _import_arrow_table(n_chunks: int, chunks_addr: int, schema_addr: int):
    import pyarrow as pa

    try:
        schema = pa.Schema._import_from_c(schema_addr)
        struct_type = pa.struct(list(schema))
    except Exception:
        _release_arrow_arrays(chunks_addr, 0, n_chunks)
        raise
    batches = []
    for i in range(n_chunks):
        try:
            arr = pa.Array._import_from_c(
                chunks_addr + i * _ARROW_ARRAY_STRUCT_SIZE, struct_type)
            batches.append(pa.RecordBatch.from_struct_array(arr))
        except Exception:
            _release_arrow_arrays(chunks_addr, i, n_chunks)
            raise
    return pa.Table.from_batches(batches, schema=schema)


def dataset_from_arrow(n_chunks: int, chunks_addr: int, schema_addr: int,
                       parameters: str, reference) -> Dataset:
    table = _import_arrow_table(n_chunks, chunks_addr, schema_addr)
    return Dataset(table, params=_dataset_params(parameters),
                   reference=reference if isinstance(reference, Dataset) else None,
                   free_raw_data=False)


def dataset_set_field_from_arrow(ds, field_name: str, n_chunks: int,
                                 chunks_addr: int, schema_addr: int) -> bool:
    import pyarrow as pa

    try:
        dtype = pa.DataType._import_from_c(schema_addr)
    except Exception:
        _release_arrow_arrays(chunks_addr, 0, n_chunks)
        raise
    if n_chunks == 0:
        ds.set_field(field_name, None)  # zero-length clears, like SetField
        return True
    parts = []
    for i in range(n_chunks):
        try:
            parts.append(pa.Array._import_from_c(
                chunks_addr + i * _ARROW_ARRAY_STRUCT_SIZE, dtype))
        except Exception:
            _release_arrow_arrays(chunks_addr, i, n_chunks)
            raise
    vals = np.concatenate([p.to_numpy(zero_copy_only=False) for p in parts])
    ds.set_field(field_name, vals)
    return True


def predict_arrow_into(bst: Booster, n_chunks: int, chunks_addr: int,
                       schema_addr: int, predict_type: int,
                       start_iteration: int, num_iteration: int,
                       parameter: str, out_addr: int) -> int:
    table = _import_arrow_table(n_chunks, chunks_addr, schema_addr)
    return _predict_any_into(bst, table, predict_type, out_addr,
                             **_predict_kw(start_iteration, num_iteration,
                                           parameter))


# ---- network surface (reference: LGBM_NetworkInit / Free /
#      InitWithFunctions).  The machine list brings up a torch.distributed
#      process group (parallel/distributed.py): NCCL where a card is
#      visible, gloo on the CPU; the rank is the machine-list entry whose
#      port is local_listen_port (or LIGHTGBM_TPU_RANK). ----

_NETWORK_PARAMS: dict = {}


def network_init(machines: str, local_listen_port: int, listen_time_out: int,
                 num_machines: int) -> bool:
    _NETWORK_PARAMS.clear()
    if num_machines > 1:
        _NETWORK_PARAMS.update({
            "machines": machines,
            "local_listen_port": int(local_listen_port),
            "time_out": int(listen_time_out),
            "num_machines": int(num_machines),
        })
        import torch

        from .config import Config
        from .parallel.distributed import init_distributed

        cfg = Config.from_dict(dict(
            _NETWORK_PARAMS,
            device_type="cuda" if torch.cuda.is_available() else "cpu"))
        init_distributed(cfg)
    return True


def network_free() -> bool:
    """reference: LGBM_NetworkFree — the process group is torn down, so a
    later LGBM_NetworkInit brings up a new one."""
    from .parallel.distributed import free_network

    _NETWORK_PARAMS.clear()
    free_network()
    return True


def network_init_with_functions(num_machines: int, rank: int,
                                has_reduce_scatter: int = 0,
                                has_allgather: int = 0) -> bool:
    """reference: LGBM_NetworkInitWithFunctions lets the host (SynapseML)
    supply reduce-scatter/allgather function pointers.  The port's
    collectives run over torch.distributed, which does not call them.  A
    host that relies on its custom transport (e.g. a firewalled environment
    where only its channel works) would silently get torch.distributed's
    instead — so a multi-machine call with real function pointers is an
    ERROR unless the host opts in by setting
    LIGHTGBM_TPU_ACCEPT_XLA_TRANSPORT=1 (the JAX package's variable, so a
    host set up for one package works with the other).  Topology (ranks)
    still drives pre_partition semantics (ROADMAP queue C records the
    wording)."""
    import os

    from .utils.log import log_warning

    _NETWORK_PARAMS.clear()
    if num_machines > 1:
        if (has_reduce_scatter or has_allgather) and os.environ.get(
                "LIGHTGBM_TPU_ACCEPT_XLA_TRANSPORT") != "1":
            raise LightGBMError(
                "LGBM_NetworkInitWithFunctions: the supplied collective "
                "function pointers are not called by the PyTorch core; "
                "collectives would run over torch.distributed instead. "
                "Set LIGHTGBM_TPU_ACCEPT_XLA_TRANSPORT=1 to accept that "
                "substitution.")
        _NETWORK_PARAMS.update({"num_machines": int(num_machines),
                                "rank": int(rank)})
        log_warning(
            "LGBM_NetworkInitWithFunctions: external collective functions are "
            "replaced by torch.distributed collectives; topology "
            "(num_machines=%d, rank=%d) recorded" % (num_machines, rank))
    return True


def network_params() -> dict:
    """Booster creation merges these (reference: Network state is global)."""
    return dict(_NETWORK_PARAMS)


# ---- global configuration surface --------------------------------------

def dump_param_aliases() -> str:
    """reference: LGBM_DumpParamAliases — JSON of parameter -> aliases."""
    import json

    from .config import _ALIASES

    table: dict = {}
    for alias, canonical in _ALIASES.items():
        table.setdefault(canonical, []).append(alias)
    return json.dumps(table, sort_keys=True)


_MAX_THREADS = [0]  # 0/-1 = OMP default in the reference; advisory here


def get_max_threads() -> int:
    return _MAX_THREADS[0] if _MAX_THREADS[0] > 0 else -1


def set_max_threads(n: int) -> bool:
    """Host-side parallelism cap (reference: LGBM_SetMaxThreads), recorded
    as in the JAX package (advisory: neither package reads it back)."""
    _MAX_THREADS[0] = int(n)
    return True


_LOG_CALLBACK = [None]


def register_log_callback(fn_addr: int) -> bool:
    """reference: LGBM_RegisterLogCallback(void (*)(const char*))."""
    from .utils import log as _log

    cb = ctypes.CFUNCTYPE(None, ctypes.c_char_p)(fn_addr)
    _LOG_CALLBACK[0] = cb  # keep alive

    class _CRedirect:
        def info(self, msg):
            cb(str(msg).encode())

        warning = info

    _log.register_logger(_CRedirect())
    return True


def get_sample_count(num_total_row: int, parameters: str) -> int:
    p = _parse_params(parameters)
    from .config import Config

    cfg = Config.from_dict(p)
    return int(min(cfg.bin_construct_sample_cnt, num_total_row))


def sample_indices_into(num_total_row: int, parameters: str,
                        out_addr: int) -> int:
    """reference: LGBM_SampleIndices — deterministic row sample for
    sampled-column dataset construction (int32 out)."""
    cnt = get_sample_count(num_total_row, parameters)
    p = _parse_params(parameters)
    from .config import Config

    cfg = Config.from_dict(p)
    rng = np.random.RandomState(cfg.data_random_seed)
    if cnt >= num_total_row:
        idx = np.arange(num_total_row, dtype=np.int32)
    else:
        idx = np.sort(rng.choice(num_total_row, size=cnt,
                                 replace=False)).astype(np.int32)
    dest = (ctypes.c_int32 * len(idx)).from_address(out_addr)
    dest[:] = idx.tolist()
    return len(idx)
