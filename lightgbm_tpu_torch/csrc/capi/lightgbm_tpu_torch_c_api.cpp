/* C API shim implementation — see lightgbm_tpu_torch_c_api.h.
 *
 * Design (vs reference src/c_api.cpp): the reference's C API *is* its core;
 * here the core is Python/PyTorch, so the C ABI embeds CPython and forwards
 * to lightgbm_tpu_torch.capi_helpers.  All entry points hold the GIL for their
 * duration (PyGILState_Ensure), so the library is usable both from plain C
 * programs (the embedded interpreter is initialized on first use) and from
 * inside an existing Python process via ctypes.
 */
#include "lightgbm_tpu_torch_c_api.h"

#include <Python.h>

#include <cstdarg>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <string>
#include <utility>
#include <vector>

namespace {

// per-thread, like the reference (c_api.cpp LGBM_GetLastError returns the
// CALLING thread's last error; a shared buffer would let one thread's
// failure overwrite another's success message)
thread_local std::string g_last_error = "ok";

void set_last_error(const std::string& msg) {
  g_last_error = msg;
}

void set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  std::string msg = "unknown python error";
  if (value != nullptr) {
    PyObject* s = PyObject_Str(value);
    if (s != nullptr) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c != nullptr) msg = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  set_last_error(msg);
}

struct GilGuard {
  PyGILState_STATE state;
  GilGuard() {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
    }
    state = PyGILState_Ensure();
  }
  ~GilGuard() { PyGILState_Release(state); }
};

PyObject* helpers() {
  // borrowed-module pattern: import once per call; cheap after first import
  return PyImport_ImportModule("lightgbm_tpu_torch.capi_helpers");
}

int call_create(const char* kind, const char* arg, int* out_num_iterations,
                BoosterHandle* out) {
  GilGuard gil;
  PyObject* mod = helpers();
  if (mod == nullptr) {
    set_error_from_python();
    return -1;
  }
  PyObject* bst = PyObject_CallMethod(mod, kind, "s", arg);
  Py_DECREF(mod);
  if (bst == nullptr) {
    set_error_from_python();
    return -1;
  }
  if (out_num_iterations != nullptr) {
    PyObject* it = PyObject_CallMethod(bst, "current_iteration", nullptr);
    if (it == nullptr) {
      Py_DECREF(bst);
      set_error_from_python();
      return -1;
    }
    *out_num_iterations = static_cast<int>(PyLong_AsLong(it));
    Py_DECREF(it);
  }
  *out = static_cast<BoosterHandle>(bst);
  return 0;
}

// Call helpers.<method>(args...) and return the result (nullptr = error
// already recorded).  fmt/args as for PyObject_CallMethod.
PyObject* call_helper(const char* method, const char* fmt, ...) {
  PyObject* mod = helpers();
  if (mod == nullptr) {
    set_error_from_python();
    return nullptr;
  }
  va_list va;
  va_start(va, fmt);
  PyObject* callable = PyObject_GetAttrString(mod, method);
  Py_DECREF(mod);
  if (callable == nullptr) {
    va_end(va);
    set_error_from_python();
    return nullptr;
  }
  PyObject* args = Py_VaBuildValue(fmt, va);
  va_end(va);
  if (args == nullptr) {
    Py_DECREF(callable);
    set_error_from_python();
    return nullptr;
  }
  if (!PyTuple_Check(args)) {
    PyObject* t = PyTuple_Pack(1, args);
    Py_DECREF(args);
    args = t;
  }
  PyObject* r = PyObject_CallObject(callable, args);
  Py_DECREF(callable);
  Py_DECREF(args);
  if (r == nullptr) set_error_from_python();
  return r;
}

// Fill a char** with a Python list of str using the reference's
// (len buffers of buffer_len) + size-then-fill contract.
int strlist_to_buffers(PyObject* list, int len, int* out_len,
                       size_t buffer_len, size_t* out_buffer_len,
                       char** out_strs) {
  if (!PyList_Check(list)) {
    set_last_error("expected list of names");
    return -1;
  }
  Py_ssize_t n = PyList_Size(list);
  *out_len = static_cast<int>(n);
  size_t need = 1;
  for (Py_ssize_t i = 0; i < n; ++i) {
    Py_ssize_t sz = 0;
    const char* c = PyUnicode_AsUTF8AndSize(PyList_GetItem(list, i), &sz);
    if (c == nullptr) {
      set_error_from_python();
      return -1;
    }
    if (static_cast<size_t>(sz) + 1 > need) need = static_cast<size_t>(sz) + 1;
    if (out_strs != nullptr && i < len && buffer_len > 0) {
      size_t ncopy = static_cast<size_t>(sz) + 1 <= buffer_len
                         ? static_cast<size_t>(sz) + 1
                         : buffer_len;
      std::memcpy(out_strs[i], c, ncopy);
      out_strs[i][ncopy - 1] = '\0';
    }
  }
  *out_buffer_len = need;
  return 0;
}

// Build a Python list[str] from a char** (for SetFeatureNames etc.).
PyObject* buffers_to_strlist(const char** strs, int n) {
  PyObject* list = PyList_New(n);
  if (list == nullptr) return nullptr;
  for (int i = 0; i < n; ++i) {
    PyObject* s = PyUnicode_FromString(strs[i]);
    if (s == nullptr) {
      Py_DECREF(list);
      return nullptr;
    }
    PyList_SetItem(list, i, s);  // steals
  }
  return list;
}

// Copy a Python str into a caller buffer with the reference's
// size-then-fill contract.
int str_to_buffer(PyObject* s, int64_t buffer_len, int64_t* out_len,
                  char* out_str) {
  Py_ssize_t n = 0;
  const char* c = PyUnicode_AsUTF8AndSize(s, &n);
  if (c == nullptr) {
    set_error_from_python();
    return -1;
  }
  *out_len = static_cast<int64_t>(n) + 1;
  if (out_str != nullptr && buffer_len >= n + 1) {
    std::memcpy(out_str, c, static_cast<size_t>(n) + 1);
  }
  return 0;
}

}  // namespace

extern "C" {

const char* LGBM_GetLastError(void) {
  return g_last_error.c_str();
}

/* ---- Dataset surface ---- */

int LGBM_DatasetCreateFromMat(const void* data, int data_type, int32_t nrow,
                              int32_t ncol, int is_row_major,
                              const char* parameters,
                              const DatasetHandle reference,
                              DatasetHandle* out) {
  GilGuard gil;
  PyObject* ref = reference != nullptr ? static_cast<PyObject*>(reference)
                                       : Py_None;
  PyObject* r = call_helper(
      "dataset_from_mat", "(KiiiisO)",
      reinterpret_cast<unsigned long long>(data), data_type,
      static_cast<int>(nrow), static_cast<int>(ncol), is_row_major,
      parameters, ref);
  if (r == nullptr) return -1;
  *out = static_cast<DatasetHandle>(r);
  return 0;
}

int LGBM_DatasetCreateFromFile(const char* filename, const char* parameters,
                               const DatasetHandle reference,
                               DatasetHandle* out) {
  GilGuard gil;
  PyObject* ref = reference != nullptr ? static_cast<PyObject*>(reference)
                                       : Py_None;
  PyObject* r = call_helper("dataset_from_file", "(ssO)", filename,
                            parameters, ref);
  if (r == nullptr) return -1;
  *out = static_cast<DatasetHandle>(r);
  return 0;
}

int LGBM_DatasetCreateByReference(const DatasetHandle reference,
                                  int64_t num_total_row,
                                  DatasetHandle* out) {
  GilGuard gil;
  PyObject* r = call_helper("dataset_create_by_reference", "(OL)",
                            static_cast<PyObject*>(reference),
                            static_cast<long long>(num_total_row));
  if (r == nullptr) return -1;
  *out = static_cast<DatasetHandle>(r);
  return 0;
}

int LGBM_DatasetPushRows(DatasetHandle handle, const void* data, int data_type,
                         int32_t nrow, int32_t ncol, int32_t start_row) {
  GilGuard gil;
  PyObject* r = call_helper(
      "dataset_push_rows", "(OKiiii)", static_cast<PyObject*>(handle),
      reinterpret_cast<unsigned long long>(data), data_type,
      static_cast<int>(nrow), static_cast<int>(ncol),
      static_cast<int>(start_row));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_DatasetFree(DatasetHandle handle) {
  if (handle == nullptr) return 0;
  GilGuard gil;
  Py_DECREF(static_cast<PyObject*>(handle));
  return 0;
}

int LGBM_DatasetSetField(DatasetHandle handle, const char* field_name,
                         const void* field_data, int num_element, int type) {
  GilGuard gil;
  PyObject* r = call_helper(
      "dataset_set_field", "(OsKii)", static_cast<PyObject*>(handle),
      field_name, reinterpret_cast<unsigned long long>(field_data),
      num_element, type);
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_DatasetGetNumData(DatasetHandle handle, int32_t* out) {
  GilGuard gil;
  PyObject* r = call_helper("dataset_get_num_data", "(O)",
                            static_cast<PyObject*>(handle));
  if (r == nullptr) return -1;
  *out = static_cast<int32_t>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int LGBM_DatasetGetNumFeature(DatasetHandle handle, int32_t* out) {
  GilGuard gil;
  PyObject* r = call_helper("dataset_get_num_feature", "(O)",
                            static_cast<PyObject*>(handle));
  if (r == nullptr) return -1;
  *out = static_cast<int32_t>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

/* ---- Booster training surface ---- */

int LGBM_BoosterCreate(const DatasetHandle train_data, const char* parameters,
                       BoosterHandle* out) {
  GilGuard gil;
  PyObject* r = call_helper("booster_create", "(Os)",
                            static_cast<PyObject*>(train_data), parameters);
  if (r == nullptr) return -1;
  *out = static_cast<BoosterHandle>(r);
  return 0;
}

int LGBM_BoosterAddValidData(BoosterHandle handle,
                             const DatasetHandle valid_data) {
  GilGuard gil;
  PyObject* r = call_helper("booster_add_valid", "(OO)",
                            static_cast<PyObject*>(handle),
                            static_cast<PyObject*>(valid_data));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterUpdateOneIter(BoosterHandle handle, int* is_finished) {
  GilGuard gil;
  PyObject* r = call_helper("booster_update", "(O)",
                            static_cast<PyObject*>(handle));
  if (r == nullptr) return -1;
  *is_finished = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterUpdateOneIterCustom(BoosterHandle handle, const float* grad,
                                    const float* hess, int* is_finished) {
  GilGuard gil;
  PyObject* r = call_helper(
      "booster_update_custom", "(OKK)", static_cast<PyObject*>(handle),
      reinterpret_cast<unsigned long long>(grad),
      reinterpret_cast<unsigned long long>(hess));
  if (r == nullptr) return -1;
  *is_finished = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterRollbackOneIter(BoosterHandle handle) {
  GilGuard gil;
  PyObject* r = call_helper("booster_rollback", "(O)",
                            static_cast<PyObject*>(handle));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterGetCurrentIteration(BoosterHandle handle,
                                    int* out_iteration) {
  GilGuard gil;
  PyObject* r = call_helper("booster_current_iteration", "(O)",
                            static_cast<PyObject*>(handle));
  if (r == nullptr) return -1;
  *out_iteration = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterNumberOfTotalModel(BoosterHandle handle, int* out_models) {
  GilGuard gil;
  PyObject* r = call_helper("booster_num_total_model", "(O)",
                            static_cast<PyObject*>(handle));
  if (r == nullptr) return -1;
  *out_models = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterGetNumFeature(BoosterHandle handle, int* out_len) {
  GilGuard gil;
  PyObject* r = call_helper("booster_num_feature", "(O)",
                            static_cast<PyObject*>(handle));
  if (r == nullptr) return -1;
  *out_len = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterResetParameter(BoosterHandle handle, const char* parameters) {
  GilGuard gil;
  PyObject* r = call_helper("booster_reset_parameter", "(Os)",
                            static_cast<PyObject*>(handle), parameters);
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterGetEvalCounts(BoosterHandle handle, int* out_len) {
  GilGuard gil;
  PyObject* r = call_helper("booster_eval_counts", "(O)",
                            static_cast<PyObject*>(handle));
  if (r == nullptr) return -1;
  *out_len = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterGetEval(BoosterHandle handle, int data_idx, int* out_len,
                        double* out_results) {
  GilGuard gil;
  PyObject* r = call_helper(
      "booster_get_eval_into", "(OiK)", static_cast<PyObject*>(handle),
      data_idx, reinterpret_cast<unsigned long long>(out_results));
  if (r == nullptr) return -1;
  *out_len = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterSaveModelToString(BoosterHandle handle, int start_iteration,
                                  int num_iteration,
                                  int feature_importance_type,
                                  int64_t buffer_len, int64_t* out_len,
                                  char* out_str) {
  (void)feature_importance_type;
  GilGuard gil;
  PyObject* r = call_helper("booster_save_string", "(Oii)",
                            static_cast<PyObject*>(handle), start_iteration,
                            num_iteration);
  if (r == nullptr) return -1;
  int rc = str_to_buffer(r, buffer_len, out_len, out_str);
  Py_DECREF(r);
  return rc;
}

int LGBM_BoosterDumpModel(BoosterHandle handle, int start_iteration,
                          int num_iteration, int feature_importance_type,
                          int64_t buffer_len, int64_t* out_len,
                          char* out_str) {
  (void)feature_importance_type;
  GilGuard gil;
  PyObject* r = call_helper("booster_dump_json", "(Oii)",
                            static_cast<PyObject*>(handle), start_iteration,
                            num_iteration);
  if (r == nullptr) return -1;
  int rc = str_to_buffer(r, buffer_len, out_len, out_str);
  Py_DECREF(r);
  return rc;
}

int LGBM_BoosterFeatureImportance(BoosterHandle handle, int num_iteration,
                                  int importance_type, double* out_results) {
  (void)num_iteration;
  GilGuard gil;
  PyObject* r = call_helper(
      "booster_feature_importance_into", "(OiK)",
      static_cast<PyObject*>(handle), importance_type,
      reinterpret_cast<unsigned long long>(out_results));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterCreateFromModelfile(const char* filename,
                                    int* out_num_iterations,
                                    BoosterHandle* out) {
  return call_create("booster_from_file", filename, out_num_iterations, out);
}

int LGBM_BoosterLoadModelFromString(const char* model_str,
                                    int* out_num_iterations,
                                    BoosterHandle* out) {
  return call_create("booster_from_string", model_str, out_num_iterations, out);
}

int LGBM_BoosterFree(BoosterHandle handle) {
  if (handle == nullptr) return 0;
  GilGuard gil;
  Py_DECREF(static_cast<PyObject*>(handle));
  return 0;
}

int LGBM_BoosterGetNumClasses(BoosterHandle handle, int* out_len) {
  GilGuard gil;
  PyObject* mod = helpers();
  if (mod == nullptr) {
    set_error_from_python();
    return -1;
  }
  PyObject* r = PyObject_CallMethod(mod, "num_classes", "O",
                                    static_cast<PyObject*>(handle));
  Py_DECREF(mod);
  if (r == nullptr) {
    set_error_from_python();
    return -1;
  }
  *out_len = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterSaveModel(BoosterHandle handle, int start_iteration,
                          int num_iteration, int feature_importance_type,
                          const char* filename) {
  (void)feature_importance_type;
  GilGuard gil;
  PyObject* mod = helpers();
  if (mod == nullptr) {
    set_error_from_python();
    return -1;
  }
  PyObject* r = PyObject_CallMethod(
      mod, "save_model", "Osii", static_cast<PyObject*>(handle), filename,
      start_iteration, num_iteration);
  Py_DECREF(mod);
  if (r == nullptr) {
    set_error_from_python();
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

int LGBM_DatasetCreateFromCSR(const void* indptr, int indptr_type,
                              const int32_t* indices, const void* data,
                              int data_type, int64_t nindptr, int64_t nelem,
                              int64_t num_col, const char* parameters,
                              const DatasetHandle reference,
                              DatasetHandle* out) {
  GilGuard gil;
  PyObject* ref = reference != nullptr ? static_cast<PyObject*>(reference)
                                       : Py_None;
  PyObject* r = call_helper(
      "dataset_from_csr", "(KiKKiLLLsO)",
      reinterpret_cast<unsigned long long>(indptr), indptr_type,
      reinterpret_cast<unsigned long long>(indices),
      reinterpret_cast<unsigned long long>(data), data_type,
      static_cast<long long>(nindptr), static_cast<long long>(nelem),
      static_cast<long long>(num_col), parameters, ref);
  if (r == nullptr) return -1;
  *out = static_cast<DatasetHandle>(r);
  return 0;
}

int LGBM_BoosterPredictForCSR(BoosterHandle handle, const void* indptr,
                              int indptr_type, const int32_t* indices,
                              const void* data, int data_type,
                              int64_t nindptr, int64_t nelem, int64_t num_col,
                              int predict_type, int start_iteration,
                              int num_iteration, const char* parameter,
                              int64_t* out_len, double* out_result) {
  GilGuard gil;
  PyObject* r = call_helper(
      "predict_csr_into", "(OKiKKiLLLiiisK)", static_cast<PyObject*>(handle),
      reinterpret_cast<unsigned long long>(indptr), indptr_type,
      reinterpret_cast<unsigned long long>(indices),
      reinterpret_cast<unsigned long long>(data), data_type,
      static_cast<long long>(nindptr), static_cast<long long>(nelem),
      static_cast<long long>(num_col), predict_type, start_iteration,
      num_iteration, parameter == nullptr ? "" : parameter,
      reinterpret_cast<unsigned long long>(out_result));
  if (r == nullptr) return -1;
  *out_len = PyLong_AsLongLong(r);
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterPredictSparseOutput(BoosterHandle handle, const void* indptr,
                                    int indptr_type, const int32_t* indices,
                                    const void* data, int data_type,
                                    int64_t nindptr, int64_t nelem,
                                    int64_t num_col_or_row, int predict_type,
                                    int start_iteration, int num_iteration,
                                    const char* parameter, int matrix_type,
                                    int64_t* out_len, void** out_indptr,
                                    int32_t** out_indices, void** out_data) {
  if (data_type != C_API_DTYPE_FLOAT32 && data_type != C_API_DTYPE_FLOAT64) {
    set_last_error(
        "LGBM_BoosterPredictSparseOutput: data_type must be "
        "C_API_DTYPE_FLOAT32 or C_API_DTYPE_FLOAT64");
    return -1;
  }
  GilGuard gil;
  PyObject* r = call_helper(
      "predict_sparse_output", "(OKiKKiLLLiiisi)",
      static_cast<PyObject*>(handle),
      reinterpret_cast<unsigned long long>(indptr), indptr_type,
      reinterpret_cast<unsigned long long>(indices),
      reinterpret_cast<unsigned long long>(data), data_type,
      static_cast<long long>(nindptr), static_cast<long long>(nelem),
      static_cast<long long>(num_col_or_row), predict_type, start_iteration,
      num_iteration, parameter == nullptr ? "" : parameter, matrix_type);
  if (r == nullptr) return -1;
  /* (indptr_addr, indices_addr, data_addr, n_indptr, nnz) — buffers were
   * malloc()'d on the Python side via libc so free() releases them */
  unsigned long long a_indptr = PyLong_AsUnsignedLongLong(PyTuple_GetItem(r, 0));
  unsigned long long a_indices = PyLong_AsUnsignedLongLong(PyTuple_GetItem(r, 1));
  unsigned long long a_data = PyLong_AsUnsignedLongLong(PyTuple_GetItem(r, 2));
  long long n_indptr = PyLong_AsLongLong(PyTuple_GetItem(r, 3));
  long long nnz = PyLong_AsLongLong(PyTuple_GetItem(r, 4));
  Py_DECREF(r);
  if (PyErr_Occurred()) {
    set_error_from_python();
    return -1;
  }
  *out_indptr = reinterpret_cast<void*>(a_indptr);
  *out_indices = reinterpret_cast<int32_t*>(a_indices);
  *out_data = reinterpret_cast<void*>(a_data);
  out_len[0] = n_indptr;
  out_len[1] = nnz;
  return 0;
}

int LGBM_BoosterFreePredictSparse(void* indptr, int32_t* indices, void* data,
                                  int indptr_type, int data_type) {
  (void)indptr_type;
  (void)data_type;
  std::free(indptr);
  std::free(indices);
  std::free(data);
  return 0;
}

int LGBM_DatasetCreateFromCSRFunc(void* get_row_funptr, int num_rows,
                                  int64_t num_col, const char* parameters,
                                  const DatasetHandle reference,
                                  DatasetHandle* out) {
  /* the reference's contract: funptr is a C++ std::function pointer,
   * invoked once per row OUTSIDE the GIL (the callback may be arbitrary
   * caller code); rows materialize dense, then the mat path ingests */
  using RowFn = std::function<void(int, std::vector<std::pair<int, double>>&)>;
  auto* fn = reinterpret_cast<RowFn*>(get_row_funptr);
  if (fn == nullptr || num_rows < 0 || num_col <= 0) {
    set_last_error("LGBM_DatasetCreateFromCSRFunc: bad arguments");
    return -1;
  }
  std::vector<double> buf(static_cast<size_t>(num_rows) * num_col, 0.0);
  std::vector<std::pair<int, double>> row;
  for (int i = 0; i < num_rows; ++i) {
    row.clear();
    (*fn)(i, row);
    for (const auto& kv : row) {
      if (kv.first >= 0 && kv.first < num_col) {
        buf[static_cast<size_t>(i) * num_col + kv.first] = kv.second;
      }
    }
  }
  GilGuard gil;
  PyObject* ref = reference != nullptr ? static_cast<PyObject*>(reference)
                                       : Py_None;
  PyObject* r = call_helper(
      "dataset_from_mat", "(KiiiisO)",
      reinterpret_cast<unsigned long long>(buf.data()), C_API_DTYPE_FLOAT64,
      num_rows, static_cast<int>(num_col), 1,
      parameters == nullptr ? "" : parameters, ref);
  if (r == nullptr) return -1;
  *out = static_cast<DatasetHandle>(r);
  return 0;
}

int LGBM_BoosterResetTrainingData(BoosterHandle handle,
                                  const DatasetHandle train_data) {
  GilGuard gil;
  PyObject* r = call_helper("booster_reset_training_data", "(OO)",
                            static_cast<PyObject*>(handle),
                            static_cast<PyObject*>(train_data));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_DatasetGetFeatureNumBin(DatasetHandle handle, int feature_idx,
                                 int* out) {
  GilGuard gil;
  PyObject* r = call_helper("dataset_get_feature_num_bin", "(Oi)",
                            static_cast<PyObject*>(handle), feature_idx);
  if (r == nullptr) return -1;
  *out = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterPredictForMatSingleRow(BoosterHandle handle, const void* data,
                                       int data_type, int32_t ncol,
                                       int is_row_major, int predict_type,
                                       int start_iteration, int num_iteration,
                                       const char* parameter,
                                       int64_t* out_len, double* out_result) {
  (void)is_row_major;  /* one row: both layouts identical */
  GilGuard gil;
  PyObject* r = call_helper(
      "predict_single_row_into", "(OKiiiiisK)", static_cast<PyObject*>(handle),
      reinterpret_cast<unsigned long long>(data), static_cast<int>(ncol),
      data_type, predict_type, start_iteration, num_iteration,
      parameter == nullptr ? "" : parameter,
      reinterpret_cast<unsigned long long>(out_result));
  if (r == nullptr) return -1;
  *out_len = PyLong_AsLongLong(r);
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterPredictForMatSingleRowFastInit(BoosterHandle handle,
                                               int predict_type,
                                               int start_iteration,
                                               int num_iteration,
                                               int data_type, int32_t ncol,
                                               const char* parameter,
                                               FastConfigHandle* out) {
  GilGuard gil;
  PyObject* r = call_helper(
      "predict_single_row_fast_init", "(Oiiiiis)",
      static_cast<PyObject*>(handle), predict_type, start_iteration,
      num_iteration, data_type,
      static_cast<int>(ncol), parameter == nullptr ? "" : parameter);
  if (r == nullptr) return -1;
  *out = static_cast<FastConfigHandle>(r);
  return 0;
}

int LGBM_BoosterPredictForMatSingleRowFast(FastConfigHandle fast_config,
                                           const void* data, int64_t* out_len,
                                           double* out_result) {
  GilGuard gil;
  PyObject* r = call_helper(
      "predict_single_row_fast", "(OKK)",
      static_cast<PyObject*>(fast_config),
      reinterpret_cast<unsigned long long>(data),
      reinterpret_cast<unsigned long long>(out_result));
  if (r == nullptr) return -1;
  *out_len = PyLong_AsLongLong(r);
  Py_DECREF(r);
  return 0;
}

int LGBM_FastConfigFree(FastConfigHandle fast_config) {
  if (fast_config == nullptr) return 0;
  GilGuard gil;
  Py_DECREF(static_cast<PyObject*>(fast_config));
  return 0;
}

int LGBM_BoosterPredictForMat(BoosterHandle handle, const void* data,
                              int data_type, int32_t nrow, int32_t ncol,
                              int is_row_major, int predict_type,
                              int start_iteration, int num_iteration,
                              const char* parameter,
                              int64_t* out_len, double* out_result) {
  GilGuard gil;
  PyObject* r = call_helper(
      "predict_into", "(OKiiiiiiisK)", static_cast<PyObject*>(handle),
      reinterpret_cast<unsigned long long>(data), data_type,
      static_cast<int>(nrow), static_cast<int>(ncol),
      static_cast<int>(is_row_major), static_cast<int>(predict_type),
      start_iteration, num_iteration, parameter == nullptr ? "" : parameter,
      reinterpret_cast<unsigned long long>(out_result));
  if (r == nullptr) return -1;
  *out_len = PyLong_AsLongLong(r);
  Py_DECREF(r);
  return 0;
}

/* ---- CSC ---- */

int LGBM_DatasetCreateFromCSC(const void* col_ptr, int col_ptr_type,
                              const int32_t* indices, const void* data,
                              int data_type, int64_t ncol_ptr, int64_t nelem,
                              int64_t num_row, const char* parameters,
                              const DatasetHandle reference,
                              DatasetHandle* out) {
  GilGuard gil;
  PyObject* ref = reference != nullptr ? static_cast<PyObject*>(reference)
                                       : Py_None;
  PyObject* r = call_helper(
      "dataset_from_csc", "(KiKKiLLLsO)",
      reinterpret_cast<unsigned long long>(col_ptr), col_ptr_type,
      reinterpret_cast<unsigned long long>(indices),
      reinterpret_cast<unsigned long long>(data), data_type,
      static_cast<long long>(ncol_ptr), static_cast<long long>(nelem),
      static_cast<long long>(num_row), parameters, ref);
  if (r == nullptr) return -1;
  *out = static_cast<DatasetHandle>(r);
  return 0;
}

int LGBM_BoosterPredictForCSC(BoosterHandle handle, const void* col_ptr,
                              int col_ptr_type, const int32_t* indices,
                              const void* data, int data_type,
                              int64_t ncol_ptr, int64_t nelem, int64_t num_row,
                              int predict_type, int start_iteration,
                              int num_iteration, const char* parameter,
                              int64_t* out_len, double* out_result) {
  GilGuard gil;
  PyObject* r = call_helper(
      "predict_csc_into", "(OKiKKiLLLiiisK)", static_cast<PyObject*>(handle),
      reinterpret_cast<unsigned long long>(col_ptr), col_ptr_type,
      reinterpret_cast<unsigned long long>(indices),
      reinterpret_cast<unsigned long long>(data), data_type,
      static_cast<long long>(ncol_ptr), static_cast<long long>(nelem),
      static_cast<long long>(num_row), predict_type, start_iteration,
      num_iteration, parameter == nullptr ? "" : parameter,
      reinterpret_cast<unsigned long long>(out_result));
  if (r == nullptr) return -1;
  *out_len = PyLong_AsLongLong(r);
  Py_DECREF(r);
  return 0;
}

/* ---- multi-block matrices ---- */

int LGBM_DatasetCreateFromMats(int32_t nmat, const void** data, int data_type,
                               int32_t* nrow, int32_t ncol, int is_row_major,
                               const char* parameters,
                               const DatasetHandle reference,
                               DatasetHandle* out) {
  GilGuard gil;
  PyObject* ref = reference != nullptr ? static_cast<PyObject*>(reference)
                                       : Py_None;
  PyObject* r = call_helper(
      "dataset_from_mats", "(iKiKiisO)", static_cast<int>(nmat),
      reinterpret_cast<unsigned long long>(data), data_type,
      reinterpret_cast<unsigned long long>(nrow), static_cast<int>(ncol),
      is_row_major, parameters, ref);
  if (r == nullptr) return -1;
  *out = static_cast<DatasetHandle>(r);
  return 0;
}

int LGBM_BoosterPredictForMats(BoosterHandle handle, const void** data,
                               int data_type, int32_t nmat, int32_t* nrow,
                               int32_t ncol, int predict_type,
                               int start_iteration, int num_iteration,
                               const char* parameter,
                               int64_t* out_len, double* out_result) {
  GilGuard gil;
  PyObject* r = call_helper(
      "predict_mats_into", "(OiKiKiiiisK)", static_cast<PyObject*>(handle),
      static_cast<int>(nmat), reinterpret_cast<unsigned long long>(data),
      data_type, reinterpret_cast<unsigned long long>(nrow),
      static_cast<int>(ncol), predict_type, start_iteration, num_iteration,
      parameter == nullptr ? "" : parameter,
      reinterpret_cast<unsigned long long>(out_result));
  if (r == nullptr) return -1;
  *out_len = PyLong_AsLongLong(r);
  Py_DECREF(r);
  return 0;
}

/* ---- sampled-column construction ---- */

int LGBM_DatasetCreateFromSampledColumn(double** sample_data,
                                        int** sample_indices, int32_t ncol,
                                        const int* num_per_col,
                                        int32_t num_sample_row,
                                        int32_t num_local_row,
                                        int64_t num_dist_total_row,
                                        const char* parameters,
                                        DatasetHandle* out) {
  (void)num_dist_total_row; /* distributed total used only for logging */
  GilGuard gil;
  PyObject* r = call_helper(
      "dataset_from_sampled_column", "(KKiKiis)",
      reinterpret_cast<unsigned long long>(sample_data),
      reinterpret_cast<unsigned long long>(sample_indices),
      static_cast<int>(ncol),
      reinterpret_cast<unsigned long long>(num_per_col),
      static_cast<int>(num_sample_row), static_cast<int>(num_local_row),
      parameters);
  if (r == nullptr) return -1;
  *out = static_cast<DatasetHandle>(r);
  return 0;
}

/* ---- dataset field / names / persistence ---- */

int LGBM_DatasetGetField(DatasetHandle handle, const char* field_name,
                         int* out_len, const void** out_ptr, int* out_type) {
  GilGuard gil;
  PyObject* r = call_helper("dataset_get_field", "(Os)",
                            static_cast<PyObject*>(handle), field_name);
  if (r == nullptr) return -1;
  unsigned long long addr = 0;
  int n = 0, code = 0;
  if (!PyArg_ParseTuple(r, "Kii", &addr, &n, &code)) {
    Py_DECREF(r);
    set_error_from_python();
    return -1;
  }
  Py_DECREF(r);
  *out_ptr = reinterpret_cast<const void*>(addr);
  *out_len = n;
  *out_type = code;
  return 0;
}

int LGBM_DatasetSetFeatureNames(DatasetHandle handle,
                                const char** feature_names,
                                int num_feature_names) {
  GilGuard gil;
  PyObject* list = buffers_to_strlist(feature_names, num_feature_names);
  if (list == nullptr) {
    set_error_from_python();
    return -1;
  }
  PyObject* r = call_helper("dataset_set_feature_names", "(OO)",
                            static_cast<PyObject*>(handle), list);
  Py_DECREF(list);
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_DatasetGetFeatureNames(DatasetHandle handle, const int len,
                                int* out_len, const size_t buffer_len,
                                size_t* out_buffer_len, char** out_strs) {
  GilGuard gil;
  PyObject* r = call_helper("dataset_feature_names", "(O)",
                            static_cast<PyObject*>(handle));
  if (r == nullptr) return -1;
  int rc = strlist_to_buffers(r, len, out_len, buffer_len, out_buffer_len,
                              out_strs);
  Py_DECREF(r);
  return rc;
}

int LGBM_DatasetSaveBinary(DatasetHandle handle, const char* filename) {
  GilGuard gil;
  PyObject* r = call_helper("dataset_save_binary", "(Os)",
                            static_cast<PyObject*>(handle), filename);
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_DatasetDumpText(DatasetHandle handle, const char* filename) {
  GilGuard gil;
  PyObject* r = call_helper("dataset_dump_text", "(Os)",
                            static_cast<PyObject*>(handle), filename);
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_DatasetGetSubset(const DatasetHandle handle,
                          const int32_t* used_row_indices,
                          int32_t num_used_row_indices,
                          const char* parameters, DatasetHandle* out) {
  GilGuard gil;
  PyObject* r = call_helper(
      "dataset_get_subset", "(OKis)", static_cast<PyObject*>(handle),
      reinterpret_cast<unsigned long long>(used_row_indices),
      static_cast<int>(num_used_row_indices), parameters);
  if (r == nullptr) return -1;
  *out = static_cast<DatasetHandle>(r);
  return 0;
}

int LGBM_DatasetAddFeaturesFrom(DatasetHandle target, DatasetHandle source) {
  GilGuard gil;
  PyObject* r = call_helper("dataset_add_features_from", "(OO)",
                            static_cast<PyObject*>(target),
                            static_cast<PyObject*>(source));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_DatasetUpdateParamChecking(const char* old_parameters,
                                    const char* new_parameters) {
  GilGuard gil;
  PyObject* r = call_helper("dataset_update_param_checking", "(ss)",
                            old_parameters, new_parameters);
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_DatasetPushRowsByCSR(DatasetHandle handle, const void* indptr,
                              int indptr_type, const int32_t* indices,
                              const void* data, int data_type, int64_t nindptr,
                              int64_t nelem, int64_t num_col,
                              int32_t start_row) {
  GilGuard gil;
  PyObject* r = call_helper(
      "dataset_push_rows_by_csr", "(OKiKKiLLLi)",
      static_cast<PyObject*>(handle),
      reinterpret_cast<unsigned long long>(indptr), indptr_type,
      reinterpret_cast<unsigned long long>(indices),
      reinterpret_cast<unsigned long long>(data), data_type,
      static_cast<long long>(nindptr), static_cast<long long>(nelem),
      static_cast<long long>(num_col), static_cast<int>(start_row));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

/* ---- streaming with metadata ---- */

int LGBM_DatasetInitStreaming(DatasetHandle handle, int32_t has_weights,
                              int32_t has_init_scores, int32_t has_queries,
                              int32_t nclasses, int32_t nthreads,
                              int32_t omp_max_threads) {
  (void)nthreads;
  (void)omp_max_threads; /* host threading is numpy's job here */
  GilGuard gil;
  PyObject* r = call_helper(
      "dataset_init_streaming", "(Oiiii)", static_cast<PyObject*>(handle),
      static_cast<int>(has_weights), static_cast<int>(has_init_scores),
      static_cast<int>(has_queries), static_cast<int>(nclasses));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_DatasetPushRowsWithMetadata(DatasetHandle handle, const void* data,
                                     int data_type, int32_t nrow, int32_t ncol,
                                     int32_t start_row, const float* label,
                                     const float* weight,
                                     const double* init_score,
                                     const int32_t* query, int32_t tid) {
  (void)tid;
  GilGuard gil;
  PyObject* r = call_helper(
      "dataset_push_rows_with_metadata", "(OKiiiiKKKK)",
      static_cast<PyObject*>(handle),
      reinterpret_cast<unsigned long long>(data), data_type,
      static_cast<int>(nrow), static_cast<int>(ncol),
      static_cast<int>(start_row),
      reinterpret_cast<unsigned long long>(label),
      reinterpret_cast<unsigned long long>(weight),
      reinterpret_cast<unsigned long long>(init_score),
      reinterpret_cast<unsigned long long>(query));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_DatasetPushRowsByCSRWithMetadata(
    DatasetHandle handle, const void* indptr, int indptr_type,
    const int32_t* indices, const void* data, int data_type, int64_t nindptr,
    int64_t nelem, int64_t num_col, int32_t start_row, const float* label,
    const float* weight, const double* init_score, const int32_t* query,
    int32_t tid) {
  (void)tid;
  GilGuard gil;
  PyObject* r = call_helper(
      "dataset_push_rows_by_csr_with_metadata", "(OKiKKiLLLiKKKK)",
      static_cast<PyObject*>(handle),
      reinterpret_cast<unsigned long long>(indptr), indptr_type,
      reinterpret_cast<unsigned long long>(indices),
      reinterpret_cast<unsigned long long>(data), data_type,
      static_cast<long long>(nindptr), static_cast<long long>(nelem),
      static_cast<long long>(num_col), static_cast<int>(start_row),
      reinterpret_cast<unsigned long long>(label),
      reinterpret_cast<unsigned long long>(weight),
      reinterpret_cast<unsigned long long>(init_score),
      reinterpret_cast<unsigned long long>(query));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_DatasetMarkFinished(DatasetHandle handle) {
  GilGuard gil;
  PyObject* r = call_helper("dataset_mark_finished", "(O)",
                            static_cast<PyObject*>(handle));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_DatasetSetWaitForManualFinish(DatasetHandle handle, int wait) {
  GilGuard gil;
  PyObject* r = call_helper("dataset_set_wait_for_manual_finish", "(Oi)",
                            static_cast<PyObject*>(handle), wait);
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

/* ---- serialized reference + ByteBuffer ---- */

int LGBM_DatasetSerializeReferenceToBinary(DatasetHandle handle,
                                           ByteBufferHandle* out,
                                           int32_t* out_len) {
  GilGuard gil;
  PyObject* r = call_helper("dataset_serialize_reference", "(O)",
                            static_cast<PyObject*>(handle));
  if (r == nullptr) return -1;
  *out = static_cast<ByteBufferHandle>(r); /* Python bytes object */
  *out_len = static_cast<int32_t>(PyBytes_Size(r));
  return 0;
}

int LGBM_ByteBufferGetAt(ByteBufferHandle handle, int32_t index,
                         uint8_t* out_val) {
  GilGuard gil;
  PyObject* bytes = static_cast<PyObject*>(handle);
  char* buf = nullptr;
  Py_ssize_t n = 0;
  if (PyBytes_AsStringAndSize(bytes, &buf, &n) != 0 || index < 0 ||
      index >= n) {
    PyErr_Clear();
    set_last_error("ByteBuffer index out of range");
    return -1;
  }
  *out_val = static_cast<uint8_t>(buf[index]);
  return 0;
}

int LGBM_ByteBufferFree(ByteBufferHandle handle) {
  if (handle == nullptr) return 0;
  GilGuard gil;
  Py_DECREF(static_cast<PyObject*>(handle));
  return 0;
}

int LGBM_DatasetCreateFromSerializedReference(const void* ref_buffer,
                                              int32_t ref_buffer_size,
                                              int64_t num_row,
                                              int32_t num_classes,
                                              const char* parameters,
                                              DatasetHandle* out) {
  (void)num_classes; /* class count rides in parameters */
  GilGuard gil;
  PyObject* r = call_helper(
      "dataset_from_serialized_reference", "(KiLs)",
      reinterpret_cast<unsigned long long>(ref_buffer),
      static_cast<int>(ref_buffer_size), static_cast<long long>(num_row),
      parameters);
  if (r == nullptr) return -1;
  *out = static_cast<DatasetHandle>(r);
  return 0;
}

/* ---- booster model surgery & introspection ---- */

int LGBM_BoosterMerge(BoosterHandle handle, BoosterHandle other_handle) {
  GilGuard gil;
  PyObject* r = call_helper("booster_merge", "(OO)",
                            static_cast<PyObject*>(handle),
                            static_cast<PyObject*>(other_handle));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterRefit(BoosterHandle handle, const int32_t* leaf_preds,
                      int32_t nrow, int32_t ncol) {
  GilGuard gil;
  PyObject* r = call_helper(
      "booster_refit_leaf_preds", "(OKii)", static_cast<PyObject*>(handle),
      reinterpret_cast<unsigned long long>(leaf_preds),
      static_cast<int>(nrow), static_cast<int>(ncol));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterGetLeafValue(BoosterHandle handle, int tree_idx, int leaf_idx,
                             double* out_val) {
  GilGuard gil;
  PyObject* r = call_helper("booster_get_leaf_value", "(Oii)",
                            static_cast<PyObject*>(handle), tree_idx,
                            leaf_idx);
  if (r == nullptr) return -1;
  *out_val = PyFloat_AsDouble(r);
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterSetLeafValue(BoosterHandle handle, int tree_idx, int leaf_idx,
                             double val) {
  GilGuard gil;
  PyObject* r = call_helper("booster_set_leaf_value", "(Oiid)",
                            static_cast<PyObject*>(handle), tree_idx, leaf_idx,
                            val);
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterGetLinear(BoosterHandle handle, int* out) {
  GilGuard gil;
  PyObject* r = call_helper("booster_get_linear", "(O)",
                            static_cast<PyObject*>(handle));
  if (r == nullptr) return -1;
  *out = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterNumModelPerIteration(BoosterHandle handle,
                                     int* out_tree_per_iteration) {
  GilGuard gil;
  PyObject* r = call_helper("booster_num_model_per_iteration", "(O)",
                            static_cast<PyObject*>(handle));
  if (r == nullptr) return -1;
  *out_tree_per_iteration = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterGetLowerBoundValue(BoosterHandle handle,
                                   double* out_results) {
  GilGuard gil;
  PyObject* r = call_helper("booster_lower_bound", "(O)",
                            static_cast<PyObject*>(handle));
  if (r == nullptr) return -1;
  out_results[0] = PyFloat_AsDouble(r);
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterGetUpperBoundValue(BoosterHandle handle,
                                   double* out_results) {
  GilGuard gil;
  PyObject* r = call_helper("booster_upper_bound", "(O)",
                            static_cast<PyObject*>(handle));
  if (r == nullptr) return -1;
  out_results[0] = PyFloat_AsDouble(r);
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterGetEvalNames(BoosterHandle handle, const int len, int* out_len,
                             const size_t buffer_len, size_t* out_buffer_len,
                             char** out_strs) {
  GilGuard gil;
  PyObject* r = call_helper("booster_eval_names", "(O)",
                            static_cast<PyObject*>(handle));
  if (r == nullptr) return -1;
  int rc = strlist_to_buffers(r, len, out_len, buffer_len, out_buffer_len,
                              out_strs);
  Py_DECREF(r);
  return rc;
}

int LGBM_BoosterGetFeatureNames(BoosterHandle handle, const int len,
                                int* out_len, const size_t buffer_len,
                                size_t* out_buffer_len, char** out_strs) {
  GilGuard gil;
  PyObject* r = call_helper("booster_feature_names", "(O)",
                            static_cast<PyObject*>(handle));
  if (r == nullptr) return -1;
  int rc = strlist_to_buffers(r, len, out_len, buffer_len, out_buffer_len,
                              out_strs);
  Py_DECREF(r);
  return rc;
}

int LGBM_BoosterGetLoadedParam(BoosterHandle handle, int64_t buffer_len,
                               int64_t* out_len, char* out_str) {
  GilGuard gil;
  PyObject* r = call_helper("booster_loaded_param", "(O)",
                            static_cast<PyObject*>(handle));
  if (r == nullptr) return -1;
  int rc = str_to_buffer(r, buffer_len, out_len, out_str);
  Py_DECREF(r);
  return rc;
}

int LGBM_BoosterValidateFeatureNames(BoosterHandle handle,
                                     const char** data_names,
                                     int data_num_features) {
  GilGuard gil;
  PyObject* list = buffers_to_strlist(data_names, data_num_features);
  if (list == nullptr) {
    set_error_from_python();
    return -1;
  }
  PyObject* r = call_helper("booster_validate_feature_names", "(OO)",
                            static_cast<PyObject*>(handle), list);
  Py_DECREF(list);
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterShuffleModels(BoosterHandle handle, int start_iter,
                              int end_iter) {
  GilGuard gil;
  PyObject* r = call_helper("booster_shuffle_models", "(Oii)",
                            static_cast<PyObject*>(handle), start_iter,
                            end_iter);
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterGetNumPredict(BoosterHandle handle, int data_idx,
                              int64_t* out_len) {
  GilGuard gil;
  PyObject* r = call_helper("booster_get_num_predict", "(Oi)",
                            static_cast<PyObject*>(handle), data_idx);
  if (r == nullptr) return -1;
  *out_len = PyLong_AsLongLong(r);
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterGetPredict(BoosterHandle handle, int data_idx,
                           int64_t* out_len, double* out_result) {
  GilGuard gil;
  PyObject* r = call_helper(
      "booster_get_predict_into", "(OiK)", static_cast<PyObject*>(handle),
      data_idx, reinterpret_cast<unsigned long long>(out_result));
  if (r == nullptr) return -1;
  *out_len = PyLong_AsLongLong(r);
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterCalcNumPredict(BoosterHandle handle, int num_row,
                               int predict_type, int start_iteration,
                               int num_iteration, int64_t* out_len) {
  GilGuard gil;
  PyObject* r = call_helper("booster_calc_num_predict", "(Oiiii)",
                            static_cast<PyObject*>(handle), num_row,
                            predict_type, start_iteration, num_iteration);
  if (r == nullptr) return -1;
  *out_len = PyLong_AsLongLong(r);
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterPredictForFile(BoosterHandle handle, const char* data_filename,
                               int data_has_header, int predict_type,
                               int start_iteration, int num_iteration,
                               const char* parameter,
                               const char* result_filename) {
  GilGuard gil;
  PyObject* r = call_helper(
      "predict_for_file", "(Osiiiiss)", static_cast<PyObject*>(handle),
      data_filename, data_has_header, predict_type, start_iteration,
      num_iteration, parameter == nullptr ? "" : parameter, result_filename);
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterPredictForCSRSingleRow(BoosterHandle handle,
                                       const void* indptr, int indptr_type,
                                       const int32_t* indices,
                                       const void* data, int data_type,
                                       int64_t nindptr, int64_t nelem,
                                       int64_t num_col, int predict_type,
                                       int start_iteration, int num_iteration,
                                       const char* parameter,
                                       int64_t* out_len, double* out_result) {
  GilGuard gil;
  PyObject* r = call_helper(
      "predict_csr_single_row_into", "(OKiKKiLLLiiisK)",
      static_cast<PyObject*>(handle),
      reinterpret_cast<unsigned long long>(indptr), indptr_type,
      reinterpret_cast<unsigned long long>(indices),
      reinterpret_cast<unsigned long long>(data), data_type,
      static_cast<long long>(nindptr), static_cast<long long>(nelem),
      static_cast<long long>(num_col), predict_type, start_iteration,
      num_iteration, parameter == nullptr ? "" : parameter,
      reinterpret_cast<unsigned long long>(out_result));
  if (r == nullptr) return -1;
  *out_len = PyLong_AsLongLong(r);
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterPredictForCSRSingleRowFastInit(BoosterHandle handle,
                                               int predict_type,
                                               int start_iteration,
                                               int num_iteration,
                                               int data_type,
                                               int64_t num_col,
                                               const char* parameter,
                                               FastConfigHandle* out) {
  GilGuard gil;
  PyObject* r = call_helper(
      "predict_csr_single_row_fast_init", "(Oiiiiis)",
      static_cast<PyObject*>(handle), predict_type, start_iteration,
      num_iteration, data_type,
      static_cast<int>(num_col), parameter == nullptr ? "" : parameter);
  if (r == nullptr) return -1;
  *out = static_cast<FastConfigHandle>(r);
  return 0;
}

int LGBM_BoosterPredictForCSRSingleRowFast(FastConfigHandle fast_config,
                                           const void* indptr,
                                           int indptr_type,
                                           const int32_t* indices,
                                           const void* data, int64_t nindptr,
                                           int64_t nelem, int64_t* out_len,
                                           double* out_result) {
  GilGuard gil;
  PyObject* r = call_helper(
      "predict_csr_single_row_fast", "(OKiKKLLK)",
      static_cast<PyObject*>(fast_config),
      reinterpret_cast<unsigned long long>(indptr), indptr_type,
      reinterpret_cast<unsigned long long>(indices),
      reinterpret_cast<unsigned long long>(data),
      static_cast<long long>(nindptr), static_cast<long long>(nelem),
      reinterpret_cast<unsigned long long>(out_result));
  if (r == nullptr) return -1;
  *out_len = PyLong_AsLongLong(r);
  Py_DECREF(r);
  return 0;
}

/* ---- Arrow C-data-interface ---- */

int LGBM_DatasetCreateFromArrow(int64_t n_chunks,
                                const struct ArrowArray* chunks,
                                const struct ArrowSchema* schema,
                                const char* parameters,
                                const DatasetHandle reference,
                                DatasetHandle* out) {
  GilGuard gil;
  PyObject* ref = reference != nullptr ? static_cast<PyObject*>(reference)
                                       : Py_None;
  PyObject* r = call_helper(
      "dataset_from_arrow", "(LKKsO)", static_cast<long long>(n_chunks),
      reinterpret_cast<unsigned long long>(chunks),
      reinterpret_cast<unsigned long long>(schema), parameters, ref);
  if (r == nullptr) return -1;
  *out = static_cast<DatasetHandle>(r);
  return 0;
}

int LGBM_DatasetSetFieldFromArrow(DatasetHandle handle, const char* field_name,
                                  int64_t n_chunks,
                                  const struct ArrowArray* chunks,
                                  const struct ArrowSchema* schema) {
  GilGuard gil;
  PyObject* r = call_helper(
      "dataset_set_field_from_arrow", "(OsLKK)",
      static_cast<PyObject*>(handle), field_name,
      static_cast<long long>(n_chunks),
      reinterpret_cast<unsigned long long>(chunks),
      reinterpret_cast<unsigned long long>(schema));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterPredictForArrow(BoosterHandle handle, int64_t n_chunks,
                                const struct ArrowArray* chunks,
                                const struct ArrowSchema* schema,
                                int predict_type, int start_iteration,
                                int num_iteration, const char* parameter,
                                int64_t* out_len, double* out_result) {
  GilGuard gil;
  PyObject* r = call_helper(
      "predict_arrow_into", "(OLKKiiisK)", static_cast<PyObject*>(handle),
      static_cast<long long>(n_chunks),
      reinterpret_cast<unsigned long long>(chunks),
      reinterpret_cast<unsigned long long>(schema), predict_type,
      start_iteration, num_iteration, parameter == nullptr ? "" : parameter,
      reinterpret_cast<unsigned long long>(out_result));
  if (r == nullptr) return -1;
  *out_len = PyLong_AsLongLong(r);
  Py_DECREF(r);
  return 0;
}

/* ---- network ---- */

int LGBM_NetworkInit(const char* machines, int local_listen_port,
                     int listen_time_out, int num_machines) {
  GilGuard gil;
  PyObject* r = call_helper("network_init", "(siii)",
                            machines == nullptr ? "" : machines,
                            local_listen_port, listen_time_out, num_machines);
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_NetworkFree(void) {
  GilGuard gil;
  PyObject* r = call_helper("network_free", "()");
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_NetworkInitWithFunctions(int num_machines, int rank,
                                  void* reduce_scatter_ext_fun,
                                  void* allgather_ext_fun) {
  /* torch.distributed owns the transport; the helper errors when the host
   * supplied real collective fns for a multi-machine run without the
   * explicit opt-in (see header note). */
  GilGuard gil;
  PyObject* r = call_helper("network_init_with_functions", "(iiii)",
                            num_machines, rank,
                            reduce_scatter_ext_fun != nullptr ? 1 : 0,
                            allgather_ext_fun != nullptr ? 1 : 0);
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

/* ---- global configuration ---- */

int LGBM_DumpParamAliases(int64_t buffer_len, int64_t* out_len,
                          char* out_str) {
  GilGuard gil;
  PyObject* r = call_helper("dump_param_aliases", "()");
  if (r == nullptr) return -1;
  int rc = str_to_buffer(r, buffer_len, out_len, out_str);
  Py_DECREF(r);
  return rc;
}

int LGBM_GetMaxThreads(int* out) {
  GilGuard gil;
  PyObject* r = call_helper("get_max_threads", "()");
  if (r == nullptr) return -1;
  *out = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int LGBM_SetMaxThreads(int num_threads) {
  GilGuard gil;
  PyObject* r = call_helper("set_max_threads", "(i)", num_threads);
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_RegisterLogCallback(void (*callback)(const char*)) {
  GilGuard gil;
  PyObject* r = call_helper(
      "register_log_callback", "(K)",
      reinterpret_cast<unsigned long long>(callback));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_GetSampleCount(int32_t num_total_row, const char* parameters,
                        int* out) {
  GilGuard gil;
  PyObject* r = call_helper("get_sample_count", "(is)",
                            static_cast<int>(num_total_row), parameters);
  if (r == nullptr) return -1;
  *out = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int LGBM_SampleIndices(int32_t num_total_row, const char* parameters,
                       void* out, int32_t* out_len) {
  GilGuard gil;
  PyObject* r = call_helper("sample_indices_into", "(isK)",
                            static_cast<int>(num_total_row), parameters,
                            reinterpret_cast<unsigned long long>(out));
  if (r == nullptr) return -1;
  *out_len = static_cast<int32_t>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

}  // extern "C"
