/* C API for lightgbm_tpu_torch — the reference's `LGBM_*` FFI surface
 * (reference: include/LightGBM/c_api.h, src/c_api.cpp) re-hosted over the
 * PyTorch/CUDA core.  The entry points and their signatures are those of
 * src/capi/lightgbm_tpu_c_api.h, so a LightGBM C host links against
 * either library.  The shim embeds CPython: handles are refcounted
 * lightgbm_tpu_torch.Booster objects, array arguments cross as raw
 * pointers wrapped zero-copy by numpy on the Python side
 * (lightgbm_tpu_torch/capi_helpers.py).  Training and prediction run on
 * the card unless the parameters say device_type=cpu.
 *
 * Return convention matches the reference: 0 = success, -1 = failure with
 * the message available via LGBM_GetLastError().
 */
#ifndef LIGHTGBM_TPU_TORCH_C_API_H_
#define LIGHTGBM_TPU_TORCH_C_API_H_

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef void* BoosterHandle;
typedef void* DatasetHandle;

#define C_API_PREDICT_NORMAL 0
#define C_API_PREDICT_RAW_SCORE 1
#define C_API_PREDICT_LEAF_INDEX 2
#define C_API_PREDICT_CONTRIB 3

/* reference: C_API_DTYPE_* */
#define C_API_DTYPE_FLOAT32 0
#define C_API_DTYPE_FLOAT64 1
#define C_API_DTYPE_INT32 2
#define C_API_DTYPE_INT64 3

#define C_API_FEATURE_IMPORTANCE_SPLIT 0
#define C_API_FEATURE_IMPORTANCE_GAIN 1

const char* LGBM_GetLastError(void);

/* ---- Dataset surface (reference: LGBM_Dataset*) ---- */

/* data: (nrow x ncol) matrix of `data_type`; parameters: "k=v k=v";
 * reference: bin-alignment dataset or NULL. */
int LGBM_DatasetCreateFromMat(const void* data,
                              int data_type,
                              int32_t nrow,
                              int32_t ncol,
                              int is_row_major,
                              const char* parameters,
                              const DatasetHandle reference,
                              DatasetHandle* out);

int LGBM_DatasetCreateFromFile(const char* filename,
                               const char* parameters,
                               const DatasetHandle reference,
                               DatasetHandle* out);

/* Streaming construction: preallocate by reference, push row blocks
 * (reference: LGBM_DatasetCreateByReference / LGBM_DatasetPushRows). */
int LGBM_DatasetCreateByReference(const DatasetHandle reference,
                                  int64_t num_total_row,
                                  DatasetHandle* out);

int LGBM_DatasetPushRows(DatasetHandle handle,
                         const void* data,
                         int data_type,
                         int32_t nrow,
                         int32_t ncol,
                         int32_t start_row);

int LGBM_DatasetFree(DatasetHandle handle);

/* field_name: label/weight/group/init_score/position. */
int LGBM_DatasetSetField(DatasetHandle handle,
                         const char* field_name,
                         const void* field_data,
                         int num_element,
                         int type);

int LGBM_DatasetGetNumData(DatasetHandle handle, int32_t* out);

int LGBM_DatasetGetNumFeature(DatasetHandle handle, int32_t* out);

/* ---- Booster training surface (reference: LGBM_Booster*) ---- */

int LGBM_BoosterCreate(const DatasetHandle train_data,
                       const char* parameters,
                       BoosterHandle* out);

int LGBM_BoosterAddValidData(BoosterHandle handle, const DatasetHandle valid_data);

int LGBM_BoosterUpdateOneIter(BoosterHandle handle, int* is_finished);

/* grad/hess: float32[num_data * num_class], caller-computed objective. */
int LGBM_BoosterUpdateOneIterCustom(BoosterHandle handle,
                                    const float* grad,
                                    const float* hess,
                                    int* is_finished);

int LGBM_BoosterRollbackOneIter(BoosterHandle handle);

int LGBM_BoosterGetCurrentIteration(BoosterHandle handle, int* out_iteration);

int LGBM_BoosterNumberOfTotalModel(BoosterHandle handle, int* out_models);

int LGBM_BoosterGetNumFeature(BoosterHandle handle, int* out_len);

int LGBM_BoosterResetParameter(BoosterHandle handle, const char* parameters);

/* Swap the training data under an existing booster; trees already grown
 * are kept (reference: GBDT::ResetTrainingData). */
int LGBM_BoosterResetTrainingData(BoosterHandle handle,
                                  const DatasetHandle train_data);

/* Number of bins of one feature, incl. missing/offset slots (reference:
 * LGBM_DatasetGetFeatureNumBin -> Dataset::FeatureNumBin). */
int LGBM_DatasetGetFeatureNumBin(DatasetHandle handle, int feature_idx,
                                 int* out);

int LGBM_BoosterGetEvalCounts(BoosterHandle handle, int* out_len);

/* data_idx: 0 = train, i = i-th validation set. */
int LGBM_BoosterGetEval(BoosterHandle handle,
                        int data_idx,
                        int* out_len,
                        double* out_results);

/* out_str: caller buffer of buffer_len bytes; *out_len receives the
 * required size incl. NUL (call twice to size, like the reference). */
int LGBM_BoosterSaveModelToString(BoosterHandle handle,
                                  int start_iteration,
                                  int num_iteration,
                                  int feature_importance_type,
                                  int64_t buffer_len,
                                  int64_t* out_len,
                                  char* out_str);

int LGBM_BoosterDumpModel(BoosterHandle handle,
                          int start_iteration,
                          int num_iteration,
                          int feature_importance_type,
                          int64_t buffer_len,
                          int64_t* out_len,
                          char* out_str);

/* out_results: double[num_feature]. */
int LGBM_BoosterFeatureImportance(BoosterHandle handle,
                                  int num_iteration,
                                  int importance_type,
                                  double* out_results);

int LGBM_BoosterCreateFromModelfile(const char* filename,
                                    int* out_num_iterations,
                                    BoosterHandle* out);

int LGBM_BoosterLoadModelFromString(const char* model_str,
                                    int* out_num_iterations,
                                    BoosterHandle* out);

int LGBM_BoosterFree(BoosterHandle handle);

int LGBM_BoosterGetNumClasses(BoosterHandle handle, int* out_len);

int LGBM_BoosterSaveModel(BoosterHandle handle,
                          int start_iteration,
                          int num_iteration,
                          int feature_importance_type,
                          const char* filename);

/* ---- CSR ingestion & prediction (reference: LGBM_DatasetCreateFromCSR,
 * LGBM_BoosterPredictForCSR).  indptr_type / data_type use the
 * C_API_DTYPE codes (0=f32 1=f64 2=i32 3=i64); indices are int32. */
int LGBM_DatasetCreateFromCSR(const void* indptr,
                              int indptr_type,
                              const int32_t* indices,
                              const void* data,
                              int data_type,
                              int64_t nindptr,
                              int64_t nelem,
                              int64_t num_col,
                              const char* parameters,
                              const DatasetHandle reference,
                              DatasetHandle* out);

int LGBM_BoosterPredictForCSR(BoosterHandle handle,
                              const void* indptr,
                              int indptr_type,
                              const int32_t* indices,
                              const void* data,
                              int data_type,
                              int64_t nindptr,
                              int64_t nelem,
                              int64_t num_col,
                              int predict_type,
                              int start_iteration,
                              int num_iteration,
                              const char* parameter,
                              int64_t* out_len,
                              double* out_result);

/* ---- sparse-output SHAP prediction (reference:
 * LGBM_BoosterPredictSparseOutput / LGBM_BoosterFreePredictSparse).
 * predict_type must be C_API_PREDICT_CONTRIB; matrix_type 0 = CSR input
 * and output, 1 = CSC (num_col_or_row = #cols for CSR, #rows for CSC).
 * The library malloc()s *out_indptr/*out_indices/*out_data; release them
 * with LGBM_BoosterFreePredictSparse.  Output data is written in the
 * requested data_type (C_API_DTYPE_FLOAT32 or _FLOAT64, matching the
 * reference's per-type allocation).  out_len[0] = indptr length,
 * out_len[1] = nnz. */
#define C_API_MATRIX_TYPE_CSR 0
#define C_API_MATRIX_TYPE_CSC 1

int LGBM_BoosterPredictSparseOutput(BoosterHandle handle,
                                    const void* indptr,
                                    int indptr_type,
                                    const int32_t* indices,
                                    const void* data,
                                    int data_type,
                                    int64_t nindptr,
                                    int64_t nelem,
                                    int64_t num_col_or_row,
                                    int predict_type,
                                    int start_iteration,
                                    int num_iteration,
                                    const char* parameter,
                                    int matrix_type,
                                    int64_t* out_len,
                                    void** out_indptr,
                                    int32_t** out_indices,
                                    void** out_data);

int LGBM_BoosterFreePredictSparse(void* indptr, int32_t* indices, void* data,
                                  int indptr_type, int data_type);

/* Row-callback dataset construction (reference:
 * LGBM_DatasetCreateFromCSRFunc): get_row_funptr is a
 * std::function<void(int idx, std::vector<std::pair<int, double>>&)>*
 * invoked once per row, exactly the reference's C++-ABI contract. */
int LGBM_DatasetCreateFromCSRFunc(void* get_row_funptr,
                                  int num_rows,
                                  int64_t num_col,
                                  const char* parameters,
                                  const DatasetHandle reference,
                                  DatasetHandle* out);

/* ---- single-row predict, plain and Fast (reference: SingleRowPredictor,
 * FastConfigHandle — the Fast variants freeze predict settings into an
 * opaque handle so the per-call path is minimal). */
typedef void* FastConfigHandle;

int LGBM_BoosterPredictForMatSingleRow(BoosterHandle handle,
                                       const void* data,
                                       int data_type,
                                       int32_t ncol,
                                       int is_row_major,
                                       int predict_type,
                                       int start_iteration,
                                       int num_iteration,
                                       const char* parameter,
                                       int64_t* out_len,
                                       double* out_result);

int LGBM_BoosterPredictForMatSingleRowFastInit(BoosterHandle handle,
                                               int predict_type,
                                               int start_iteration,
                                               int num_iteration,
                                               int data_type,
                                               int32_t ncol,
                                               const char* parameter,
                                               FastConfigHandle* out);

int LGBM_BoosterPredictForMatSingleRowFast(FastConfigHandle fast_config,
                                           const void* data,
                                           int64_t* out_len,
                                           double* out_result);

int LGBM_FastConfigFree(FastConfigHandle fast_config);

/* data: (nrow x ncol) matrix of `data_type` (C_API_DTYPE code).
 * out_result must hold nrow (normal/raw), nrow*num_class (multiclass), or
 * nrow*num_trees (leaf index) doubles; *out_len receives the count
 * written.  start_iteration/num_iteration window the trees used (-1 =
 * all); parameter carries "k=v" predict params. */
int LGBM_BoosterPredictForMat(BoosterHandle handle,
                              const void* data,
                              int data_type,
                              int32_t nrow,
                              int32_t ncol,
                              int is_row_major,
                              int predict_type,
                              int start_iteration,
                              int num_iteration,
                              const char* parameter,
                              int64_t* out_len,
                              double* out_result);

/* ---- CSC ingestion & prediction (reference: LGBM_DatasetCreateFromCSC,
 * LGBM_BoosterPredictForCSC).  col_ptr has ncol_ptr entries; indices are
 * int32 row ids; num_row is the dense row count. */
int LGBM_DatasetCreateFromCSC(const void* col_ptr,
                              int col_ptr_type,
                              const int32_t* indices,
                              const void* data,
                              int data_type,
                              int64_t ncol_ptr,
                              int64_t nelem,
                              int64_t num_row,
                              const char* parameters,
                              const DatasetHandle reference,
                              DatasetHandle* out);

int LGBM_BoosterPredictForCSC(BoosterHandle handle,
                              const void* col_ptr,
                              int col_ptr_type,
                              const int32_t* indices,
                              const void* data,
                              int data_type,
                              int64_t ncol_ptr,
                              int64_t nelem,
                              int64_t num_row,
                              int predict_type,
                              int start_iteration,
                              int num_iteration,
                              const char* parameter,
                              int64_t* out_len,
                              double* out_result);

/* ---- multi-block matrices (reference: LGBM_DatasetCreateFromMats,
 * LGBM_BoosterPredictForMats).  data: nmat pointers; nrow: rows per mat. */
int LGBM_DatasetCreateFromMats(int32_t nmat,
                               const void** data,
                               int data_type,
                               int32_t* nrow,
                               int32_t ncol,
                               int is_row_major,
                               const char* parameters,
                               const DatasetHandle reference,
                               DatasetHandle* out);

int LGBM_BoosterPredictForMats(BoosterHandle handle,
                               const void** data,
                               int data_type,
                               int32_t nmat,
                               int32_t* nrow,
                               int32_t ncol,
                               int predict_type,
                               int start_iteration,
                               int num_iteration,
                               const char* parameter,
                               int64_t* out_len,
                               double* out_result);

/* ---- sampled-column schema construction (reference:
 * LGBM_DatasetCreateFromSampledColumn → ConstructBinMappersFromSampleData;
 * bin mappers come from the per-column sample, rows arrive via PushRows). */
int LGBM_DatasetCreateFromSampledColumn(double** sample_data,
                                        int** sample_indices,
                                        int32_t ncol,
                                        const int* num_per_col,
                                        int32_t num_sample_row,
                                        int32_t num_local_row,
                                        int64_t num_dist_total_row,
                                        const char* parameters,
                                        DatasetHandle* out);

/* ---- dataset field/name/persistence (reference: LGBM_DatasetGetField,
 * Set/GetFeatureNames, SaveBinary, DumpText, GetSubset, AddFeaturesFrom,
 * UpdateParamChecking). */

/* *out_ptr points into dataset-owned memory (valid until the dataset is
 * freed); *out_type is a C_API_DTYPE code. */
int LGBM_DatasetGetField(DatasetHandle handle,
                         const char* field_name,
                         int* out_len,
                         const void** out_ptr,
                         int* out_type);

int LGBM_DatasetSetFeatureNames(DatasetHandle handle,
                                const char** feature_names,
                                int num_feature_names);

/* len buffers of buffer_len bytes each; *out_len = #names,
 * *out_buffer_len = max name length incl. NUL (size-then-fill). */
int LGBM_DatasetGetFeatureNames(DatasetHandle handle,
                                const int len,
                                int* out_len,
                                const size_t buffer_len,
                                size_t* out_buffer_len,
                                char** out_strs);

int LGBM_DatasetSaveBinary(DatasetHandle handle, const char* filename);

int LGBM_DatasetDumpText(DatasetHandle handle, const char* filename);

int LGBM_DatasetGetSubset(const DatasetHandle handle,
                          const int32_t* used_row_indices,
                          int32_t num_used_row_indices,
                          const char* parameters,
                          DatasetHandle* out);

int LGBM_DatasetAddFeaturesFrom(DatasetHandle target, DatasetHandle source);

int LGBM_DatasetUpdateParamChecking(const char* old_parameters,
                                    const char* new_parameters);

int LGBM_DatasetPushRowsByCSR(DatasetHandle handle,
                              const void* indptr,
                              int indptr_type,
                              const int32_t* indices,
                              const void* data,
                              int data_type,
                              int64_t nindptr,
                              int64_t nelem,
                              int64_t num_col,
                              int32_t start_row);

/* ---- streaming with metadata (reference: LGBM_DatasetInitStreaming,
 * LGBM_DatasetPushRowsWithMetadata, LGBM_DatasetMarkFinished,
 * LGBM_DatasetSetWaitForManualFinish). */
int LGBM_DatasetInitStreaming(DatasetHandle handle,
                              int32_t has_weights,
                              int32_t has_init_scores,
                              int32_t has_queries,
                              int32_t nclasses,
                              int32_t nthreads,
                              int32_t omp_max_threads);

int LGBM_DatasetPushRowsWithMetadata(DatasetHandle handle,
                                     const void* data,
                                     int data_type,
                                     int32_t nrow,
                                     int32_t ncol,
                                     int32_t start_row,
                                     const float* label,
                                     const float* weight,
                                     const double* init_score,
                                     const int32_t* query,
                                     int32_t tid);

int LGBM_DatasetPushRowsByCSRWithMetadata(DatasetHandle handle,
                                          const void* indptr,
                                          int indptr_type,
                                          const int32_t* indices,
                                          const void* data,
                                          int data_type,
                                          int64_t nindptr,
                                          int64_t nelem,
                                          int64_t num_col,
                                          int32_t start_row,
                                          const float* label,
                                          const float* weight,
                                          const double* init_score,
                                          const int32_t* query,
                                          int32_t tid);

int LGBM_DatasetMarkFinished(DatasetHandle handle);

int LGBM_DatasetSetWaitForManualFinish(DatasetHandle handle, int wait);

/* ---- serialized dataset reference + ByteBuffer (reference:
 * LGBM_DatasetSerializeReferenceToBinary,
 * LGBM_DatasetCreateFromSerializedReference, LGBM_ByteBuffer*). */
typedef void* ByteBufferHandle;

int LGBM_DatasetSerializeReferenceToBinary(DatasetHandle handle,
                                           ByteBufferHandle* out,
                                           int32_t* out_len);

int LGBM_ByteBufferGetAt(ByteBufferHandle handle, int32_t index,
                         uint8_t* out_val);

int LGBM_ByteBufferFree(ByteBufferHandle handle);

int LGBM_DatasetCreateFromSerializedReference(const void* ref_buffer,
                                              int32_t ref_buffer_size,
                                              int64_t num_row,
                                              int32_t num_classes,
                                              const char* parameters,
                                              DatasetHandle* out);

/* ---- booster model surgery & introspection ---- */

int LGBM_BoosterMerge(BoosterHandle handle, BoosterHandle other_handle);

/* leaf_preds: (nrow x num_trees) int32 leaf assignments on the attached
 * training data (reference: GBDT::RefitTree). */
int LGBM_BoosterRefit(BoosterHandle handle,
                      const int32_t* leaf_preds,
                      int32_t nrow,
                      int32_t ncol);

int LGBM_BoosterGetLeafValue(BoosterHandle handle,
                             int tree_idx,
                             int leaf_idx,
                             double* out_val);

int LGBM_BoosterSetLeafValue(BoosterHandle handle,
                             int tree_idx,
                             int leaf_idx,
                             double val);

int LGBM_BoosterGetLinear(BoosterHandle handle, int* out);

int LGBM_BoosterNumModelPerIteration(BoosterHandle handle,
                                     int* out_tree_per_iteration);

/* out_results: double[num_class]. */
int LGBM_BoosterGetLowerBoundValue(BoosterHandle handle, double* out_results);

int LGBM_BoosterGetUpperBoundValue(BoosterHandle handle, double* out_results);

int LGBM_BoosterGetEvalNames(BoosterHandle handle,
                             const int len,
                             int* out_len,
                             const size_t buffer_len,
                             size_t* out_buffer_len,
                             char** out_strs);

int LGBM_BoosterGetFeatureNames(BoosterHandle handle,
                                const int len,
                                int* out_len,
                                const size_t buffer_len,
                                size_t* out_buffer_len,
                                char** out_strs);

int LGBM_BoosterGetLoadedParam(BoosterHandle handle,
                               int64_t buffer_len,
                               int64_t* out_len,
                               char* out_str);

int LGBM_BoosterValidateFeatureNames(BoosterHandle handle,
                                     const char** data_names,
                                     int data_num_features);

int LGBM_BoosterShuffleModels(BoosterHandle handle,
                              int start_iter,
                              int end_iter);

/* Raw scores of the train (data_idx 0) or (i-1)-th valid dataset. */
int LGBM_BoosterGetNumPredict(BoosterHandle handle,
                              int data_idx,
                              int64_t* out_len);

int LGBM_BoosterGetPredict(BoosterHandle handle,
                           int data_idx,
                           int64_t* out_len,
                           double* out_result);

int LGBM_BoosterCalcNumPredict(BoosterHandle handle,
                               int num_row,
                               int predict_type,
                               int start_iteration,
                               int num_iteration,
                               int64_t* out_len);

int LGBM_BoosterPredictForFile(BoosterHandle handle,
                               const char* data_filename,
                               int data_has_header,
                               int predict_type,
                               int start_iteration,
                               int num_iteration,
                               const char* parameter,
                               const char* result_filename);

int LGBM_BoosterPredictForCSRSingleRow(BoosterHandle handle,
                                       const void* indptr,
                                       int indptr_type,
                                       const int32_t* indices,
                                       const void* data,
                                       int data_type,
                                       int64_t nindptr,
                                       int64_t nelem,
                                       int64_t num_col,
                                       int predict_type,
                                       int start_iteration,
                                       int num_iteration,
                                       const char* parameter,
                                       int64_t* out_len,
                                       double* out_result);

int LGBM_BoosterPredictForCSRSingleRowFastInit(BoosterHandle handle,
                                               int predict_type,
                                               int start_iteration,
                                               int num_iteration,
                                               int data_type,
                                               int64_t num_col,
                                               const char* parameter,
                                               FastConfigHandle* out);

int LGBM_BoosterPredictForCSRSingleRowFast(FastConfigHandle fast_config,
                                           const void* indptr,
                                           int indptr_type,
                                           const int32_t* indices,
                                           const void* data,
                                           int64_t nindptr,
                                           int64_t nelem,
                                           int64_t* out_len,
                                           double* out_result);

/* ---- Arrow C-data-interface ingestion (reference:
 * LGBM_DatasetCreateFromArrow / LGBM_DatasetSetFieldFromArrow /
 * LGBM_BoosterPredictForArrow over include/LightGBM/arrow.h).  chunks is a
 * contiguous array of n_chunks struct ArrowArray record batches (struct
 * layout per the Arrow C data interface spec); ownership transfers (release
 * is called). */
struct ArrowArray;
struct ArrowSchema;

int LGBM_DatasetCreateFromArrow(int64_t n_chunks,
                                const struct ArrowArray* chunks,
                                const struct ArrowSchema* schema,
                                const char* parameters,
                                const DatasetHandle reference,
                                DatasetHandle* out);

int LGBM_DatasetSetFieldFromArrow(DatasetHandle handle,
                                  const char* field_name,
                                  int64_t n_chunks,
                                  const struct ArrowArray* chunks,
                                  const struct ArrowSchema* schema);

int LGBM_BoosterPredictForArrow(BoosterHandle handle,
                                int64_t n_chunks,
                                const struct ArrowArray* chunks,
                                const struct ArrowSchema* schema,
                                int predict_type,
                                int start_iteration,
                                int num_iteration,
                                const char* parameter,
                                int64_t* out_len,
                                double* out_result);

/* ---- network bring-up (reference: LGBM_NetworkInit over socket/MPI
 * linkers; here the machine list brings up a torch.distributed process
 * group: NCCL on the card, gloo on the CPU). ---- */
int LGBM_NetworkInit(const char* machines,
                     int local_listen_port,
                     int listen_time_out,
                     int num_machines);

int LGBM_NetworkFree(void);

/* External collective fn pointers are not called: the collectives run
 * over torch.distributed.  With num_machines > 1 and non-null pointers
 * this entry FAILS unless the host accepts that substitution by setting
 * LIGHTGBM_TPU_ACCEPT_XLA_TRANSPORT=1 in the environment (the variable
 * the JAX package's library reads, so one host set-up serves both);
 * topology is then recorded, the transport is torch.distributed's. */
int LGBM_NetworkInitWithFunctions(int num_machines,
                                  int rank,
                                  void* reduce_scatter_ext_fun,
                                  void* allgather_ext_fun);

/* ---- global configuration (reference: LGBM_DumpParamAliases,
 * LGBM_Get/SetMaxThreads, LGBM_RegisterLogCallback, LGBM_GetSampleCount,
 * LGBM_SampleIndices). ---- */
int LGBM_DumpParamAliases(int64_t buffer_len,
                          int64_t* out_len,
                          char* out_str);

int LGBM_GetMaxThreads(int* out);

int LGBM_SetMaxThreads(int num_threads);

int LGBM_RegisterLogCallback(void (*callback)(const char*));

int LGBM_GetSampleCount(int32_t num_total_row,
                        const char* parameters,
                        int* out);

/* out: int32 buffer of at least GetSampleCount entries. */
int LGBM_SampleIndices(int32_t num_total_row,
                       const char* parameters,
                       void* out,
                       int32_t* out_len);

#ifdef __cplusplus
}
#endif

#endif  /* LIGHTGBM_TPU_TORCH_C_API_H_ */
