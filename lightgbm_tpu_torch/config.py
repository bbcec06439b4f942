"""Parameter system: names, defaults, aliases.

Copy of lightgbm_tpu/config.py for the PyTorch/CUDA package.  Only
``device_type`` differs: it defaults to the CUDA card ("cuda", alias "gpu")
and "cpu" selects the host (the parity tests ask for it explicitly).

Re-implementation of the reference's config layer
(reference: include/LightGBM/config.h, src/io/config.cpp,
src/io/config_auto.cpp -> Config::Set / parameter2aliases).  The reference
generates its alias tables from docs/Parameters.rst; here a single Python
table is the source of truth.

Only a (large) subset of the ~180 params is meaningful yet; unknown params are
accepted and kept (LightGBM behavior: warn-and-ignore for unused params).
"""

from __future__ import annotations

import copy
import os
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional, Union

# ---------------------------------------------------------------------------
# Alias table (reference: Config::parameter2aliases in src/io/config_auto.cpp)
# maps alias -> canonical name.
# ---------------------------------------------------------------------------
_ALIASES: Dict[str, str] = {
    # core
    "config_file": "config",
    "task_type": "task",
    "objective_type": "objective",
    "app": "objective",
    "application": "objective",
    "loss": "objective",
    "boosting_type": "boosting",
    "boost": "boosting",
    "train": "data",
    "train_data": "data",
    "train_data_file": "data",
    "data_filename": "data",
    "test": "valid",
    "valid_data": "valid",
    "valid_data_file": "valid",
    "test_data": "valid",
    "test_data_file": "valid",
    "valid_filenames": "valid",
    "num_iteration": "num_iterations",
    "n_iter": "num_iterations",
    "num_tree": "num_iterations",
    "num_trees": "num_iterations",
    "num_round": "num_iterations",
    "num_rounds": "num_iterations",
    "nrounds": "num_iterations",
    "num_boost_round": "num_iterations",
    "n_estimators": "num_iterations",
    "max_iter": "num_iterations",
    "shrinkage_rate": "learning_rate",
    "eta": "learning_rate",
    "num_leaf": "num_leaves",
    "max_leaves": "num_leaves",
    "max_leaf": "num_leaves",
    "max_leaf_nodes": "num_leaves",
    "tree": "tree_learner",
    "tree_type": "tree_learner",
    "tree_learner_type": "tree_learner",
    "num_thread": "num_threads",
    "nthread": "num_threads",
    "nthreads": "num_threads",
    "n_jobs": "num_threads",
    "device": "device_type",
    "random_seed": "seed",
    "random_state": "seed",
    # learning control
    "min_data_per_leaf": "min_data_in_leaf",
    "min_data": "min_data_in_leaf",
    "min_child_samples": "min_data_in_leaf",
    "min_samples_leaf": "min_data_in_leaf",
    "min_sum_hessian_per_leaf": "min_sum_hessian_in_leaf",
    "min_sum_hessian": "min_sum_hessian_in_leaf",
    "min_hessian": "min_sum_hessian_in_leaf",
    "min_child_weight": "min_sum_hessian_in_leaf",
    "sub_row": "bagging_fraction",
    "subsample": "bagging_fraction",
    "bagging": "bagging_fraction",
    "pos_sub_row": "pos_bagging_fraction",
    "pos_subsample": "pos_bagging_fraction",
    "pos_bagging": "pos_bagging_fraction",
    "neg_sub_row": "neg_bagging_fraction",
    "neg_subsample": "neg_bagging_fraction",
    "neg_bagging": "neg_bagging_fraction",
    "subsample_freq": "bagging_freq",
    "bagging_fraction_seed": "bagging_seed",
    "sub_feature": "feature_fraction",
    "colsample_bytree": "feature_fraction",
    "sub_feature_bynode": "feature_fraction_bynode",
    "colsample_bynode": "feature_fraction_bynode",
    "early_stopping_rounds": "early_stopping_round",
    "early_stopping": "early_stopping_round",
    "n_iter_no_change": "early_stopping_round",
    "max_tree_output": "max_delta_step",
    "max_leaf_output": "max_delta_step",
    "reg_alpha": "lambda_l1",
    "l1_regularization": "lambda_l1",
    "reg_lambda": "lambda_l2",
    "lambda": "lambda_l2",
    "l2_regularization": "lambda_l2",
    "min_split_gain": "min_gain_to_split",
    "rate_drop": "drop_rate",
    "topk": "top_k",
    "mc": "monotone_constraints",
    "feature_contrib": "feature_contri",
    "fc": "feature_contri",
    "fp": "feature_contri",
    "feature_penalty": "feature_contri",
    "fs": "forcedsplits_filename",
    "forced_splits_filename": "forcedsplits_filename",
    "forced_splits_file": "forcedsplits_filename",
    "forced_splits": "forcedsplits_filename",
    "monotone_constraint": "monotone_constraints",
    "monotonic_cst": "monotone_constraints",
    "monotone_constraining_method": "monotone_constraints_method",
    "mc_method": "monotone_constraints_method",
    "monotone_splits_penalty": "monotone_penalty",
    "ms_penalty": "monotone_penalty",
    "mc_penalty": "monotone_penalty",
    "interaction_constraint": "interaction_constraints",
    "verbose": "verbosity",
    "model_output": "output_model",
    "model_out": "output_model",
    "save_period": "snapshot_freq",
    "model_input": "input_model",
    "model_in": "input_model",
    "predict_result": "output_result",
    "prediction_result": "output_result",
    "predict_name": "output_result",
    "prediction_name": "output_result",
    "pred_name": "output_result",
    "name_pred": "output_result",
    "is_pre_partition": "pre_partition",
    "is_enable_bundle": "enable_bundle",
    "bundle": "enable_bundle",
    "is_sparse": "is_enable_sparse",
    "enable_sparse": "is_enable_sparse",
    "sparse": "is_enable_sparse",
    "two_round_loading": "two_round",
    "use_two_round_loading": "two_round",
    "is_save_binary": "save_binary",
    "is_save_binary_file": "save_binary",
    "has_header": "header",
    "label": "label_column",
    "weight": "weight_column",
    "group": "group_column",
    "group_id": "group_column",
    "query_column": "group_column",
    "query": "group_column",
    "query_id": "group_column",
    "ignore_feature": "ignore_column",
    "blacklist": "ignore_column",
    "cat_feature": "categorical_feature",
    "categorical_column": "categorical_feature",
    "cat_column": "categorical_feature",
    "is_predict_raw_score": "predict_raw_score",
    "predict_rawscore": "predict_raw_score",
    "raw_score": "predict_raw_score",
    "is_predict_leaf_index": "predict_leaf_index",
    "leaf_index": "predict_leaf_index",
    "is_predict_contrib": "predict_contrib",
    "contrib": "predict_contrib",
    "convert_model_file": "convert_model",
    "num_classes": "num_class",
    "unbalance": "is_unbalance",
    "unbalanced_sets": "is_unbalance",
    "metrics": "metric",
    "metric_types": "metric",
    "output_freq": "metric_freq",
    "training_metric": "is_provide_training_metric",
    "is_training_metric": "is_provide_training_metric",
    "train_metric": "is_provide_training_metric",
    "ndcg_eval_at": "eval_at",
    "ndcg_at": "eval_at",
    "map_eval_at": "eval_at",
    "map_at": "eval_at",
    "num_machine": "num_machines",
    "local_port": "local_listen_port",
    "port": "local_listen_port",
    "machine_list_file": "machine_list_filename",
    "machine_list": "machine_list_filename",
    "mlist": "machine_list_filename",
    "workers": "machines",
    "nodes": "machines",
    "subsample_for_bin": "bin_construct_sample_cnt",
    "hist_pool_size": "histogram_pool_size",
    "linear_trees": "linear_tree",
    "max_bins": "max_bin",
    "extra_tree": "extra_trees",
    "data_seed": "data_random_seed",
}

_OBJECTIVE_ALIASES: Dict[str, str] = {
    "regression_l2": "regression",
    "l2": "regression",
    "mean_squared_error": "regression",
    "mse": "regression",
    "l2_root": "regression",
    "root_mean_squared_error": "regression",
    "rmse": "regression",
    "regression_l1": "regression_l1",
    "l1": "regression_l1",
    "mean_absolute_error": "regression_l1",
    "mae": "regression_l1",
    "mean_absolute_percentage_error": "mape",
    "multiclassova": "multiclassova",
    "multiclass_ova": "multiclassova",
    "ova": "multiclassova",
    "ovr": "multiclassova",
    "xentropy": "cross_entropy",
    "xentlambda": "cross_entropy_lambda",
    "lambdarank": "lambdarank",
    "rank_xendcg": "rank_xendcg",
    "xendcg": "rank_xendcg",
    "xe_ndcg": "rank_xendcg",
    "xe_ndcg_mart": "rank_xendcg",
    "xendcg_mart": "rank_xendcg",
    "binary_logloss": "binary",
}


def canonical_objective(name: str) -> str:
    return _OBJECTIVE_ALIASES.get(name, name)


@dataclass
class Config:
    """Typed parameter bag (reference: include/LightGBM/config.h).

    Defaults match the reference's documented defaults.
    """

    # --- core ---
    config: str = ""  # path of a config file (CLI `config=`; cli.py reads it)
    task: str = "train"
    objective: str = "regression"
    boosting: str = "gbdt"
    data_sample_strategy: str = "bagging"
    data: str = ""
    valid: List[str] = field(default_factory=list)
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    tree_learner: str = "serial"
    num_threads: int = 0
    device_type: str = "cuda"  # cuda | gpu (alias) | cpu
    seed: int = 0
    deterministic: bool = False
    # TPU-specific growth scheduling (ops/treegrow_fast.py): "auto" uses the
    # round-batched grower on TPU backends and the strict best-first grower
    # elsewhere; "strict" / "rounds" force one.  Split formulas are shared
    # (ops/split.py), but the rounds grower differs from the reference in
    # leaf expansion ORDER and in histogram payload precision (see
    # hist_precision), so trees can differ from strict/CPU ones — the same
    # class of deviation the reference documents for its CUDA-vs-CPU
    # learners.  "windowed" forces the windowed grower at any width and on
    # either device (the solo run a booster-fleet lane reproduces).
    tree_growth_mode: str = "auto"
    # histogram payload precision on the TPU MXU path: "f32" = bf16x2 split
    # payloads (~17-bit mantissa products, f32 accumulation — between the
    # reference's float and double hist modes); "bf16" = single bf16
    # payloads (~8-bit mantissa, cheapest)
    hist_precision: str = "f32"
    # fuse gradients + tree growth + score update into one jit dispatch
    # (models/gbdt.py _fused_eligible).  Disable for very wide/deep shapes
    # where the combined trace compiles slowly (e.g. Epsilon-scale
    # num_leaves=255 x 2000 features)
    fused_training: bool = True

    # --- learning control ---
    force_col_wise: bool = False
    force_row_wise: bool = False
    histogram_pool_size: float = -1.0
    max_depth: int = -1
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    bagging_fraction: float = 1.0
    pos_bagging_fraction: float = 1.0
    neg_bagging_fraction: float = 1.0
    bagging_freq: int = 0
    bagging_seed: int = 3
    bagging_by_query: bool = False
    feature_fraction: float = 1.0
    feature_fraction_bynode: float = 1.0
    feature_fraction_seed: int = 2
    extra_trees: bool = False
    extra_seed: int = 6
    early_stopping_round: int = 0
    early_stopping_min_delta: float = 0.0
    first_metric_only: bool = False
    max_delta_step: float = 0.0
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    linear_lambda: float = 0.0
    min_gain_to_split: float = 0.0
    drop_rate: float = 0.1
    max_drop: int = 50
    skip_drop: float = 0.5
    xgboost_dart_mode: bool = False
    uniform_drop: bool = False
    drop_seed: int = 4
    top_rate: float = 0.2
    other_rate: float = 0.1
    min_data_per_group: int = 100
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_to_onehot: int = 4
    top_k: int = 20
    monotone_constraints: List[int] = field(default_factory=list)
    monotone_constraints_method: str = "basic"
    monotone_penalty: float = 0.0
    feature_contri: List[float] = field(default_factory=list)
    forcedsplits_filename: str = ""
    refit_decay_rate: float = 0.9
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0
    cegb_penalty_feature_lazy: List[float] = field(default_factory=list)
    cegb_penalty_feature_coupled: List[float] = field(default_factory=list)
    path_smooth: float = 0.0
    interaction_constraints: Union[str, List[List[int]]] = ""
    verbosity: int = 1
    use_quantized_grad: bool = False
    num_grad_quant_bins: int = 4
    quant_train_renew_leaf: bool = False
    stochastic_rounding: bool = True

    # --- dataset ---
    linear_tree: bool = False
    max_bin: int = 255
    max_bin_by_feature: List[int] = field(default_factory=list)
    min_data_in_bin: int = 3
    bin_construct_sample_cnt: int = 200000
    data_random_seed: int = 1
    is_enable_sparse: bool = True
    enable_bundle: bool = True
    use_missing: bool = True
    zero_as_missing: bool = False
    feature_pre_filter: bool = True
    pre_partition: bool = False
    two_round: bool = False
    header: bool = False
    label_column: str = ""
    weight_column: str = ""
    group_column: str = ""
    ignore_column: str = ""
    categorical_feature: Union[str, List[int]] = ""
    forcedbins_filename: str = ""
    save_binary: bool = False
    precise_float_parser: bool = False
    parser_config_file: str = ""

    # --- predict ---
    start_iteration_predict: int = 0
    num_iteration_predict: int = -1
    predict_raw_score: bool = False
    predict_leaf_index: bool = False
    predict_contrib: bool = False
    predict_disable_shape_check: bool = False
    pred_early_stop: bool = False
    pred_early_stop_freq: int = 10
    pred_early_stop_margin: float = 10.0
    output_result: str = "LightGBM_predict_result.txt"

    # --- convert ---
    convert_model_language: str = ""
    convert_model: str = "gbdt_prediction.cpp"

    # --- objective params ---
    objective_seed: int = 5
    num_class: int = 1
    is_unbalance: bool = False
    scale_pos_weight: float = 1.0
    sigmoid: float = 1.0
    boost_from_average: bool = True
    reg_sqrt: bool = False
    alpha: float = 0.9
    fair_c: float = 1.0
    poisson_max_delta_step: float = 0.7
    tweedie_variance_power: float = 1.5
    lambdarank_truncation_level: int = 30
    lambdarank_norm: bool = True
    label_gain: List[float] = field(default_factory=list)
    lambdarank_position_bias_regularization: float = 0.0

    # --- metric ---
    metric: List[str] = field(default_factory=list)
    metric_freq: int = 1
    is_provide_training_metric: bool = False
    eval_at: List[int] = field(default_factory=lambda: [1, 2, 3, 4, 5])
    multi_error_top_k: int = 1
    auc_mu_weights: List[float] = field(default_factory=list)

    # --- network ---
    num_machines: int = 1
    local_listen_port: int = 12400
    time_out: int = 120
    machine_list_filename: str = ""
    machines: str = ""
    # num_slices (ours; docs/DISTRIBUTED.md "Hierarchical merge"): slice
    # count of the nested (dcn, ici) mesh for multi-slice scale-out.
    # With num_slices > 1 and tree_learner=data|voting, the fused
    # windowed round runs the two-level merge: full psum/psum_scatter
    # histogram collectives stay INSIDE each slice's ici axis, and only
    # top_k_features features' histograms + gain scalars per split
    # candidate cross the dcn axis (the PV-Tree/voting-parallel route).
    # Devices must divide evenly into slices.  1 (default) = the
    # single-level sharded round.
    num_slices: int = 1
    # top_k_features (ours; docs/DISTRIBUTED.md "Hierarchical merge"):
    # per-slice feature election width of the hierarchical merge — how
    # many features' histograms each slice may ship over DCN per split
    # candidate.  k >= num_features makes the election exhaustive
    # (trees structurally exact vs the single-mesh sharded round, at
    # full-merge byte cost over DCN); smaller k is the PV-Tree
    # approximation with a statically pinned DCN byte budget
    # (jaxpr-audit dcn_max_bytes, jaxlint R17).  Distinct from top_k,
    # which parameterizes the strict voting-parallel grower.
    top_k_features: int = 32
    # num_feature_shards (ours; docs/DISTRIBUTED.md "2-D sharding"):
    # feature-axis size d_f of the 2-D (feature, row) mesh for
    # tree_learner=feature2d — each device owns an (F/d_f, N/d_r) tile
    # of the bin matrix, per-leaf histograms are complete for the owned
    # feature block with ZERO feature-axis collectives, and the split
    # election runs the owned-feature winner machinery over the feature
    # axis.  F pads to a multiple of d_f with dead features (never
    # electable), rows pad to a multiple of d_r = devices/d_f.  A d_f
    # that does not divide the device count warns and falls back to the
    # single-level mesh instead of crashing.  1 (default) = rows-only
    # sharding.
    num_feature_shards: int = 1

    # --- GPU-compat (accepted, translated to mesh semantics) ---
    gpu_platform_id: int = -1
    gpu_device_id: int = -1
    gpu_use_dp: bool = False
    num_gpu: int = 1

    # --- io ---
    input_model: str = ""
    output_model: str = "LightGBM_model.txt"
    saved_feature_importance_type: int = 0
    snapshot_freq: int = -1
    # resume (ours; docs/ROBUSTNESS.md): "auto" resumes from the newest
    # VALID snapshot in output_model's family without naming a file; a
    # path to a fleet manifest (lgbmtpu-fleet-ckpt-v1, written by the
    # launcher's coordinated checkpoints) resumes from that FLEET-VALID
    # round — torn or unconfirmed manifests are refused.  Either way only
    # the remaining rounds toward num_iterations are trained.
    resume: str = ""
    # snapshot_keep (ours; docs/ROBUSTNESS.md "Elastic fleet recovery"):
    # retention bound for the *.snapshot_iter_<k> family (and the
    # launcher's fleet checkpoint rounds).  After each successful snapshot
    # write the oldest snapshots beyond the newest snapshot_keep are
    # pruned — but NEVER the newest one that verifies, whatever its age.
    # 0 (default) = keep all, today's behavior.
    snapshot_keep: int = 0
    # heartbeat_timeout_s (ours; docs/ROBUSTNESS.md): hang-aware fleet
    # watchdog.  Workers heartbeat by bumping the heartbeat_ts gauge at
    # every boosting round (flushed by the periodic per-rank metrics
    # snapshot — zero extra device dispatches, zero new threads); the
    # launcher declares a rank HUNG when its heartbeat goes stale past
    # this many seconds, kills its process group, and routes into the
    # max_restarts relaunch path exactly as a death does.  Size it above
    # the WORST-case round — including mid-run XLA recompiles (bucket-cap
    # transitions), not just the steady state: the host is blocked during
    # a compile, so a compile longer than the timeout reads as a hang
    # (only the very first observation is automatically excused).
    # 0 (default) = disabled (exit-code watchdog + launch timeout only).
    # LGBMTPU_HEARTBEAT_TIMEOUT_S is the env spelling.
    heartbeat_timeout_s: float = 0.0
    # slow_rank_factor (ours; docs/OBSERVABILITY.md "Fleet metrics"):
    # straggler DETECTION threshold for the launcher's heartbeat watchdog.
    # A rank whose heartbeat AGE (seconds since its value last changed)
    # exceeds slow_rank_factor x the fleet median age — and a 1 s absolute
    # floor, so an idle-but-healthy fleet's jitter can't trip it — emits a
    # fleet_slow_rank event and bumps fleet_slow_ranks_total, once per
    # slow episode.  Detection only: nothing is killed (full stalls are
    # heartbeat_timeout_s's job); the signal is for dashboards watching
    # the live launcher /metrics endpoint, where per-rank heartbeat age is
    # a labeled gauge.  0 = off.  LGBMTPU_SLOW_RANK_FACTOR is the env
    # spelling.
    slow_rank_factor: float = 3.0

    # --- out-of-core data path (ours; docs/PERF_NOTES.md round 12) ---
    # out_of_core: stream the binned matrix in row chunks through pinned,
    # reused host buffers instead of materializing it whole.  From a
    # save_binary cache the host never holds the full matrix; on device,
    # residency is governed by max_rows_in_hbm (below).  Datasets whose
    # rows exceed the device budget train via chunked histogram
    # accumulation (ops/treegrow_ooc.py) — bins are streamed per pass and
    # the device keeps only O(N) vectors + O(L*F*B) histograms.
    out_of_core: bool = False
    # max_rows_in_hbm: device-residency budget for the binned matrix, in
    # rows.  0 (default) = unbounded: the matrix is assembled device-
    # resident from the streamed chunks and training runs the standard
    # growers unchanged.  N > max_rows_in_hbm selects the spill regime
    # (chunked-histogram training).  Only meaningful with out_of_core.
    max_rows_in_hbm: int = 0
    # out_of_core_chunk_rows: rows per streamed chunk (the reused host
    # buffer's size and the device chunk shape).  0 = auto (65536).
    # Chunking never changes results: the ingest assembles the identical
    # device matrix, and the spill grower's histogram accumulation is an
    # order-preserving fold (tests/test_out_of_core.py pins bitwise
    # equality across chunk sizes).
    out_of_core_chunk_rows: int = 0

    # --- observability (ours; docs/OBSERVABILITY.md) ---
    # telemetry: the process-wide metrics/event registry (lightgbm_tpu/obs)
    # is DEFAULT-ON — it adds zero device dispatches and zero blocking
    # syncs (every device-derived metric rides an existing sync point);
    # telemetry=false flips the registry off for the process.
    telemetry: bool = True
    # metrics_file / metrics_port / trace_file: the end-of-run metrics
    # snapshot, the live /metrics + /healthz endpoint and the Chrome-trace
    # span file, as in the JAX package (engine.train, obs/)
    metrics_file: str = ""
    metrics_port: int = -1
    trace_file: str = ""
    # request_tracing: request-scoped distributed tracing (docs/
    # OBSERVABILITY.md "Request tracing") — DEFAULT-ON like telemetry=,
    # and with the same budget contract: a TraceContext minted per
    # request at admission (honoring inbound W3C traceparent on
    # /predict), threaded explicitly through coalescing/dispatch/fleet
    # retry/hedge legs, zero added device dispatches or syncs.  false
    # stops minting sampled contexts (responses still carry a trace id
    # for correlation; no spans are recorded for them).
    request_tracing: bool = True
    # trace_sample: fraction of requests whose trace is RECORDED (the
    # admission-time sampling decision; 1.0 default).  Unsampled
    # requests still carry ids end-to-end — only span recording and the
    # latency exemplar are skipped.
    trace_sample: float = 1.0

    # --- serving runtime (ours; README "Serving", lightgbm_tpu/serve) ---
    # serve_max_wait_ms: the coalescer's admission window — after the
    # first queued request, up to this many milliseconds of later arrivals
    # coalesce into the same bucket-rung batch (flushed EARLY the moment a
    # pow-2 rung fills).  Smaller = lower added latency, larger = fuller
    # batches under bursty load.
    serve_max_wait_ms: float = 2.0
    # serve_max_queue: admission bound on queued requests across the
    # runtime; submissions past it are SHED with a typed Overloaded error
    # (counted in serve_shed_total, evented, /healthz-visible) instead of
    # queuing unboundedly — a hang is never the failure mode.
    serve_max_queue: int = 1024
    # serve_slo_p99_ms: p99 latency SLO driving load shedding off the
    # existing predict_warm_latency_ms reservoirs — when the observed p99
    # exceeds this and requests are already queued, new submissions shed.
    # The reservoir is process-cumulative, so size the SLO for steady
    # state, not cold compiles (which never enter the warm reservoirs).
    # 0 (default) = no SLO shedding (queue bound + health shedding only).
    serve_slo_p99_ms: float = 0.0
    # serve_tenant_quota: per-tenant bound on queued requests (each served
    # model name is a tenant; per-tenant latency is labeled
    # serve_request_latency_ms{tenant="..."}).  A tenant at its quota
    # sheds with Overloaded while other tenants keep serving — one noisy
    # caller cannot monopolize the chip.  0 (default) = unlimited.
    serve_tenant_quota: int = 0
    # serve_replicas: replica count for the resilient fleet layer
    # (lightgbm_tpu/serve/fleet.py) — N dispatchers behind ONE admission
    # queue (one per device on a real slice; N threads off-chip), with
    # health-aware routing, an ejection/readmission circuit breaker and
    # watchdog-driven replica restart.  1 (default) keeps the solo
    # ServingRuntime unless another fleet knob opts in.
    serve_replicas: int = 1
    # serve_deadline_ms: per-request completion deadline — an admitted
    # request that cannot finish inside it raises a typed
    # DeadlineExceeded (distinct from Overloaded: admission succeeded,
    # completion was late; /predict maps it to 504).  Expired requests
    # still queued are dropped BEFORE spending a dispatch.  0 = off.
    serve_deadline_ms: float = 0.0
    # serve_hedge_ms: tail-latency hedging — a batch in flight on one
    # replica longer than this is speculatively re-dispatched on another
    # (first completion wins; predict is pure, so both produce the same
    # bits).  0 (default) = off; -1 = auto, p99-derived from the
    # serve_replica_batch_ms reservoirs.
    serve_hedge_ms: float = 0.0
    # serve_retry_budget: retry tokens added per admitted request (a
    # failed/dead/hung replica dispatch requeues its batch's requests
    # EXACTLY once onto a healthy replica, spending one token per
    # batch).  The budget is what turns a sick fleet into shedding
    # instead of a retry storm.  Negative = unlimited retries.
    serve_retry_budget: float = 0.25
    # serve_replica_trip: consecutive batch failures that trip a
    # replica's circuit breaker (ejected from rotation, readmitted via a
    # half-open probe after a jittered exponential cooldown).  The LAST
    # healthy replica is never ejected.
    serve_replica_trip: int = 3
    # serve_replica_cooldown_ms: base ejection cooldown; doubles per
    # consecutive trip, with +/-50% jitter.
    serve_replica_cooldown_ms: float = 50.0
    # serve_hang_timeout_ms: per-replica heartbeat staleness bound — a
    # replica holding a batch without a heartbeat tick for this long is
    # declared hung (serve_replica_hangs_total), its in-flight requests
    # requeue, and a replacement is spawned.  Size it above the worst
    # legitimate batch latency.
    serve_hang_timeout_ms: float = 2000.0
    # serve_restart_backoff_ms: base delay before a dead/hung replica's
    # replacement spawns; doubles per restart, jittered.  The
    # replacement warms the bucket ladder BEFORE joining rotation.
    serve_restart_backoff_ms: float = 20.0
    # serve_max_restarts: restarts per replica slot before it is
    # abandoned (the fleet degrades to the surviving replicas; the last
    # replica's death with no restarts left fails queued requests with a
    # typed error rather than hanging them).
    serve_max_restarts: int = 3

    # --- continual training (ours; README "Continuous training",
    # lightgbm_tpu/continual) ---
    # update_every_rows: the continual runner triggers an update
    # (leaf-value refit, escalating to appended trees) once this many
    # fresh rows have been ingested since the last rollover.  0 = no
    # row-driven updates (update_every_s or explicit update() calls
    # drive them).
    update_every_rows: int = 0
    # update_every_s: time-driven update trigger — an update fires when
    # the OLDEST un-incorporated ingested row is this many seconds old,
    # so a trickle of rows still reaches the model on a deadline.  0 =
    # no time-driven updates.
    update_every_s: float = 0.0
    # append_trees: trees appended per escalated continual update, seeded
    # init_model-style from the live ensemble (same growers, budgets and
    # bitwise semantics as offline continued training).  0 (default) =
    # refit-only: updates renew leaf values of the existing structure.
    append_trees: int = 0
    # drift_window: rows of recent ingest forming the rolling baseline
    # the per-chunk label-drift gauge (continual_label_drift) compares
    # against — the cheap covariate/label-shift signal riding the
    # continual_chunk event stream.
    drift_window: int = 8192
    # bin_cache_segment_threshold: durable-ingest append mode for
    # save_binary caches (io/stream.py).  0 (default) = every
    # append_rows() rewrites the whole cache (one file, O(total rows)
    # per append).  >= 1 = appends land in CRC'd sidecar segment files
    # (O(new rows) per append — the continual runner's steady-state
    # ingest cost) and the cache compacts back to one file once this
    # many live segments accumulate.
    bin_cache_segment_threshold: int = 0

    # --- booster fleets (ours; README "Booster fleets",
    # lightgbm_tpu/models/fleet.py) ---
    # fleet_size: expected number of boosters in a train_fleet batch.
    # 0 (default) = infer B from the (B, N) label matrix; a non-zero
    # value is a guard — train_fleet raises when it disagrees with the
    # labels, catching a transposed label matrix before a B=N fleet
    # trains silently.
    fleet_size: int = 0

    # unknown/passthrough params preserved here
    extra: Dict[str, Any] = field(default_factory=dict)
    # names the user explicitly set (vs defaults) — lets device-specific
    # default resolution (e.g. quantized training on wide-bin TPU runs)
    # respect an explicit user choice either way
    _explicit: set = field(default_factory=set, repr=False, compare=False)

    def is_set(self, name: str) -> bool:
        return name in self._explicit

    # ------------------------------------------------------------------
    @classmethod
    def from_dict(cls, params: Optional[Dict[str, Any]]) -> "Config":
        cfg = cls()
        cfg.update(params or {})
        return cfg

    def update(self, params: Dict[str, Any]) -> None:
        known = {f.name: f for f in fields(self)}
        for raw_key, value in params.items():
            key = _ALIASES.get(raw_key, raw_key)
            if key == "objective" and isinstance(value, str):
                value = canonical_objective(value)
            if key in known and key != "extra":
                cur = getattr(self, key)
                setattr(self, key, _coerce(value, cur, known[key].type))
                self._explicit.add(key)
            else:
                self.extra[key] = value
        # derived conveniences
        if self.objective in ("multiclass", "multiclassova") and self.num_class < 2:
            raise ValueError(
                "Number of classes should be specified and greater than 1 for multiclass training"
            )
        if self.tree_growth_mode not in ("auto", "strict", "rounds", "windowed"):
            raise ValueError(
                "tree_growth_mode must be auto/strict/rounds/windowed, got "
                f"{self.tree_growth_mode!r}"
            )
        if self.hist_precision not in ("f32", "bf16"):
            raise ValueError(
                f"hist_precision must be f32/bf16, got {self.hist_precision!r}"
            )
        if self.device_type not in ("cuda", "gpu", "cpu"):
            raise ValueError(
                f"device_type must be cuda/gpu/cpu, got {self.device_type!r}"
            )
        if self.max_bin >= 32768:
            # device bin storage is int16 (basic.py); the reference's uint16
            # caps at 65535 — far above any practical histogram width
            raise ValueError(f"max_bin must be < 32768, got {self.max_bin}")

    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for f in fields(self):
            if f.name in ("extra", "_explicit"):
                continue
            out[f.name] = copy.deepcopy(getattr(self, f.name))
        out.update(self.extra)
        return out

    def trace_path(self) -> str:
        """The run's trace file: ``trace_file=``, else LGBMTPU_TRACE_FILE."""
        return self.trace_file or os.environ.get("LGBMTPU_TRACE_FILE", "")

    @property
    def num_tree_per_iteration(self) -> int:
        return self.num_class if self.objective in ("multiclass", "multiclassova") else 1

    # params that exist for CPU/GPU-implementation reasons and have no TPU
    # analogue (reference: every accepted param has semantics in
    # src/io/config_auto.cpp; here the honest equivalent is an explicit
    # warning whenever a non-default value would otherwise be silently
    # ignored — see docs/Parameters.md)
    _NA_PARAMS = {
        "force_col_wise": "histogram layout is chosen by the measured "
        "per-max_bin device strategy, not col/row-wise threading",
        "force_row_wise": "histogram layout is chosen by the measured "
        "per-max_bin device strategy, not col/row-wise threading",
        "histogram_pool_size": "per-leaf histograms live in device HBM; "
        "there is no host LRU histogram pool",
        "gpu_platform_id": "device selection is device_type (cuda/cpu) "
        "and the current torch.cuda device",
        "gpu_device_id": "device selection is the current torch.cuda device",
        "gpu_use_dp": "histogram accumulation precision is controlled by "
        "hist_precision (bf16x2/f32 lanes)",
        "num_gpu": "this package trains on one device",
        "precise_float_parser": "parsing always uses full float64 "
        "precision (numpy)",
        "parser_config_file": "custom parser plugins are not supported",
    }

    def warn_na_params(self) -> None:
        """Warn for every accepted-but-N/A param set to a non-default value
        so nothing is silently ignored."""
        from .utils.log import log_warning

        defaults = type(self)()
        for name, reason in self._NA_PARAMS.items():
            if getattr(self, name) != getattr(defaults, name):
                log_warning(f"{name} has no effect on this backend: {reason}")


def _coerce(value: Any, current: Any, anno: Any) -> Any:
    """Coerce `value` to the type of the dataclass default (LightGBM accepts
    string-typed values everywhere since its config is string key=value)."""
    if isinstance(current, bool):
        if isinstance(value, str):
            return value.lower() in ("true", "1", "+", "yes")
        return bool(value)
    if isinstance(current, int) and not isinstance(value, bool):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, list):
        if isinstance(value, str):
            if not value:
                return []
            parts = [p for p in value.replace(" ", ",").split(",") if p]
            elem = (current[0] if current else None)
            if isinstance(elem, int):
                return [int(p) for p in parts]
            if isinstance(elem, float):
                return [float(p) for p in parts]
            # unknown element type: keep strings, try numeric
            out: List[Any] = []
            for p in parts:
                try:
                    out.append(int(p))
                except ValueError:
                    try:
                        out.append(float(p))
                    except ValueError:
                        out.append(p)
            return out
        if isinstance(value, (list, tuple)):
            return list(value)
        return [value]
    if isinstance(current, str):
        if isinstance(value, (list, tuple)):
            return ",".join(str(v) for v in value)
        return str(value)
    return value


def choose_param_value(main_param_name: str, params: Dict[str, Any], default_value: Any) -> Dict[str, Any]:
    """Resolve aliases in a raw param dict in favor of the main parameter
    (reference: python-package/lightgbm/basic.py -> _choose_param_value)."""
    params = dict(params)
    if main_param_name in params:
        return params
    for alias, canon in _ALIASES.items():
        if canon == main_param_name and alias in params:
            params[main_param_name] = params.pop(alias)
            return params
    if default_value is not None:
        params[main_param_name] = default_value
    return params
