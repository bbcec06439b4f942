"""Training and serving entry points: train(), cv() and serve().

Counterpart of lightgbm_tpu/engine.py::train, ::cv and ::serve
(reference: python-package/lightgbm/engine.py: train(), cv(), CVBooster,
callback ordering by ``.order`` / ``.before_iteration``, the
EarlyStopException flow).  train() carries the JAX package's runtime:
``snapshot_freq`` snapshots (atomic, integrity-trailed, pure-delta trees,
named by global iteration, pruned to ``snapshot_keep``), ``resume="auto"``
and ``init_model=<snapshot>`` with the fall back to the newest valid older
snapshot, so a resumed run gives the uninterrupted run's model text
bitwise; the ``train`` span, the heartbeat gauges, the fault sites
``host_crash`` and ``worker_hang``, ``metrics_file``, ``trace_file`` and
``metrics_port``; ``resume=<fleet manifest>``, the launcher's relaunch
from its coordinated checkpoints (the manifest checked: torn, unconfirmed,
a diverged acknowledgement, another shard fingerprint, past the asked
rounds; the ``fleet_resume`` event, counter and span).
"""

from __future__ import annotations

import copy
import os
import re
import time
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from .basic import Booster, CorruptModelError, Dataset, LightGBMError
from .callback import CallbackEnv, EarlyStopException
from .config import Config, choose_param_value
from .obs import metrics as _obs
from .obs import server as _obs_server
from .obs import trace as _trace
from .utils import checkpoint as _checkpoint
from .utils import faults as _faults
from .utils.log import log_debug, log_info, log_warning, set_verbosity


def _load_init_booster(init_model, device_type: str) -> Booster:
    """init_model as a Booster: a Booster, a model file or a model string
    (loaded for ``device_type``).  A snapshot that fails its integrity
    check falls back to the newest valid older snapshot of its family
    (never a newer one: it may come from another, longer run), and
    failing that, a snapshot with no trailer at all that is structurally
    whole loads unverified, with a warning, as in the JAX package."""
    if isinstance(init_model, Booster):
        return init_model
    text = os.fspath(init_model)
    params = {"device_type": device_type}
    if text.startswith("tree\n"):
        return Booster(params=params, model_str=text)
    try:
        return Booster(params=params, model_file=text)
    except CorruptModelError as corrupt:
        below = _checkpoint.snapshot_iteration(text)
        fb = _checkpoint.latest_valid_snapshot(text, below_iter=below)
        if fb is not None:
            it, snap = fb
            _obs.counter("checkpoint_fallbacks_total").inc()
            _obs.event("checkpoint_fallback", requested=text, used=snap, iteration=it)
            log_warning(f"init_model {text} failed integrity verification; falling "
                        f"back to the newest valid older snapshot {snap} "
                        f"(iteration {it})")
            return Booster(params=params, model_file=snap)
        body, ok = _checkpoint.read_and_verify(text)
        if ok is None and "\nend of trees" in body:
            m = re.search(r"^tree_sizes=(.*)$", body, re.M)
            expected = len(m.group(1).split()) if m else -1
            try:
                booster = Booster(params=params, model_str=body)
            except Exception:  # noqa: BLE001 (torn after all)
                raise corrupt from None
            if booster.num_trees() != expected:
                raise corrupt from None
            log_warning(f"init_model {text} is a snapshot with no integrity trailer; "
                        "no verified fallback exists, so it loads UNVERIFIED")
            return booster
        raise


def _replay_scores(gbdt) -> None:
    """The training score from the trees so far (continued training, a
    resume), on the device, adding the f32 values training added in the
    same order: the strict grower scales a tree's values in f64 and casts
    (the host tree's f32), the rounds and windowed growers multiply the
    f32 leaf value by the f32 shrinkage (recovered exactly from the host
    tree: its f64 value over its shrinkage is the f32 value), and a linear
    tree adds its leaf models' rows (``_tree_rows``).  Trees whose
    shrinkage no longer is one factor (a DART rescale) add their f32
    values.  The init score is in the base already."""
    k = gbdt.num_tree_per_iteration
    f32_product = not gbdt._use_strict()
    for i in range(gbdt._num_trees()):
        rows = None
        if f32_product and i < len(gbdt._models):
            tree = gbdt._models[i]
            lr = float(tree.shrinkage)
            if not tree.is_linear and lr not in (0.0, 1.0):
                raw = np.asarray(tree.leaf_value, np.float64) / lr
                vals = torch.as_tensor(raw.astype(np.float32) * np.float32(lr),
                                       device=gbdt.device)
                rows = vals[gbdt._tree_leaves(i, gbdt.train_set).long()]
        if rows is None:
            rows = gbdt._tree_rows(i, gbdt.train_set)
        gbdt._add_score(gbdt._score, rows, i % k)


def _seed_from(booster: Booster, init_model) -> None:
    """Start ``booster``'s training from ``init_model``'s trees (the JAX
    package's train(init_model=)): the trees and iteration count are
    carried over, and the score is rebuilt from the init scores, the
    training set's init_score and the trees in training order."""
    gbdt = booster._gbdt
    src = _load_init_booster(init_model, gbdt.cfg.device_type)._gbdt
    k = gbdt.num_tree_per_iteration
    if src.average_output:
        # a forest's text folds its init into every tree
        from .models.gbdt import GBDT

        gbdt.models = GBDT.load_model_from_string(
            src.save_model_to_string(), gbdt.cfg.device_type).models
        gbdt.init_scores = [0.0] * k
    else:
        gbdt.models = copy.deepcopy(src.models)
        gbdt.init_scores = list(src.init_scores)
    gbdt.iter_ = len(gbdt.models) // max(k, 1)
    base = np.zeros(tuple(gbdt._score.shape), dtype=np.float32)
    if any(s != 0.0 for s in gbdt.init_scores):
        base += (np.float32(gbdt.init_scores[0]) if k == 1
                 else np.asarray(gbdt.init_scores, dtype=np.float32)[None, :])
    ts = gbdt.train_set
    if ts.init_score is not None:
        base += np.asarray(ts.init_score, np.float32).reshape(base.shape)
    gbdt._score = torch.as_tensor(base, device=gbdt.device)
    _replay_scores(gbdt)


def _ordered(callbacks) -> tuple:
    """(before-iteration, after-iteration) callbacks, each sorted by order."""
    for cb in callbacks:
        if not hasattr(cb, "order"):
            cb.order = 0  # type: ignore[attr-defined]
    before = sorted((cb for cb in callbacks if getattr(cb, "before_iteration", False)),
                    key=lambda cb: cb.order)
    after = sorted((cb for cb in callbacks if not getattr(cb, "before_iteration", False)),
                   key=lambda cb: cb.order)
    return before, after


def _fleet_resume(manifest_path: str, num_boost_round: int):
    """resume=<fleet manifest> (the JAX package's): the manifest must be
    fleet-valid (utils/checkpoint.py::fleet_manifest_valid, without the acks
    of the ranks LGBMTPU_RESUME_EXCLUDE_RANKS names: a respawned slice's),
    name this rank's shard fingerprint where both are known, and be at or
    below ``num_boost_round``.  Returns (its snapshot, the rounds left)."""
    if not os.path.exists(manifest_path):
        raise LightGBMError(
            f"resume={manifest_path!r} is not supported: pass 'auto', a fleet "
            "manifest path (lgbmtpu-fleet-ckpt-v1), or init_model=<snapshot> for "
            "a specific file")
    excl = tuple(int(r) for r in os.environ.get(
        "LGBMTPU_RESUME_EXCLUDE_RANKS", "").split(",") if r)
    manifest = _checkpoint.fleet_manifest_valid(manifest_path, exclude_ranks=excl)
    if manifest is None:
        raise LightGBMError(
            f"resume manifest {manifest_path} is not fleet-valid (torn, unconfirmed "
            "by some rank, or its snapshot fails verification): refusing to resume "
            "into inconsistent fleet state")
    rank = os.environ.get("LGBM_TPU_WORKER_ID", os.environ.get("LIGHTGBM_TPU_RANK", "0"))
    shard_fp = os.environ.get("LGBMTPU_SHARD_FINGERPRINT")
    want_fp = (manifest.get("shards") or {}).get(rank)
    if shard_fp and want_fp and shard_fp != want_fp:
        raise LightGBMError(
            f"rank {rank}'s data shard fingerprint {shard_fp[:12]} does not match "
            f"the manifest's {want_fp[:12]}: the shard changed since the checkpoint, "
            "and resuming would train round k+1 on other data than rounds 1..k")
    it = int(manifest["round"])
    if it > num_boost_round:
        raise LightGBMError(
            f"resume manifest {manifest_path} is at round {it}, beyond the "
            f"requested num_iterations={num_boost_round}: raise num_iterations or "
            "resume from an older manifest")
    _obs.counter("fleet_resumes_total").inc()
    _obs.gauge("fleet_resumed_round").set(it)
    _obs.event("fleet_resume", round=it, manifest=os.fspath(manifest_path),
               snapshot=manifest["snapshot"])
    _trace.record_span("checkpoint.resume", 0.0, round=it,
                       manifest=os.fspath(manifest_path), outcome="fleet_manifest")
    left = max(num_boost_round - it, 0)
    log_info(f"resume: fleet manifest {manifest_path} (round {it}); training {left} "
             "remaining round(s) from its snapshot")
    return manifest["snapshot"], left


def train(
    params: Dict[str, Any],
    train_set: Dataset,
    num_boost_round: int = 100,
    valid_sets: Optional[List[Dataset]] = None,
    valid_names: Optional[List[str]] = None,
    feval: Optional[Callable] = None,
    init_model: Optional[Union[str, Booster]] = None,
    keep_training_booster: bool = False,
    callbacks: Optional[List[Callable]] = None,
    resume: Optional[str] = None,
) -> Booster:
    """Boost ``num_boost_round`` iterations on ``train_set`` (on the card
    unless params say device_type='cpu').  ``feval(score, dataset)`` adds
    metrics; ``init_model`` (a Booster, a model file, a snapshot or a model
    string) continues its trees; a callable ``objective`` gives the
    gradients.  ``resume="auto"`` (or the ``resume=auto`` parameter)
    continues from the newest valid snapshot of ``output_model``'s family
    at or below ``num_boost_round`` and trains the remaining rounds;
    ``resume=<fleet manifest>`` from that manifest's snapshot
    (``_fleet_resume``).  The
    returned booster keeps its training state whatever
    ``keep_training_booster`` says, as in the JAX package."""
    params = dict(params or {})
    params = choose_param_value("num_iterations", params, None)
    if params.get("num_iterations") is not None:
        num_boost_round = int(params["num_iterations"])
    params["num_iterations"] = num_boost_round
    params = choose_param_value("early_stopping_round", params, None)
    early_stopping_round = params.get("early_stopping_round")
    fobj = None
    if callable(params.get("objective")):
        fobj = params["objective"]
        params["objective"] = "none"
    cfg = Config.from_dict(params)
    set_verbosity(cfg.verbosity)
    telemetry_on = (bool(cfg.telemetry) if cfg.is_set("telemetry")
                    else _obs.DEFAULT_ENABLED)
    if telemetry_on:
        _start_endpoint(cfg)

    resume = resume if resume is not None else (cfg.resume or None)
    if resume is not None and resume != "auto":
        if init_model is not None:
            log_warning("resume=<manifest> ignored: an explicit init_model was "
                        "given and takes precedence")
        else:
            init_model, num_boost_round = _fleet_resume(resume, num_boost_round)
    elif resume is not None:
        if init_model is not None:
            log_warning("resume='auto' ignored: an explicit init_model was given "
                        "and takes precedence")
        else:
            # at or below the target: a newer snapshot of a longer run that
            # shares the prefix would overshoot the requested model
            fb = _checkpoint.latest_valid_snapshot(cfg.output_model,
                                                   below_iter=num_boost_round + 1)
            if fb is not None:
                it, snap = fb
                init_model = snap
                num_boost_round = max(num_boost_round - it, 0)
                _trace.record_span("checkpoint.resume", 0.0, round=it,
                                   snapshot=os.fspath(snap), outcome="auto_snapshot")
                log_info(f"resume=auto: resuming from {snap} (iteration {it}); "
                         f"training {num_boost_round} remaining round(s)")
            else:
                log_info("resume=auto: no valid snapshot found for "
                         f"{cfg.output_model}; starting fresh")

    booster = Booster(params=params, train_set=train_set)
    if init_model is not None:
        _seed_from(booster, init_model)
    valid_sets = valid_sets or []
    valid_names = valid_names or []
    for i, vs in enumerate(valid_sets):
        if vs is train_set:
            booster._gbdt.train_name = (valid_names[i] if i < len(valid_names)
                                        else "training")
            continue
        booster.add_valid(vs, valid_names[i] if i < len(valid_names)
                          else f"valid_{i}")

    callbacks = list(callbacks or [])
    if early_stopping_round is not None and int(early_stopping_round) > 0:
        from .callback import early_stopping

        callbacks.append(early_stopping(
            int(early_stopping_round),
            first_metric_only=bool(params.get("first_metric_only", False)),
            verbose=cfg.verbosity >= 1,
            min_delta=float(params.get("early_stopping_min_delta", 0.0))))
    before, after = _ordered(callbacks)
    train_in_valids = any(vs is train_set for vs in valid_sets)

    snapshot_freq = int(cfg.snapshot_freq)
    # snapshot names carry global iteration numbers: a resumed run must not
    # write a 6-tree model as snapshot_iter_2
    snapshot_base = booster.current_iteration()
    _trace.configure_request_tracing(cfg.request_tracing, cfg.trace_sample)
    trace_out = _trace_path(cfg)
    if _obs.enabled() and trace_out:
        try:  # the ring's evictions spill next to the trace file
            _trace.enable_spill(trace_out + ".spill.jsonl")
        except OSError as e:
            log_warning(f"could not arm the trace spill sink next to {trace_out}: {e}")

    # the run's span is host wall clock; heartbeat_done=0 marks the process
    # as training for a launcher's hang watchdog, until the finally below
    train_span = _trace.span("train", num_boost_round=num_boost_round)
    train_span.__enter__()
    _obs.gauge("heartbeat_done").set(0.0)
    try:
        for i in range(num_boost_round):
            _obs.gauge("heartbeat_ts").set(time.monotonic())
            # fault sites: preemption, or a wedged process, at the start of
            # 1-based iteration i + 1 (utils/faults.py)
            _faults.maybe_crash("host_crash", i + 1)
            _faults.maybe_hang("worker_hang", i + 1)
            for cb in before:
                cb(CallbackEnv(booster, params, i, 0, num_boost_round, []))
            finished = booster.update(fobj=fobj)
            results = []
            if train_in_valids or booster._gbdt.cfg.is_provide_training_metric:
                results.extend(booster.eval_train(feval))
            results.extend(booster.eval_valid(feval))
            for cb in after:
                cb(CallbackEnv(booster, params, i, 0, num_boost_round, results))
            global_iter = snapshot_base + i + 1
            if snapshot_freq > 0 and global_iter % snapshot_freq == 0:
                _snapshot(booster, cfg, global_iter)
            if finished:
                log_info("Stopped training because there are no more leaves "
                         "that meet the split requirements")
                break
    except EarlyStopException as e:
        booster.best_iteration = e.best_iteration + 1
        for item in e.best_score:
            booster.best_score.setdefault(item[0], {})[item[1]] = item[2]
        train_span.set(early_stopped=True)
    finally:
        _obs.gauge("heartbeat_done").set(1.0)
        train_span.set(trained_iterations=booster.current_iteration())
        train_span.__exit__(None, None, None)
        _finish_run_report(cfg)
    if booster.best_iteration <= 0:
        booster.best_iteration = booster.current_iteration()
    return booster


def _snapshot(booster: Booster, cfg: Config, global_iter: int) -> None:
    """``<output_model>.snapshot_iter_<global_iter>``: the snapshot form of
    the model text (pure-delta trees, exact init scores) written
    atomically with its integrity trailer; then the oldest snapshots
    beyond ``snapshot_keep`` are pruned (never the newest valid one)."""
    snap = f"{cfg.output_model}.snapshot_iter_{global_iter}"
    with _trace.span("checkpoint.snapshot", iteration=global_iter, path=snap):
        _checkpoint.save_snapshot(snap, booster.model_to_string(raw_deltas=True),
                                  global_iter)
    log_info(f"Saved snapshot to {snap}")
    if int(cfg.snapshot_keep) > 0:
        _checkpoint.prune_snapshots(cfg.output_model, int(cfg.snapshot_keep))


def _start_endpoint(cfg: Config) -> None:
    """The process-wide /metrics and /healthz endpoint (obs/server.py) at
    ``metrics_port`` (or LGBMTPU_METRICS_PORT); a port that cannot be bound
    warns and never costs the caller a model."""
    try:
        _obs_server.maybe_start(cfg.metrics_port if cfg.is_set("metrics_port")
                                else None)
    except OSError as e:
        log_warning(f"metrics endpoint could not start: {e}")


def _trace_path(cfg: Config) -> str:
    """The run's trace file: ``trace_file=``, else LGBMTPU_TRACE_FILE."""
    return cfg.trace_file or os.environ.get("LGBMTPU_TRACE_FILE", "")


def _finish_run_report(cfg: Config) -> None:
    """End-of-run observability, as the JAX package's: the "Time for X /
    counter = v" report at debug verbosity, the metrics snapshot to
    ``metrics_file=`` (atomic JSON; ``python -m lightgbm_tpu_torch.obs
    <file>`` renders it) and the Chrome-trace spans to ``trace_file=``,
    each best-effort; then the run's spill sink is disarmed."""
    if not _obs.enabled():
        for name, val in (("metrics_file", cfg.metrics_file),
                          ("trace_file", _trace_path(cfg))):
            if val:
                log_warning(f"{name}={val} ignored: telemetry is disabled "
                            "(telemetry=false / LGBMTPU_TELEMETRY=0)")
        return
    snap = _obs.snapshot()
    for line in _obs.render_lightgbm(snap):
        log_debug(line)
    if cfg.metrics_file:
        try:
            _obs.write_snapshot(cfg.metrics_file, snap)
        except OSError as e:
            log_warning(f"could not write metrics snapshot to {cfg.metrics_file}: {e}")
        else:
            log_info(f"Metrics snapshot written to {cfg.metrics_file}")
    trace_out = _trace_path(cfg)
    if trace_out:
        try:
            n_spans = _trace.write_trace(trace_out)
        except OSError as e:
            log_warning(f"could not write trace to {trace_out}: {e}")
        else:
            log_info(f"Trace ({n_spans} spans) written to {trace_out}")
        _trace.disable_spill()


def serve(model=None, params: Optional[Dict[str, Any]] = None, *, models=None,
          start: bool = True):
    """Serving entry point (the JAX package's engine.serve): build, and by
    default start, a :class:`~lightgbm_tpu_torch.serve.ServingRuntime` over
    one model (``model``: a Booster or a model file, served as "default")
    or several (``models``: {name: Booster or file}), with the /metrics and
    /healthz endpoint brought up as train() does.  ``params`` holds the
    serve options (serve_max_wait_ms, serve_max_queue, serve_slo_p99_ms,
    serve_tenant_quota), metrics_port, telemetry and device_type (the
    device model files load for: the card unless it says cpu).  Any fleet
    option (serve_replicas, serve_deadline_ms, serve_hedge_ms,
    serve_retry_budget, serve_replica_trip, serve_replica_cooldown_ms,
    serve_hang_timeout_ms, serve_restart_backoff_ms, serve_max_restarts)
    builds a :class:`~lightgbm_tpu_torch.serve.ServingFleet` instead.

    >>> rt = lgb.serve(booster, {"serve_max_wait_ms": 2})
    >>> y = rt.predict(X); rt.stop()
    """
    from .models.gbdt import resolve_device
    from .serve.fleet import ServingFleet
    from .serve.runtime import ServingRuntime

    cfg = Config.from_dict(dict(params or {}))
    set_verbosity(cfg.verbosity)
    resolve_device(cfg)  # no card and no device_type=cpu: raise here
    telemetry_on = (bool(cfg.telemetry) if cfg.is_set("telemetry")
                    else _obs.DEFAULT_ENABLED)
    _obs.set_enabled(telemetry_on)
    if telemetry_on:
        _start_endpoint(cfg)

    def _load(m):
        if isinstance(m, Booster):
            return m
        return Booster(params={"device_type": cfg.device_type}, model_file=m)

    table = None if models is None else {n: _load(m) for n, m in models.items()}
    single = None if model is None else _load(model)
    kw = {}
    for name, param in (("max_wait_ms", "serve_max_wait_ms"),
                        ("max_queue", "serve_max_queue"),
                        ("slo_p99_ms", "serve_slo_p99_ms"),
                        ("tenant_quota", "serve_tenant_quota")):
        if cfg.is_set(param):
            kw[name] = getattr(cfg, param)
    fleet_kw = {}
    for name, param in (("replicas", "serve_replicas"),
                        ("deadline_ms", "serve_deadline_ms"),
                        ("hedge_ms", "serve_hedge_ms"),
                        ("retry_budget", "serve_retry_budget"),
                        ("trip", "serve_replica_trip"),
                        ("cooldown_ms", "serve_replica_cooldown_ms"),
                        ("hang_timeout_ms", "serve_hang_timeout_ms"),
                        ("restart_backoff_ms", "serve_restart_backoff_ms"),
                        ("max_restarts", "serve_max_restarts")):
        if cfg.is_set(param):
            fleet_kw[name] = getattr(cfg, param)
    if fleet_kw:
        return ServingFleet(single, models=table, start=start, **kw, **fleet_kw)
    return ServingRuntime(single, models=table, start=start, **kw)


class CVBooster:
    """The folds' boosters of cv(); a method call on it calls every fold's
    booster and returns the list of results (reference: CVBooster)."""

    def __init__(self, boosters: Optional[List[Booster]] = None):
        self.boosters = boosters or []
        self.best_iteration = -1

    def append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        def handler_function(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]

        return handler_function


def _make_n_folds(full_data: Dataset, nfold: int, params: Dict, seed: int,
                  stratified: bool, shuffle: bool):
    """(train rows, test rows) of each fold, from numpy's RandomState(seed):
    whole queries for ranking data, stratified by label when asked."""
    num_data = full_data.num_data()
    rng = np.random.RandomState(seed)
    if full_data.group is not None:
        qidx = np.arange(len(full_data.group))
        if shuffle:
            rng.shuffle(qidx)
        bounds = np.concatenate([[0], np.cumsum(full_data.group)]).astype(np.int64)
        for q_chunk in np.array_split(qidx, nfold):
            te = np.sort(np.concatenate([np.arange(bounds[q], bounds[q + 1])
                                         for q in q_chunk]))
            yield np.setdiff1d(np.arange(num_data), te), te
        return
    if stratified and full_data.label is not None:
        label = np.asarray(full_data.label)
        folds: List[list] = [[] for _ in range(nfold)]
        for c in np.unique(label):
            idx = np.nonzero(label == c)[0]
            if shuffle:
                rng.shuffle(idx)
            for i, chunk in enumerate(np.array_split(idx, nfold)):
                folds[i].extend(chunk.tolist())
        test_indices = [np.asarray(sorted(f), dtype=np.int64) for f in folds]
    else:
        idx = np.arange(num_data)
        if shuffle:
            rng.shuffle(idx)
        test_indices = [np.sort(chunk) for chunk in np.array_split(idx, nfold)]
    for te in test_indices:
        yield np.setdiff1d(np.arange(num_data), te), te


def continual_train(model=None, params: Optional[Dict[str, Any]] = None, *,
                    runtime=None, model_name: str = "default", reference=None,
                    state_dir: Optional[str] = None, cache_path: Optional[str] = None,
                    start: bool = True, **runner_kwargs):
    """Make, and by default start, a ContinualRunner (README "Continuous
    training"; continual/runtime.py): it ingests fresh rows beside a live
    ServingRuntime, refits the leaves or appends trees on the card by
    policy, and swaps the serving ensemble without downtime.

    ``model`` is a Booster or a model file; ``runtime`` a ServingRuntime
    already serving it as ``model_name``; ``reference`` the training
    Dataset (or its save_binary cache) with the frozen bin mappers;
    ``params`` the policy (``update_every_rows``, ``update_every_s``,
    ``append_trees``, ``drift_window``) and ``metrics_port`` /
    ``telemetry``; ``state_dir`` arms rollover checkpoints (with
    ``resume=True`` to pick the newest valid one up) and ``cache_path``
    the durable ingest cache.  Runs on the card unless ``device_type`` is
    "cpu"; without a card and that parameter it raises."""
    from .continual.runtime import ContinualRunner
    from .models.gbdt import resolve_device

    cfg = Config.from_dict(dict(params or {}))
    set_verbosity(cfg.verbosity)
    resolve_device(cfg)  # raises without a card unless device_type is cpu
    _obs.set_enabled(bool(cfg.telemetry) if cfg.is_set("telemetry")
                     else _obs.DEFAULT_ENABLED)
    if _obs.enabled():
        _start_endpoint(cfg)
    bst = (model if isinstance(model, Booster)
           else Booster(params={"device_type": cfg.device_type}, model_file=model))
    for name in ("update_every_rows", "update_every_s", "append_trees", "drift_window"):
        if cfg.is_set(name):
            runner_kwargs.setdefault(name, getattr(cfg, name))
    return ContinualRunner(bst, runtime=runtime, model_name=model_name,
                           reference=reference, state_dir=state_dir,
                           cache_path=cache_path, start=start, **runner_kwargs)


def train_fleet(params: Optional[Dict[str, Any]], train_set, labels=None, *,
                num_boost_round: int = 100, weights=None, rounds=None):
    """Train B independent boosters over one shared binned Dataset (README
    "Booster fleets"; models/fleet.py::FleetBooster): every boosting round
    of every lane advances as one fleet round, with the histogram and
    partition kernels launched once a round for all lanes.

    ``train_set`` is the shared Dataset with ``labels`` a (B, N) label
    matrix (and optionally ``weights`` (B, N)), or a list of Datasets over
    the same feature data whose labels and weights are stacked here.
    ``rounds`` optionally gives each lane's budget (default
    ``num_boost_round``); ``params`` may pin ``fleet_size`` as a shape
    guard.  Runs on the card unless ``device_type`` is "cpu".  Returns the
    trained FleetBooster: ``booster(b)`` is lane b's Booster."""
    from .models.fleet import FleetBooster, FleetError

    cfg = Config.from_dict(dict(params or {}))
    set_verbosity(cfg.verbosity)
    _obs.set_enabled(bool(cfg.telemetry) if cfg.is_set("telemetry")
                     else _obs.DEFAULT_ENABLED)
    if _obs.enabled():
        _start_endpoint(cfg)
    if isinstance(train_set, (list, tuple)):
        if labels is not None:
            raise FleetError("train_fleet: pass either a list of Datasets or one "
                             "Dataset and a (B, N) label matrix, not both")
        datasets = list(train_set)
        if not datasets:
            raise FleetError("train_fleet: empty Dataset list")
        labels = np.stack([np.asarray(d.label, np.float64) for d in datasets])
        ws = [d.weight for d in datasets]
        if any(w is not None for w in ws):
            weights = np.stack([np.ones(labels.shape[1]) if w is None
                                else np.asarray(w, np.float64) for w in ws])
        train_set = datasets[0]
    elif labels is None:
        raise FleetError("train_fleet: a (B, N) label matrix (or a list of "
                         "Datasets) is required")
    fb = FleetBooster(train_set, labels, params, weights=weights, rounds=rounds)
    return fb.train(num_boost_round)


def cv(
    params: Dict[str, Any],
    train_set: Dataset,
    num_boost_round: int = 100,
    folds=None,
    nfold: int = 5,
    stratified: bool = True,
    shuffle: bool = True,
    metrics=None,
    feval=None,
    init_model=None,
    fpreproc=None,
    seed: int = 0,
    callbacks=None,
    eval_train_metric: bool = False,
    return_cvbooster: bool = False,
) -> Dict[str, Any]:
    """K-fold cross-validation (reference: engine.py cv()): per iteration,
    the mean and standard deviation over the folds of each validation
    metric, under "<set> <metric>-mean" / "-stdv".  ``init_model`` and
    ``fpreproc`` are accepted and unused, as in the JAX package."""
    from .models.gbdt import resolve_device

    params = dict(params or {})
    if metrics is not None:
        params["metric"] = metrics
    params = choose_param_value("num_iterations", params, None)
    if params.get("num_iterations") is not None:
        num_boost_round = int(params["num_iterations"])
    params.pop("num_iterations", None)
    params = choose_param_value("early_stopping_round", params, None)
    early_stopping_round = params.get("early_stopping_round")
    objective = params.get("objective", "")
    stratified = stratified and isinstance(objective, str) and (
        objective.startswith("binary") or objective.startswith("multiclass"))

    train_set.construct(device=resolve_device(Config.from_dict(
        {**(train_set.params or {}), **params})))
    if folds is None:
        folds = list(_make_n_folds(train_set, nfold, params, seed, stratified, shuffle))
    elif hasattr(folds, "split"):
        folds = list(folds.split(np.zeros(train_set.num_data()),
                                 np.asarray(train_set.label)))

    cvbooster = CVBooster()
    for tr_idx, te_idx in folds:
        bst = Booster(params=params, train_set=train_set.subset(tr_idx))
        bst.add_valid(train_set.subset(te_idx), "valid")
        cvbooster.append(bst)

    callbacks = list(callbacks or [])
    if early_stopping_round is not None and int(early_stopping_round) > 0:
        from .callback import early_stopping

        callbacks.append(early_stopping(int(early_stopping_round), verbose=False))
    before, after = _ordered(callbacks)

    results: Dict[str, List[float]] = {}
    try:
        for i in range(num_boost_round):
            for cb in before:
                cb(CallbackEnv(cvbooster, params, i, 0, num_boost_round, []))
            merged: Dict[tuple, List[float]] = {}
            for bst in cvbooster.boosters:
                bst.update()
                evals = bst.eval_valid(feval)
                if eval_train_metric:
                    evals = bst.eval_train(feval) + evals
                for (name, metric, val, hib) in evals:
                    merged.setdefault((name, metric, hib), []).append(val)
            agg = []
            for (name, metric, hib), vals in merged.items():
                mean, std = float(np.mean(vals)), float(np.std(vals))
                results.setdefault(f"{name} {metric}-mean", []).append(mean)
                results.setdefault(f"{name} {metric}-stdv", []).append(std)
                agg.append((name, metric, mean, hib, std))
            for cb in after:
                cb(CallbackEnv(cvbooster, params, i, 0, num_boost_round, agg))
    except EarlyStopException as e:
        cvbooster.best_iteration = e.best_iteration + 1
        for key in list(results.keys()):
            results[key] = results[key][: cvbooster.best_iteration]
    if return_cvbooster:
        results["cvbooster"] = cvbooster  # type: ignore[assignment]
    return results
