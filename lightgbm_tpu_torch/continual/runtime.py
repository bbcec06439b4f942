"""Continuous training: streaming ingest, device refit or appended trees,
and zero-downtime rollover (README "Continuous training").

Counterpart of lightgbm_tpu/continual/runtime.py, whose policy code this
copies; the refit it drives is continual/refit.py's torch one.

* Ingest: ``ContinualRunner.ingest`` takes raw (X, y) chunks, bins them
  against the frozen mappers (out-of-range values clamp into the edge
  bins and are counted, ``continual_clamped_values_total``, never
  rebinned), appends them to the CRC-checked durable cache when one is
  configured (io/stream.py ``append_rows``, segments under
  ``bin_cache_segment_threshold``) and keeps a rolling window.
* Updates, by policy (``update_every_rows`` / ``update_every_s``): the
  refit renews every leaf of the live structure on the window on the
  card; the append update trains ``append_trees`` trees seeded from the
  live ensemble (init_model) through the ordinary ``engine.train``, so it
  is bitwise reproducible offline.
* Rollover: each update is built on a clone, checkpointed (raw-delta
  snapshot and fleet manifest, world size 1), then published through
  ``ServingRuntime.swap_model``, which packs before it publishes; a crash
  at the ``continual_swap`` fault site lands between checkpoint and
  publication, the previous ensemble still serving, and a runner made
  with ``resume=True`` picks the update up from the manifest.  Mutations
  bump the pack version under the lock the serving threads read.
* Staleness: ``model_staleness_s`` / ``model_staleness_rows`` say how far
  the served ensemble lags ingest; ``staleness_slo_s`` arms
  ``continual_staleness_exceeded``, which turns ``/healthz`` degraded.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..basic import Booster, LightGBMError
from ..obs import metrics as _obs
from ..obs import trace as _trace
from ..utils import checkpoint as _checkpoint
from ..utils import locktrace as _lt
from ..utils import faults as _faults
from ..utils import sanitizer as _san
from .refit import ContinualError, make_refit_entry, refit_eligible, refit_leaves

# the runner thread's wake cadence: staleness gauges refresh and the
# update policy is re-evaluated at this period (update_every_s is
# honored to within one tick)
_TICK_S = 0.05


class ContinualRunner:
    """In-process continual-training runtime beside (optionally) a live
    :class:`~lightgbm_tpu_torch.serve.ServingRuntime`.

    >>> rt = lgb.serve(booster, {"serve_max_wait_ms": 2})
    >>> cr = lgb.continual_train(booster, {"update_every_rows": 4096,
    ...                                    "append_trees": 5},
    ...                          runtime=rt, reference=train_ds)
    >>> cr.ingest(X_new, y_new)   # serving keeps answering throughout
    >>> cr.stop(); rt.stop()

    ``reference`` (a constructed Dataset, typically the training set or a
    ``save_binary`` cache path) supplies the FROZEN bin mappers for
    ingest binning, the durable cache, and append training; without it
    the runner is refit-only with unbinned ingest.  ``state_dir`` arms
    durable rollover checkpoints + crash resume; ``cache_path`` arms the
    durable CRC'd ingest cache.  Policy knobs default from the model's
    Config (``update_every_rows`` / ``update_every_s`` /
    ``append_trees`` / ``drift_window``); explicit kwargs win.
    """

    def __init__(self, model, *, runtime=None, model_name: str = "default",
                 reference=None, state_dir: Optional[str] = None,
                 cache_path: Optional[str] = None,
                 update_every_rows: Optional[int] = None,
                 update_every_s: Optional[float] = None,
                 append_trees: Optional[int] = None,
                 drift_window: Optional[int] = None,
                 append_every_rows: Optional[int] = None,
                 window_rows: int = 65536,
                 staleness_slo_s: float = 0.0,
                 resume: bool = False,
                 snapshot_keep: int = 0,
                 start: bool = False):
        self._live: Booster = (model if isinstance(model, Booster)
                               else Booster(model_file=model))
        cfg = self._live._gbdt.cfg
        self._device_params = {"device_type": cfg.device_type}
        self._runtime = runtime
        self._model_name = model_name
        if runtime is not None and model_name not in runtime.models():
            raise LightGBMError(
                f"model {model_name!r} is not served by the runtime "
                f"(have {runtime.models()}) — the runner can only roll "
                "over a model the serving loop already publishes")
        self._state_dir = state_dir
        if state_dir is not None:
            os.makedirs(state_dir, exist_ok=True)
        self._cache_path = cache_path
        self._update_every_rows = int(
            cfg.update_every_rows if update_every_rows is None
            else update_every_rows)
        self._update_every_s = float(
            cfg.update_every_s if update_every_s is None else update_every_s)
        self._append_trees = int(
            cfg.append_trees if append_trees is None else append_trees)
        self._drift_window = max(int(
            cfg.drift_window if drift_window is None else drift_window), 1)
        # escalation threshold: rows since the last append before an
        # auto update appends trees instead of refitting.  Defaults to 4
        # row-triggered update periods; for purely time-driven policies
        # (update_every_rows=0) it defaults to a full rolling window —
        # NOT a handful of rows, which would turn every timed update
        # into a tree append
        self._append_every_rows = int(
            append_every_rows if append_every_rows is not None
            else (4 * self._update_every_rows if self._update_every_rows > 0
                  else int(window_rows)))
        self._window_rows = int(window_rows)
        self._staleness_slo_s = float(staleness_slo_s)
        self._snapshot_keep = int(snapshot_keep)
        # durable-ingest append mode: >= 1 routes ingest appends into
        # CRC'd sidecar segments (O(new rows) per chunk) with threshold
        # compaction, instead of rewriting the whole cache every chunk
        self._seg_threshold = int(cfg.bin_cache_segment_threshold)

        # frozen mappers: an explicit reference Dataset (or save_binary
        # cache path) wins; else the booster's own training set
        self._ref_dataset = None
        binner = None
        if reference is not None:
            from ..basic import Dataset

            ref = (reference if isinstance(reference, Dataset)
                   else Dataset(reference, params={"verbosity": -1,
                                                   **self._device_params}))
            ref.construct()
            self._ref_dataset = ref
            binner = ref.binner
        elif getattr(self._live._gbdt, "train_set", None) is not None:
            self._ref_dataset = self._live._gbdt.train_set
            binner = self._ref_dataset.binner
        self._binner = binner
        if cache_path is not None and binner is None:
            raise ContinualError(
                "cache_path= needs the frozen bin mappers — pass "
                "reference= (the training Dataset or its save_binary "
                "cache)")

        # the refit entry is made once for the runner's lifetime
        self._refit_entry = None
        if refit_eligible(self._live._gbdt) is None:
            self._refit_entry = make_refit_entry(
                self._live._gbdt.objective, float(cfg.refit_decay_rate),
                float(cfg.lambda_l2),
                k=self._live._gbdt.num_tree_per_iteration)

        # rolling window (raw rows + labels, host): refit traverses raw
        # values, appends bin via the reference mappers — both read it
        self._wlock = _lt.lock("continual.window")
        self._wx: List[np.ndarray] = []
        self._wy: List[np.ndarray] = []
        self._wrows = 0
        self._pending_rows = 0
        self._rows_since_append = 0
        # (rows, ingest monotonic ts) per still-pending chunk, oldest
        # first: staleness reads the TRUE age of the oldest row an
        # update has not yet incorporated — rows ingested mid-update
        # keep their original timestamps when the update completes
        self._pending_ts: List[tuple] = []
        # rows consumed from the ledger by an IN-FLIGHT update: still
        # unpublished, so staleness keeps reporting them until the swap
        # actually lands (cleared at publication, folded back on failure)
        self._inflight_rows = 0
        self._inflight_oldest: Optional[float] = None
        self._label_hist: List[tuple] = []  # (rows, sum) per chunk
        self._mu = _lt.lock("continual.update")  # one update/rollover at a time
        # durable-cache appends are read-rewrite-replace: serialized
        # here so concurrent ingest() calls cannot drop each other's
        # rows (one process owns a cache; cross-process appends are out
        # of contract, like save_binary itself)
        self._cache_lock = _lt.lock("continual.cache")
        # runner-thread failure backoff: a deterministic update failure
        # must not retry at tick cadence forever
        self._fail_backoff_s = 0.0
        self._retry_after = 0.0
        self._seq = 0
        self._updates = 0
        self._running = False
        self._thread: Optional[threading.Thread] = None

        if resume:
            if state_dir is None:
                raise ContinualError("resume=True needs state_dir=")
            found = _checkpoint.latest_valid_fleet_manifest(state_dir, 1)
            if found is not None:
                seq, _path, manifest = found
                self._live = Booster(params=dict(self._device_params),
                                     model_file=manifest["snapshot"])
                self._live._gbdt.cfg = cfg
                self._seq = seq
                _obs.counter("continual_resumes_total").inc()
                _obs.event("continual_resume", seq=seq,
                           snapshot=manifest["snapshot"])
                if runtime is not None:
                    runtime.swap_model(model_name, self._live)
        self._last_rollover = time.monotonic()
        self._publish_staleness()
        if start:
            self.start()

    # -- properties ------------------------------------------------------
    @property
    def booster(self) -> Booster:
        """The CURRENT ensemble (the one the serving runtime publishes)."""
        return self._live

    @property
    def seq(self) -> int:
        """Rollovers published so far (the fleet-checkpoint round)."""
        return self._seq

    def stats(self) -> Dict[str, Any]:
        with self._wlock:
            return {"window_rows": self._wrows,
                    "pending_rows": self._pending_rows,
                    "rows_since_append": self._rows_since_append,
                    "seq": self._seq, "updates": self._updates,
                    "running": self._running}

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "ContinualRunner":
        if self._running:
            return self
        self._running = True
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="lgbmtpu-continual")
        self._thread.start()
        _obs.event("continual_start",
                   update_every_rows=self._update_every_rows,
                   update_every_s=self._update_every_s,
                   append_trees=self._append_trees)
        return self

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        _obs.event("continual_stop", seq=self._seq)

    def __enter__(self) -> "ContinualRunner":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _loop(self) -> None:
        while self._running:
            time.sleep(_TICK_S)
            self._publish_staleness()
            if time.monotonic() < self._retry_after:
                continue  # backing off after a failed update
            try:
                if self._due():
                    self.update("auto")
                    self._fail_backoff_s = 0.0
            except Exception as e:  # noqa: BLE001 — the trainer thread
                # must never die silently beside a live serving loop: the
                # failure is counted, evented, /healthz-visible
                # (obs/server.py DEGRADED_COUNTERS), and retried with
                # exponential backoff — a deterministic failure must not
                # spin at tick cadence while the PREVIOUS ensemble keeps
                # serving
                self._fail_backoff_s = min(
                    max(self._fail_backoff_s * 2, 1.0), 30.0)
                self._retry_after = time.monotonic() + self._fail_backoff_s
                _obs.counter("continual_update_failures_total").inc()
                _obs.event("continual_update_failed", error=repr(e),
                           retry_in_s=self._fail_backoff_s)

    # -- ingest ----------------------------------------------------------
    def ingest(self, X, y) -> Dict[str, Any]:
        """Take one chunk of fresh rows.  Bins against the frozen
        mappers (clamp-and-count), appends to the durable cache when
        configured, grows the rolling window, refreshes staleness and
        drift telemetry.  Returns the chunk's summary (also the
        ``continual_chunk`` event payload)."""
        X = np.asarray(X, np.float64)
        if X.ndim == 1:
            X = X[None, :]
        y = np.asarray(y, np.float64).ravel()
        if X.shape[0] != len(y):
            raise ValueError(f"ingest: {X.shape[0]} rows but {len(y)} labels")
        if not np.isfinite(y).all():
            bad = int(np.nonzero(~np.isfinite(y))[0][0])
            raise LightGBMError(
                f"ingest: non-finite label at chunk row {bad} — a NaN/inf "
                "target would poison every later update (the same guard "
                "Dataset construction applies)")
        n = int(X.shape[0])
        clamped = 0
        bins = None
        if self._binner is not None:
            clamped = self._count_clamped(X)
            bins = self._binner.transform(X)
            if self._cache_path is not None:
                with self._cache_lock:
                    self._append_cache(bins, y)
        with self._wlock:
            self._wx.append(X)
            self._wy.append(y)
            self._wrows += n
            self._pending_rows += n
            self._rows_since_append += n
            self._pending_ts.append((n, time.monotonic()))
            # rolling window: drop whole oldest chunks past the cap (the
            # durable cache, when armed, keeps the full history).  The
            # pending-age ledger entries map 1:1 onto the window's
            # TRAILING chunks (each ingest appends one; updates consume
            # whole entries from the front), so an evicted chunk is
            # still-pending exactly when every window chunk is — those
            # rows will never reach an update: they leave the staleness
            # accounting and are COUNTED as lost instead of silently
            # reported as incorporated
            evicted_pending = 0
            while self._wrows > self._window_rows and len(self._wx) > 1:
                dropped = self._wx[0].shape[0]
                if len(self._pending_ts) == len(self._wx):
                    self._pending_ts.pop(0)
                    self._pending_rows = max(self._pending_rows - dropped, 0)
                    evicted_pending += dropped
                self._wrows -= dropped
                self._wx.pop(0)
                self._wy.pop(0)
            drift = self._note_drift(y)
        _obs.counter("continual_ingested_rows_total").inc(n)
        if clamped:
            _obs.counter("continual_clamped_values_total").inc(clamped)
        if evicted_pending:
            _obs.counter(
                "continual_window_evicted_pending_rows_total").inc(
                evicted_pending)
            _obs.event("continual_window_overflow", rows=evicted_pending)
        self._publish_staleness()
        summary = dict(rows=n, clamped=clamped, **drift)
        _obs.event("continual_chunk", **summary)
        return summary

    def _count_clamped(self, X: np.ndarray) -> int:
        """Out-of-range raw values per the FROZEN mappers: they clamp
        into the edge bins (numeric) or the fallback bin (unseen
        categories) — never a rebin — and the count is the cheapest
        honest covariate-shift signal there is."""
        total = 0
        for j, m in enumerate(self._binner.mappers):
            col = X[:, j]
            finite = np.isfinite(col)
            if m.is_categorical:
                if m.categories is not None and len(m.categories):
                    known = np.isin(col, np.asarray(m.categories, np.float64))
                    total += int(np.count_nonzero(finite & ~known))
            else:
                total += int(np.count_nonzero(
                    finite & ((col < m.min_value) | (col > m.max_value))))
        return total

    def _note_drift(self, y: np.ndarray) -> Dict[str, float]:
        """Under self._wlock: label-mean drift of this chunk vs the
        rolling drift_window baseline (the chunks BEFORE this one)."""
        base_rows = sum(r for r, _ in self._label_hist)
        base_sum = sum(s for _, s in self._label_hist)
        chunk_mean = float(y.mean()) if len(y) else 0.0
        drift = (abs(chunk_mean - base_sum / base_rows)
                 if base_rows else 0.0)
        self._label_hist.append((len(y), float(y.sum())))
        while (sum(r for r, _ in self._label_hist) - self._label_hist[0][0]
               >= self._drift_window and len(self._label_hist) > 1):
            self._label_hist.pop(0)
        _obs.gauge("continual_label_drift").set(drift)
        return {"label_mean": chunk_mean, "label_drift": drift}

    def _append_cache(self, bins: np.ndarray, y: np.ndarray) -> None:
        from ..io.stream import append_rows, create_bin_cache

        if not os.path.exists(self._cache_path):
            names = (self._ref_dataset.feature_names
                     if self._ref_dataset is not None else
                     [f"Column_{j}" for j in range(len(self._binner.mappers))])
            # atomic creation with shared-reader permissions — the one
            # crash-safety recipe, owned by io/stream.py for both the
            # create and append halves
            create_bin_cache(self._cache_path, bins, self._binner.mappers,
                             label=y, feature_names=names)
        else:
            append_rows(self._cache_path, bins, label=y,
                        segment_threshold=self._seg_threshold or None)

    # -- update policy ---------------------------------------------------
    def _due(self) -> bool:
        with self._wlock:
            pending = self._pending_rows
            oldest = self._pending_ts[0][1] if self._pending_ts else None
        if pending <= 0:
            return False
        if 0 < self._update_every_rows <= pending:
            return True
        return (self._update_every_s > 0 and oldest is not None
                and time.monotonic() - oldest >= self._update_every_s)

    def _choose_kind(self, mode: str) -> str:
        if mode in ("refit", "append"):
            return mode
        if self._refit_entry is None and self._append_trees > 0:
            # refit-ineligible ensemble (multiclass/linear/RF) with an
            # append path configured: auto updates take it instead of
            # failing toward the refit the envelope already refused
            return "append"
        if (self._append_trees > 0
                and self._rows_since_append >= self._append_every_rows):
            return "append"
        return "refit"

    # -- the rollover ----------------------------------------------------
    def update(self, mode: str = "auto") -> Optional[str]:
        """Run one policy-driven update + zero-downtime rollover.  Returns
        the kind performed ("refit"/"append") or None when the window is
        empty.  Serializable: one update at a time; ingest stays
        concurrent."""
        with self._mu:
            with self._wlock:
                if self._wrows == 0:
                    return None
                Xw = np.concatenate(self._wx, axis=0)
                yw = np.concatenate(self._wy)
                # consume the pending ledger AT SNAPSHOT TIME, under the
                # same lock as the snapshot: a mid-build ingest that
                # evicts window chunks then sees only the NEW rows'
                # entries, so a chunk the update IS training on can
                # never be double-accounted as "evicted pending" AND
                # subtracted again below (restored wholesale if the
                # build fails — those rows were not incorporated)
                consumed = self._pending_ts
                self._pending_ts = []
                trained_pending = self._pending_rows
                self._pending_rows = 0
                # the consumed rows stay visible to staleness as
                # IN-FLIGHT until the rollover publishes: the serving
                # model is still stale for them, and the SLO gauge must
                # not flip healthy for the duration of the build
                self._inflight_rows = trained_pending
                self._inflight_oldest = consumed[0][1] if consumed else None
            kind = self._choose_kind(mode)
            counter = _san.DispatchCounter()
            counter.__enter__()
            # the rollover's trace identity: build,
            # checkpoint and swap legs all record under this one context,
            # so a rollover published mid-request-storm reads as ONE
            # connected story next to the serve.request spans in the
            # merged flight recorder
            roll_ctx = _trace.TraceContext(_trace.new_trace_id())
            t_roll = time.perf_counter()
            try:
                with _trace.span(f"continual_{kind}", parent=roll_ctx,
                                 rows=int(Xw.shape[0]),
                                 seq=self._seq + 1):
                    if kind == "append":
                        candidate = self._build_append(Xw, yw)
                    else:
                        candidate = self._build_refit(Xw, yw)
            except BaseException:
                counter.__exit__(None, None, None)
                lost = 0
                with self._wlock:
                    self._pending_ts = consumed + self._pending_ts
                    self._pending_rows += trained_pending
                    self._inflight_rows = 0
                    self._inflight_oldest = None
                    # chunks evicted by a mid-build ingest are gone from
                    # the window: reconcile the restored ledger against
                    # what a retry can actually still train (oldest
                    # pending rows beyond the window count as LOST, the
                    # same honesty rule the eviction path applies)
                    excess = self._pending_rows - self._wrows
                    while excess > 0 and self._pending_ts:
                        r, ts = self._pending_ts[0]
                        take = min(r, excess)
                        if take == r:
                            self._pending_ts.pop(0)
                        else:
                            self._pending_ts[0] = (r - take, ts)
                        self._pending_rows -= take
                        lost += take
                        excess -= take
                if lost:
                    _obs.counter(
                        "continual_window_evicted_pending_rows_total").inc(
                        lost)
                    _obs.event("continual_window_overflow", rows=lost)
                _trace.record_span("continual.rollover",
                                   time.perf_counter() - t_roll,
                                   ctx=roll_ctx, mode=kind,
                                   seq=self._seq + 1, outcome="error")
                raise
            counter.__exit__(None, None, None)
            seq = self._seq + 1
            if self._state_dir is not None:
                # durable BEFORE visible: the raw-delta snapshot + fleet
                # manifest land first, so a crash in the swap window
                # below resumes the UPDATE while the old ensemble keeps
                # serving (no torn pack is ever published — swap_model
                # packs before it publishes)
                with _trace.span("checkpoint.snapshot", parent=roll_ctx,
                                 seq=seq):
                    _checkpoint.write_fleet_checkpoint(
                        self._state_dir,
                        candidate.model_to_string(raw_deltas=True), seq,
                        world_size=1, keep=self._snapshot_keep)
            # the continual_swap fault site (docs/ROBUSTNESS.md): a hard
            # crash between checkpoint and publication
            _faults.maybe_crash("continual_swap", seq)
            with _trace.span("continual.swap", parent=roll_ctx, seq=seq,
                             model=self._model_name):
                if self._runtime is not None:
                    self._runtime.swap_model(self._model_name, candidate)
                else:
                    candidate._gbdt._packed(0, -1)  # warm, like swap_model
            self._live = candidate
            self._seq = seq
            self._updates += 1
            now = time.monotonic()
            with self._wlock:
                # the trained rows' ledger entries were consumed at
                # snapshot time; entries present now belong to rows
                # ingested MID-update, which keep their true ingest
                # timestamps (staleness must not be reset to "now" by
                # the update that missed them).  The in-flight holdover
                # retires only HERE — at publication
                self._inflight_rows = 0
                self._inflight_oldest = None
                if kind == "append":
                    self._rows_since_append = 0
            self._last_rollover = now
            self._publish_staleness()
            counts = counter.stats()
            ledger = dict(dispatches=counts["dispatches"],
                          host_syncs=counts["host_syncs"],
                          captures=counts["captures"], replays=counts["replays"])
            _obs.counter("continual_rollovers_total").inc()
            _obs.counter(f"continual_{kind}s_total").inc()
            _obs.event(f"continual_{kind}", seq=seq, rows=int(Xw.shape[0]),
                       **ledger)
            _obs.event("continual_rollover", mode=kind, seq=seq,
                       rows=int(Xw.shape[0]), trees=self._live.num_trees(),
                       **ledger)
            # the rollover's root span closes at publication — the
            # build/checkpoint/swap legs above are its children
            _trace.record_span("continual.rollover",
                               time.perf_counter() - t_roll, ctx=roll_ctx,
                               mode=kind, seq=seq, rows=int(Xw.shape[0]),
                               trees=self._live.num_trees(), outcome="ok",
                               **ledger)
            return kind

    def _clone(self) -> Booster:
        clone = Booster(params=dict(self._device_params),
                        model_str=self._live.model_to_string())
        clone._gbdt.cfg = self._live._gbdt.cfg
        return clone

    def _build_refit(self, Xw: np.ndarray, yw: np.ndarray) -> Booster:
        if self._refit_entry is None:
            why = refit_eligible(self._live._gbdt)
            raise ContinualError(
                f"device refit does not apply: {why} — configure "
                "append_trees= and drive append updates instead")
        clone = self._clone()
        refit_leaves(clone._gbdt, Xw, yw, entry=self._refit_entry)
        return clone

    def _build_append(self, Xw: np.ndarray, yw: np.ndarray) -> Booster:
        if self._append_trees <= 0:
            raise ContinualError("append update requested with "
                                 "append_trees=0")
        if self._ref_dataset is None:
            raise ContinualError(
                "append training needs the frozen bin mappers — pass "
                "reference= (the training Dataset or its save_binary "
                "cache)")
        from ..basic import Dataset
        from ..engine import train as _train

        ds = Dataset(Xw, label=yw, reference=self._ref_dataset,
                     params={"verbosity": -1, **self._device_params})
        params = self._train_params()
        return _train(params, ds, num_boost_round=self._append_trees,
                      init_model=self._live)

    def _train_params(self) -> Dict[str, Any]:
        params = self._live._gbdt.cfg.to_dict()
        # the runner drives rounds/checkpoints/resume itself
        for k in ("num_iterations", "snapshot_freq", "resume",
                  "input_model", "metrics_file", "trace_file"):
            params.pop(k, None)
        return params

    # -- staleness -------------------------------------------------------
    def _publish_staleness(self) -> None:
        with self._wlock:
            rows = self._pending_rows + self._inflight_rows
            oldest = self._pending_ts[0][1] if self._pending_ts else None
            if self._inflight_oldest is not None:
                oldest = (self._inflight_oldest if oldest is None
                          else min(oldest, self._inflight_oldest))
        stale_s = (time.monotonic() - oldest) if oldest is not None else 0.0
        _obs.gauge("model_staleness_rows").set(float(rows))
        _obs.gauge("model_staleness_s").set(stale_s)
        if self._staleness_slo_s > 0:
            _obs.gauge("continual_staleness_exceeded").set(
                1.0 if stale_s > self._staleness_slo_s else 0.0)
