"""The serving loop: continuous micro-batching of concurrent predicts
onto the cached device ensemble (counterpart of
lightgbm_tpu/serve/runtime.py, rewritten for torch; README "Serving").

The serving primitives are GBDT's: the packed ensemble cached on the
device a model version (``GBDT._packed``), the pow-2 rung ladder
(``_predict_bucket``), one traversal and one counted blocking read a
call, the per-rung latency reservoirs, ``/metrics`` and ``/healthz``.
This module ties them together:

* **Coalescing**: a request queue and a coalescer thread pack concurrent
  requests for the same (model, raw/converted) group into the smallest
  covering rung, with a ``serve_max_wait_ms`` admission window and an
  immediate flush when a rung fills or the dispatcher is idle.  Rows are
  sliced back out per request; rows traverse independently and the
  conversions are row-wise, so every coalesced response is bitwise the
  ``Booster.predict`` of its own rows.
* **Pinned staging**: each rung owns a free-list of pinned host row
  buffers (two a rung, replicas + 1 in a fleet).  A batch is copied into
  a checked-out buffer (the f64 -> f32 cast is that copy), its rows (not
  the rung's padding) uploaded with ``non_blocking=True`` and a CUDA
  event recorded after the upload; the buffer goes back to the free-list
  only after the batch's read retired, and its next writer waits on the
  event first, so a pinned
  buffer is never written while its copy is in flight.  Uploads and
  traversals run on the same (default) stream of the card, so the
  traversal is ordered after its upload without a cross-stream wait.  On
  the CPU nothing is pinned (pinning needs a card) and the traversal reads
  the staged buffer itself.  The depth-1 handoff stages batch k + 1 while
  batch k runs.  The dispatch is ``GBDT.predict_coalesced``: one traversal
  and one blocking read a coalesced batch (utils/sanitizer.py counts both).
* **Load shedding**: submissions past ``serve_max_queue``, a tenant's
  ``serve_tenant_quota``, the ``serve_slo_p99_ms`` SLO (read off the warm
  latency reservoirs, under queue pressure only) or while ``/healthz``
  reports unhealthy raise a typed :class:`Overloaded`, counted and evented.
* **Multi-model, multi-tenant**: several packed ensembles behind one rung
  ladder, each model name a tenant.  :meth:`ServingRuntime.swap_model`
  builds the new model's pack before publishing it, and the pack cache's
  versions keep the previous pack servable for batches in flight.

This module launches nothing of its own: it only stages, enqueues and
calls ``GBDT.predict_coalesced`` (or ``GBDT.predict`` for a model that is
not coalescible), as tests/test_torch_serve.py checks.
"""

from __future__ import annotations

import threading
import time
from queue import Queue
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..basic import Booster, LightGBMError
from ..models.gbdt import _predict_bucket
from ..obs import metrics as _obs
from ..utils import faults as _flt
from ..utils import locktrace as _lt
from ..obs import server as _obs_server
from ..obs import trace as _trace

# one coalesced batch never exceeds this many rows (the top rung the
# coalescer will fill; a single request larger than this is served alone
# through GBDT.predict, whose pinned staging is bounded in bytes, so the
# runtime's staging buffers never exceed this many rows)
MAX_BATCH_ROWS = 4096
# SLO/health shed-state recompute cadence: percentile + health derivation
# sort reservoirs and walk counters, so the verdict is cached briefly
# instead of recomputed per request
_SHED_REFRESH_S = 0.05


class Overloaded(LightGBMError):
    """A submission the runtime REFUSED (queue bound, tenant quota, p99
    SLO, or unhealthy process) — the typed, immediate alternative to an
    unbounded queue.  ``reason`` is the shed cause
    (``queue_full`` / ``tenant_quota`` / ``slo_p99`` / ``unhealthy``)."""

    def __init__(self, reason: str, tenant: str):
        super().__init__(
            f"serving runtime shed the request (reason={reason}, "
            f"tenant={tenant}) — see serve_shed_total / the serve_shed "
            "event stream")
        self.reason = reason
        self.tenant = tenant


class DeadlineExceeded(LightGBMError):
    """A request that was ADMITTED but missed its ``serve_deadline_ms``
    budget — typed distinctly from :class:`Overloaded` (which is an
    admission refusal): the caller's SLA logic treats "never started"
    and "started but late" differently, and the ``/predict`` front door
    maps them to 429 vs 504."""

    def __init__(self, tenant: str, deadline_ms: float):
        super().__init__(
            f"serving request exceeded its {deadline_ms:g} ms deadline "
            f"(tenant={tenant}) — admission succeeded, completion was "
            "late; see serve_deadline_exceeded_total")
        self.tenant = tenant
        self.deadline_ms = deadline_ms


# /predict requests are bounded even when no deadline is configured: an
# HTTP worker must never wedge on a result() wait
_PREDICT_HTTP_TIMEOUT_S = 30.0
_PREDICT_MAX_BODY = 32 << 20


class _Request:
    """One queued predict: host rows + completion event.  ``x`` is
    already cast to f64 (mirroring ``Booster.predict``'s intake cast, so
    the staged f32 batch holds the same bits an individual call would).

    ``ctx`` is the request's :class:`~..obs.trace.TraceContext` — minted
    at admission, carried EXPLICITLY on the request across the
    coalescer/dispatcher/replica thread handoffs (a thread-local stack
    cannot follow them), so every span the request's journey emits files
    under one trace id.  The ``t_*`` stamps are host ``perf_counter``
    reads at points the pipeline already touches; the completion path
    turns them into the queue/coalesce/staging/dispatch/sliceout phase
    breakdown (zero new device pulls — the R9/R10 rule)."""

    __slots__ = ("x", "n", "model", "raw", "serial", "event", "result",
                 "error", "t0", "t_done", "deadline", "retries", "avoid",
                 "ctx", "t_dequeue", "t_stage", "t_hand")

    def __init__(self, x: np.ndarray, model: str, raw: bool,
                 deadline: Optional[float] = None,
                 ctx: Optional[_trace.TraceContext] = None):
        self.x = np.ascontiguousarray(x)
        self.n = int(x.shape[0])
        self.model = model
        self.raw = raw
        self.serial = False
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.t0 = time.perf_counter()
        self.t_done: Optional[float] = None  # stamped at completion —
        # open-loop harnesses read t_done - t0 for true request latency
        # fleet-layer fields (serve/fleet.py): absolute monotonic deadline,
        # the exactly-once requeue count, and the replica index a retried
        # request must route AWAY from
        self.deadline = deadline
        self.retries = 0
        self.avoid = -1
        self.ctx = ctx
        # phase stamps (perf_counter): first coalescer pop, staging
        # start, staged-and-uploaded.  A requeued/hedged request is
        # re-stamped by its winning leg — the breakdown describes the
        # journey that actually delivered the bits.
        self.t_dequeue: Optional[float] = None
        self.t_stage: Optional[float] = None
        self.t_hand: Optional[float] = None


def _phase_breakdown(r: "_Request", t_sync: Optional[float],
                     now: float) -> Dict[str, float]:
    """Per-request phase milliseconds from the host stamps the pipeline
    already takes — queue (admission→first pop), coalesce (pop→staging
    start), staging (pack+upload issue), dispatch (hand wait + device
    execute through the accounted sync), sliceout (sync→publish).  A
    missing stamp (serial requests skip staging; a failed dispatch never
    syncs) collapses its phase to zero rather than guessing."""
    t_dq = r.t_dequeue if r.t_dequeue is not None else r.t0
    t_st = r.t_stage if r.t_stage is not None else t_dq
    t_hd = r.t_hand if r.t_hand is not None else t_st
    t_sy = t_sync if t_sync is not None else now
    return {"queue": max(t_dq - r.t0, 0.0) * 1e3,
            "coalesce": max(t_st - t_dq, 0.0) * 1e3,
            "staging": max(t_hd - t_st, 0.0) * 1e3,
            "dispatch": max(t_sy - t_hd, 0.0) * 1e3,
            "sliceout": max(now - t_sy, 0.0) * 1e3}


def _unwrap(model) -> Any:
    """Booster -> its GBDT; a GBDT passes through (the bench harness
    builds synthetic GBDTs directly)."""
    return model._gbdt if isinstance(model, Booster) else model


class _Staging:
    """One pinned rows buffer of a rung, and the CUDA event recorded after
    its last upload (an event never recorded waits for nothing; None on
    the CPU, where the buffer is not pinned and the traversal reads it)."""

    __slots__ = ("rows", "event")

    def __init__(self, nb: int, f: int, device: torch.device):
        pin = device.type == "cuda"
        self.rows = torch.empty((nb, f), dtype=torch.float32, pin_memory=pin)
        self.event = torch.cuda.Event() if pin else None

    def wait_upload(self) -> None:
        """Block until the buffer's last upload has finished: only then may
        it be written again."""
        if self.event is not None:
            self.event.synchronize()


class ServingRuntime:
    """In-process async serving over one or more trained models.

    >>> rt = ServingRuntime(booster, max_wait_ms=2.0)
    >>> with rt:
    ...     y = rt.predict(X)                  # blocking, coalesced
    ...     h = rt.submit(X2); y2 = rt.result(h)   # async pair

    Construction does not start threads unless ``start=True`` (the
    default); an unstarted runtime still queues submissions, which drain
    on :meth:`start` — the deterministic harness tests and the open-loop
    bench build on.  Defaults for the knobs come from the first model's
    Config (``serve_max_wait_ms`` / ``serve_max_queue`` /
    ``serve_slo_p99_ms`` / ``serve_tenant_quota``); explicit kwargs win.
    ``shed_unhealthy=False`` opts out of health-driven shedding (the
    process-cumulative health counters may reflect unrelated earlier
    work, e.g. in a shared test process).
    """

    def __init__(self, model=None, *, models: Optional[Dict[str, Any]] = None,
                 max_wait_ms: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 slo_p99_ms: Optional[float] = None,
                 tenant_quota: Optional[int] = None,
                 shed_unhealthy: bool = True,
                 start: bool = True):
        if (model is None) == (models is None):
            raise LightGBMError(
                "ServingRuntime needs exactly one of model= (single) or "
                "models= (a {name: Booster} table)")
        table = {"default": model} if models is None else dict(models)
        if not table:
            raise LightGBMError("ServingRuntime needs at least one model")
        # the model TABLE (name -> GBDT) — deliberately not "_models",
        # which names the per-ensemble TREE LIST whose in-place mutation
        # jaxlint R16 polices in serve/continual code
        self._table: Dict[str, Any] = {n: _unwrap(m)
                                       for n, m in table.items()}
        cfg = next(iter(self._table.values())).cfg
        self._max_wait_s = (float(cfg.serve_max_wait_ms) if max_wait_ms is None
                            else float(max_wait_ms)) / 1e3
        self._max_queue = (int(cfg.serve_max_queue) if max_queue is None
                           else int(max_queue))
        self._slo_p99_ms = (float(cfg.serve_slo_p99_ms) if slo_p99_ms is None
                            else float(slo_p99_ms))
        self._tenant_quota = (int(cfg.serve_tenant_quota)
                              if tenant_quota is None else int(tenant_quota))
        self._shed_unhealthy = bool(shed_unhealthy)
        # request deadline in seconds; 0 disables.  The base runtime never
        # sets it — the fleet layer (serve/fleet.py) does, and stamps every
        # admitted request via submit()'s _Request construction.
        self._deadline_s = 0.0

        self._cv = _lt.condition("serve.cv")
        self._queue: List[_Request] = []
        self._queued_per_tenant: Dict[str, int] = {}
        # depth-1 handoff: the coalescer blocks here while the dispatcher
        # is one batch behind — the one-deep double-buffered device feed
        self._hand: Queue = Queue(maxsize=1)
        # (nb, f, device) -> free-list of pinned _Staging buffers (two a
        # rung).  A buffer is checked out at staging and returned by the
        # dispatcher only after the batch's read retired (on the CPU the
        # traversal reads the buffer itself), and its next writer waits on
        # the event recorded after its upload
        self._staging: Dict[Tuple[int, int, str], Queue] = {}
        # every ADMITTED, unresolved request (added in submit under _cv,
        # discarded when its event is set).  stop()'s drain sweep walks
        # this — NOT just self._queue — so a request a worker popped but
        # never resolved (a dispatch wedged inside the device runtime)
        # still gets a typed error instead of hanging its waiter forever
        self._pending: set = set()
        self._shed_cache: Tuple[float, Optional[str]] = (-1e9, None)
        self._running = False
        self._started = False
        self._closed = False
        self._coalescer: Optional[threading.Thread] = None
        self._dispatcher: Optional[threading.Thread] = None
        if start:
            self.start()

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "ServingRuntime":
        # state flips under _cv: stop() reads/writes _running/_closed
        # under the same lock, and the under-lock _started check makes
        # concurrent start() calls spawn exactly one thread pair (the
        # unlocked version was an L3 finding plus a double-spawn TOCTOU)
        with self._cv:
            if self._closed:
                raise LightGBMError("ServingRuntime is stopped")
            if self._started:
                return self
            self._started = True
            self._running = True
        self._spawn_workers()
        # the /predict front door: the most recently started runtime owns
        # the route on the (singleton) metrics endpoint — obs stays
        # stdlib-only, so the serve layer registers a callable instead of
        # obs importing serve
        _obs_server.set_predict_handler(self._http_predict)
        _obs.event("serve_start", models=sorted(self._table),
                   max_wait_ms=self._max_wait_s * 1e3,
                   max_queue=self._max_queue)
        return self

    def _spawn_workers(self) -> None:
        """Spawn the worker threads (overridden by ServingFleet, which
        runs one dispatcher per replica plus a supervisor)."""
        self._coalescer = threading.Thread(  # jaxlint: disable=L5 (joined via the _worker_threads() loop in stop())
            target=self._coalesce_loop, daemon=True, name="lgbmtpu-coalescer")
        self._dispatcher = threading.Thread(  # jaxlint: disable=L5 (joined via the _worker_threads() loop in stop())
            target=self._dispatch_loop, daemon=True, name="lgbmtpu-dispatch")
        self._dispatcher.start()
        self._coalescer.start()

    def _worker_threads(self) -> List[threading.Thread]:
        """Every thread stop() must join (fleet adds replicas + the
        supervisor)."""
        return [t for t in (self._coalescer, self._dispatcher)
                if t is not None]

    def stop(self) -> None:
        """Drain the queue, then stop the worker threads.  Idempotent;
        never abandons an accepted request: after the joins, EVERY
        admitted request whose event is still unset — still queued,
        or popped by a worker that wedged mid-dispatch and will never
        publish a result — is failed with a typed error.  (The old
        sweep only failed ``self._queue``; a batch a wedged dispatcher
        held was in neither list, and its waiters hung forever — the
        stop-under-load test in tests/test_serve.py pins the fix.)"""
        with self._cv:
            if self._closed:
                return
            # closed + drained under ONE lock section: a submit racing
            # this either raised on the under-lock _closed check or its
            # request is already visible to the draining coalescer
            self._closed = True
            self._running = False
            self._cv.notify_all()
        _obs_server.clear_predict_handler(self._http_predict)
        wedged = False
        if self._started:
            for t in self._worker_threads():
                t.join(timeout=30)
                wedged = wedged or t.is_alive()
        # the drain sweep: anything admitted but unresolved gets a typed
        # error NOW.  After a clean join this set is empty (the coalescer
        # drains the queue and the dispatcher resolves every handed batch
        # before exiting); it is non-empty only for a never-started
        # runtime or a wedged worker.
        with self._cv:
            leftover = [r for r in self._pending if not r.event.is_set()]
            self._pending.clear()
            self._queue = []
            self._queued_per_tenant.clear()
        for r in leftover:
            r.error = LightGBMError(
                "ServingRuntime stopped before the request resolved "
                + ("(wedged worker thread)" if wedged
                   else "(runtime never started)" if not self._started
                   else "(shutdown drain)"))
            r.event.set()
        if leftover:
            _obs.event("serve_stop_wedged" if wedged else "serve_stop_drain",
                       failed_requests=len(leftover))
        _obs.gauge("serve_queue_depth").set(0.0)
        _obs.event("serve_stop")

    def __enter__(self) -> "ServingRuntime":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- model table -----------------------------------------------------
    def models(self) -> List[str]:
        with self._cv:
            return sorted(self._table)

    def add_model(self, name: str, model) -> None:
        g = _unwrap(model)
        g._packed(0, -1)  # resident before the first request hits it
        with self._cv:
            if name in self._table:
                raise LightGBMError(
                    f"model {name!r} already served — use swap_model")
            self._table[name] = g

    def swap_model(self, name: str, model) -> None:
        """Hot-swap a served ensemble: the replacement's pack is built
        device-resident BEFORE publication, and in-flight batches keep
        the old GBDT's (versioned) pack — no request ever observes a
        cold cache (tests/test_serve.py pins this)."""
        g = _unwrap(model)
        if name not in self._table:
            raise LightGBMError(f"model {name!r} is not served")
        g._packed(0, -1)  # warm the new pack outside the serving path
        # chaos site: a failure BETWEEN the warm build and the table
        # publish must leave every replica serving the OLD ensemble —
        # the swap either fully publishes or changes nothing
        _flt.maybe_fail("swap_publish")
        with self._cv:
            self._table[name] = g
        _obs.counter("serve_model_swaps_total").inc()
        _obs.event("serve_model_swap", model=name)

    # -- client API ------------------------------------------------------
    def predict(self, X, *, model: str = "default", raw_score: bool = False,
                timeout: Optional[float] = None,
                trace_ctx: Optional[_trace.TraceContext] = None) -> np.ndarray:
        """Blocking coalesced predict — semantics (and bits) of
        ``Booster.predict(X, raw_score=raw_score)``.  Raises
        :class:`Overloaded` when shed, ``TimeoutError`` past
        ``timeout`` seconds."""
        return self.result(self.submit(X, model=model, raw_score=raw_score,
                                       trace_ctx=trace_ctx),
                           timeout=timeout)

    def submit(self, X, *, model: str = "default",
               raw_score: bool = False,
               trace_ctx: Optional[_trace.TraceContext] = None) -> _Request:
        """Enqueue one request (admission control happens HERE — a shed
        raises immediately, an accepted request always resolves).
        Returns a handle for :meth:`result`.

        ``trace_ctx`` is the request's trace identity when the caller
        (the HTTP front door, honoring an inbound ``traceparent``)
        already minted one; otherwise a fresh root context is minted
        here — admission is the single sampling decision point."""
        g = self._table.get(model)
        if g is None:
            raise LightGBMError(f"model {model!r} is not served "
                                f"(have {sorted(self._table)})")
        X = np.asarray(X, dtype=np.float64)  # Booster.predict's intake cast
        if X.ndim == 1:
            X = X[None, :]
        # the SLO/health verdict refresh snapshots the registry (sorts
        # reservoirs, runs collectors) — computed OUTSIDE the condition
        # lock so a refresh never stalls the coalescer's bookkeeping or
        # concurrent submits; the cached tuple is read under the lock
        self._refresh_shed_state()
        shed: Optional[str] = None
        req: Optional[_Request] = None
        with self._cv:
            # _closed re-checked UNDER the lock: a submit racing stop()
            # must either be failed here or be visible to the draining
            # coalescer — never appended after the drain finished
            if self._closed:
                raise LightGBMError("ServingRuntime is stopped")
            if len(self._queue) >= self._max_queue:
                shed = "queue_full"
            elif (self._tenant_quota > 0 and self._queued_per_tenant.get(
                    model, 0) >= self._tenant_quota):
                shed = "tenant_quota"
            else:
                shed = self._shed_cache[1]
                if shed == "slo_p99" and not self._queue:
                    # SLO shedding only under queue pressure — a lone
                    # request after a slow spell must serve, or the
                    # cumulative p99 could latch the runtime shut
                    shed = None
            if shed is None:
                req = _Request(X, model, bool(raw_score),
                               deadline=(time.monotonic() + self._deadline_s
                                         if self._deadline_s > 0 else None),
                               ctx=(trace_ctx if trace_ctx is not None
                                    else _trace.mint_request_context()))
                self._queue.append(req)
                self._pending.add(req)
                self._queued_per_tenant[model] = (
                    self._queued_per_tenant.get(model, 0) + 1)
                _obs.gauge("serve_queue_depth").set(len(self._queue))
                self._cv.notify_all()
            self._publish_shed_gauge()
        if shed is not None:
            _obs.counter("serve_shed_total").inc()
            _obs.counter(_obs.labeled("serve_shed_total",
                                      tenant=model)).inc()
            _obs.event("serve_shed", reason=shed, tenant=model,
                       rows=int(X.shape[0]))
            raise Overloaded(shed, model)
        _obs.counter("serve_requests_total").inc()
        _obs.counter(_obs.labeled("serve_requests_total",
                                  tenant=model)).inc()
        return req

    def result(self, req: _Request,
               timeout: Optional[float] = None) -> np.ndarray:
        if req.deadline is not None:
            budget = req.deadline - time.monotonic()
            if timeout is not None:
                budget = min(budget, timeout)
            if not req.event.wait(max(budget, 0.0)):
                if time.monotonic() >= req.deadline:
                    self._count_deadline(req.model)
                    raise DeadlineExceeded(req.model, self._deadline_s * 1e3)
                raise TimeoutError("serving request did not complete in "
                                   f"{timeout}s (queue depth "
                                   f"{len(self._queue)})")
        elif not req.event.wait(timeout):
            raise TimeoutError("serving request did not complete in "
                               f"{timeout}s (queue depth "
                               f"{len(self._queue)})")
        if req.error is not None:
            raise req.error
        return req.result

    @staticmethod
    def _count_deadline(tenant: str) -> None:
        _obs.counter("serve_deadline_exceeded_total").inc()
        _obs.counter(_obs.labeled("serve_deadline_exceeded_total",
                                  tenant=tenant)).inc()
        _obs.event("serve_deadline", tenant=tenant)

    def stats(self) -> Dict[str, Any]:
        with self._cv:
            return {"queue_depth": len(self._queue),
                    "models": sorted(self._table),
                    "staging_rungs": sorted(k[0] for k in self._staging),
                    "running": self._running}

    # -- shedding --------------------------------------------------------
    def _refresh_shed_state(self) -> None:
        """Recompute the cached SLO/health shed verdict at most every
        _SHED_REFRESH_S.  Runs WITHOUT self._cv (the registry snapshot
        and reservoir percentile are the expensive part); the cache is a
        single tuple publish, safe to read under the lock.  Concurrent
        refreshes are harmless (same verdict, last write wins)."""
        now = time.monotonic()
        if now - self._shed_cache[0] < _SHED_REFRESH_S:
            return
        reason = None
        if self._slo_p99_ms > 0:
            p99 = _obs.histogram("predict_warm_latency_ms").percentile(99)
            if p99 is not None and p99 > self._slo_p99_ms:
                reason = "slo_p99"
        if reason is None and self._shed_unhealthy:
            code, _body = _obs_server.health()
            if code == 503:
                reason = "unhealthy"
        self._shed_cache = (now, reason)

    def _shedding_now(self) -> bool:
        """CURRENT shed state, derived from live queue/tenant/SLO state
        (under self._cv) — not a latch toggled per submission, so an
        idle drained runtime reads healthy and a tenant still at quota
        keeps /healthz degraded even while other tenants serve."""
        if len(self._queue) >= self._max_queue:
            return True
        if self._tenant_quota > 0 and any(
                v >= self._tenant_quota
                for v in self._queued_per_tenant.values()):
            return True
        reason = self._shed_cache[1]
        if reason == "unhealthy":
            return True
        return reason == "slo_p99" and bool(self._queue)

    def _publish_shed_gauge(self) -> None:
        """Under self._cv: recompute the /healthz-driving gauge from
        current state (obs/server.py DEGRADED_GAUGES)."""
        _obs.gauge("serve_shedding").set(
            1.0 if self._shedding_now() else 0.0)

    # -- coalescer -------------------------------------------------------
    def _coalesce_loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and self._running:
                    self._cv.wait(0.1)
                if not self._queue:
                    break  # stopped and drained
                first = self._queue.pop(0)
                self._note_dequeued(first)
            # the caller owns the batch list: if ANYTHING below raises
            # (a pack build in _coalescible, a device OOM in the upload),
            # every already-popped request is failed loudly and the
            # thread keeps serving — a dead coalescer would turn every
            # future predict() into the unbounded hang the Overloaded
            # machinery exists to prevent
            batch: List[_Request] = [first]
            try:
                g = self._build_batch(first, batch)
                self._stage_and_hand(g, batch)
            except BaseException as e:  # noqa: BLE001
                for r in batch:
                    r.error = e
                    r.event.set()
                with self._cv:
                    for r in batch:
                        self._pending.discard(r)
        self._shutdown_pipeline()

    def _shutdown_pipeline(self) -> None:
        """Coalescer exit: wake the dispatch side (overridden by the
        fleet, whose replica loops poll ``self._running`` instead)."""
        self._hand.put(None)  # dispatcher stop sentinel

    def _note_dequeued(self, req: _Request) -> None:
        """Under self._cv: tenant + depth bookkeeping for one pop."""
        req.t_dequeue = time.perf_counter()  # queue-wait phase closes here
        left = self._queued_per_tenant.get(req.model, 1) - 1
        self._queued_per_tenant[req.model] = max(left, 0)
        _obs.gauge("serve_queue_depth").set(len(self._queue))
        # draining clears the shed state without waiting for a submit
        self._publish_shed_gauge()

    def _build_batch(self, first: _Request, batch: List[_Request]):
        """Admission: gather requests compatible with ``first`` (same
        model, same raw/converted group, same feature width).  The batch
        flushes the moment a pow-2 rung fills exactly, MAX_BATCH_ROWS is
        reached, or — the continuous-batching rule — the dispatch
        pipeline is IDLE: waiting for companions while the device sits
        empty only adds latency, whereas a busy pipeline grows the batch
        for free (new arrivals queue while batch k executes).  The
        ``serve_max_wait_ms`` window bounds the busy-pipeline wait.

        Fills the caller-owned ``batch`` list (so an exception cannot
        strand a popped request) and returns the resolved model — it
        rides along so a concurrent ``swap_model`` between eligibility
        check and staging cannot hand the batch a model it was not
        built against."""
        g = self._table.get(first.model)
        if g is None or first.n > MAX_BATCH_ROWS or not g._coalescible(first.raw):
            first.serial = True
            _obs.counter("serve_uncoalesced_total").inc()
            return g
        total = first.n
        f = first.x.shape[1]
        deadline = time.monotonic() + self._max_wait_s
        with self._cv:
            while True:
                took = True
                while took and total < MAX_BATCH_ROWS:
                    took = False
                    for i, r in enumerate(self._queue):
                        if (r.model == first.model and r.raw == first.raw
                                and r.x.shape[1] == f
                                and total + r.n <= MAX_BATCH_ROWS):
                            batch.append(self._queue.pop(i))
                            self._note_dequeued(r)
                            total += r.n
                            took = True
                            break
                if (total >= MAX_BATCH_ROWS
                        or total == _predict_bucket(total)
                        or self._pipeline_idle()):
                    break  # rung filled, cap reached, or idle pipeline
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._running:
                    break
                self._cv.wait(remaining)
        return g

    def _checkout_staging(self, nb: int, f: int, device: torch.device):
        """Check a pinned pair out of rung ``nb``'s free-list, allocated
        once (two pairs a rung, the double buffer) and recycled through
        :meth:`_return_staging` when the owning batch's read has retired.
        Blocks while every pair is in flight (the depth-1 handoff bounds
        the pipeline at two)."""
        key = (nb, f, str(device))
        pool = self._staging.get(key)
        if pool is None:
            pool = Queue()
            for _ in range(self._staging_pairs()):
                pool.put(self._new_staging(key))
            self._staging[key] = pool
        return key, pool.get()

    @staticmethod
    def _new_staging(key) -> _Staging:
        """A fresh pair for the pool ``key`` (nb, f, device): the fleet
        adds one when a hung replica keeps its pair."""
        nb, f, device = key
        return _Staging(nb, f, torch.device(device))

    def _staging_pairs(self) -> int:
        """Pinned pairs per rung: 2 (the double buffer) for the solo
        runtime; the fleet sizes it replicas+1 so N concurrent in-flight
        batches on one rung cannot starve the coalescer."""
        return 2

    def _pipeline_idle(self) -> bool:
        """True when the dispatch side has fully retired its work — the
        coalescer's immediate-flush condition (overridden by the fleet:
        idle means ANY routable replica is idle)."""
        return self._hand.unfinished_tasks == 0

    def _return_staging(self, key, pair) -> None:
        self._staging[key].put(pair)

    def _stage_and_hand(self, g, batch: List[_Request]) -> None:
        """Pack the batch into the rung's pinned buffer (ONE copy per
        request), upload, and hand to the dispatcher.  The blocking
        depth-1 put is the pipeline: this upload overlaps the previous
        batch's device execution.  (The fleet overrides this to ROUTE
        the staged item to a healthy replica's hand queue.)"""
        if batch[0].serial:
            self._hand.put(("serial", batch, g))
            return
        self._hand.put(self._stage_batch(g, batch))

    def _stage_batch(self, g, batch: List[_Request]):
        """Stage one coalesced batch into a checked-out pinned pair and
        return the ``("batch", batch, payload)`` hand item.  On ANY
        failure the pair is returned before re-raising: leaking it would
        shrink the rung's pool and eventually block _checkout_staging
        forever — wedging the coalescer, the hang this module exists to
        prevent.  (After a successful hand-off the DISPATCHER owns the
        return.)"""
        total = sum(r.n for r in batch)
        nb = _predict_bucket(total)
        t_stage = time.perf_counter()  # coalesce-wait phase closes here
        for r in batch:
            r.t_stage = t_stage
        skey, pair = self._checkout_staging(nb, batch[0].x.shape[1], g.device)
        try:
            pair.wait_upload()  # the buffer's previous upload has landed
            buf = pair.rows
            off = 0
            for r in batch:
                # f64 -> f32 in the copy: the rounding of predict's own cast
                buf[off:off + r.n].copy_(torch.from_numpy(r.x))
                off += r.n
            x_dev = buf[:total]
            if pair.event is not None:
                x_dev = x_dev.to(g.device, non_blocking=True)
                pair.event.record()
            t_hand = time.perf_counter()  # staged + uploaded (async): the
            for r in batch:              # staging phase closes here
                r.t_hand = t_hand
            return ("batch", batch, (g, x_dev, total, nb, skey, pair))
        except BaseException:
            self._return_staging(skey, pair)
            raise

    # -- dispatcher ------------------------------------------------------
    @staticmethod
    def _batch_ctx(batch: List[_Request]) -> Optional[_trace.TraceContext]:
        """Identity for one dispatch leg's span: a SIBLING of the first
        sampled member's context — same trace, NO parent edge.  The N
        member request spans each carry a link TO this context instead
        (the N-to-1 fan-in the coalescer creates cannot be expressed as
        parentage: a span has one parent, a batch has N requests)."""
        for r in batch:
            if r.ctx is not None and r.ctx.sampled:
                return r.ctx.sibling()
        return None

    def _finish_request(self, r: _Request, now: float,
                        t_sync: Optional[float],
                        leg_ctx: Optional[_trace.TraceContext] = None,
                        outcome: str = "ok",
                        replica: Optional[int] = None) -> None:
        """Completion bookkeeping for ONE resolved request: stamp
        ``t_done``, feed the latency + per-phase reservoirs (the latency
        reservoir keeps this trace_id as its exemplar when sampled),
        emit the ``serve.request`` span linked to the dispatch leg that
        delivered the bits, and wake the waiter LAST.  Shared by the
        solo dispatcher and the fleet's publish paths so every leg
        speaks the same span vocabulary.  Host-side arithmetic only —
        zero device pulls (the R9/R10 contract)."""
        r.t_done = now
        dt_ms = (now - r.t0) * 1e3
        sampled = r.ctx is not None and r.ctx.sampled
        _obs.histogram("serve_request_latency_ms").observe(
            dt_ms, exemplar=(r.ctx.trace_id if sampled else None))
        _obs.histogram(_obs.labeled(
            "serve_request_latency_ms", tenant=r.model)).observe(dt_ms)
        phases = _phase_breakdown(r, t_sync, now)
        for ph, v in phases.items():
            _obs.histogram(_obs.labeled(
                "serve_phase_ms", phase=ph)).observe(v)
        if sampled:
            attrs: Dict[str, Any] = {
                f"{ph}_ms": round(v, 3) for ph, v in phases.items()}
            if replica is not None:
                attrs["replica"] = replica
            _trace.record_span(
                "serve.request", now - r.t0, ctx=r.ctx,
                links=([leg_ctx] if leg_ctx is not None else None),
                model=r.model, rows=r.n, outcome=outcome,
                attempt=r.retries, **attrs)
        r.event.set()

    def _dispatch_loop(self) -> None:
        while True:
            item = self._hand.get()
            if item is None:
                self._hand.task_done()
                return
            kind, batch, payload = item
            t_batch = time.perf_counter()
            # the dispatch-leg span identity is minted BEFORE execution
            # and carried explicitly — this dispatcher thread's ambient
            # span stack is empty and must stay out of parentage (the
            # cross-thread bug R21 now lints for)
            leg_ctx = self._batch_ctx(batch)
            t_sync: Optional[float] = None
            outcome = "ok"
            staging = None
            try:
                if kind == "serial":
                    (r,) = batch
                    g = payload if payload is not None \
                        else self._table[r.model]
                    r.result = g.predict(r.x, raw_score=r.raw)
                    t_sync = time.perf_counter()
                else:
                    g, x_dev, total, nb, skey, pair = payload
                    staging = (skey, pair)
                    convert = ((not batch[0].raw)
                               and g.objective is not None)
                    res = g.predict_coalesced(x_dev, convert=convert,
                                              trace_ctx=leg_ctx)
                    # the accounted sync retired inside predict_coalesced
                    # — the dispatch phase closes on this host stamp
                    t_sync = time.perf_counter()
                    off = 0
                    for r in batch:
                        r.result = res[off:off + r.n]
                        off += r.n
                    _obs.counter("serve_batches_total").inc()
                    _obs.counter("serve_coalesced_rows_total").inc(total)
                    _obs.histogram("serve_batch_occupancy").observe(
                        total / nb)
            except BaseException as e:  # noqa: BLE001 — a failed batch
                outcome = "error"
                for r in batch:  # must fail its requests, not the thread
                    r.error = e
            finally:
                    # the batch's read has retired (or it failed): its
                # pinned pair may be checked out again
                if staging is not None:
                    self._return_staging(*staging)
                # latency closes after predict_coalesced's counted read:
                # the batch's device work is done, so the time covers it
                now = time.perf_counter()
                for r in batch:
                    self._finish_request(r, now, t_sync, leg_ctx, outcome)
                # leg_ctx is None exactly when NO member was sampled —
                # the admission-time decision covers the batch span too
                # (an identityless record would leak spans under
                # trace_sample=0)
                if leg_ctx is not None:
                    _trace.record_span(
                        "serve.batch", now - t_batch, ctx=leg_ctx,
                        requests=len(batch),
                        rows=sum(r.n for r in batch),
                        model=batch[0].model,
                        coalesced=kind == "batch", outcome=outcome,
                        attempt=0)
                # unfinished_tasks drops to 0 only here: the coalescer's
                # idle-pipeline flush reads it, so "idle" honestly means
                # the previous batch has fully retired (sync included) —
                # and the notify wakes a window-waiting coalescer so the
                # admission window stays a busy-pipeline-only cost
                self._hand.task_done()
                with self._cv:
                    for r in batch:
                        self._pending.discard(r)
                    self._cv.notify_all()


    # -- /predict front door (obs/server.py owns the socket) -------------
    def _http_predict(self, payload: Dict[str, Any],
                      traceparent: Optional[str] = None,
                      ) -> Tuple[int, Dict, Optional[str]]:
        """One ``POST /predict`` request: JSON rows in, predictions out,
        routed through the SAME submit/result path every other caller
        uses — so shedding, deadlines and fleet health apply unchanged,
        mapped onto HTTP: Overloaded -> 429 (unhealthy -> 503),
        DeadlineExceeded/timeout -> 504, stopped runtime -> 503, bad
        request -> 400.

        The request's trace context is minted HERE, honoring an inbound
        W3C ``traceparent`` (the caller's trace adopts our spans); the
        outbound header and the ``trace_id`` body field are returned on
        EVERY outcome — a shed or timed-out request is exactly the one
        the caller needs to look up."""
        _obs.counter("serve_http_requests_total").inc()
        ctx = _trace.mint_request_context(traceparent)
        tp_out = _trace.format_traceparent(ctx)

        def _done(code: int, body: Dict) -> Tuple[int, Dict, Optional[str]]:
            body["trace_id"] = ctx.trace_id
            return code, body, tp_out

        try:
            rows = payload.get("rows") if isinstance(payload, dict) else None
            if rows is None:
                return _done(400, {"error": "bad_request",
                                   "detail": 'body must be JSON like '
                                             '{"rows": [[...], ...], '
                                             '"model": "default", '
                                             '"raw_score": false}'})
            X = np.asarray(rows, dtype=np.float64)
            model = str(payload.get("model", "default"))
            raw = bool(payload.get("raw_score", False))
            y = self.predict(X, model=model, raw_score=raw,
                             timeout=_PREDICT_HTTP_TIMEOUT_S,
                             trace_ctx=ctx)
            return _done(200, {"model": model,
                               "rows": int(np.atleast_2d(X).shape[0]),
                               "predictions": np.asarray(y).tolist()})
        except Overloaded as e:
            # admission refusals: 429 back-pressure, except an unhealthy
            # process, which is a 503 service condition
            code = 503 if e.reason == "unhealthy" else 429
            return _done(code, {"error": "overloaded", "reason": e.reason,
                                "tenant": e.tenant})
        except DeadlineExceeded as e:
            return _done(504, {"error": "deadline_exceeded",
                               "tenant": e.tenant,
                               "deadline_ms": e.deadline_ms})
        except TimeoutError as e:
            return _done(504, {"error": "timeout", "detail": str(e)})
        except LightGBMError as e:
            return _done(503, {"error": "unavailable", "detail": str(e)})
        except (TypeError, ValueError, KeyError) as e:
            return _done(400, {"error": "bad_request", "detail": str(e)})
