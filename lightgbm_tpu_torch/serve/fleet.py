"""The resilient serving fleet: health-routed replicas behind one
admission queue (round 22; docs/ROBUSTNESS.md "Serving fleet
resilience").

:class:`ServingRuntime` is one dispatcher on one device — a single
wedged dispatch takes the whole front door with it.  This module
replicates the dispatch side N ways (one per device on a real slice; N
threads off-chip) while keeping EVERYTHING the solo runtime already
pinned: one admission queue, the same coalescer, the same pinned
staging discipline, the same ``GBDT.predict_coalesced`` entry (1
dispatch + 1 accounted sync per coalesced batch per replica, zero
retraces), and bitwise-identical responses.  What it adds is the
robustness layer the training side got rounds ago:

* **Health-aware routing** — each staged batch routes to the best
  replica by (queue depth, warm batch latency from the per-replica
  ``serve_replica_batch_ms`` reservoirs); a replica accumulating
  consecutive failures trips an ejection/readmission circuit breaker
  (``serve_replica_ejections_total``): ejected replicas sit out a
  jittered exponential cooldown, then readmit through a single
  half-open probe batch.  The LAST healthy replica is never ejected —
  the fleet degrades to single-replica + shedding, never to zero.
* **Deadline / retry / hedge discipline** — every admitted request can
  carry a ``serve_deadline_ms`` deadline (typed
  :class:`~lightgbm_tpu_torch.serve.runtime.DeadlineExceeded`, distinct from
  :class:`~lightgbm_tpu_torch.serve.runtime.Overloaded`); a failed, dead or
  hung replica dispatch requeues the batch's requests EXACTLY once onto
  a healthy replica (idempotent because predict is pure — and pinned by
  test so a future stateful path cannot silently double-dispatch),
  gated by a retry-token budget so a sick fleet degrades to shedding
  instead of retry-storming itself; optionally a batch in flight past a
  p99-derived delay is hedged onto a second replica, first completion
  wins.
* **Replica lifecycle** — the launcher watchdog's machinery per
  replica: heartbeat gauges (``serve_replica_heartbeat_ts{replica=}``),
  hang detection by heartbeat staleness (not exit codes — a thread
  wedged inside a dispatch never exits), restart with jittered
  exponential backoff, and a replacement that warms every served pack
  BEFORE joining rotation.  In-flight requests of a dead/hung replica
  requeue through the same exactly-once path.
* **Chaos surface** — the ``replica_dispatch`` / ``replica_death`` /
  ``replica_hang`` / ``swap_publish`` fault sites (utils/faults.py,
  call-counted; each batch touches the sites at two pipeline stages, so
  even/odd rounds select stage A "on receipt" vs stage B "dispatch
  retired, results unpublished") drive the tier-1 chaos drills in
  tests/test_serve_fleet.py: kill or hang a replica mid-open-loop and
  every admitted request still resolves with the solo runtime's exact
  bits.

Off-chip replica threads share the process-global executable cache, so
a replacement is warm by construction; the explicit pack-touch before
rotation is what keeps the discipline honest for per-device replicas on
real hardware (each device re-stages its pack).  Like runtime.py, this
module owns NO jitted code (tests/test_serve.py's AST pin covers the
whole serve/ directory).
"""

from __future__ import annotations

import random
import threading
import time
from queue import Empty, Queue
from typing import Any, Dict, List, Optional

import numpy as np

from ..obs import metrics as _obs
from ..obs import server as _obs_server
from ..obs import trace as _trace
from ..utils import faults as _flt
from .runtime import DeadlineExceeded, Overloaded, ServingRuntime, _Request

# replica states (the serve_replica_state{replica=} gauge exports the int)
_ACTIVE, _HALF_OPEN, _EJECTED, _DEAD = 0, 1, 2, 3
_STATE_NAMES = {_ACTIVE: "active", _HALF_OPEN: "half_open",
                _EJECTED: "ejected", _DEAD: "dead"}
# routing reads a replica's warm p50 from its labeled reservoir at most
# this often (percentile() sorts the reservoir — cheap, not free)
_LAT_REFRESH_S = 0.05
# supervisor cadence: hang sweep, breaker cooldowns, restarts, hedging
_SUP_TICK_S = 0.01
# retry tokens: a fresh fleet can absorb a few failures before the
# per-admission refill (serve_retry_budget) has accumulated anything
_RETRY_TOKENS_INIT = 4.0
_RETRY_TOKENS_CAP = 64.0


class _ReplicaDeath(BaseException):
    """Raised inside a replica thread to model whole-replica death (the
    thread-fleet analogue of the launcher's worker_death).  BaseException
    so the batch-failure handler cannot swallow it."""


def _member_ctxs(reqs) -> Optional[List]:
    """The sampled members' trace contexts — the link targets a
    fleet-side span (failed leg, requeue, hedge) carries so every
    affected request's trace slice adopts it."""
    out = [r.ctx for r in reqs if r.ctx is not None and r.ctx.sampled]
    return out or None


class _Inflight:
    """What a replica is currently executing — enough for the supervisor
    to requeue it (hang/death) or hedge it (tail latency).  ``leg_ctx``
    is the dispatch leg's trace identity: the supervisor's hedge/death
    spans link to it so the chaos matrix reconstructs from the export."""

    __slots__ = ("batch", "skey", "t_mono", "hedged", "leg_ctx", "t_perf")

    def __init__(self, batch: List[_Request], skey,
                 leg_ctx=None, t_perf: float = 0.0):
        self.batch = batch
        self.skey = skey  # staging-pool key, None for serial items
        self.t_mono = time.monotonic()
        self.hedged = False
        self.leg_ctx = leg_ctx
        self.t_perf = t_perf


class _Replica:
    __slots__ = ("idx", "hand", "thread", "state", "fail_streak", "trips",
                 "cooldown_until", "probe_inflight", "inflight", "last_tick",
                 "restarts", "next_restart_at", "hung", "exhausted",
                 "lat_cache")

    def __init__(self, idx: int):
        self.idx = idx
        # the hand queue is STABLE across restarts: an item put while the
        # previous incarnation was dying is consumed by the replacement —
        # no request is ever stranded in a dead queue
        self.hand: Queue = Queue(maxsize=1)
        self.thread: Optional[threading.Thread] = None
        self.state = _ACTIVE
        self.fail_streak = 0
        self.trips = 0
        self.cooldown_until = 0.0
        self.probe_inflight = False
        self.inflight: Optional[_Inflight] = None
        self.last_tick = 0.0
        self.restarts = 0
        self.next_restart_at = 0.0
        self.hung = False
        self.exhausted = False
        self.lat_cache = (0.0, 0.0)  # (refreshed_at, p50_ms)

    def depth(self) -> int:
        """Approximate outstanding work (the routing load signal).  Not
        Queue.unfinished_tasks: a hung incarnation never task_done()s its
        item, which would bias the count forever."""
        return self.hand.qsize() + (1 if self.inflight is not None else 0)


class ServingFleet(ServingRuntime):
    """N health-routed replicas behind the inherited admission queue.

    >>> fl = ServingFleet(booster, replicas=2, deadline_ms=50.0)
    >>> with fl:
    ...     y = fl.predict(X)          # same bits as Booster.predict
    >>> # /predict, /healthz (replica table) ride the obs endpoint

    Knob defaults come from the first model's Config
    (``serve_replicas``, ``serve_deadline_ms``, ``serve_hedge_ms``,
    ``serve_retry_budget``, ``serve_replica_trip``,
    ``serve_replica_cooldown_ms``, ``serve_hang_timeout_ms``,
    ``serve_restart_backoff_ms``, ``serve_max_restarts``); explicit
    kwargs win, like the base runtime's.
    """

    def __init__(self, model=None, *, models: Optional[Dict[str, Any]] = None,
                 replicas: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 hedge_ms: Optional[float] = None,
                 retry_budget: Optional[float] = None,
                 trip: Optional[int] = None,
                 cooldown_ms: Optional[float] = None,
                 hang_timeout_ms: Optional[float] = None,
                 restart_backoff_ms: Optional[float] = None,
                 max_restarts: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 slo_p99_ms: Optional[float] = None,
                 tenant_quota: Optional[int] = None,
                 shed_unhealthy: bool = True,
                 start: bool = True):
        super().__init__(model, models=models, max_wait_ms=max_wait_ms,
                         max_queue=max_queue, slo_p99_ms=slo_p99_ms,
                         tenant_quota=tenant_quota,
                         shed_unhealthy=shed_unhealthy, start=False)
        cfg = next(iter(self._table.values())).cfg

        def _k(explicit, name, cast):
            return cast(getattr(cfg, name) if explicit is None else explicit)

        self._n_replicas = max(1, _k(replicas, "serve_replicas", int))
        self._deadline_s = _k(deadline_ms, "serve_deadline_ms", float) / 1e3
        self._hedge_ms = _k(hedge_ms, "serve_hedge_ms", float)
        self._retry_rate = _k(retry_budget, "serve_retry_budget", float)
        self._trip = max(1, _k(trip, "serve_replica_trip", int))
        self._cooldown_s = _k(cooldown_ms,
                              "serve_replica_cooldown_ms", float) / 1e3
        self._hang_s = _k(hang_timeout_ms, "serve_hang_timeout_ms",
                          float) / 1e3
        self._restart_backoff_s = _k(restart_backoff_ms,
                                     "serve_restart_backoff_ms", float) / 1e3
        self._max_restarts = max(0, _k(max_restarts, "serve_max_restarts",
                                       int))
        self._retry_tokens = _RETRY_TOKENS_INIT
        self._coal_done = False
        self._sup: Optional[threading.Thread] = None
        self._replicas = [_Replica(i) for i in range(self._n_replicas)]
        if start:
            self.start()

    # -- lifecycle -------------------------------------------------------
    def _spawn_workers(self) -> None:
        # warm every served pack once before ANY replica joins rotation —
        # the same "resident before the first request" discipline
        # add_model/swap_model already follow
        for g in list(self._table.values()):
            g._packed(0, -1)
        now = time.monotonic()
        for rep in self._replicas:
            rep.last_tick = now
            self._launch_replica_thread(rep)
        self._sup = threading.Thread(  # jaxlint: disable=L5 (joined via the _worker_threads() loop in stop())
            target=self._supervise_loop, daemon=True,
            name="lgbmtpu-fleet-supervisor")
        self._sup.start()
        self._coalescer = threading.Thread(  # jaxlint: disable=L5 (joined via the _worker_threads() loop in stop())
            target=self._coalesce_loop, daemon=True,
            name="lgbmtpu-fleet-coalescer")
        self._coalescer.start()
        _obs_server.set_health_extra(self._health_extra)
        with self._cv:
            self._publish_fleet_gauges()

    def _launch_replica_thread(self, rep: _Replica) -> None:
        rep.thread = threading.Thread(  # jaxlint: disable=L5 (non-hung replica threads are joined via the _worker_threads() loop in stop(); a HUNG replica is deliberately abandoned as a daemon — joining a wedged dispatch would hang shutdown)
            target=self._replica_loop, args=(rep,), daemon=True,
            name=f"lgbmtpu-replica-{rep.idx}")
        rep.thread.start()

    def _worker_threads(self) -> List[threading.Thread]:
        # join order matters: the coalescer first (it finishes routing the
        # drained queue), then the replicas (they finish their hands), then
        # the supervisor.  A HUNG replica's thread is excluded — it sleeps
        # inside a dispatch and would eat the whole join timeout; the
        # stop() drain sweep types-out whatever it held.
        out = [t for t in (self._coalescer,) if t is not None]
        out += [rep.thread for rep in self._replicas
                if rep.thread is not None and not rep.hung]
        if self._sup is not None:
            out.append(self._sup)
        return out

    def _shutdown_pipeline(self) -> None:
        # replicas poll this instead of a depth-1 sentinel: they must not
        # exit before the coalescer has routed the last drained batch
        self._coal_done = True

    def stop(self) -> None:
        if self._closed:
            super().stop()
            return
        super().stop()
        _obs_server.clear_health_extra(self._health_extra)
        with self._cv:
            _obs.gauge("serve_fleet_degraded").set(0.0)

    # -- admission (inherited) + retry-budget refill ---------------------
    def submit(self, X, *, model: str = "default",
               raw_score: bool = False, trace_ctx=None) -> _Request:
        req = super().submit(X, model=model, raw_score=raw_score,
                             trace_ctx=trace_ctx)
        if self._retry_rate > 0:
            with self._cv:
                self._retry_tokens = min(_RETRY_TOKENS_CAP,
                                         self._retry_tokens
                                         + self._retry_rate)
        return req

    def _take_retry_token_locked(self) -> bool:
        if self._retry_rate < 0:
            return True  # unlimited
        if self._retry_tokens >= 1.0:
            self._retry_tokens -= 1.0
            return True
        _obs.counter("serve_retry_budget_exhausted_total").inc()
        return False

    # -- routing ---------------------------------------------------------
    def _pipeline_idle(self) -> bool:
        for rep in self._replicas:
            if (rep.state == _ACTIVE and rep.inflight is None
                    and rep.hand.empty()):
                return True
        return False

    def _staging_pairs(self) -> int:
        # N replicas can each hold one batch in flight while the coalescer
        # stages the next — 2 pairs (the solo double buffer) would starve
        return self._n_replicas + 1

    def _lat_ms_locked(self, rep: _Replica, now: float) -> float:
        t, v = rep.lat_cache
        if now - t > _LAT_REFRESH_S:
            p = _obs.histogram(_obs.labeled(
                "serve_replica_batch_ms", replica=rep.idx)).percentile(50)
            v = 0.0 if p is None else float(p)
            rep.lat_cache = (now, v)
        return v

    def _route(self, avoid: int = -1) -> Optional[_Replica]:
        """Pick the healthiest replica for one staged batch: active (or
        half-open with a free probe slot), away from ``avoid`` (the
        replica a retried batch just failed on) when any alternative
        exists, minimizing (outstanding depth, warm p50).  Blocks while
        no replica is routable (all ejected/dead mid-restart); returns
        None only when the fleet is stopping or every replica slot is
        dead with its restarts exhausted."""
        with self._cv:
            while True:
                cands = [rep for rep in self._replicas
                         if rep.state == _ACTIVE
                         or (rep.state == _HALF_OPEN
                             and not rep.probe_inflight)]
                if avoid >= 0 and len(cands) > 1:
                    cands = [c for c in cands if c.idx != avoid] or cands
                if cands:
                    # a half-open replica with a free probe slot takes the
                    # next batch unconditionally: probes must actually run
                    # for readmission to ever happen, and min-latency
                    # routing would starve them (the freshly cooled replica
                    # rarely wins a (depth, p50) tiebreak)
                    half = [c for c in cands if c.state == _HALF_OPEN]
                    if half:
                        rep = min(half, key=lambda c: c.idx)
                        rep.probe_inflight = True
                        return rep
                    now = time.monotonic()
                    rep = min(cands, key=lambda c: (
                        c.depth(), self._lat_ms_locked(c, now), c.idx))
                    return rep
                if not self._running and self._closed:
                    return None
                if all(rep.state == _DEAD and rep.exhausted
                       for rep in self._replicas):
                    return None
                self._cv.wait(0.05)

    def _expire_deadlines(self, batch: List[_Request]) -> None:
        """Drop (typed-fail) requests already past their deadline BEFORE
        they spend staging + a dispatch."""
        if self._deadline_s <= 0:
            return
        now = time.monotonic()
        expired = [r for r in batch
                   if r.deadline is not None and now > r.deadline
                   and not r.event.is_set()]
        if not expired:
            return
        gone = set(id(r) for r in expired)
        batch[:] = [r for r in batch if id(r) not in gone]
        with self._cv:
            for r in expired:
                self._pending.discard(r)
        t = time.perf_counter()
        for r in expired:
            self._count_deadline(r.model)
            r.error = DeadlineExceeded(r.model, self._deadline_s * 1e3)
            r.t_done = t
            if r.ctx is not None and r.ctx.sampled:
                _trace.record_span(
                    "serve.request", t - r.t0, ctx=r.ctx, model=r.model,
                    rows=r.n, outcome="deadline", attempt=r.retries)
            r.event.set()

    def _stage_and_hand(self, g, batch: List[_Request]) -> None:
        self._expire_deadlines(batch)
        if not batch:
            return
        rep = self._route(max(r.avoid for r in batch))
        if rep is None:
            # stopping, or every replica slot is dead beyond restarts:
            # shed typed instead of queueing into nowhere (the coalescer's
            # error path fails the batch with this)
            raise Overloaded("unhealthy", batch[0].model)
        if batch[0].serial:
            rep.hand.put(("serial", batch, g))
            return
        rep.hand.put(self._stage_batch(g, batch))

    # -- replica worker --------------------------------------------------
    def _replica_loop(self, rep: _Replica) -> None:
        _obs.event("serve_replica_start", replica=rep.idx,
                   restarts=rep.restarts)
        try:
            while True:
                try:
                    item = rep.hand.get(timeout=0.05)
                except Empty:
                    with self._cv:
                        rep.last_tick = time.monotonic()
                    _obs.gauge(_obs.labeled(
                        "serve_replica_heartbeat_ts",
                        replica=rep.idx)).set(time.time())
                    if self._coal_done and not self._running:
                        break
                    continue
                self._replica_execute(rep, item)
        except _ReplicaDeath:
            self._on_replica_exit(rep, why="death")
        except BaseException as e:  # noqa: BLE001 — an escaping error IS
            # a replica death: the slot restarts, the batch requeues
            _obs.event("serve_replica_error", replica=rep.idx,
                       error=repr(e))
            self._on_replica_exit(rep, why="error")

    def _chaos(self, rep: _Replica) -> None:
        """The serve-side fault sites, touched once per pipeline stage
        (docs/ROBUSTNESS.md).  Order: death, hang, dispatch-failure."""
        if _flt.fire("replica_death"):
            raise _ReplicaDeath(f"replica {rep.idx}")
        _flt.maybe_hang("replica_hang")
        _flt.maybe_fail("replica_dispatch")

    def _replica_execute(self, rep: _Replica, item) -> None:
        kind, batch, payload = item
        staging = None
        total = sum(r.n for r in batch)
        nb = total
        if kind == "batch":
            g, x_dev, total, nb, skey, pair = payload
            staging = (skey, pair)
        t_batch = time.perf_counter()
        # the leg's trace identity: minted on receipt, stored on the
        # inflight record so the SUPERVISOR thread (hedge sweep, hang
        # detection) can link its spans to this exact dispatch attempt —
        # explicit context, never this thread's (empty) ambient stack
        leg_ctx = self._batch_ctx(batch)
        with self._cv:
            rep.inflight = _Inflight(batch, staging[0] if staging else None,
                                     leg_ctx=leg_ctx, t_perf=t_batch)
            rep.last_tick = time.monotonic()
        _obs.gauge(_obs.labeled("serve_replica_heartbeat_ts",
                                replica=rep.idx)).set(time.time())
        err: Optional[BaseException] = None
        outs: Optional[List[np.ndarray]] = None
        t_sync: Optional[float] = None
        try:
            try:
                self._chaos(rep)  # stage A: batch received, not dispatched
                if kind == "serial":
                    (r,) = batch
                    gg = payload if payload is not None \
                        else self._table[r.model]
                    outs = [gg.predict(r.x, raw_score=r.raw)]
                else:
                    convert = ((not batch[0].raw)
                               and g.objective is not None)
                    res = g.predict_coalesced(x_dev, convert=convert,
                                              trace_ctx=leg_ctx)
                    outs = []
                    off = 0
                    for r in batch:
                        outs.append(res[off:off + r.n])
                        off += r.n
                t_sync = time.perf_counter()  # accounted sync retired
                self._chaos(rep)  # stage B: dispatch retired, unpublished
            except _ReplicaDeath:
                raise
            except BaseException as e:  # noqa: BLE001 — a failed batch
                err = e  # fails (or requeues) its requests, not the thread
        finally:
            # the batch's accounted sync has retired (or it never ran):
            # the pinned pair may be reused.  This also runs on the way
            # OUT of a replica death — the dying thread returns its pair
            # cleanly, so only a HANG leaks one (the supervisor
            # compensates the pool).
            if staging is not None:
                self._return_staging(*staging)
        if err is None:
            self._publish_success(rep, batch, outs, total, nb,
                                  kind == "batch", t_batch, t_sync, leg_ctx)
        else:
            self._publish_failure(rep, batch, err, t_batch, leg_ctx)
        rep.hand.task_done()
        with self._cv:
            rep.inflight = None
            rep.last_tick = time.monotonic()
            self._cv.notify_all()

    def _publish_success(self, rep: _Replica, batch, outs, total, nb,
                         coalesced, t_batch, t_sync=None,
                         leg_ctx=None) -> None:
        now = time.perf_counter()
        attempt = max((r.retries for r in batch), default=0)
        for r, y in zip(batch, outs):
            if r.event.is_set():
                continue  # a hedged/raced twin already delivered — the
                # bits are identical either way (predict is pure)
            r.result = y
            # shared completion path (runtime.py): latency + phase
            # reservoirs, exemplar, and the serve.request span linked to
            # THIS leg — the one that actually delivered the bits
            self._finish_request(r, now, t_sync, leg_ctx,
                                 outcome="ok", replica=rep.idx)
        dt_batch_ms = (now - t_batch) * 1e3
        _obs.histogram("serve_replica_batch_ms").observe(dt_batch_ms)
        _obs.histogram(_obs.labeled(
            "serve_replica_batch_ms", replica=rep.idx)).observe(dt_batch_ms)
        if coalesced:
            _obs.counter("serve_batches_total").inc()
            _obs.counter("serve_coalesced_rows_total").inc(total)
            _obs.histogram("serve_batch_occupancy").observe(total / nb)
        if leg_ctx is not None:  # None = no member sampled: batch span
            _trace.record_span(  # obeys the admission decision too
                "serve.batch", now - t_batch, ctx=leg_ctx,
                requests=len(batch), rows=total,
                model=batch[0].model, coalesced=coalesced,
                replica=rep.idx, attempt=attempt, outcome="ok")
        with self._cv:
            for r in batch:
                self._pending.discard(r)
            rep.fail_streak = 0
            if rep.state == _HALF_OPEN:
                # probe succeeded: readmit
                rep.state = _ACTIVE
                rep.probe_inflight = False
                rep.trips = 0
                _obs.counter("serve_replica_readmissions_total").inc()
                _obs.counter(_obs.labeled(
                    "serve_replica_readmissions_total",
                    replica=rep.idx)).inc()
                _obs.event("serve_replica_readmit", replica=rep.idx)
                self._publish_fleet_gauges()

    def _publish_failure(self, rep: _Replica, batch,
                         err: BaseException, t_batch: float = 0.0,
                         leg_ctx=None) -> None:
        _obs.counter("serve_replica_failures_total").inc()
        _obs.counter(_obs.labeled("serve_replica_failures_total",
                                  replica=rep.idx)).inc()
        # the FAILED leg's span: its own identity (leg_ctx) plus links to
        # every member request, so a request's trace slice adopts this
        # leg even though the request span will link only to the leg
        # that eventually delivered — death/hang × stage reconstructs
        # from the export alone
        now = time.perf_counter()
        if leg_ctx is not None:  # None = no member sampled (admission)
            _trace.record_span(
                "serve.leg", now - (t_batch or now), ctx=leg_ctx,
                links=_member_ctxs(batch),
                replica=rep.idx, requests=len(batch),
                attempt=max((r.retries for r in batch), default=0),
                outcome="error", error=type(err).__name__,
                model=batch[0].model)
        with self._cv:
            rep.fail_streak += 1
            self._breaker_failure_locked(rep, time.monotonic())
            self._retry_or_fail_locked(rep, batch, err)

    # -- exactly-once requeue --------------------------------------------
    def _retry_or_fail_locked(self, rep: _Replica, reqs,
                              err: BaseException) -> int:
        """Under self._cv.  Requeue each unresolved request EXACTLY once
        (budget permitting) at the FRONT of the admission queue, marked
        to route away from ``rep``; requests already retried (or past
        budget) fail with ``err``.  Returns the requeue count."""
        live = [r for r in reqs if not r.event.is_set()]
        fresh = [r for r in live if r.retries == 0]
        fail = [r for r in live if r.retries != 0]  # already retried once
        # ONE token per failed BATCH (not per request): the budget bounds
        # how many redispatches a sick fleet performs, and a redispatch
        # costs one dispatch regardless of how many requests coalesced
        requeue: List[_Request] = []
        if fresh and self._take_retry_token_locked():
            requeue = fresh
            for r in requeue:
                r.retries = 1
                r.avoid = rep.idx
        else:
            fail.extend(fresh)
        for r in requeue:
            self._queued_per_tenant[r.model] = (
                self._queued_per_tenant.get(r.model, 0) + 1)
        self._queue[0:0] = requeue
        if requeue:
            _obs.gauge("serve_queue_depth").set(len(self._queue))
            _obs.counter("serve_requeues_total").inc(len(requeue))
            _obs.event("serve_requeue", replica=rep.idx,
                       requests=len(requeue), error=type(err).__name__)
            # the requeue decision as a span: links to every re-queued
            # request, so "this request was redispatched off replica K
            # after error E" reads straight out of the trace export
            # (skipped when no member was sampled — admission decision)
            rq_ctx = self._batch_ctx(requeue)
            if rq_ctx is not None:
                _trace.record_span(
                    "serve.requeue", 0.0, ctx=rq_ctx,
                    links=_member_ctxs(requeue), replica=rep.idx,
                    requests=len(requeue), error=type(err).__name__,
                    outcome="requeued", attempt=1)
        t = time.perf_counter()
        for r in fail:
            self._pending.discard(r)
            r.error = err
            r.t_done = t
            # terminal failure closes the request's span too — every
            # admitted sampled request leaves exactly one serve.request
            # span in the recorder, whatever its fate
            if r.ctx is not None and r.ctx.sampled:
                _trace.record_span(
                    "serve.request", t - r.t0, ctx=r.ctx,
                    model=r.model, rows=r.n, outcome="failed",
                    error=type(err).__name__, attempt=r.retries,
                    replica=rep.idx)
            r.event.set()
        self._cv.notify_all()
        return len(requeue)

    # -- circuit breaker -------------------------------------------------
    def _active_count_locked(self) -> int:
        return sum(1 for rep in self._replicas if rep.state == _ACTIVE)

    def _breaker_failure_locked(self, rep: _Replica, now: float) -> None:
        if rep.state == _HALF_OPEN:
            # the probe itself failed: straight back out, longer cooldown
            rep.probe_inflight = False
            self._eject_locked(rep, now)
        elif rep.state == _ACTIVE and rep.fail_streak >= self._trip:
            if self._active_count_locked() > 1:
                self._eject_locked(rep, now)
            # else: the LAST healthy replica is never ejected — the fleet
            # degrades to single-replica + shedding, never to zero

    def _eject_locked(self, rep: _Replica, now: float) -> None:
        rep.state = _EJECTED
        rep.trips += 1
        back = self._cooldown_s * (2 ** (rep.trips - 1))
        rep.cooldown_until = now + back * (0.5 + random.random())
        rep.fail_streak = 0
        _obs.counter("serve_replica_ejections_total").inc()
        _obs.counter(_obs.labeled("serve_replica_ejections_total",
                                  replica=rep.idx)).inc()
        _obs.event("serve_replica_eject", replica=rep.idx, trips=rep.trips,
                   cooldown_ms=round((rep.cooldown_until - now) * 1e3, 2))
        self._publish_fleet_gauges()

    # -- death / hang lifecycle ------------------------------------------
    def _on_replica_exit(self, rep: _Replica, why: str) -> None:
        """Runs in the DYING replica thread: mark the slot dead, requeue
        whatever it held (its staging pair was already returned on the
        way out), and schedule the replacement."""
        with self._cv:
            self._mark_dead_locked(rep, hung=False, why=why)

    def _mark_dead_locked(self, rep: _Replica, hung: bool,
                          why: str) -> None:
        now = time.monotonic()
        rep.state = _DEAD
        rep.hung = hung
        rep.probe_inflight = False
        name = ("serve_replica_hangs_total" if hung
                else "serve_replica_deaths_total")
        _obs.counter(name).inc()
        _obs.counter(_obs.labeled(name, replica=rep.idx)).inc()
        _obs.event("serve_replica_hang" if hung else "serve_replica_death",
                   replica=rep.idx, why=why, restarts=rep.restarts)
        infl, rep.inflight = rep.inflight, None
        err = RuntimeError(
            f"replica {rep.idx} {'hung' if hung else 'died'} ({why})")
        if infl is not None and infl.leg_ctx is not None:
            # the leg that died/hung with work in flight: the span wears
            # the leg's own stored context (minted by the replica thread
            # on receipt — the supervisor/dying thread must NOT invent a
            # fresh one) and links every stranded request; a None leg
            # context means no member was sampled, so the span drops too
            _trace.record_span(
                "serve.leg", time.perf_counter() - (infl.t_perf or 0.0)
                if infl.t_perf else 0.0,
                ctx=infl.leg_ctx, links=_member_ctxs(infl.batch),
                replica=rep.idx, requests=len(infl.batch),
                attempt=max((r.retries for r in infl.batch), default=0),
                outcome="hang" if hung else "death", error=why)
        if infl is not None:
            if hung and infl.skey is not None:
                # the wedged thread still owns its pinned pair: grow the
                # rung's pool by one fresh pair so the coalescer cannot
                # starve (if the thread ever wakes, its late return only
                # makes the pool one pair deeper — never corrupts, the
                # pair is out of every in-flight batch by then)
                self._staging[infl.skey].put(self._new_staging(infl.skey))
            self._retry_or_fail_locked(rep, infl.batch, err)
        if rep.restarts >= self._max_restarts:
            rep.exhausted = True
            # no replacement will ever drain this hand: requeue/fail its
            # queued items now instead of stranding them
            self._drain_hand_locked(rep, err)
            _obs.event("serve_replica_abandoned", replica=rep.idx)
        else:
            back = self._restart_backoff_s * (2 ** rep.restarts)
            rep.next_restart_at = now + back * (0.5 + random.random())
        self._publish_fleet_gauges()
        self._cv.notify_all()

    def _drain_hand_locked(self, rep: _Replica, err: BaseException) -> None:
        while True:
            try:
                item = rep.hand.get_nowait()
            except Empty:
                return
            kind, batch, payload = item
            if kind == "batch":
                # never dispatched: the retry path re-stages from the
                # requests' own rows, so the pair goes straight back
                self._return_staging(payload[4], payload[5])
            rep.hand.task_done()
            self._retry_or_fail_locked(rep, batch, err)

    def _restart_replica(self, rep: _Replica) -> None:
        """Outside self._cv: warm FIRST, then join rotation — a cold
        replacement must never catch live traffic."""
        with self._cv:
            gs = list(self._table.values())
        for g in gs:
            g._packed(0, -1)
        with self._cv:
            rep.restarts += 1
            rep.state = _ACTIVE
            rep.hung = False
            rep.exhausted = False
            rep.fail_streak = 0
            rep.probe_inflight = False
            rep.inflight = None
            rep.last_tick = time.monotonic()
            _obs.counter("serve_replica_restarts_total").inc()
            _obs.counter(_obs.labeled("serve_replica_restarts_total",
                                      replica=rep.idx)).inc()
            _obs.event("serve_replica_restart", replica=rep.idx,
                       restarts=rep.restarts)
            self._publish_fleet_gauges()
            self._cv.notify_all()
        self._launch_replica_thread(rep)

    # -- supervisor ------------------------------------------------------
    def _supervise_loop(self) -> None:
        while self._running:
            now = time.monotonic()
            spawn: List[_Replica] = []
            with self._cv:
                for rep in self._replicas:
                    if rep.state == _EJECTED and now >= rep.cooldown_until:
                        rep.state = _HALF_OPEN
                        rep.probe_inflight = False
                        _obs.event("serve_replica_half_open",
                                   replica=rep.idx)
                        self._publish_fleet_gauges()
                        self._cv.notify_all()
                    if (rep.state in (_ACTIVE, _HALF_OPEN)
                            and rep.inflight is not None
                            and now - rep.last_tick > self._hang_s):
                        self._mark_dead_locked(rep, hung=True,
                                               why="heartbeat stale")
                    if (rep.state == _DEAD and not rep.exhausted
                            and now >= rep.next_restart_at
                            and (rep.hung or rep.thread is None
                                 or not rep.thread.is_alive())):
                        # claim the slot so one restart spawns exactly once
                        rep.next_restart_at = float("inf")
                        spawn.append(rep)
                if self._hedge_ms != 0:
                    self._hedge_sweep_locked(now)
            for rep in spawn:
                self._restart_replica(rep)
            time.sleep(_SUP_TICK_S)

    # -- hedging ---------------------------------------------------------
    def _hedge_delay_s(self) -> float:
        if self._hedge_ms > 0:
            return self._hedge_ms / 1e3
        # auto: p99-derived from the fleet-wide batch reservoir
        p = _obs.histogram("serve_replica_batch_ms").percentile(99)
        return (float(p) / 1e3) if p else 0.05

    def _hedge_sweep_locked(self, now: float) -> None:
        delay = self._hedge_delay_s()
        for rep in self._replicas:
            infl = rep.inflight
            if infl is None or infl.hedged or now - infl.t_mono <= delay:
                continue
            others = any(r.state == _ACTIVE and r is not rep
                         for r in self._replicas)
            if not others:
                continue
            infl.hedged = True
            twins = [r for r in infl.batch if not r.event.is_set()]
            if not twins:
                continue
            for r in twins:
                r.avoid = rep.idx
                self._queued_per_tenant[r.model] = (
                    self._queued_per_tenant.get(r.model, 0) + 1)
            self._queue[0:0] = twins
            _obs.counter("serve_hedges_total").inc()
            _obs.event("serve_hedge", replica=rep.idx, requests=len(twins),
                       delay_ms=round(delay * 1e3, 2))
            # the hedge pair as links: the slow original leg + every
            # hedged request — first result wins, and both legs stay
            # reachable from the request's trace slice
            hedge_links = list(_member_ctxs(twins) or [])
            if infl.leg_ctx is not None:
                hedge_links.append(infl.leg_ctx)
            hedge_ctx = self._batch_ctx(twins)
            if hedge_ctx is not None:  # None = no twin sampled
                _trace.record_span(
                    "serve.hedge", 0.0, ctx=hedge_ctx,
                    links=hedge_links or None, replica=rep.idx,
                    requests=len(twins), delay_ms=round(delay * 1e3, 2),
                    outcome="hedged")
            self._cv.notify_all()

    # -- observability ---------------------------------------------------
    def _publish_fleet_gauges(self) -> None:
        """Under self._cv: routing-state gauges + the /healthz-driving
        degraded flag (obs/server.py DEGRADED_GAUGES)."""
        degraded = any(rep.state != _ACTIVE for rep in self._replicas)
        _obs.gauge("serve_fleet_degraded").set(1.0 if degraded else 0.0)
        for rep in self._replicas:
            _obs.gauge(_obs.labeled("serve_replica_state",
                                    replica=rep.idx)).set(float(rep.state))

    def _health_extra(self) -> Dict[str, Any]:
        """The /healthz replica table (obs/server.py set_health_extra)."""
        with self._cv:
            return {
                "replicas": [
                    {"replica": rep.idx,
                     "state": _STATE_NAMES[rep.state],
                     "fail_streak": rep.fail_streak,
                     "restarts": rep.restarts,
                     "depth": rep.depth()}
                    for rep in self._replicas],
                "retry_tokens": round(self._retry_tokens, 2),
            }

    def stats(self) -> Dict[str, Any]:
        out = super().stats()
        with self._cv:
            out["replicas"] = {rep.idx: _STATE_NAMES[rep.state]
                               for rep in self._replicas}
            out["retry_tokens"] = round(self._retry_tokens, 2)
        return out
