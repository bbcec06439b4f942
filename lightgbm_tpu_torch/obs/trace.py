"""Lightweight span tracing (docs/OBSERVABILITY.md "Span tracing").

Round 10's registry answers "how many / how fast on aggregate"; this module
answers "WHAT was the process doing when round 412 took 3x its neighbors".
Spans are named, attributed, nesting host-side intervals:

    with trace.span("boost_round", iteration=i) as sp:
        ...
        sp.set(dispatches=3)

plus :func:`record_span` for the retroactive form — an interval whose end
the caller anchors at an **accounted sync point** it already paid for (the
windowed grower's one-round-behind async info resolve, a coalesced
predict's ``sync_pull``).  That split embodies the zero-dispatch rule:

* opening/closing a span NEVER touches a device value.  A span close that
  performs a fresh host pull to "drain" the queue would add the blocking
  sync the round-7 protocol removed — the port's lint rule R10
  ``sync-in-span-close`` (``lightgbm_tpu_torch/analysis``) statically bans
  exactly that, the tracing twin of R9's mistiming class.
* consequently a context-manager span measures HOST-CAUSAL wall clock
  (async device work dispatched inside it may still be in flight at
  close).  Spans that must cover device time are recorded retroactively
  at the next accounted sync (``windowed_round``, ``predict.coalesced``),
  or close only after one (a ``predict.<entry>`` call span, which takes
  its CUDA-event readings as attributes after the call's one blocking
  read) — the instrumented layers own that anchoring, not this module.

Finished spans land in a bounded ring (cap :data:`TRACE_RING_CAP`) and
export as Chrome-trace / Perfetto-loadable JSON (:func:`to_chrome_trace`,
:func:`write_trace`; ``python -m lightgbm_tpu_torch.obs trace`` is the CLI form,
``trace_file=`` the Config param).  Long runs overflow the ring — an
out-of-core training sweep emits far more than 8192 spans — and before
round 12 the evictions were SILENT.  Now every eviction is accounted:
with a spill sink enabled (:func:`enable_spill`; engine.train arms it
next to ``trace_file=``) evicted spans append to a bounded JSONL file
and count ``trace_spans_spilled_total``; past the byte bound, or with no
sink, they count ``trace_spans_dropped_total`` — the ring can no longer
lose history without the metrics saying so.  Spilling is pure host IO
(no device value is ever touched — the R10 discipline holds).  The exported file keeps the raw span
records under a ``"lgbmtpu"`` key (schema :data:`SCHEMA_TRACE`) so it
round-trips through the CLI while chrome://tracing and ui.perfetto.dev
read the standard ``traceEvents`` list.

On-chip correlation: :func:`set_annotation_factory` accepts a callable
``(name, attrs) -> context manager`` entered for the body of every
context-manager span while its gate holds.  ``utils/profiling.py``
installs ``torch.profiler.record_function`` at import, gated on a
torch.profiler recording, so every such span is a ``user_annotation`` of
the profiler's trace, on the clock of its device events; with no profiler
recording the gate is one call and nothing is entered
(:func:`mirror_active` tells the instrumented layers which case holds).
The torch bridge lives in that layer, never here: this module stays
stdlib-only like the rest of ``lightgbm_tpu_torch/obs``.

Enablement follows the metrics registry (``telemetry=false`` /
``LGBMTPU_TELEMETRY=0`` silences spans too); a disabled span is a cheap
no-op object.

Request-scoped distributed tracing (docs/OBSERVABILITY.md "Request
tracing"): a :class:`TraceContext` — 128-bit ``trace_id``, 64-bit
``span_id``, optional parent span id, all lowercase hex — names a span's
identity EXPLICITLY so causality survives thread handoffs.  The
thread-local stack severs the moment a request crosses the serving
coalescer (submitter thread -> coalescer -> dispatcher/replica threads);
cross-thread emitters therefore pass ``parent=``/``ctx=`` to
:func:`span`/:func:`record_span` instead of inheriting the WRONG
thread's stack top, and fan-in/fan-out joins (one coalesced dispatch
serving N requests, a hedge pair racing first-result-wins) are expressed
as ``links=`` — a list of peer contexts attached to the record, the
OpenTelemetry span-link shape.  Contexts interoperate with W3C
``traceparent`` headers (:func:`parse_traceparent` /
:func:`format_traceparent`); :func:`mint_request_context` is the
/predict entry's minting point and applies the ``request_tracing=`` /
``trace_sample=`` sampling decision (an unsampled context still carries
a trace id for response correlation — its spans are simply not
recorded).  :func:`spans_for_trace` and :func:`trace_slice` are the
trace_id-indexed retrieval; :func:`merge_trace_files` folds per-rank /
per-replica trace exports into one clock-aligned flight recorder (the
launcher's events/metrics merge triad, completed).  None of this touches
a device value: ids come from ``os.urandom``, timings from host clocks
the caller already read.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import random
import threading
import time
from typing import (Any, Callable, ContextManager, Dict, Iterable, List,
                    Optional, Sequence)

from . import metrics as _metrics

SCHEMA_TRACE = "lgbmtpu-trace-v1"
TRACE_RING_CAP = 8192

# spans a single record may link to: a serving batch can coalesce many
# requests — the links list is bounded so one fan-in record cannot bloat
# the ring; overflow is counted on the record (link_overflow attr)
MAX_LINKS = 64

SPILL_MAX_BYTES = 64 * 1024 * 1024  # default bound for the spill sink

_lock = threading.RLock()
_ring: "collections.deque" = collections.deque(maxlen=TRACE_RING_CAP)
_ids = itertools.count(1)
_tls = threading.local()
_annotation_factory: Optional[
    Callable[[str, Dict[str, Any]], ContextManager]] = None
_annotation_gate: Optional[Callable[[], bool]] = None
_spill_fh = None
_spill_path: Optional[str] = None
_spill_bytes = 0
_spill_max_bytes = SPILL_MAX_BYTES
_spill_clean = False  # previous arm in THIS process was disarmed cleanly


def enable_spill(path: str, max_bytes: int = SPILL_MAX_BYTES) -> None:
    """Arm the ring-eviction spill sink: spans evicted from the full ring
    append to ``path`` as JSONL (one raw span record per line), up to
    ``max_bytes``; beyond the bound evictions fall back to the dropped
    counter.  Appends on first arm in a process, so a watchdog-relaunched
    run keeps its pre-crash history; re-arming AFTER a clean disarm
    truncates (the previous run's complete history was sidecar + its own
    trace export — a later run's evictions must not be appended to and
    mistaken for it), as does switching to a different path mid-process."""
    global _spill_fh, _spill_path, _spill_bytes, _spill_max_bytes, _spill_clean
    with _lock:
        if _spill_fh is not None:
            try:
                _spill_fh.close()  # jaxlint: disable=L2 (rare arm/disarm path; must serialize with _handle_eviction writes, which run under this same lock by design)
            except OSError:
                pass
            # disarm BEFORE the open: if the new path fails to open, the
            # sink must read as disarmed (counted drops), not as a live
            # handle that every eviction write would find closed
            _spill_fh = None
        mode = ("w" if _spill_clean
                or (_spill_path is not None and path != _spill_path)
                else "a")
        _spill_fh = open(path, mode, encoding="utf-8")  # jaxlint: disable=L2 (rare arm path; the handle swap must be atomic vs eviction writes under the same lock)
        _spill_bytes = _spill_fh.tell()  # jaxlint: disable=L2 (rare arm path; byte-count seed is part of the atomic handle swap)
        _spill_path = path
        _spill_max_bytes = int(max_bytes)
        _spill_clean = False


def disable_spill() -> Optional[str]:
    """Close the spill sink; returns its path (None when never armed)."""
    global _spill_fh, _spill_clean
    with _lock:
        if _spill_fh is not None:
            try:
                _spill_fh.close()  # jaxlint: disable=L2 (rare disarm path; must serialize with eviction writes under the same lock)
            except OSError:
                pass
            _spill_fh = None
            _spill_clean = True
        return _spill_path


def spill_path() -> Optional[str]:
    return _spill_path


def set_ring_cap(cap: int) -> None:
    """Resize the span ring (tests; keeps the newest ``cap`` spans)."""
    global _ring
    with _lock:
        _ring = collections.deque(_ring, maxlen=max(int(cap), 1))


def _handle_eviction(evicted: Dict[str, Any]) -> None:
    """Account one span falling off the full ring — spill when armed and
    under the byte bound, count a drop otherwise.  Caller holds _lock."""
    global _spill_bytes
    if _spill_fh is not None and _spill_bytes < _spill_max_bytes:
        try:
            line = json.dumps(evicted, default=str) + "\n"
            _spill_fh.write(line)  # jaxlint: disable=L2 (spill sink design: eviction accounting is atomic with the ring mutation by construction; the write is bounded JSONL to a local file)
            _spill_bytes += len(line.encode("utf-8"))
            _metrics.counter("trace_spans_spilled_total").inc()
            return
        except (OSError, ValueError):
            pass  # unwritable sink degrades to counted drops
    _metrics.counter("trace_spans_dropped_total").inc()


def set_annotation_factory(
        fn: Optional[Callable[[str, Dict[str, Any]], ContextManager]],
        gate: Optional[Callable[[], bool]] = None) -> None:
    """Install (or clear, with None) the device-annotation mirror used by
    context-manager spans; with ``gate``, a span enters the factory only
    while ``gate()`` holds.  Factory and gate must be cheap and must not
    raise; utils/profiling.py installs ``torch.profiler.record_function``,
    gated on a profiler recording."""
    global _annotation_factory, _annotation_gate
    _annotation_factory, _annotation_gate = fn, gate


def _live_factory() -> Optional[Callable[[str, Dict[str, Any]], ContextManager]]:
    fac, gate = _annotation_factory, _annotation_gate
    return fac if fac is not None and (gate is None or gate()) else None


def mirror_active() -> bool:
    """Whether a span opened now is mirrored into a device trace (a
    factory is installed and its gate holds: a profiler is recording)."""
    return _live_factory() is not None


def _stack() -> List["Span"]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


# ---------------------------------------------------------------------------
# request-scoped trace contexts (docs/OBSERVABILITY.md "Request tracing")
# ---------------------------------------------------------------------------

# request-tracing switch + sampling rate (Config request_tracing= /
# trace_sample=; configure_request_tracing applies them).  Default ON at
# rate 1.0.  The sampler is a private
# random.Random seeded from os.urandom so tests seeding the global
# random module cannot couple to the sampling stream.
_req_tracing = True
_req_sample = 1.0
_req_rng = random.Random(os.urandom(8))


def configure_request_tracing(enabled: bool = True,
                              sample: float = 1.0) -> None:
    """Apply the ``request_tracing=`` / ``trace_sample=`` Config params to
    the process (engine/serve entries call this)."""
    global _req_tracing, _req_sample
    _req_tracing = bool(enabled)
    _req_sample = min(max(float(sample), 0.0), 1.0)


def request_tracing_enabled() -> bool:
    return _req_tracing and _metrics.enabled()


def new_trace_id() -> str:
    """Fresh 128-bit trace id, 32 lowercase hex chars (W3C trace-id)."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    """Fresh 64-bit span id, 16 lowercase hex chars (W3C parent-id)."""
    return os.urandom(8).hex()


class TraceContext:
    """One span's identity: ``trace_id`` (128-bit hex) names the request's
    whole causal story, ``span_id`` (64-bit hex) names THIS span inside
    it, ``parent_id`` the span it descends from (None = trace root).
    ``sampled`` carries the admission-time sampling decision: an
    unsampled context still travels (responses carry the trace id either
    way) but :func:`record_span` drops its spans."""

    __slots__ = ("trace_id", "span_id", "parent_id", "sampled")

    def __init__(self, trace_id: str, span_id: Optional[str] = None,
                 parent_id: Optional[str] = None,
                 sampled: bool = True) -> None:
        self.trace_id = trace_id
        self.span_id = span_id or new_span_id()
        self.parent_id = parent_id
        self.sampled = bool(sampled)

    def child(self) -> "TraceContext":
        """A context for a new span UNDER this one (same trace, this span
        as parent) — the cross-thread handoff shape: the enqueuing side
        makes the child, the worker thread records with ``ctx=child``."""
        return TraceContext(self.trace_id, new_span_id(), self.span_id,
                            self.sampled)

    def sibling(self) -> "TraceContext":
        """A context in the SAME trace with no parent — the fan-in shape:
        a coalesced dispatch span lives in its first request's trace and
        the member requests attach via ``links=``, not parentage."""
        return TraceContext(self.trace_id, new_span_id(), None,
                            self.sampled)

    def ref(self) -> Dict[str, str]:
        """The serialized link form stored on ring records."""
        return {"trace": self.trace_id, "sid": self.span_id}

    def __repr__(self) -> str:  # debugging/test readability only
        return (f"TraceContext({self.trace_id[:8]}…/{self.span_id}"
                f"{'' if self.sampled else ' unsampled'})")


def parse_traceparent(header: Optional[str]) -> Optional[TraceContext]:
    """Parse a W3C ``traceparent`` header (``00-<32hex>-<16hex>-<2hex>``)
    into the REMOTE caller's context (their span id, no local parent).
    Returns None on anything malformed — a bad header must never shed a
    request, it just starts a fresh trace."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().lower().split("-")
    if len(parts) != 4:
        return None
    ver, trace_id, span_id, flags = parts
    if (len(ver) != 2 or len(trace_id) != 32 or len(span_id) != 16
            or len(flags) != 2):
        return None
    try:
        int(ver, 16), int(trace_id, 16), int(span_id, 16), int(flags, 16)
    except ValueError:
        return None
    if ver == "ff" or int(trace_id, 16) == 0 or int(span_id, 16) == 0:
        return None  # ff is forbidden by the spec; zero ids are invalid
    return TraceContext(trace_id, span_id, None,
                        sampled=bool(int(flags, 16) & 0x01))


def format_traceparent(ctx: TraceContext) -> str:
    """The W3C ``traceparent`` header naming ``ctx`` as the parent of
    whatever the receiver does next."""
    return f"00-{ctx.trace_id}-{ctx.span_id}-{'01' if ctx.sampled else '00'}"


def mint_request_context(
        traceparent: Optional[str] = None) -> TraceContext:
    """Mint the per-request root context at an admission point (/predict,
    ``ServingRuntime.submit``).  An inbound ``traceparent`` is honored:
    the request joins the caller's trace as a child of their span.  The
    sampling decision (``request_tracing=`` x ``trace_sample=``) is made
    HERE, once per request; every downstream span inherits it."""
    sampled = (request_tracing_enabled()
               and (_req_sample >= 1.0 or _req_rng.random() < _req_sample))
    remote = parse_traceparent(traceparent)
    if remote is not None:
        return TraceContext(remote.trace_id, new_span_id(),
                            remote.span_id, sampled)
    return TraceContext(new_trace_id(), new_span_id(), None, sampled)


def current_context() -> Optional[TraceContext]:
    """The context of THIS thread's innermost open span (None outside any
    span).  This is the explicit-handoff source: read it on the enqueuing
    thread, pass ``.child()`` to the worker — never let the worker read
    its own (different) stack."""
    st = _stack()
    return st[-1].ctx if st else None


def _link_refs(links: Optional[Iterable[TraceContext]],
               attrs: Dict[str, Any]) -> Optional[List[Dict[str, str]]]:
    """Serialize a links list, bounding it at MAX_LINKS (overflow is
    recorded on the span so a truncated fan-in reads as truncated)."""
    if not links:
        return None
    refs = [c.ref() for c in links if c is not None]
    if len(refs) > MAX_LINKS:
        attrs["link_overflow"] = len(refs) - MAX_LINKS
        refs = refs[:MAX_LINKS]
    return refs or None


class Span:
    """One open span.  Use via :func:`span`; ``set(**attrs)`` attaches
    attributes any time before close.  ``ctx`` is the span's
    :class:`TraceContext` — readable after ``__enter__`` so the opener
    can hand ``sp.ctx.child()`` to another thread; ``link(ctx)`` attaches
    a span link any time before close."""

    __slots__ = ("name", "attrs", "span_id", "parent_id", "depth",
                 "ctx", "_parent_ctx", "_links",
                 "_ts", "_t0", "_annotation", "_recorded")

    def __init__(self, name: str, attrs: Dict[str, Any],
                 parent: Optional[TraceContext] = None,
                 links: Optional[Iterable[TraceContext]] = None) -> None:
        self.name = name
        self.attrs = attrs
        self.span_id = next(_ids)
        self.parent_id: Optional[int] = None
        self.depth = 0
        self._parent_ctx = parent
        self.ctx: Optional[TraceContext] = None
        self._links: List[TraceContext] = list(links) if links else []
        self._ts = time.time()
        self._t0 = time.perf_counter()
        self._annotation: Optional[ContextManager] = None
        self._recorded = False

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def link(self, ctx: Optional[TraceContext]) -> "Span":
        """Attach a span link (fan-in/fan-out peer) before close."""
        if ctx is not None:
            self._links.append(ctx)
        return self

    # -- context protocol ------------------------------------------------
    def __enter__(self) -> "Span":
        st = _stack()
        # resolve the span's identity: an EXPLICIT parent context wins —
        # the cross-thread handoff case, where this thread's stack
        # belongs to a DIFFERENT causal story and inheriting it would
        # file the span under the wrong parent (the pre-round-24 bug).
        # Else descend from this thread's innermost open span; else root
        # a fresh trace.
        if self._parent_ctx is not None:
            self.ctx = self._parent_ctx.child()
        elif st and st[-1].ctx is not None:
            self.ctx = st[-1].ctx.child()
            self.parent_id = st[-1].span_id
            self.depth = st[-1].depth + 1
        else:
            self.ctx = TraceContext(new_trace_id())
            if st:  # pre-context legacy nesting (factory-made spans)
                self.parent_id = st[-1].span_id
                self.depth = st[-1].depth + 1
        st.append(self)
        fac = _live_factory()
        if fac is not None:
            try:
                self._annotation = fac(self.name, self.attrs)
                self._annotation.__enter__()
            except Exception:  # noqa: BLE001 — a broken profiler bridge
                self._annotation = None  # must never take training down
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # close = read the host clock and append to the ring.  NOTHING
        # else belongs here — in particular no device pull (rule R10):
        # a span that must cover device time is recorded retroactively at
        # an accounted sync via record_span().
        dur = time.perf_counter() - self._t0
        if self._annotation is not None:
            try:
                self._annotation.__exit__(exc_type, exc, tb)
            except Exception:  # noqa: BLE001
                pass
            self._annotation = None
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:  # mis-nested close: drop self + anything above
            del st[st.index(self):]
        if not self._recorded:
            self._recorded = True
            if exc_type is not None:
                self.attrs.setdefault("error", exc_type.__name__)
            _append(self.name, self._ts, dur, self.attrs,
                    span_id=self.span_id, parent_id=self.parent_id,
                    depth=self.depth, ctx=self.ctx,
                    links=_link_refs(self._links, self.attrs))
        return None


class _NoopSpan:
    """Returned while telemetry is disabled: absorbs the protocol."""

    __slots__ = ()

    ctx: Optional[TraceContext] = None

    def set(self, **attrs: Any) -> "_NoopSpan":
        return self

    def link(self, ctx: Optional[TraceContext] = None) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NOOP = _NoopSpan()


def span(name: str, parent: Optional[TraceContext] = None,
         links: Optional[Iterable[TraceContext]] = None,
         **attrs: Any):
    """Open a nesting span around a host-side section.  Records a ring
    entry on close; mirrors into the installed device-annotation factory
    (torch.profiler's ``record_function``) while its gate holds.
    ``parent=`` names an explicit parent context (the cross-thread form —
    REQUIRED when the opener's causal parent lives on another thread's
    stack; rule R21 polices the serve/continual thread targets);
    ``links=`` attaches fan-in/fan-out peer contexts."""
    if not _metrics.enabled():
        return _NOOP
    if parent is not None and not parent.sampled:
        return _NOOP  # the request's admission-time sampling decision
    return Span(name, attrs, parent=parent, links=links)


def record_span(name: str, duration_s: float,
                ctx: Optional[TraceContext] = None,
                parent: Optional[TraceContext] = None,
                links: Optional[Iterable[TraceContext]] = None,
                **attrs: Any) -> None:
    """Record a span that ENDS NOW and lasted ``duration_s`` — the
    retroactive form for intervals anchored at an accounted sync point the
    caller just passed (async info resolve, ``sync_pull``).  Never touches
    a device value.

    Identity is explicit, never implicit-cross-thread: ``ctx=`` records
    under a pre-minted identity (so OTHER spans could already hold links
    to it — the serving batch/leg shape); ``parent=`` derives a fresh
    child of an explicit parent context; with neither, the span adopts
    this thread's innermost open span as parent when one exists (the
    training-loop form: ``windowed_round`` under ``boost_round``) and is
    otherwise a fresh root.  ``links=`` attaches peer contexts.  A
    context carrying ``sampled=False`` drops the record — that is the
    request-sampling contract."""
    if not _metrics.enabled():
        return
    attrs = dict(attrs)
    if ctx is not None:
        rec_ctx = ctx
    elif parent is not None:
        rec_ctx = parent.child()
    else:
        cur = current_context()
        rec_ctx = cur.child() if cur is not None else None
    if rec_ctx is not None and not rec_ctx.sampled:
        return
    dur = max(float(duration_s), 0.0)
    _append(name, time.time() - dur, dur, attrs, ctx=rec_ctx,
            links=_link_refs(links, attrs))


def _append(name: str, ts: float, dur: float, attrs: Dict[str, Any],
            span_id: Optional[int] = None, parent_id: Optional[int] = None,
            depth: int = 0, ctx: Optional[TraceContext] = None,
            links: Optional[List[Dict[str, str]]] = None) -> None:
    rec = {
        "name": name,
        "ts": ts,
        "dur": dur,
        "tid": threading.get_ident(),
        "depth": depth,
        "attrs": dict(attrs),
    }
    if span_id is not None:
        rec["id"] = span_id
    if parent_id is not None:
        rec["parent"] = parent_id
    if ctx is not None:
        rec["trace"] = ctx.trace_id
        rec["sid"] = ctx.span_id
        if ctx.parent_id is not None:
            rec["psid"] = ctx.parent_id
    if links:
        rec["links"] = links
    with _lock:
        if len(_ring) == _ring.maxlen:
            # the deque would evict silently — account the victim first
            _handle_eviction(_ring[0])
        _ring.append(rec)


def spans(name: Optional[str] = None) -> List[Dict[str, Any]]:
    """Finished spans currently in the ring (oldest first)."""
    with _lock:
        out = list(_ring)
    if name is not None:
        out = [s for s in out if s["name"] == name]
    return out


def spans_for_trace(trace_id: str,
                    span_list: Optional[List[Dict[str, Any]]] = None
                    ) -> List[Dict[str, Any]]:
    """Spans recorded DIRECTLY under ``trace_id`` (oldest first) — the
    trace_id-indexed retrieval over the live ring or a loaded span list.
    For the cross-trace closure (a request's batch/leg/hedge spans that
    live in sibling traces and connect via links) use
    :func:`trace_slice`."""
    if span_list is None:
        span_list = spans()
    return [s for s in span_list if s.get("trace") == trace_id]


def trace_slice(trace_id: str,
                span_list: Optional[List[Dict[str, Any]]] = None
                ) -> List[Dict[str, Any]]:
    """The CONNECTED trace: every span reachable from ``trace_id``'s own
    spans by following links in either direction, to a fixpoint.  This is
    what reconstructs one hedged, requeued request end-to-end — the
    request span links to the winning dispatch span, the failed legs and
    the requeue/hedge records link back to the request's context — across
    threads, replicas and (after :func:`merge_trace_files`) ranks.
    Membership is by link edge or direct trace membership only; an
    adopted foreign span does NOT pull in its whole home trace."""
    if span_list is None:
        span_list = spans()
    member = [s.get("trace") == trace_id for s in span_list]
    sids = {s["sid"] for s, m in zip(span_list, member)
            if m and "sid" in s}
    changed = True
    while changed:
        changed = False
        # sids every selected span points at (links + explicit parents)
        wanted = set(sids)
        for s, m in zip(span_list, member):
            if not m:
                continue
            for ref in s.get("links", ()):
                wanted.add(ref.get("sid"))
            if "psid" in s:
                wanted.add(s["psid"])
        for i, s in enumerate(span_list):
            if member[i]:
                continue
            sid = s.get("sid")
            hit = sid is not None and sid in wanted
            if not hit:
                hit = any(ref.get("sid") in sids
                          for ref in s.get("links", ()))
            if hit:
                member[i] = True
                if sid is not None:
                    sids.add(sid)
                changed = True
    return [s for s, m in zip(span_list, member) if m]


def reset_trace() -> None:
    """Clear the span ring (tests)."""
    with _lock:
        _ring.clear()
    _tls.stack = []


# ---------------------------------------------------------------------------
# Chrome-trace / Perfetto export
# ---------------------------------------------------------------------------

def to_chrome_trace(
        span_list: Optional[List[Dict[str, Any]]] = None) -> Dict[str, Any]:
    """Chrome Trace Event Format dict (complete "X" events, microsecond
    timestamps) that chrome://tracing and ui.perfetto.dev load directly.
    The raw span records ride along under ``"lgbmtpu"`` so the file
    round-trips through :func:`load_trace` / the obs CLI."""
    if span_list is None:
        span_list = spans()
    pid = os.getpid()
    events = []
    for s in span_list:
        args = dict(s.get("attrs", {}))
        if "trace" in s:
            # surface the causal identity to Perfetto/chrome queries —
            # the raw records under "lgbmtpu" stay the machine form
            args["trace"] = s["trace"]
            args["sid"] = s.get("sid")
        ev = {
            "name": s["name"],
            "cat": "lgbmtpu",
            "ph": "X",
            "ts": s["ts"] * 1e6,
            "dur": s["dur"] * 1e6,
            "pid": s.get("pid", pid),
            "tid": s.get("tid", 0),
            "args": args,
        }
        events.append(ev)
    return {
        "displayTimeUnit": "ms",
        "traceEvents": events,
        "lgbmtpu": {"schema": SCHEMA_TRACE, "spans": span_list},
    }


def write_trace(path: str,
                span_list: Optional[List[Dict[str, Any]]] = None) -> int:
    """Atomically write the Chrome-trace JSON for ``span_list`` (default:
    the live ring).  Returns the number of spans written."""
    doc = to_chrome_trace(span_list)
    _metrics._atomic_write_json(path, doc)
    return len(doc["traceEvents"])


def load_trace(path: str) -> Dict[str, Any]:
    """Load + validate a trace file written by :func:`write_trace`.
    Raises ValueError on anything that is not a schema-valid trace."""
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    validate_trace(doc)
    return doc


def merge_trace_files(paths: Sequence[str],
                      out_path: Optional[str] = None) -> Dict[str, Any]:
    """Fold per-rank / per-replica trace exports into ONE clock-aligned
    Chrome-trace document — the flight recorder's merge, completing the
    launcher's events/metrics/trace triad (``python -m lightgbm_tpu_torch.obs
    trace --merge`` is the CLI form).

    Every input is a :func:`write_trace` file.  Span ``ts`` is unix wall
    clock stamped at record time, so spans from one host (the launcher's
    worker processes) align natively; the merged timeline is the
    ts-sorted union.  Each source keeps its own Chrome ``pid`` lane
    (source index) and its spans gain a ``src`` field naming the input
    file, so a fleet-wide view separates ranks while trace ids and links
    join one request's story across them.  Missing inputs raise OSError;
    schema-invalid ones raise ValueError (a merge must never silently
    drop a rank's history).  With ``out_path`` the merged document is
    also written atomically."""
    merged: List[Dict[str, Any]] = []
    sources = []
    for idx, path in enumerate(paths):
        doc = load_trace(path)
        src = os.path.basename(str(path))
        span_list = doc["lgbmtpu"]["spans"]
        for s in span_list:
            s = dict(s)
            s["src"] = src
            s["pid"] = idx
            merged.append(s)
        ts_vals = [s["ts"] for s in span_list]
        sources.append({"src": src, "spans": len(span_list),
                        "ts_min": min(ts_vals) if ts_vals else None,
                        "ts_max": max(ts_vals) if ts_vals else None})
    merged.sort(key=lambda s: s["ts"])
    doc = to_chrome_trace(merged)
    doc["lgbmtpu"]["merged"] = {"sources": sources, "clock": "unix-wall"}
    if out_path:
        _metrics._atomic_write_json(out_path, doc)
    return doc


def validate_trace(doc: Any) -> None:
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        raise ValueError("not a Chrome-trace JSON document "
                         "(missing traceEvents list)")
    meta = doc.get("lgbmtpu")
    if not isinstance(meta, dict) or meta.get("schema") != SCHEMA_TRACE:
        raise ValueError(
            f"not a {SCHEMA_TRACE} trace: lgbmtpu.schema="
            f"{meta.get('schema')!r}" if isinstance(meta, dict)
            else "missing lgbmtpu trace metadata")
    if not isinstance(meta.get("spans"), list):
        raise ValueError("lgbmtpu.spans missing or mistyped")
