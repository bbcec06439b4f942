"""Process-wide metrics registry + structured event sink (docs/OBSERVABILITY.md).

The reference ships TIMETAG per-phase timers and "Time for X: Y s" summaries
(SURVEY §6.1/§6.2); a production serving/training system additionally needs
counters, latency percentiles, and machine-readable run artifacts.  This
module is that layer, with one hard design rule inherited from the round-7/8
budget protocol:

**Telemetry adds ZERO device dispatches and ZERO blocking syncs.**  Nothing
in this module imports jax or touches a device value.  Every device-derived
metric is recorded by a caller that already holds the value on the host —
the windowed grower's one-round-behind async info vector, the accounted
``sync_pull`` at a predict entry, the sanitizer's ``jax.monitoring``
listener — so enabling telemetry (it is default-on) cannot change the
dispatch/sync budgets that ``tests/test_retrace.py`` and
``tests/test_predict_budget.py`` pin.

Three primitives plus an event stream:

* :class:`Counter` — monotonic ``inc(n)``;
* :class:`Gauge` — last-write-wins ``set(v)``;
* :class:`Histogram` — bounded reservoir (cap 512, deterministic
  per-name-seeded sampling) with exact ``count``/``sum``/``min``/``max``
  and reservoir-estimated percentiles (p50/p90/p99);
* :func:`event` — a structured record appended to an in-memory ring
  (cap 4096) and, when a sink file is configured
  (``LGBMTPU_EVENTS_FILE`` env or :func:`set_events_file`), to a JSONL
  file — one JSON object per line, schema below.

Event schema (every record)::

    {"ts": <unix float>, "kind": <str>, "rank": <int|None>, ...fields}

``rank`` is read from ``LIGHTGBM_TPU_RANK`` so launcher workers stamp their
own records; ``parallel/launcher.py`` aggregates per-rank files into one
fleet-level JSONL.

Collectors bridge subsystems that keep their own authoritative counters
(``utils/sanitizer.py``'s dispatch/sync/compile ledger): a registered
collector is called at :func:`snapshot` time and its values merge into the
snapshot — zero per-event overhead, one read per snapshot.

Snapshots are plain JSON (schema ``lgbmtpu-metrics-v1``); render them as
Prometheus text exposition (:func:`render_prometheus`) or reference-style
log lines (:func:`render_lightgbm`), or via ``python -m lightgbm_tpu_torch.obs``.

Kept import-light (stdlib only) on purpose: utils/faults.py, the launcher's
thin worker processes, and checkpoint writers all record here without
paying a jax import.
"""

from __future__ import annotations

import collections
import json
import os
import random
import re
import tempfile
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional

SCHEMA = "lgbmtpu-metrics-v1"
RESERVOIR_CAP = 512
EVENT_RING_CAP = 4096
# exemplar freshness window: the kept witness outlier yields to ANY newer
# exemplar once it is this old, so a single cold-start spike cannot pin
# the series' exemplar forever
EXEMPLAR_TTL_S = 60.0
_PROM_PREFIX = "lgbmtpu_"

_lock = threading.RLock()
# dedicated event-sink IO leaf lock: the JSONL write/flush of an event
# record happens here, NOT under the registry ``_lock`` every counter
# inc contends on — a slow disk must never stall the hot metric paths
# (the L2 lock-lint finding this split fixed).  Order: never taken while
# holding ``_lock`` (both call sites release the registry lock first);
# the write-error path nests ``_lock`` INSIDE it, which is the one
# allowed direction.
_events_io_lock = threading.Lock()
# the process default (env-derived); Config application restores it for
# models that do not set telemetry= explicitly, so one model's
# telemetry=false cannot silently disable a later model's metrics_file=
DEFAULT_ENABLED: bool = os.environ.get("LGBMTPU_TELEMETRY", "1") != "0"
_enabled: bool = DEFAULT_ENABLED


def set_enabled(on: bool) -> None:
    """Process-wide switch (``telemetry=false`` Config param routes here).
    Disabling makes every record call a cheap no-op; existing values stay
    readable."""
    global _enabled
    with _lock:
        _enabled = bool(on)


def enabled() -> bool:
    return _enabled


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str) -> None:
        self.name = name
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if not _enabled:
            return
        with _lock:
            self._value += n

    @property
    def value(self) -> int:
        with _lock:
            return self._value


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str) -> None:
        self.name = name
        self._value = 0.0

    def set(self, v: float) -> None:
        if not _enabled:
            return
        with _lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with _lock:
            return self._value


class Histogram:
    """Bounded-reservoir distribution: exact count/sum/min/max, percentiles
    estimated from a RESERVOIR_CAP-sample reservoir (classic algorithm-R,
    seeded per name so runs are reproducible)."""

    __slots__ = ("name", "count", "total", "min", "max", "_samples", "_rng",
                 "_exemplar")

    def __init__(self, name: str) -> None:
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._samples: List[float] = []
        # stable per-name seed (str hash() is salted per process — crc32
        # keeps the "identical runs keep identical reservoirs" promise)
        self._rng = random.Random(zlib.crc32(name.encode("utf-8")))
        # OpenMetrics-style exemplar: the trace id of a WITNESS outlier —
        # {"trace_id", "value", "ts"} — so a latency series answers
        # "show me one request that actually looked like this tail"
        self._exemplar: Optional[Dict[str, Any]] = None

    def observe(self, v: float, always: bool = False,
                exemplar: Optional[str] = None) -> None:
        """``always=True`` records even while telemetry is disabled — for
        explicitly invoked profiling APIs (utils/profiling.py
        timed_section), where the call itself is the opt-in.
        ``exemplar=`` attaches a trace id witnessing this observation;
        the histogram keeps the witness of the LARGEST value seen in the
        trailing EXEMPLAR_TTL_S window (outliers win, a one-off spike
        ages out)."""
        if not (_enabled or always):
            return
        v = float(v)
        with _lock:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            if len(self._samples) < RESERVOIR_CAP:
                self._samples.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < RESERVOIR_CAP:
                    self._samples[j] = v
            if exemplar is not None:
                ex = self._exemplar
                now = time.time()
                if (ex is None or v >= ex["value"]
                        or now - ex["ts"] > EXEMPLAR_TTL_S):
                    self._exemplar = {"trace_id": str(exemplar),
                                      "value": v, "ts": now}

    @property
    def exemplar(self) -> Optional[Dict[str, Any]]:
        with _lock:
            return dict(self._exemplar) if self._exemplar else None

    def percentile(self, p: float) -> Optional[float]:
        with _lock:
            s = sorted(self._samples)
        return _percentile_of(s, p)

    def summary(self, include_samples: bool = False) -> Dict[str, Any]:
        """``include_samples=True`` attaches the raw reservoir — the form
        per-rank snapshot files carry so the launcher's fleet merge can
        recompute exact combined percentiles instead of averaging
        per-rank estimates."""
        with _lock:
            n, tot, lo, hi = self.count, self.total, self.min, self.max
            samples = list(self._samples) if include_samples else None
        out = {
            "count": n, "sum": tot, "min": lo, "max": hi,
            "p50": self.percentile(50), "p90": self.percentile(90),
            "p99": self.percentile(99),
        }
        if samples is not None:
            out["samples"] = samples
        ex = self.exemplar
        if ex is not None:
            out["exemplar"] = ex
        return out


class Registry:
    """One process-wide instance (:data:`REGISTRY`); separate instances
    exist only for tests."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._collectors: Dict[str, Callable[[], Dict[str, Dict[str, float]]]] = {}
        self._events: "collections.deque" = collections.deque(
            maxlen=EVENT_RING_CAP)
        self._events_total = 0
        self._events_path: Optional[str] = None
        self._events_fh = None
        # sink resolution happens ONCE (explicit path, else the env var);
        # a failed open stays failed — no per-event retry, no silent
        # fallback from an explicit path to the env-configured one
        self._events_resolved = False
        self._rank = _rank_from_env()

    # -- metric accessors (create-on-first-use) -------------------------
    def counter(self, name: str) -> Counter:
        with _lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with _lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str) -> Histogram:
        with _lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name)
            return h

    def histogram_items(self, prefix: str = "") -> Dict[str, Histogram]:
        with _lock:
            return {n: h for n, h in self._histograms.items()
                    if n.startswith(prefix)}

    def clear_prefix(self, prefix: str) -> None:
        """Drop metrics whose name starts with ``prefix`` (the profiling
        module's ``log_timings(reset=True)`` semantics)."""
        with _lock:
            for table in (self._counters, self._gauges, self._histograms):
                for name in [n for n in table if n.startswith(prefix)]:
                    del table[name]

    # -- collectors ------------------------------------------------------
    def register_collector(
            self, name: str,
            fn: Callable[[], Dict[str, Dict[str, float]]]) -> None:
        """``fn`` returns ``{"counters": {...}, "gauges": {...}}`` merged at
        snapshot time — for subsystems keeping their own ledgers
        (utils/sanitizer.py).  Re-registration under the same name
        replaces (idempotent module reloads)."""
        with _lock:
            self._collectors[name] = fn

    def unregister_collector(self, name: str) -> None:
        """Drop a registered collector (no-op when absent).  For
        launch-scoped collectors like the launcher's ``fleet_live``
        (which deliberately outlives its run for post-mortem scrapes of
        the LAUNCHER's endpoint): tests probing process health after a
        faulted launch must drop it, or the dead fleet's on-disk
        counters keep flipping /healthz degraded — ``reset()`` cannot,
        since the sanitizer-ledger collectors must survive it."""
        with _lock:
            self._collectors.pop(name, None)

    # -- events ----------------------------------------------------------
    def set_events_file(self, path: Optional[str]) -> None:
        """Explicit sink path; ``None`` reverts to env-var resolution
        (``LGBMTPU_EVENTS_FILE``) at the next event."""
        with _lock:
            fh, self._events_fh = self._events_fh, None
            self._events_path = path
            self._events_resolved = False
        if fh is not None:
            # close on the IO leaf lock so it serializes with in-flight
            # sink writes instead of stalling registry readers
            with _events_io_lock:
                try:
                    fh.close()  # jaxlint: disable=L2 (dedicated event-sink IO leaf lock; guards only the fh)
                except OSError:
                    pass

    def event(self, kind: str, **fields: Any) -> None:
        if not _enabled:
            return
        rec = {"ts": time.time(), "kind": kind, "rank": self._rank}
        rec.update(fields)
        with _lock:
            self._events.append(rec)
            self._events_total += 1
            if not self._events_resolved:
                self._events_resolved = True
                path = self._events_path or os.environ.get(
                    "LGBMTPU_EVENTS_FILE")
                if path:
                    try:
                        # one-time sink arm (first event only): the open
                        # stays under the registry lock so exactly one
                        # resolution wins; steady-state writes do not
                        # pass through here
                        self._events_fh = open(path, "a", encoding="utf-8")  # jaxlint: disable=L2 (one-time sink arm on the first event, not a steady-state path)
                        self._events_path = path
                    except OSError:
                        self._events_fh = None  # stays failed: no
                        # per-event retry, no fallback to another path
            fh = self._events_fh
        if fh is None:
            return
        # sink write OUTSIDE the registry lock: a slow disk stalls only
        # other event writers (this leaf lock), never counter/gauge/
        # histogram updates.  A concurrent set_events_file may have
        # detached fh since the snapshot — the identity re-check makes
        # the stale writer skip instead of writing to a closed handle.
        # File line order can differ from ring order across racing
        # events; records carry ts.
        with _events_io_lock:
            if fh is not self._events_fh:
                return
            try:
                fh.write(json.dumps(rec, default=str) + "\n")  # jaxlint: disable=L2 (dedicated event-sink IO leaf lock; guards only the fh)
                fh.flush()  # jaxlint: disable=L2 (dedicated event-sink IO leaf lock; guards only the fh)
            except (OSError, ValueError):
                with _lock:
                    if self._events_fh is fh:
                        self._events_fh = None

    def events(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        with _lock:
            out = list(self._events)
        if kind is not None:
            out = [e for e in out if e.get("kind") == kind]
        return out

    # -- snapshot --------------------------------------------------------
    def snapshot(self, include_samples: bool = False) -> Dict[str, Any]:
        with _lock:
            counters = {n: c.value for n, c in self._counters.items()}
            gauges = {n: g.value for n, g in self._gauges.items()}
            # capture the Histogram OBJECTS under the lock: a concurrent
            # clear_prefix()/reset() may drop map entries, but captured
            # objects stay summarizable
            hist_objs = dict(self._histograms)
            collectors = list(self._collectors.items())
            events_total = self._events_total
        hists = {n: h.summary(include_samples=include_samples)
                 for n, h in hist_objs.items()}
        for cname, fn in collectors:
            try:
                extra = fn() or {}
            except Exception:  # noqa: BLE001 — a broken collector must
                continue  # never take the snapshot (or a run report) down
            for n, v in (extra.get("counters") or {}).items():
                counters[n] = int(v)
            for n, v in (extra.get("gauges") or {}).items():
                gauges[n] = float(v)
        return {
            "schema": SCHEMA,
            "ts": time.time(),
            "enabled": _enabled,
            "rank": self._rank,
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
            "events_total": events_total,
        }

    def reset(self) -> None:
        """Clear metrics and events (tests only).  Registered collectors
        survive — their backing ledgers are process-cumulative and owned
        elsewhere (utils/sanitizer.py)."""
        with _lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._events.clear()
            self._events_total = 0
            self._rank = _rank_from_env()


def _percentile_of(sorted_samples: List[float], p: float) -> Optional[float]:
    if not sorted_samples:
        return None
    k = min(int(round((p / 100.0) * (len(sorted_samples) - 1))),
            len(sorted_samples) - 1)
    return sorted_samples[k]


def _rank_from_env() -> Optional[int]:
    # events/snapshots stamp the fleet-GLOBAL worker id when the launcher
    # set one: multi-slice fleets reuse slice-local rendezvous ranks per
    # slice (parallel/launcher.py), so LIGHTGBM_TPU_RANK alone would
    # attribute two different processes' records to one rank in the
    # merged fleet flight recorder
    r = os.environ.get("LGBM_TPU_WORKER_ID",
                       os.environ.get("LIGHTGBM_TPU_RANK"))
    try:
        return int(r) if r is not None else None
    except ValueError:
        return None


REGISTRY = Registry()

# module-level conveniences bound to the process registry
counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
event = REGISTRY.event
events = REGISTRY.events
snapshot = REGISTRY.snapshot
reset = REGISTRY.reset
register_collector = REGISTRY.register_collector
unregister_collector = REGISTRY.unregister_collector
set_events_file = REGISTRY.set_events_file
histogram_items = REGISTRY.histogram_items
clear_prefix = REGISTRY.clear_prefix


# ---------------------------------------------------------------------------
# snapshot persistence + validation
# ---------------------------------------------------------------------------

def _atomic_write_json(path: str, obj: Any) -> None:
    """Same-dir temp + ``os.replace``.  Deliberately NOT routed through
    utils/checkpoint.py: metrics/trace writes must not count as model
    checkpoint writes nor arm the snapshot_write fault site."""
    path = os.fspath(path)
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".tmp.", dir=d)
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as fh:
            json.dump(obj, fh, indent=1, default=str)
            fh.write("\n")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_snapshot(path: str, snap: Optional[Dict[str, Any]] = None,
                   include_samples: bool = False) -> None:
    """Write a snapshot as JSON, atomically.  ``include_samples`` (used by
    the per-rank periodic writer) attaches raw reservoirs so a fleet merge
    can recompute exact combined percentiles."""
    if snap is None:
        snap = snapshot(include_samples=include_samples)
    _atomic_write_json(path, snap)


def load_snapshot(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as fh:
        snap = json.load(fh)
    validate_snapshot(snap)
    return snap


def validate_snapshot(snap: Dict[str, Any]) -> None:
    """Raise ValueError unless ``snap`` is a schema-valid metrics snapshot
    (the contract bench artifacts and tests assert)."""
    if not isinstance(snap, dict) or snap.get("schema") != SCHEMA:
        raise ValueError(
            f"not a {SCHEMA} snapshot: schema={snap.get('schema')!r}"
            if isinstance(snap, dict) else "snapshot is not a JSON object")
    for key, typ in (("counters", dict), ("gauges", dict),
                     ("histograms", dict), ("events_total", int),
                     ("ts", (int, float))):
        if not isinstance(snap.get(key), typ):
            raise ValueError(f"snapshot field {key!r} missing or mistyped")
    for table in ("counters", "gauges"):
        for name, v in snap[table].items():
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                raise ValueError(
                    f"{table} entry {name!r} is not numeric: {v!r}")
    for name, h in snap["histograms"].items():
        if not isinstance(h, dict) or "count" not in h or "sum" not in h:
            raise ValueError(f"histogram {name!r} missing count/sum")


# ---------------------------------------------------------------------------
# rendering: Prometheus text exposition + reference-style log lines
# ---------------------------------------------------------------------------

def labeled(name: str, **labels: Any) -> str:
    """A metric name carrying Prometheus labels: ``labeled("x", bucket=128)``
    -> ``x{bucket="128"}``.  The registry treats the result as an opaque
    name; :func:`render_prometheus` splits it back so the exposition gets a
    real label set (and merges quantile labels for histograms).  Labels on
    an already-labeled name merge (sorted by key)."""
    base, existing = _split_labels(name)
    merged = dict(_parse_labels(existing))
    merged.update({k: str(v) for k, v in labels.items()})
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(merged.items()))
    return f"{base}{{{inner}}}" if inner else base


def _split_labels(name: str) -> tuple:
    """``x{bucket="128"}`` -> ("x", 'bucket="128"'); plain names pass
    through with an empty label string."""
    if name.endswith("}") and "{" in name:
        base, _, rest = name.partition("{")
        return base, rest[:-1]
    return name, ""


def _parse_labels(label_str: str) -> List[tuple]:
    return [(m.group(1), m.group(2)) for m in
            re.finditer(r'(\w+)="([^"]*)"', label_str)]


def _prom_name(name: str) -> str:
    return _PROM_PREFIX + re.sub(r"[^a-zA-Z0-9_]", "_", name)


def render_prometheus(snap: Optional[Dict[str, Any]] = None) -> str:
    """Prometheus text exposition (counters/gauges plus summary-style
    quantiles for histograms).  Names written via :func:`labeled` render
    with real label sets; a ``# TYPE`` line is emitted once per base
    family."""
    if snap is None:
        snap = snapshot()
    lines = [f"# lightgbm_tpu metrics ({snap.get('schema')})"]
    typed = set()

    def emit(name, typ):
        base, labels = _split_labels(name)
        pn = _prom_name(base)
        if pn not in typed:
            typed.add(pn)
            lines.append(f"# TYPE {pn} {typ}")
        return pn, labels

    for name in sorted(snap.get("counters", {})):
        pn, labels = emit(name, "counter")
        sfx = f"{{{labels}}}" if labels else ""
        lines.append(f"{pn}{sfx} {snap['counters'][name]}")
    for name in sorted(snap.get("gauges", {})):
        pn, labels = emit(name, "gauge")
        sfx = f"{{{labels}}}" if labels else ""
        lines.append(f"{pn}{sfx} {snap['gauges'][name]}")
    for name in sorted(snap.get("histograms", {})):
        h = snap["histograms"][name]
        pn, labels = emit(name, "summary")
        sfx = f"{{{labels}}}" if labels else ""
        pre = labels + "," if labels else ""
        for q, key in (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99")):
            v = h.get(key)
            if v is not None:
                lines.append(f'{pn}{{{pre}quantile="{q}"}} {v}')
        lines.append(f"{pn}_sum{sfx} {h.get('sum', 0.0)}")
        ex = h.get("exemplar")
        if isinstance(ex, dict) and ex.get("trace_id"):
            # OpenMetrics exemplar syntax on the count series: the trace
            # id of a witness outlier, so the latency family answers
            # "show me one real request from this tail" (the trace CLI's
            # --trace-id form reconstructs it from the flight recorder)
            lines.append(
                f"{pn}_count{sfx} {h.get('count', 0)} "
                f'# {{trace_id="{ex["trace_id"]}"}} '
                f"{ex.get('value')} {ex.get('ts')}")
        else:
            lines.append(f"{pn}_count{sfx} {h.get('count', 0)}")
    ev = snap.get("events_total")
    if ev is not None:
        pn = _prom_name("events_total")
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {ev}")
    return "\n".join(lines) + "\n"


SECTION_PREFIX = "section_seconds."


def render_lightgbm(snap: Optional[Dict[str, Any]] = None) -> List[str]:
    """Reference-log-style end-of-run report lines: the TIMETAG "Time for
    X: Y s" section tallies first, then one line per counter/gauge."""
    if snap is None:
        snap = snapshot()
    lines: List[str] = []
    hists = snap.get("histograms", {})
    sections = {n[len(SECTION_PREFIX):]: h for n, h in hists.items()
                if n.startswith(SECTION_PREFIX)}
    for name in sorted(sections, key=lambda n: -sections[n].get("sum", 0.0)):
        h = sections[name]
        lines.append(
            f"Time for {name}: {h.get('sum', 0.0):.6f} s "
            f"({h.get('count', 0)} calls)")
    for name in sorted(snap.get("counters", {})):
        lines.append(f"{name} = {snap['counters'][name]}")
    for name in sorted(snap.get("gauges", {})):
        lines.append(f"{name} = {snap['gauges'][name]:g}")
    for name in sorted(hists):
        if name.startswith(SECTION_PREFIX):
            continue
        h = hists[name]
        if not h.get("count"):
            continue
        lines.append(
            f"{name}: count={h['count']} p50={h.get('p50')} "
            f"p99={h.get('p99')} max={h.get('max')}")
    return lines


# ---------------------------------------------------------------------------
# fleet event aggregation (parallel/launcher.py)
# ---------------------------------------------------------------------------

def merge_event_files(paths: List[str], out_path: str) -> int:
    """Merge per-rank JSONL event files into one fleet-level JSONL sorted by
    timestamp; malformed lines are skipped (a crashed worker may have torn
    its last record).  Returns the number of merged records."""
    records: List[Dict[str, Any]] = []
    for p in paths:
        try:
            with open(p, encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(rec, dict):
                        records.append(rec)
        except OSError:
            continue
    records.sort(key=lambda r: r.get("ts", 0.0))
    with open(out_path, "w", encoding="utf-8") as fh:
        for rec in records:
            fh.write(json.dumps(rec, default=str) + "\n")
    return len(records)


# ---------------------------------------------------------------------------
# fleet metrics aggregation (parallel/launcher.py)
# ---------------------------------------------------------------------------

FLEET_SCHEMA = "lgbmtpu-fleet-metrics-v1"


def _merge_hist_summaries(summaries: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge per-rank histogram summaries: count/sum/min/max combine
    exactly; percentiles recompute from the concatenated reservoirs when
    the snapshots carry samples (``include_samples=True``, the per-rank
    writer default), else fall back to a count-weighted average of the
    per-rank estimates (approximate, better than dropping them)."""
    count = sum(int(s.get("count") or 0) for s in summaries)
    total = sum(float(s.get("sum") or 0.0) for s in summaries)
    mins = [s["min"] for s in summaries if s.get("min") is not None]
    maxs = [s["max"] for s in summaries if s.get("max") is not None]
    out: Dict[str, Any] = {
        "count": count, "sum": total,
        "min": min(mins) if mins else None,
        "max": max(maxs) if maxs else None,
    }
    exemplars = [s["exemplar"] for s in summaries
                 if isinstance(s.get("exemplar"), dict)
                 and s["exemplar"].get("trace_id")]
    if exemplars:
        # fleet-wide witness: the worst outlier any rank saw
        out["exemplar"] = max(
            exemplars, key=lambda e: float(e.get("value") or 0.0))
    samples: List[float] = []
    for s in summaries:
        samples.extend(s.get("samples") or [])
    if samples:
        samples.sort()
        for key, p in (("p50", 50), ("p90", 90), ("p99", 99)):
            out[key] = _percentile_of(samples, p)
        return out
    for key in ("p50", "p90", "p99"):
        num = den = 0.0
        for s in summaries:
            v, c = s.get(key), int(s.get("count") or 0)
            if v is not None and c > 0:
                num += v * c
                den += c
        out[key] = (num / den) if den else None
    return out


def merge_snapshot_files(paths: List[str],
                         out_path: Optional[str] = None) -> Dict[str, Any]:
    """Merge per-rank snapshot files into one fleet-level document (schema
    ``lgbmtpu-fleet-metrics-v1``): counters SUM, gauges MAX, histogram
    reservoirs merge (:func:`_merge_hist_summaries`), ``events_total``
    sums.  Missing or invalid rank files are skipped, not fatal — a
    crashed worker leaves whatever its periodic writer got out, possibly
    nothing, and the fleet artifact must still be written on kill paths.
    ``out_path`` additionally writes the document atomically."""
    ranks: Dict[str, Dict[str, Any]] = {}
    skipped: List[str] = []
    for i, p in enumerate(paths):
        try:
            snap = load_snapshot(p)
        except (OSError, ValueError):
            skipped.append(os.path.basename(os.fspath(p)))
            continue
        rank = snap.get("rank")
        ranks[str(rank if rank is not None else i)] = snap
    counters: Dict[str, int] = {}
    gauges: Dict[str, float] = {}
    hist_parts: Dict[str, List[Dict[str, Any]]] = {}
    events_total = 0
    for snap in ranks.values():
        for n, v in snap["counters"].items():
            counters[n] = counters.get(n, 0) + int(v)
        for n, v in snap["gauges"].items():
            gauges[n] = max(gauges.get(n, float("-inf")), float(v))
        for n, h in snap["histograms"].items():
            hist_parts.setdefault(n, []).append(h)
        events_total += int(snap.get("events_total") or 0)
    fleet = {
        "schema": FLEET_SCHEMA,
        "ts": time.time(),
        "num_ranks": len(ranks),
        "skipped": skipped,
        "ranks": ranks,
        "aggregate": {
            "counters": counters,
            "gauges": gauges,
            "histograms": {n: _merge_hist_summaries(parts)
                           for n, parts in hist_parts.items()},
            "events_total": events_total,
        },
    }
    if out_path is not None:
        _atomic_write_json(out_path, fleet)
    return fleet


def load_fleet_metrics(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as fh:
        fleet = json.load(fh)
    validate_fleet_metrics(fleet)
    return fleet


def validate_fleet_metrics(fleet: Any) -> None:
    """Raise ValueError unless ``fleet`` is a schema-valid fleet metrics
    document (one entry per rank plus the aggregate)."""
    if not isinstance(fleet, dict) or fleet.get("schema") != FLEET_SCHEMA:
        raise ValueError(
            f"not a {FLEET_SCHEMA} document: schema={fleet.get('schema')!r}"
            if isinstance(fleet, dict) else "fleet metrics not a JSON object")
    if not isinstance(fleet.get("ranks"), dict):
        raise ValueError("fleet field 'ranks' missing or mistyped")
    for rank, snap in fleet["ranks"].items():
        try:
            validate_snapshot(snap)
        except ValueError as e:
            raise ValueError(f"rank {rank}: {e}") from None
    agg = fleet.get("aggregate")
    if not isinstance(agg, dict):
        raise ValueError("fleet field 'aggregate' missing or mistyped")
    for key in ("counters", "gauges", "histograms"):
        if not isinstance(agg.get(key), dict):
            raise ValueError(f"aggregate field {key!r} missing or mistyped")


def render_prometheus_fleet(fleet: Dict[str, Any]) -> str:
    """Prometheus exposition for a fleet document: the aggregate unlabeled
    plus every per-rank series re-labeled ``{rank="<r>"}``."""
    agg = fleet["aggregate"]
    counters = dict(agg.get("counters", {}))
    gauges = dict(agg.get("gauges", {}))
    hists = dict(agg.get("histograms", {}))
    for rank, snap in sorted(fleet.get("ranks", {}).items()):
        for n, v in snap.get("counters", {}).items():
            counters[labeled(n, rank=rank)] = v
        for n, v in snap.get("gauges", {}).items():
            gauges[labeled(n, rank=rank)] = v
        for n, h in snap.get("histograms", {}).items():
            hists[labeled(n, rank=rank)] = h
    pseudo = {
        "schema": fleet.get("schema"),
        "counters": counters,
        "gauges": gauges,
        "histograms": hists,
        "events_total": agg.get("events_total"),
    }
    return render_prometheus(pseudo)


# ---------------------------------------------------------------------------
# periodic snapshot writer (per-rank flight recorder for the fleet merge)
# ---------------------------------------------------------------------------

_snap_writer_lock = threading.Lock()
_snap_writer: Optional[tuple] = None  # (thread, stop_event, path)


def start_periodic_snapshots(path: str, period_s: float = 1.0,
                             include_samples: bool = True) -> None:
    """Write the registry snapshot to ``path`` atomically NOW and then
    every ``period_s`` seconds from a daemon thread — the per-rank flight
    recorder the launcher merges into ``fleet_metrics.json``.  Writing
    first (not after the first sleep) means even a worker that dies in
    its first iteration leaves a mergeable file.  One writer per process;
    restarting moves it to the new path."""
    stop_periodic_snapshots()
    stop = threading.Event()

    def _loop() -> None:
        while True:
            try:
                write_snapshot(path, include_samples=include_samples)
            except OSError:
                pass  # a full disk must not kill the worker
            if stop.wait(max(period_s, 0.05)):
                return

    t = threading.Thread(target=_loop, daemon=True,
                         name="lgbmtpu-metrics-snapshots")
    global _snap_writer
    with _snap_writer_lock:
        _snap_writer = (t, stop, path)
    t.start()


def stop_periodic_snapshots(final_write: bool = True) -> None:
    """Stop the periodic writer; by default flush one last exact snapshot
    so a clean exit's file is not one period stale."""
    global _snap_writer
    with _snap_writer_lock:
        writer, _snap_writer = _snap_writer, None
    if writer is None:
        return
    t, stop, path = writer
    stop.set()
    t.join(timeout=5)
    if final_write:
        try:
            write_snapshot(path, include_samples=True)
        except OSError:
            pass
