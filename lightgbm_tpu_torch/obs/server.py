"""In-process HTTP metrics/health endpoint (docs/OBSERVABILITY.md).

A long-lived training or serving process needs a scrape target, not a
file dropped at exit: this module serves the live registry over a
daemon-threaded stdlib ``http.server`` (no third-party deps, no jax —
``lightgbm_tpu_torch/obs`` stays stdlib-only).  Routes:

* ``GET /metrics``  — Prometheus text exposition of the live snapshot
  (train + serve + fault-tolerance families, per-bucket latency labels);
* ``GET /healthz``  — watchdog/degrade/nonfinite-aware status JSON.
  ``200 {"status": "ok" | "degraded"}`` or ``503 {"status":
  "unhealthy"}``; "degraded" means the process is still making progress
  on a fallback path (a Pallas kernel degraded to XLA, a fleet relaunch,
  a checkpoint fallback), "unhealthy" means data or fleet integrity
  tripped (non-finite guard, worker death, watchdog timeout, torn
  checkpoint);
* ``GET /snapshot`` — the raw JSON snapshot (schema lgbmtpu-metrics-v1);
* ``GET /events?tail=N[&kind=K]`` — the newest N ring events as NDJSON;
* ``POST /predict`` — the serving front door (JSON rows in, predictions
  out), routed through whatever ServingRuntime/ServingFleet registered
  itself via :func:`set_predict_handler`: shed -> 429, deadline -> 504,
  unhealthy/stopped -> 503 (see lightgbm_tpu_torch/serve).

Opt-in and lifecycle: ``metrics_port=`` (Config/CLI) or
``LGBMTPU_METRICS_PORT`` starts the singleton on engine.train entry
(port 0 = ephemeral, ``server.port`` reports the bind).  The server binds
``127.0.0.1`` by default — the exposition includes operational detail
(paths, fault sites), so exposing it beyond the host is an explicit
``LGBMTPU_METRICS_HOST`` decision.  Serving happens on daemon threads, so
neither a normal exit nor the launcher's process-group kill paths can be
held open by a scrape; an atexit hook additionally closes the socket
cleanly on interpreter shutdown, and :func:`stop_server` does so on
demand.  If the requested port is already bound, the server falls back to
an ephemeral port (counted in ``metrics_server_port_fallbacks_total``)
rather than failing the training run — a telemetry endpoint must never
cost the caller a model.
"""

from __future__ import annotations

import atexit
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import os

from . import metrics as _metrics

DEFAULT_HOST = "127.0.0.1"

# (counter, problem description) tables driving /healthz.  Severity is the
# counter's meaning, not its size: one non-finite round is already a data
# integrity failure, one degrade flip is already a permanent fallback.
UNHEALTHY_COUNTERS = (
    ("train_nonfinite_errors_total", "non-finite gradients/hessians/stats"),
    ("launcher_worker_deaths_total", "launcher worker died"),
    ("launcher_timeouts_total", "launcher watchdog timeout"),
    ("checkpoint_torn_total", "torn checkpoint detected"),
    ("fleet_hangs_total", "hung rank detected by the heartbeat watchdog"),
)
DEGRADED_COUNTERS = (
    ("degrade_disabled_total", "Pallas kernel degraded to XLA fallback"),
    ("launcher_relaunches_total", "fleet relaunched after a failure"),
    ("train_windowed_retries_total", "windowed W-bound prediction retries"),
    ("checkpoint_fallbacks_total", "resume fell back to an older snapshot"),
    ("fleet_resumes_total", "fleet resumed from a checkpoint round"),
    ("faults_injected_total", "injected faults fired (test harness armed)"),
    ("continual_update_failures_total",
     "continual update failed; serving continues on the previous ensemble"),
    ("lock_order_violations_total",
     "lock-order inversion witnessed by the runtime lock sanitizer"),
)
# gauge-driven degraded states: unlike the cumulative counters above these
# are CURRENT conditions — the serving runtime sets serve_shedding to 1
# while it refuses submissions (queue bound / tenant quota / p99 SLO /
# unhealthy process, lightgbm_tpu_torch/serve) and back to 0 when admissions
# resume, so /healthz flips degraded exactly for the shedding interval
DEGRADED_GAUGES = (
    ("serve_shedding", "serving runtime is shedding load (Overloaded)"),
    # armed by the continual runner's staleness_slo_s: the serving
    # ensemble has un-incorporated ingest older than the SLO — stale
    # predictions, still correct ones (lightgbm_tpu_torch/continual)
    ("continual_staleness_exceeded",
     "serving model is stale past the continual staleness SLO"),
    # set by the serving fleet (lightgbm_tpu_torch/serve/fleet.py) while ANY
    # replica is not in active rotation (ejected / half-open / dead /
    # restarting) — requests still serve on the healthy replicas, so
    # this is degradation, not unavailability
    ("serve_fleet_degraded",
     "serving fleet has replicas out of rotation"),
)

# ---------------------------------------------------------------------------
# serve-layer hooks: obs stays stdlib-only (no jax, no serve import), so the
# serving runtime REGISTERS callables here instead of being imported —
# /predict routes through the hook, /healthz merges the replica table
# ---------------------------------------------------------------------------

_predict_fn: Optional[Callable[..., Tuple]] = None
_health_extra_fn: Optional[Callable[[], Dict[str, Any]]] = None


def set_predict_handler(fn: Callable[..., Tuple]) -> None:
    """Attach the process's ``POST /predict`` handler.  The current
    contract is ``fn(payload, traceparent=None) -> (http_status,
    body_dict, traceparent_out)`` — the inbound W3C header (or None)
    goes in, the outbound header (or None) comes back and is emitted on
    the response.  A legacy 2-tuple handler ``fn(payload) -> (status,
    body)`` still works (no trace header either way).  Last registration
    wins — one process, one front door."""
    global _predict_fn
    _predict_fn = fn


def clear_predict_handler(fn) -> None:
    """Detach ``fn`` if it is the current handler (a stopped runtime must
    not unregister its successor's route)."""
    global _predict_fn
    if _predict_fn == fn:
        _predict_fn = None


def set_health_extra(fn: Callable[[], Dict[str, Any]]) -> None:
    """Attach a callable whose dict is merged into the /healthz body under
    ``"serve_fleet"`` — the replica state table."""
    global _health_extra_fn
    _health_extra_fn = fn


def clear_health_extra(fn) -> None:
    global _health_extra_fn
    if _health_extra_fn == fn:
        _health_extra_fn = None


def health(snap: Optional[Dict[str, Any]] = None) -> Tuple[int, Dict[str, Any]]:
    """(http_status, body) for /healthz, derived from the snapshot's
    counters (live registry when ``snap`` is None).  Pure host-side reads
    — the health probe adds zero device work, like everything in obs."""
    if snap is None:
        snap = _metrics.snapshot()
    counters = snap.get("counters", {})
    gauges = snap.get("gauges", {})
    problems: List[Dict[str, Any]] = []
    status = "ok"
    for table, severity in ((UNHEALTHY_COUNTERS, "unhealthy"),
                            (DEGRADED_COUNTERS, "degraded")):
        for name, why in table:
            # labeled variants count against the base family too
            n = sum(int(v) for cn, v in counters.items()
                    if _metrics._split_labels(cn)[0] == name)
            if n > 0:
                problems.append({"counter": name, "count": n, "why": why,
                                 "severity": severity})
                if severity == "unhealthy":
                    status = "unhealthy"
                elif status == "ok":
                    status = "degraded"
    shedding = False
    for name, why in DEGRADED_GAUGES:
        v = float(gauges.get(name, 0.0))
        if v:
            problems.append({"gauge": name, "value": v, "why": why,
                             "severity": "degraded"})
            if status == "ok":
                status = "degraded"
            if name == "serve_shedding":
                shedding = True
    body = {
        "status": status,
        "problems": problems,
        "shedding": shedding,
        "telemetry_enabled": bool(snap.get("enabled", True)),
        "rank": snap.get("rank"),
        "ts": snap.get("ts"),
    }
    extra = _health_extra_fn
    if extra is not None:
        try:
            body["serve_fleet"] = extra()
        except Exception:  # noqa: BLE001 — a health probe must not 500
            body["serve_fleet"] = {"error": "replica table unavailable"}
    return (503 if status == "unhealthy" else 200), body


def _make_handler(server: "MetricsServer"):
    class Handler(BaseHTTPRequestHandler):
        server_version = "lgbmtpu-obs"
        protocol_version = "HTTP/1.1"

        def log_message(self, *args) -> None:  # noqa: D102, ARG002
            pass  # a scrape every few seconds must not spam the run log

        def _send(self, code: int, body: bytes, ctype: str,
                  headers: Optional[Dict[str, str]] = None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
            try:
                url = urlparse(self.path)
                route = url.path.rstrip("/") or "/"
                if route == "/metrics":
                    text = _metrics.render_prometheus(server.snapshot_fn())
                    self._send(200, text.encode("utf-8"),
                               "text/plain; version=0.0.4; charset=utf-8")
                elif route == "/healthz":
                    code, body = server.health_fn()
                    self._send(code, (json.dumps(body, default=str) + "\n")
                               .encode("utf-8"), "application/json")
                elif route == "/snapshot":
                    self._send(200, (json.dumps(server.snapshot_fn(),
                                                indent=1, default=str) + "\n")
                               .encode("utf-8"), "application/json")
                elif route == "/events":
                    q = parse_qs(url.query)
                    try:
                        tail = int(q.get("tail", ["100"])[0])
                    except ValueError:
                        tail = 100
                    kind = q.get("kind", [None])[0]
                    evs = server.events_fn(kind)
                    if tail >= 0:
                        evs = evs[-tail:]
                    body = "".join(json.dumps(e, default=str) + "\n"
                                   for e in evs)
                    self._send(200, body.encode("utf-8"),
                               "application/x-ndjson")
                elif route == "/predict":
                    self._send(405, b'{"error": "use POST /predict"}\n',
                               "application/json")
                else:
                    self._send(404, b"not found\n", "text/plain")
            except BrokenPipeError:
                pass  # the scraper hung up mid-response
            except Exception as e:  # noqa: BLE001 — endpoint must not die
                try:
                    self._send(500, f"error: {e}\n".encode("utf-8"),
                               "text/plain")
                except OSError:
                    pass

        def do_POST(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
            try:
                route = urlparse(self.path).path.rstrip("/") or "/"
                if route != "/predict":
                    self._send(404, b"not found\n", "text/plain")
                    return
                fn = _predict_fn
                if fn is None:
                    self._send(503, b'{"error": "unavailable", "detail": '
                                    b'"no serving runtime attached"}\n',
                               "application/json")
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0) or 0)
                except ValueError:
                    n = 0
                if n > 32 << 20:
                    self._send(413, b'{"error": "payload too large"}\n',
                               "application/json")
                    return
                try:
                    payload = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:
                    self._send(400, b'{"error": "bad_request", "detail": '
                                    b'"body is not valid JSON"}\n',
                               "application/json")
                    return
                # distributed tracing (docs/OBSERVABILITY.md "Request
                # tracing"): the inbound W3C traceparent (if any) is
                # handed to the runtime, which mints the request context
                # from it; the response ALWAYS names the request's trace
                # — body trace_id + outbound traceparent header — so a
                # caller can join its own trace to the flight recorder.
                tp_in = self.headers.get("traceparent")
                try:
                    code, body, tp_out = fn(payload, traceparent=tp_in)
                except TypeError:
                    # a legacy 1-arg handler (tests / external hooks)
                    code, body = fn(payload)
                    tp_out = None
                self._send(code, (json.dumps(body, default=str) + "\n")
                           .encode("utf-8"), "application/json",
                           headers={"traceparent": tp_out} if tp_out
                           else None)
            except BrokenPipeError:
                pass  # the client hung up mid-response
            except Exception as e:  # noqa: BLE001 — endpoint must not die
                try:
                    self._send(500, f"error: {e}\n".encode("utf-8"),
                               "text/plain")
                except OSError:
                    pass

    return Handler


class MetricsServer:
    """One HTTP endpoint.  ``port=0`` binds an ephemeral port; a busy
    explicit port falls back to ephemeral (``fell_back``) instead of
    raising.  The provider callables default to the live registry —
    ``python -m lightgbm_tpu_torch.obs serve`` swaps in a saved snapshot."""

    def __init__(self, port: int = 0, host: str = DEFAULT_HOST, *,
                 snapshot_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 events_fn: Optional[Callable[[Optional[str]], List]] = None,
                 health_fn: Optional[Callable[[], Tuple[int, Dict]]] = None):
        self.requested_port = int(port)
        self.host = host
        self.snapshot_fn = snapshot_fn or _metrics.snapshot
        self.events_fn = events_fn or (lambda kind=None: _metrics.events(kind))
        self.health_fn = health_fn or (lambda: health(self.snapshot_fn()))
        self.port: Optional[int] = None
        self.fell_back = False
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def running(self) -> bool:
        return self._httpd is not None

    def start(self) -> "MetricsServer":
        if self._httpd is not None:
            return self
        handler = _make_handler(self)
        try:
            self._httpd = ThreadingHTTPServer(
                (self.host, self.requested_port), handler)
        except OSError:
            if self.requested_port == 0:
                raise
            # port-in-use fallback: an ephemeral endpoint beats none, and
            # a telemetry bind conflict must never fail the training run
            self._httpd = ThreadingHTTPServer((self.host, 0), handler)
            self.fell_back = True
            _metrics.counter("metrics_server_port_fallbacks_total").inc()
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            daemon=True, name="lgbmtpu-metrics-server")
        self._thread.start()
        _metrics.event("metrics_server_start", port=self.port,
                       host=self.host, fallback=self.fell_back,
                       requested_port=self.requested_port)
        return self

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        thread, self._thread = self._thread, None
        if httpd is None:
            return
        try:
            httpd.shutdown()
            httpd.server_close()
        except OSError:
            pass
        if thread is not None:
            thread.join(timeout=5)
        _metrics.event("metrics_server_stop", port=self.port)

    def url(self, route: str = "/metrics") -> str:
        return f"http://{self.host}:{self.port}{route}"


# ---------------------------------------------------------------------------
# process singleton (engine.train / long-lived serving processes)
# ---------------------------------------------------------------------------

_singleton_lock = threading.Lock()
_singleton: Optional[MetricsServer] = None
_atexit_armed = False


def start_server(port: int = 0, host: Optional[str] = None) -> MetricsServer:
    """Start (or return) the process-wide endpoint.  Idempotent: a second
    call returns the running server regardless of the requested port — one
    process, one endpoint."""
    global _singleton, _atexit_armed
    with _singleton_lock:
        if _singleton is not None and _singleton.running:
            return _singleton
        srv = MetricsServer(
            port=port,
            host=host or os.environ.get("LGBMTPU_METRICS_HOST", DEFAULT_HOST))
        srv.start()
        _singleton = srv
        if not _atexit_armed:
            _atexit_armed = True
            atexit.register(stop_server)
        return srv


def stop_server() -> None:
    """Stop the process-wide endpoint (idempotent; also the atexit hook,
    so engine exit and interpreter shutdown close the socket cleanly)."""
    global _singleton
    with _singleton_lock:
        srv, _singleton = _singleton, None
    if srv is not None:
        srv.stop()


def get_server() -> Optional[MetricsServer]:
    return _singleton if (_singleton is not None and _singleton.running) \
        else None


def maybe_start(port: Optional[int] = None) -> Optional[MetricsServer]:
    """The Config/env opt-in gate: ``port`` is the explicit
    ``metrics_port=`` value (None = unset, falls through to
    ``LGBMTPU_METRICS_PORT``); negative or unresolvable means off.
    Telemetry disabled means off too — a metrics endpoint over a frozen
    registry would report lies."""
    if not _metrics.enabled():
        return None
    if port is None:
        raw = os.environ.get("LGBMTPU_METRICS_PORT")
        if raw is None:
            return None
        try:
            port = int(raw)
        except ValueError:
            return None
    if port < 0:
        return None
    return start_server(port)
