"""CLI: ``python -m lightgbm_tpu_torch.obs [COMMAND] ...``.

Default (no subcommand, the round-10 form): render a metrics snapshot —
``python -m lightgbm_tpu_torch.obs [snapshot.json] [--format prometheus|
lightgbm|json]``.  With a path it renders a snapshot previously written
via ``metrics_file=`` or :func:`lightgbm_tpu_torch.obs.write_snapshot`; with no
path it dumps the live in-process registry (empty in a fresh interpreter —
the path form is the operational one).  A schema-invalid snapshot exits 2
WITHOUT emitting a partial report: the render is fully materialized
before anything is printed.

Subcommands:

* ``trace [trace.json ...] [--merge] [--trace-id HEX32] [-o OUT]`` —
  export spans as Chrome-trace/Perfetto JSON.  With a path, validates +
  re-emits a saved trace file (``trace_file=`` / :func:`write_trace`);
  without, exports the live span ring.  ``--merge`` folds several
  per-rank/per-replica trace files into one clock-aligned timeline (the
  flight recorder; completes the launcher's events/metrics merge triad);
  ``--trace-id`` narrows the export to one request's connected trace
  (span-link closure — the hedged/requeued story end-to-end).  ``-o``
  writes atomically instead of printing.
* ``serve SNAPSHOT [--port N] [--host H]`` — standalone HTTP endpoint
  over a saved snapshot file (``/metrics``, ``/healthz``, ``/snapshot``;
  ``/events`` serves a sibling ``--events`` JSONL when given) — the
  post-mortem twin of the in-process ``metrics_port=`` endpoint.
* ``tail EVENTS.jsonl [-n N] [--kind K] [--follow]`` — print the newest N
  structured events (one JSON object per line); ``--follow`` keeps
  following appends like ``tail -f``.

Exit codes: 0 ok, 2 on missing/invalid inputs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .metrics import (load_snapshot, render_lightgbm, render_prometheus,
                      snapshot)
from . import trace as _trace


def _cmd_dump(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch.obs",
        description="dump a lightgbm_tpu metrics snapshot")
    parser.add_argument("path", nargs="?", default=None,
                        help="snapshot JSON written by metrics_file= / "
                             "write_snapshot (default: the live registry)")
    parser.add_argument("--format", choices=("prometheus", "lightgbm",
                                             "json"),
                        default="prometheus")
    args = parser.parse_args(argv)

    if args.path is not None:
        try:
            snap = load_snapshot(args.path)
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    else:
        snap = snapshot()

    # materialize the FULL report before printing any of it: a malformed
    # snapshot must exit non-zero with zero partial output, never die
    # halfway through a report a script is already parsing
    try:
        if args.format == "json":
            out = json.dumps(snap, indent=1, default=str) + "\n"
        elif args.format == "lightgbm":
            out = "".join(line + "\n" for line in render_lightgbm(snap))
        else:
            out = render_prometheus(snap)
    except Exception as e:  # noqa: BLE001 — any render failure is exit 2
        print(f"error: snapshot does not render ({e})", file=sys.stderr)
        return 2
    sys.stdout.write(out)
    return 0


def _cmd_trace(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch.obs trace",
        description="export spans as Chrome-trace/Perfetto JSON")
    parser.add_argument("paths", nargs="*", default=[],
                        help="saved trace file(s) (trace_file= / "
                             "write_trace) to validate + re-emit "
                             "(default: export the live span ring); "
                             "several paths require --merge")
    parser.add_argument("--merge", action="store_true",
                        help="fold the given per-rank/per-replica trace "
                             "files into ONE clock-aligned timeline "
                             "(each source keeps its own pid lane; the "
                             "launcher's events/metrics merge triad, "
                             "completed)")
    parser.add_argument("--trace-id", default=None, metavar="HEX32",
                        help="narrow the export to one request's "
                             "CONNECTED trace: its own spans plus "
                             "everything reachable over span links "
                             "(coalesced batches, failed legs, "
                             "hedge/requeue records)")
    parser.add_argument("-o", "--output", default=None,
                        help="write the trace JSON here (atomic) instead "
                             "of printing it")
    args = parser.parse_args(argv)
    if len(args.paths) > 1 and not args.merge:
        print("error: multiple trace files need --merge", file=sys.stderr)
        return 2
    try:
        if args.merge:
            if not args.paths:
                print("error: --merge needs at least one trace file",
                      file=sys.stderr)
                return 2
            doc = _trace.merge_trace_files(args.paths)
        elif args.paths:
            doc = _trace.load_trace(args.paths[0])
        else:
            doc = _trace.to_chrome_trace()
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.trace_id:
        meta = doc.get("lgbmtpu", {})
        sliced = _trace.trace_slice(args.trace_id.strip().lower(),
                                    meta.get("spans", []))
        doc = _trace.to_chrome_trace(sliced)
        if "merged" in meta:  # keep the provenance of a merged input
            doc["lgbmtpu"]["merged"] = meta["merged"]
    if args.output:
        from .metrics import _atomic_write_json

        try:
            _atomic_write_json(args.output, doc)
        except OSError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(f"wrote {len(doc['traceEvents'])} span(s) to {args.output}")
    else:
        print(json.dumps(doc, indent=1, default=str))
    return 0


def _cmd_serve(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch.obs serve",
        description="standalone HTTP endpoint over a saved snapshot")
    parser.add_argument("path", help="snapshot JSON (metrics_file=)")
    parser.add_argument("--port", type=int, default=0,
                        help="bind port (default: ephemeral)")
    parser.add_argument("--host", default=None,
                        help="bind host (default 127.0.0.1 — the "
                             "exposition includes operational detail)")
    parser.add_argument("--events", default=None,
                        help="optional events JSONL served at /events")
    args = parser.parse_args(argv)
    try:
        srv = serve_snapshot(args.path, port=args.port, host=args.host,
                             events_path=args.events)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"serving {args.path} at {srv.url('/metrics')} "
          f"(/healthz, /snapshot, /events) — Ctrl-C to stop", flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
    return 0


def serve_snapshot(path: str, port: int = 0, host=None, events_path=None):
    """Build + start a MetricsServer over a saved snapshot file (the CLI
    ``serve`` body, importable so tests and tools can drive it without a
    blocking foreground loop).  Raises OSError/ValueError on a missing or
    schema-invalid snapshot."""
    from .server import DEFAULT_HOST, MetricsServer, health

    snap = load_snapshot(path)  # validates; raise before binding anything
    events = []
    if events_path:
        with open(events_path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn tail from a crashed worker
                if isinstance(rec, dict):
                    events.append(rec)
    return MetricsServer(
        port=port, host=host or DEFAULT_HOST,
        snapshot_fn=lambda: snap,
        events_fn=lambda kind=None: (
            [e for e in events if e.get("kind") == kind] if kind else events),
        health_fn=lambda: health(snap),
    ).start()


def _cmd_tail(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch.obs tail",
        description="print (and optionally follow) a structured events "
                    "JSONL stream")
    parser.add_argument("path", help="events JSONL (LGBMTPU_EVENTS_FILE / "
                                     "fleet_events.jsonl)")
    parser.add_argument("-n", "--lines", type=int, default=10)
    parser.add_argument("--kind", default=None,
                        help="only events of this kind")
    parser.add_argument("--follow", action="store_true",
                        help="keep following appended records (tail -f)")
    parser.add_argument("--poll", type=float, default=0.5,
                        help="follow poll interval seconds")
    args = parser.parse_args(argv)

    def matches(line: str):
        line = line.strip()
        if not line:
            return None
        try:
            rec = json.loads(line)
        except ValueError:
            return None  # torn tail — skip, never die
        if not isinstance(rec, dict):
            return None
        if args.kind is not None and rec.get("kind") != args.kind:
            return None
        return rec

    try:
        fh = open(args.path, encoding="utf-8")
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    with fh:
        recs = [r for r in (matches(line) for line in fh) if r is not None]
        # -n 0 is the `tail -n 0 -f` idiom: print NO history (a negated
        # zero slice would dump the whole file)
        for rec in (recs[-args.lines:] if args.lines > 0 else []):
            print(json.dumps(rec, default=str), flush=True)
        if not args.follow:
            return 0
        try:
            while True:
                line = fh.readline()
                if not line:
                    time.sleep(max(args.poll, 0.05))
                    continue
                rec = matches(line)
                if rec is not None:
                    print(json.dumps(rec, default=str), flush=True)
        except KeyboardInterrupt:
            return 0


_COMMANDS = {"trace": _cmd_trace, "serve": _cmd_serve, "tail": _cmd_tail}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in _COMMANDS:
        return _COMMANDS[argv[0]](argv[1:])
    if argv and argv[0] == "dump":  # explicit spelling of the default
        argv = argv[1:]
    return _cmd_dump(argv)


if __name__ == "__main__":
    sys.exit(main())
