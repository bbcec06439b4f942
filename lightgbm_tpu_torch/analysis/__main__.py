"""CLI: ``python -m lightgbm_tpu_torch.analysis [paths...]``.

Counterpart of lightgbm_tpu/analysis/__main__.py, with its exit codes.
Three layers, one entry point:

* default — the AST pass over source (rules R1-R21 and the concurrency
  rules L1-L5).  Stale pragmas (a ``disable=Rn`` whose line no longer
  triggers Rn) warn by default; ``--strict-pragmas`` makes them findings.
* ``--locks`` — the concurrency layer alone (L1-L5, analysis/locks.py).
* ``--trace`` — the trace audit (J1-J7 over the contracts of
  analysis/contracts.py, trace_audit.py): each contract's round body run
  once under a recorder on the CPU.  The sharded contracts run on 4 gloo
  ranks (one ``parallel/launcher.py::run_spmd`` launch); ``--contract
  NAME`` selects a subset (repeatable), ``--no-runtime`` skips the ledger
  cross-check of a sharded tree.

Exit status 0 when no unsuppressed findings, 1 otherwise, 2 on bad usage.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .core import RULES, run
from . import rules  # noqa: F401
from . import locks  # noqa: F401  — registers L1-L5


def _main_trace(args) -> int:
    from . import trace_audit
    from .contracts import CONTRACTS

    if args.list_contracts:
        for name in sorted(CONTRACTS):
            c = CONTRACTS[name]
            print(f"{name}  [{len(c.collectives)} collective(s), "
                  f"launches {dict(c.launches)}]")
            print(f"      {c.description}")
        for rid in sorted(trace_audit.TRACE_RULES):
            print(f"{rid}  {trace_audit.TRACE_RULES[rid]}")
        return 0

    names = list(args.contract) if args.contract else None
    if names:
        unknown = [n for n in names if n not in CONTRACTS]
        if unknown:
            print(f"error: unknown contracts {unknown}; known: "
                  f"{sorted(CONTRACTS)}", file=sys.stderr)
            return 2
    report = trace_audit.run_trace_audit(names, runtime=not args.no_runtime)
    for f in report.findings:
        print(f.format())
    if args.show_suppressed:
        for f, reason in report.waived:
            print(f"[waived: {reason}] {f.format()}")
    for r in report.results:
        coll = r.detail.get("collectives")
        extra = f", collectives: {len(coll)}" if coll is not None else ""
        if "live_budget" in r.detail:
            extra += (f", live bytes: {r.detail['peak_live_bytes']} "
                      f"(budget {r.detail['live_budget']})")
        print(f"trace-audit: {r.name}: "
              f"{'ok' if r.ok else f'{len(r.findings)} finding(s)'}"
              f"{extra}", file=sys.stderr)
    for merge, summary in report.ledger.items():
        print(f"trace-audit: ledger[{merge}]: {summary}", file=sys.stderr)
    n, w = len(report.findings), len(report.waived)
    print(f"trace-audit: {n} finding(s), {w} waived", file=sys.stderr)
    return 0 if report.ok else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch.analysis",
        description="jaxlint for the port: AST rules R1-R21, lock rules "
                    "L1-L5; --trace: the trace audit J1-J7")
    parser.add_argument("paths", nargs="*", default=None,
                        help="files/directories to scan (default: the "
                             "installed lightgbm_tpu_torch package)")
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule ids (default: all)")
    parser.add_argument("--show-suppressed", action="store_true",
                        help="also list pragma-suppressed (or contract-"
                             "waived) findings")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalogue and exit")
    parser.add_argument("--strict-pragmas", action="store_true",
                        help="make stale pragmas (suppressions whose line no "
                             "longer triggers the named rule) findings")
    parser.add_argument("--locks", action="store_true",
                        help="run only the concurrency layer (L1-L5)")
    parser.add_argument("--trace", action="store_true",
                        help="run the trace audit (J1-J7 over the registered "
                             "contracts) instead of the AST layer")
    parser.add_argument("--contract", action="append", metavar="NAME",
                        help="audit only this contract (repeatable; implies "
                             "--trace)")
    parser.add_argument("--list-contracts", action="store_true",
                        help="print the contract and J-rule catalogue and "
                             "exit (implies --trace)")
    parser.add_argument("--no-runtime", action="store_true",
                        help="--trace: skip the ledger cross-check (a sharded "
                             "tree on gloo ranks)")
    args = parser.parse_args(argv)

    if args.locks and (args.trace or args.contract or args.list_contracts
                       or args.rules):
        print("error: --locks selects the L1-L5 layer and contradicts "
              "--trace/--contract/--list-contracts/--rules", file=sys.stderr)
        return 2

    if args.trace or args.contract or args.list_contracts:
        if args.paths:
            print("error: --trace audits registered contracts and takes no "
                  "paths (use --contract NAME to select)", file=sys.stderr)
            return 2
        return _main_trace(args)

    if args.list_rules:
        for rid in sorted(RULES):
            rule = RULES[rid]
            print(f"{rid}  {rule.name}" + ("  (scoped out)"
                                           if rule.layer == "scoped" else ""))
            for line in rule.doc.splitlines():
                print(f"      {line.strip()}")
        return 0

    if args.paths:
        roots = [Path(p) for p in args.paths]
    else:
        roots = [Path(__file__).resolve().parent.parent]
    for r in roots:
        if not r.exists():
            print(f"error: no such path: {r}", file=sys.stderr)
            return 2

    rule_ids = None
    if args.locks:
        rule_ids = [rid for rid, rule in RULES.items() if rule.layer == "locks"]
    elif args.rules:
        rule_ids = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rule_ids if r not in RULES]
        if unknown:
            print(f"error: unknown rules {unknown}; known: {sorted(RULES)}",
                  file=sys.stderr)
            return 2

    report = run(roots, rule_ids, strict_pragmas=args.strict_pragmas)
    for f in report.findings:
        print(f.format())
    if args.show_suppressed:
        for f, p in report.suppressed:
            print(f"[suppressed: {p.reason}] {f.format()}")
    if report.stale and not args.strict_pragmas:
        for f in report.stale:
            print(f"warning: {f.format()}", file=sys.stderr)
    n, s = len(report.findings), len(report.suppressed)
    print(f"jaxlint: {n} finding(s), {s} suppressed, "
          f"{len(report.stale)} stale pragma(s)", file=sys.stderr)
    return 0 if report.ok else 1


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # e.g. `... | head` closed the pipe
        sys.exit(0)
