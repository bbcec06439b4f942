"""One run of one cell: set-up, the measured window, the judgement, and the
result line.

    python3 gbdt_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits 2 with no result where the cell's cards are missing, 3 where a module
of JAX or of the JAX package is loaded, 1 where the run fails.  Otherwise
prints, as its last lines on standard error, each number compared beside its
limit, and as the last line of standard output one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (``breakdown`` in a traced
run) and, last, ``checks``.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import subprocess
import sys
import traceback
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from . import guard
from .registry import Registry


class NoCard(RuntimeError):
    pass


class Forbidden(RuntimeError):
    pass


@dataclass
class Run:
    """What a traffic loop is given."""
    workload: str
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    config: dict
    traffic: dict
    t_start: float
    control: Optional[str] = None
    fault: Optional[str] = None

    def note(self, line: str) -> None:
        print(line, file=sys.stderr, flush=True)


@dataclass
class Outcome:
    """What a traffic loop returns."""
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: Dict[str, float]
    memory_peak_bytes: int
    readings: dict = field(default_factory=dict)
    stretch: Optional[dict] = None


def parse(argv):
    p = argparse.ArgumentParser(prog="gbdt_bench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit() -> str:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "not read"
    try:
        out = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_start: float, *,
             device: str = "cuda", registry: Optional[Registry] = None,
             config_patch: Optional[dict] = None, traffic_patch: Optional[dict] = None,
             control: Optional[str] = None, fault: Optional[str] = None) -> dict:
    """Run one cell and return its result object.  ``device="cpu"``,
    ``config_patch`` and ``traffic_patch`` serve the tests, which drive a
    run on the CPU at a small size; ``control`` and ``fault`` serve
    ``calibrate.py`` (the limits' upper readings)."""
    reg = registry or Registry()
    cell = reg.cell(workload)
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            raise NoCard(f"{workload} needs {cell['chips']} CUDA card(s); "
                         f"torch.cuda.is_available()={torch.cuda.is_available()}")
    config = _patched(reg.config(cell["config"]), config_patch)
    traffic = _patched(reg.traffic(cell["traffic"]), traffic_patch)
    limits = reg.limits(workload)
    run = Run(workload=workload, seed=seed, seconds=seconds, trace=trace,
              device=torch.device(device), config=config, traffic=traffic,
              t_start=t_start, control=control, fault=fault)
    if device == "cuda":
        run.note(f"card: {power_limit()}")
    out = reg.loop(traffic).run(run)
    metrics = {}
    if trace:
        for m in reg.per_layer(workload):
            value = reg.reader(m["name"])(out.readings)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in reg.end_to_end(workload):
            metrics[m["name"]] = {"value": float(out.end_to_end[m["name"]]),
                                  "unit": m["unit"]}
    checks = {}
    for name, limit in limits.items():
        value = float(out.checks.get(name, math.inf))
        checks[name] = {"value": value, "limit": limit}
    correct = out.failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    for c in checks.values():  # JSON has no inf or nan: those read as text
        if not math.isfinite(c["value"]):
            c["value"] = str(c["value"])
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": int(cell["chips"]) if device == "cuda" else 1,
           "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": bool(correct), "attempted": int(out.attempted),
              "failed": int(out.failed), "metrics": metrics, "device": dev}
    if trace and out.stretch is not None:
        from .trace import breakdown
        dev["busy_s"] = out.stretch["busy_s"]
        dev["window_s"] = out.stretch["window_s"]
        result["breakdown"] = breakdown(out.stretch)
    result["checks"] = checks
    # last, once the readers and the breakdown have loaded what they load
    found = guard.forbidden()
    if found:
        raise Forbidden(f"modules of JAX or of the JAX package are loaded: {found}")
    return result


def _patched(base: dict, patch: Optional[dict]) -> dict:
    out = json.loads(json.dumps(base))
    for k, v in (patch or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _patched(out[k], v)
        else:
            out[k] = v
    return out


def emit(result: dict) -> None:
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def main(argv, t_start: float, **run_kw) -> int:
    """``run_kw`` goes to ``run_cell`` (the tests' CPU runs)."""
    args = parse(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start,
                          **run_kw)
    except NoCard as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    except Forbidden as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    except Exception:  # a failed run prints its traceback and no result
        traceback.print_exc()
        return 1
    emit(result)
    return 0
