"""Readings for the limits of ``correct``: one cell run on many seeds in one
process, as it is, under the control or under a planted fault; one JSON line
a seed with the numbers compared.

    python3 gbdt_bench/calibrate.py --workload higgs-train --seeds 11,12,13 \\
        --seconds 30 [--control bf16 | --fault half_batch]

The benchmark's own runs never call this; it also runs the cells of
``held_out.json``.  The limits in ``limits/<cell>.json`` lie between the
largest reading of sound runs and the smallest of the control's and the
faults' (PERF.md gives the readings).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:] = [str(ROOT)] + [p for p in sys.path
                             if Path(p or ".").resolve() != ROOT / "gbdt_bench"]

from gbdt_bench.harness.cli import run_cell  # noqa: E402
from gbdt_bench.harness.registry import Registry  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="gbdt_bench/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", default=None)
    p.add_argument("--fault", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    reg = Registry(held_out=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run_cell(args.workload, seed, args.seconds, False, time.perf_counter(),
                       device=args.device, registry=reg,
                       control=args.control, fault=args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "fault": args.fault,
                          "correct": res["correct"], "metrics": res["metrics"],
                          "checks": {k: v["value"] for k, v in res["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
