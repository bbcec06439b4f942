"""The cells' files, found by the names in ``BENCHMARK.json``.

``held_out.json`` holds entries of the same shape for cells that a fault of
the port keeps out of ``BENCHMARK.json``; ``Registry(held_out=True)`` (the
tests, ``calibrate.py``) knows them too, the benchmark's runs do not.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``, whose ``loop`` names a module of
``harness/loops``); its limits are ``limits/<cell>.json``; a per-layer
metric is read by ``metrics/<metric>.py``'s ``read``.  A new cell, mix or
metric is a new file and a new entry, never an edit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, List

BENCH_DIR = Path(__file__).resolve().parents[1]


class Registry:
    def __init__(self, bench_dir: Path = BENCH_DIR, benchmark_json: Path = None,
                 held_out: bool = False):
        self.dir = Path(bench_dir)
        path = benchmark_json or self.dir.parent / "BENCHMARK.json"
        with open(path) as fh:
            self.benchmark = json.load(fh)
        if held_out:
            with open(self.dir / "held_out.json") as fh:
                extra = json.load(fh)
            for key in ("configs", "workloads", "end_to_end", "per_layer"):
                self.benchmark[key] = self.benchmark[key] + extra[key]

    def _json(self, sub: str, name: str) -> dict:
        path = self.dir / sub / f"{name}.json"
        if not path.is_file():
            raise KeyError(f"no {sub[:-1] if sub.endswith('s') else sub} file {path}")
        with open(path) as fh:
            return json.load(fh)

    def cell(self, name: str) -> dict:
        for w in self.benchmark["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, cell: str) -> dict:
        return self._json("limits", cell)

    def loop(self, traffic: dict):
        return importlib.import_module(f"gbdt_bench.harness.loops.{traffic['loop']}")

    def end_to_end(self, cell: str) -> List[dict]:
        """The end-to-end metrics ``cell`` reports."""
        return [m for m in self.benchmark["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics that list ``cell`` (each lists its cells)."""
        return [m for m in self.benchmark["per_layer"] if cell in m["workloads"]]

    def reader(self, metric: str) -> Callable[[dict], object]:
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "gbdt_bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
        if spec is None or not path.is_file():
            raise KeyError(f"no reader {path}")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
