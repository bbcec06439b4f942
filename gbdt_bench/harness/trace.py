"""The traced stretch: torch.profiler over a few steps, read back from its
Chrome trace.

``Stretch`` profiles the device (CUPTI) and the host around the steps it is
given, inside a ``bench.stretch`` annotation that ends with a synchronize, and
reduces the trace to what the per-layer readers use:

  * ``window_s``: the stretch's length on the host clock, synchronize to
    synchronize;
  * ``busy_s``: the union of the device's kernel, copy and set intervals
    inside it (one card, so no averaging);
  * ``device_ops``: device seconds and launches by kernel or copy name;
  * ``idle_by_host``: the device's idle seconds inside the stretch, by the
    innermost host operation running at each gap's middle;
  * ``host_annotations``: host seconds and count by the name of each
    annotation (``record_function``, NVTX-style ranges) inside the stretch.
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")  # and the CUDA API calls: "cuda_*"
MARK = "bench.stretch"


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_events(events: List[dict]) -> dict:
    """Reduce Chrome-trace events (``ts``/``dur`` in microseconds) to the
    stretch's device and idle summary."""
    marks = [e for e in events if e.get("name") == MARK and e.get("ph") == "X"]
    if not marks:
        raise ValueError("the trace holds no bench.stretch annotation")
    lo = float(marks[0]["ts"])
    hi = lo + float(marks[0]["dur"])
    dev, host = [], []
    notes: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        a = float(e["ts"])
        b = a + float(e["dur"])
        if cat in DEVICE_CATS:
            dev.append((max(a, lo), min(b, hi), e.get("name", "?"), cat))
        elif (cat in HOST_CATS or cat.startswith("cuda_")) and e.get("name") != MARK:
            host.append((a, b, e.get("name", "?")))
            if cat == "user_annotation" and a >= lo and b <= hi:
                notes[e.get("name", "?")][0] += (b - a) * 1e-6
                notes[e.get("name", "?")][1] += 1
    dev = [d for d in dev if d[1] > d[0]]
    ops: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for a, b, name, _ in dev:
        ops[name][0] += (b - a) * 1e-6
        ops[name][1] += 1
    busy = _union([(a, b) for a, b, _, _ in dev])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps, cur = [], lo
    for a, b in busy:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        gaps.append((cur, hi))
    idle = _idle_by_host(gaps, host)
    return dict(busy_s=busy_s, device_ops={k: (v[0], int(v[1])) for k, v in ops.items()},
                kernels=sum(1 for d in dev if d[3] == "kernel"),
                idle_by_host=idle,
                host_annotations={k: (v[0], int(v[1])) for k, v in notes.items()})


def _idle_by_host(gaps, host) -> Dict[str, float]:
    """Gap seconds by the innermost host event (the latest started of those
    still running) at each gap's middle: one sweep over both."""
    host = sorted(host)
    idle: Dict[str, float] = defaultdict(float)
    active: list = []
    i = 0
    for a, b in sorted(gaps):
        mid = (a + b) / 2
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(active, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        label = active[0][2] if active else "host (no traced op)"
        idle[label] += (b - a) * 1e-6
    return dict(idle)


class Stretch:
    """Profile the steps run inside ``with Stretch(device) as s:``; after the
    block, ``s.summary`` holds ``reduce_events``' result and ``window_s``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.summary: dict = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._mark = record_function(MARK)
        self._mark.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        window_s = time.perf_counter() - self._t0
        self._mark.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh).get("traceEvents", [])
        self.summary = reduce_events(events)
        self.summary["window_s"] = window_s
        del self._prof
        return False


def breakdown(summary: dict, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device ops that took most time,
    and the idle seconds by what the host was doing, each [name, seconds]
    (a name cut at 160 characters)."""
    ops = sorted(summary["device_ops"].items(), key=lambda kv: -kv[1][0])[:top]
    idle = sorted(summary["idle_by_host"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k[:160], v[0]] for k, v in ops],
            "idle_gaps": [[k[:160], v] for k, v in idle]}
