"""Tracing and profiling on the card.

Counterpart of lightgbm_tpu/utils/profiling.py, rewritten for torch.
Reference: the TIMETAG-gated wall-clock tallies in src/treelearner/*.cpp
(global_timer) and the CLI's "Time for X: Y s" logs.

A timed section is an NVTX range on the card (``torch.cuda.nvtx.range_push``
/ ``range_pop``, visible in Nsight and in ``torch.profiler`` traces) and a
span of the obs trace (obs/trace.py).  Device times come from CUDA events
(:class:`DeviceTimer`); on the CPU there is no device clock, so a span is
the obs span alone and a timer reads the host clock.  Section tallies live
in the metrics registry as ``section_seconds.<name>`` histograms, as in
the JAX package: ``log_timings`` reads and (optionally) clears them.

``LGBMTPU_NVTX=1`` mirrors every context-manager span of obs/trace.py
into an NVTX range (the JAX package's ``LGBMTPU_JAX_PROFILER=1`` bridge
into jax.profiler annotations).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch

from ..obs import metrics as _obs
from ..obs import trace as _trace
from .log import log_info


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Label the enclosed launches in device traces with an NVTX range (no
    range without a card)."""
    if not torch.cuda.is_available():
        yield
        return
    torch.cuda.nvtx.range_push(name)
    try:
        yield
    finally:
        torch.cuda.nvtx.range_pop()


def _nvtx_annotation_factory(name: str, attrs: dict):
    """obs/trace.py annotation factory: a span carrying a ``step`` or
    ``iteration`` attribute names its range ``name[step]``, so the
    profiler's timeline lines up with boosting iterations."""
    step = attrs.get("step", attrs.get("iteration"))
    return annotate(name if step is None else f"{name}[{int(step)}]")


def install_nvtx_annotations() -> None:
    """Mirror every context-manager span (obs/trace.py) into NVTX ranges.
    Installed at import when ``LGBMTPU_NVTX=1``; the layers that open
    spans (models/gbdt.py, engine) import this module."""
    _trace.set_annotation_factory(_nvtx_annotation_factory)


if os.environ.get("LGBMTPU_NVTX") == "1":
    install_nvtx_annotations()


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace (host ops, and the card's kernels
    and copies where there is a card) of the enclosed block into
    ``log_dir/trace.json`` (Chrome trace format; open it in Perfetto)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class DeviceTimer:
    """Device milliseconds between :meth:`start` and :meth:`stop` on the
    current stream, from a pair of CUDA events; the host clock on the CPU.
    :meth:`elapsed_ms` waits for the stop event only."""

    def __init__(self, device: Optional[torch.device] = None):
        dev = torch.device("cpu") if device is None else torch.device(device)
        self._cuda = dev.type == "cuda"
        if self._cuda:
            self._ev = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
        self._t = [0.0, 0.0]

    def start(self) -> "DeviceTimer":
        if self._cuda:
            self._ev[0].record()
        else:
            self._t[0] = time.perf_counter()
        return self

    def stop(self) -> "DeviceTimer":
        if self._cuda:
            self._ev[1].record()
        else:
            self._t[1] = time.perf_counter()
        return self

    def elapsed_ms(self) -> float:
        if self._cuda:
            self._ev[1].synchronize()
            return float(self._ev[0].elapsed_time(self._ev[1]))
        return (self._t[1] - self._t[0]) * 1e3


@contextlib.contextmanager
def timed_section(name: str, sync: bool = False) -> Iterator[None]:
    """Host wall-clock tally per section (reference: global_timer's
    start/stop pairs), as an NVTX range and an obs span.  With sync=True
    the section first waits for the card's queued work (and again at its
    end), so the tally covers the section's device work; without it, work
    launched inside may still run when the section closes."""
    cuda = sync and torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with _trace.span(name), annotate(name):
            yield
            if cuda:
                torch.cuda.synchronize()
    finally:
        dt = time.perf_counter() - t0
        # always=True: entering a timed_section is the opt-in, as in the
        # JAX package (the tally records under telemetry=false too)
        _obs.histogram(f"{_obs.SECTION_PREFIX}{name}").observe(dt, always=True)


def log_timings(reset: bool = True) -> Dict[str, float]:
    """Emit the accumulated section tallies (reference: the TIMETAG summary
    printed at the end of training).  Returns {section: total_seconds}."""
    sections = _obs.histogram_items(_obs.SECTION_PREFIX)
    out = {}
    for full_name, h in sections.items():
        out[full_name[len(_obs.SECTION_PREFIX):]] = h.total
    for name in sorted(out, key=out.get, reverse=True):
        h = sections[_obs.SECTION_PREFIX + name]
        log_info(f"Time for {name}: {h.total:.6f} s ({h.count} calls)")
    if reset:
        _obs.clear_prefix(_obs.SECTION_PREFIX)
    return out
