"""Host-sync accounting for round loops.

Counterpart of the part of lightgbm_tpu/utils/sanitizer.py that the
windowed round driver uses.  The windowed grower counts every round it
launches and routes every device-to-host read it makes through this
module: ``sync_pull`` is a blocking read (the host waits for the device
queue to drain to the value; the grower makes one a tree, the fixed-point
exponents of ops/hist_cuda.py::fixed_shift_pair, before its first round),
``async_pull_start`` / ``async_pull_result`` a pipelined one (a
non-blocking copy into pinned host memory behind a CUDA event, resolved a
round later, while the device runs the rounds queued since).
``DispatchCounter`` reads the counts over a block, which is what the
tests pin: one round per launch and no blocking read inside the rounds.
A read made without this module is not counted; the card test runs every
round under torch's sync debug mode, which raises on any such read.

ops/graphs.py adds the counts of the one-dispatch contract, the
counterpart of the JAX package's dispatch counts: ``captures`` (CUDA graphs
captured), ``replays`` (graph replays), and ``dispatches``, rounds run as
one unit: a replay on the card, or on the CPU the same round function run
in place on its static buffers.  Rounds run as eager torch launches count
none.  ``megakernel_fallbacks`` counts windowed trees whose configuration
the round megakernel excludes (ops/treegrow_windowed.py::megakernel_mode:
EFB bundles, int8 on the card), the JAX package's
megakernel_envelope_fallbacks_total.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

_lock = threading.Lock()
_counts = {"rounds": 0, "host_syncs": 0, "async_resolves": 0, "captures": 0,
           "replays": 0, "dispatches": 0, "megakernel_fallbacks": 0}


def record_dispatch(n: int = 1) -> None:
    """Count a round launched by a host driver loop."""
    with _lock:
        _counts["rounds"] += n


def record_capture() -> None:
    """Count a CUDA graph captured."""
    with _lock:
        _counts["captures"] += 1


def record_megakernel_fallback() -> None:
    """Count a tree that takes the three-pass round where the megakernel
    was asked for."""
    with _lock:
        _counts["megakernel_fallbacks"] += 1


def record_replay(replayed: bool) -> None:
    """Count a round run as one dispatch: a graph replay (``replayed``), or
    the same round function run in place where nothing is captured."""
    with _lock:
        _counts["dispatches"] += 1
        _counts["replays"] += int(replayed)


def sync_pull(x: torch.Tensor) -> np.ndarray:
    """Blocking host read of a device value."""
    with _lock:
        _counts["host_syncs"] += 1
    return x.cpu().numpy()


class PendingPull:
    """A device->host copy in flight: pinned host buffer + CUDA event."""

    def __init__(self, x: torch.Tensor):
        if x.is_cuda:
            self.host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self.host.copy_(x, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(x.device))
        else:
            self.host = x.clone()
            self.event = None


def async_pull_start(x: torch.Tensor) -> PendingPull:
    """Begin a device->host copy without waiting (pipelined read)."""
    return PendingPull(x)


def async_pull_result(p: PendingPull) -> np.ndarray:
    """Resolve a read begun with :func:`async_pull_start`: waits for that
    copy only, while the device keeps running later work."""
    with _lock:
        _counts["async_resolves"] += 1
    if p.event is not None:
        p.event.synchronize()
    return p.host.numpy()


class DispatchCounter:
    """Context manager: rounds, blocking syncs and async resolves counted
    in the enclosed block."""

    def __enter__(self) -> "DispatchCounter":
        with _lock:
            self._start = dict(_counts)
        return self

    def __exit__(self, *exc) -> None:
        return None

    def _delta(self, key: str) -> int:
        with _lock:
            return _counts[key] - self._start[key]

    @property
    def rounds(self) -> int:
        return self._delta("rounds")

    @property
    def host_syncs(self) -> int:
        return self._delta("host_syncs")

    @property
    def async_resolves(self) -> int:
        return self._delta("async_resolves")

    @property
    def captures(self) -> int:
        return self._delta("captures")

    @property
    def replays(self) -> int:
        return self._delta("replays")

    @property
    def dispatches(self) -> int:
        return self._delta("dispatches")

    def stats(self) -> dict:
        """Every count over the block so far."""
        with _lock:
            return {k: v - self._start[k] for k, v in _counts.items()}
