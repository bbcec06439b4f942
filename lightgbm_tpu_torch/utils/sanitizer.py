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

Serving adds ``predicts``: traversals launched by a prediction entry
(``GBDT.predict_raw``, ``predict_coalesced``; the JAX package counts them
as dispatches), each followed by one counted blocking read (``sync_pull``
into the model's pinned output buffer), so "one read a coalesced batch" is
a DispatchCounter assertion.  :meth:`DispatchCounter.assert_round_budget`
and :class:`BudgetError` are the JAX package's gate.  Every metrics
snapshot reads these counts through a collector (the JAX package's
``device_*_total`` counters).  The JAX package's compile, trace and
donation counters have no torch meaning and are not carried over
(ROADMAP).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..obs import metrics as _obs
from . import locktrace as _lt

_lock = _lt.lock("sanitizer.counts")
_counts = {"rounds": 0, "host_syncs": 0, "async_resolves": 0, "captures": 0,
           "replays": 0, "dispatches": 0, "megakernel_fallbacks": 0,
           "predicts": 0}


def _obs_collect() -> dict:
    """Snapshot-time bridge into the metrics registry: this module stays
    the one ledger, and every metrics snapshot reads it once here
    (process-cumulative, as the JAX package's collector)."""
    with _lock:
        c = dict(_counts)
    return {"counters": {
        "device_dispatches_total": c["rounds"] + c["predicts"],
        "device_host_syncs_total": c["host_syncs"],
        "device_async_resolves_total": c["async_resolves"],
        "device_graph_captures_total": c["captures"],
        "device_graph_replays_total": c["replays"],
    }}


_obs.register_collector("sanitizer", _obs_collect)


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


def record_predict() -> None:
    """Count a traversal launched by a prediction entry."""
    with _lock:
        _counts["predicts"] += 1


def sync_pull(x: torch.Tensor, out: Optional[torch.Tensor] = None,
              before_wait: Optional[Callable[[], None]] = None) -> np.ndarray:
    """Blocking host read of a device value.  ``out``: a host buffer (pinned
    on the card) of at least x's rows and x's dtype, which receives the
    value; the result is then a view of it, valid until it is written
    again.  ``before_wait`` runs once the copy is queued and before the
    host waits (work that lands with this read: no second wait)."""
    with _lock:
        _counts["host_syncs"] += 1
    if out is None:
        if before_wait is not None:
            before_wait()
        return x.cpu().numpy()
    dst = out[: x.shape[0]]
    dst.copy_(x, non_blocking=x.is_cuda)
    if before_wait is not None:
        before_wait()
    if x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()
    return dst.numpy()


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


class BudgetError(AssertionError):
    """A host loop exceeded its launch or blocking-read budget."""


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

    @property
    def predicts(self) -> int:
        return self._delta("predicts")

    def assert_round_budget(self, rounds: int, *, dispatches_per_round: int = 1,
                            syncs_per_round: int = 0,
                            what: str = "round loop") -> None:
        """The JAX package's steady-state contract of a round loop: exactly
        ``dispatches_per_round`` launched rounds (prediction traversals
        count too) and ``syncs_per_round`` blocking reads a round."""
        got_d = self.rounds + self.predicts
        got_s = self.host_syncs
        want_d, want_s = rounds * dispatches_per_round, rounds * syncs_per_round
        if got_d != want_d or got_s != want_s:
            raise BudgetError(
                f"{what}: {rounds} round(s) budgeted {want_d} launch(es) + "
                f"{want_s} blocking read(s), observed {got_d} + {got_s} "
                f"(async resolves: {self.async_resolves})")

    def stats(self) -> dict:
        """Every count over the block so far."""
        with _lock:
            return {k: v - self._start[k] for k, v in _counts.items()}
