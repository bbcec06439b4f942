"""Deterministic, env-gated fault injection — the harness every recovery
test drives (docs/ROBUSTNESS.md).

A production boosting run dies in a handful of well-understood ways: the
host process is preempted mid-round, a snapshot write is cut short, a
remote Mosaic/Pallas compile fails, an SPMD worker dies, or a custom
objective emits NaN gradients.  Each of those failure classes has an
injection SITE wired into the runtime; arming a site is purely
environmental, so the library code under test is byte-identical to
production code:

    LGBMTPU_FAULT=<site>:<round>[,<site>:<round>...]

Rank-gated sites additionally accept the inline three-field form
``<site>:<rank>:<round>`` (``worker_hang:1:3`` = rank 1 hangs at round 3),
equivalent to setting ``LGBMTPU_FAULT_RANK`` for that one site.

Sites (see docs/ROBUSTNESS.md for the exact trigger points):

``host_crash``      engine.train round loop — hard process exit
                    (``os._exit``) at the START of 1-based boosting
                    iteration <round>.
``worker_hang``     same trigger point — the process SLEEPS FOREVER
                    instead of dying, modelling a rank wedged inside a
                    collective: exit-code watchdogs never fire, only the
                    heartbeat watchdog catches it.  Rank-gated.
``snapshot_write``  utils/checkpoint.py atomic writer — hard process exit
                    mid-write (after a partial payload is flushed to the
                    TEMP file, before ``os.replace``) for the snapshot
                    covering iteration <round>.
``manifest_write``  utils/checkpoint.py fleet-checkpoint writer — hard
                    process exit BETWEEN the rank-0 snapshot landing and
                    the fleet manifest publish: the torn-fleet-state
                    window the manifest protocol exists to exclude.
``continual_swap``  continual/runtime.py rollover — hard
                    process exit BETWEEN the update's durable checkpoint
                    (raw-delta snapshot + manifest) and its publication
                    through ``ServingRuntime.swap_model``: the previous
                    ensemble keeps serving, no torn pack is ever
                    published, and a resumed runner picks the update up
                    from the manifest.  <round> is the rollover sequence
                    number (1-based).
``worker_death``    parallel/launcher.py worker body — hard process exit at
                    the start of iteration <round>, gated to one rank via
                    ``LGBMTPU_FAULT_RANK`` (compared against the worker's
                    ``LIGHTGBM_TPU_RANK``).
``pallas_hist``     the histogram dispatcher (ops/histogram.py) — raises
                    :class:`InjectedFault` at trace time, modelling a
                    remote Mosaic kernel-compile failure.  <round> counts
                    dispatcher CALLS (0 = first).
``pallas_partition``ops/partition.py::partition_rows — same semantics.
``pallas_round``    ops/treegrow_windowed.py::grow_tree_windowed's round-
                    megakernel attempt — same semantics; exercises the
                    ROUND layer of the degradation net (fallback = the
                    three-pass fused round).
``nonfinite_grad``  models/gbdt.py — poisons gradient element 0 with NaN at
                    1-based boosting iteration <round>.
``nonfinite_hess``  same, for the hessian.

Serve-side sites (round 22 — the chaos harness for the replica fleet,
``serve/fleet.py``; all four are CALL-counted like the pallas sites, and
each replica batch touches a site at two pipeline stages — stage A on
batch receipt, stage B after the dispatch retires — so even/odd <round>
values select the stage):

``replica_dispatch`` a replica's batch dispatch raises
                    :class:`InjectedFault` — the transient failure class
                    (a runtime hiccup, OOM on one device): the batch's
                    requests requeue EXACTLY once onto a healthy replica.
``replica_death``   the replica worker THREAD dies (the thread-fleet
                    analogue of ``worker_death``): its in-flight batch
                    requeues and the fleet supervisor restarts the
                    replica with backoff.
``replica_hang``    the replica thread SLEEPS FOREVER mid-pipeline —
                    only the per-replica heartbeat watchdog catches it;
                    the supervisor requeues the wedged batch and spawns
                    a replacement.
``swap_publish``    ``ServingRuntime.swap_model`` — raises BETWEEN the
                    replacement pack's warm build and its publication to
                    the model table: every replica must keep serving the
                    OLD ensemble, never a torn table.

Determinism rules:

* a (site, round) pair fires exactly ONCE per process (an in-memory
  registry); crash sites never return.
* with ``LGBMTPU_FAULT_ONCE_DIR=<dir>`` set, firing also drops a marker
  file, making the once-only guarantee hold ACROSS processes — the knob
  that lets a relaunched worker (or a watchdog restart) run clean while
  the first attempt faulted.  parallel/launcher.py sets it automatically
  for its workers when a fault is armed.
* rank-gated sites only fire when ``LGBMTPU_FAULT_RANK`` is unset or
  matches ``LIGHTGBM_TPU_RANK``.

Nothing here imports jax: injection must work in thin subprocesses (the
launcher watchdog tests) without paying a backend bring-up.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

# exit code for injected hard crashes — distinctive enough that a watchdog
# log or a test can tell an injected death from a real one
CRASH_EXIT_CODE = 113

_RANK_GATED_SITES = ("worker_death", "worker_hang")

# sites whose <round> is a per-site CALL counter rather than an explicit
# round number passed by the caller (trace-time sites have no round; the
# serve sites count pipeline-stage touches — see the module docstring)
_CALL_COUNTED_SITES = ("pallas_hist", "pallas_partition", "pallas_round",
                       "replica_dispatch", "replica_death", "replica_hang",
                       "swap_publish")


class InjectedFault(RuntimeError):
    """Raised by :func:`maybe_fail` when an armed site fires."""

    def __init__(self, site: str, round_i: int):
        super().__init__(
            f"injected fault at site {site!r} (round {round_i}) — "
            "LGBMTPU_FAULT test harness, not a real failure")
        self.site = site
        self.round_i = round_i


_spec_cache: Tuple[Optional[str], Dict[str, int], Dict[str, str]] = (
    None, {}, {})
_fired: set = set()
_call_counts: Dict[str, int] = {}


def _parse_full(raw: str) -> Tuple[Dict[str, int], Dict[str, str]]:
    """``"site:round,site:rank:round"`` -> ({site: round}, {site: rank}).
    Malformed entries raise ValueError immediately — a typo'd fault spec
    silently arming nothing would invalidate the test that set it."""
    rounds: Dict[str, int] = {}
    ranks: Dict[str, str] = {}
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) == 2 and parts[0]:
            site, rnd = parts
        elif len(parts) == 3 and parts[0]:
            # inline rank gate: <site>:<rank>:<round> (rank-gated sites)
            site, rank, rnd = parts
            ranks[site] = str(int(rank))
        else:
            raise ValueError(
                f"malformed LGBMTPU_FAULT entry {entry!r}: want "
                "<site>:<round> or <site>:<rank>:<round>")
        rounds[site] = int(rnd)
    return rounds, ranks


def parse_spec(raw: Optional[str] = None) -> Dict[str, int]:
    """``"site:round,site:round"`` -> {site: round} (rank qualifiers in the
    three-field form are validated and dropped here; :func:`_spec_ranks`
    carries them)."""
    if raw is None:
        raw = os.environ.get("LGBMTPU_FAULT", "")
    return _parse_full(raw)[0]


def _refresh_spec() -> None:
    global _spec_cache
    raw = os.environ.get("LGBMTPU_FAULT", "")
    if _spec_cache[0] != raw:
        rounds, ranks = _parse_full(raw)
        _spec_cache = (raw, rounds, ranks)


def _spec() -> Dict[str, int]:
    _refresh_spec()
    return _spec_cache[1]


def _spec_ranks() -> Dict[str, str]:
    _refresh_spec()
    return _spec_cache[2]


def _this_rank() -> str:
    """The rank a fault gate compares against: the fleet-GLOBAL worker
    id when the launcher set one (multi-slice fleets reuse slice-LOCAL
    rendezvous ranks per slice, so LIGHTGBM_TPU_RANK alone would fire
    the fault in every slice at once), else LIGHTGBM_TPU_RANK."""
    return os.environ.get("LGBM_TPU_WORKER_ID",
                          os.environ.get("LIGHTGBM_TPU_RANK", ""))


def _rank_allows(site: str) -> bool:
    inline = _spec_ranks().get(site)
    if inline is not None:
        # inline <site>:<rank>:<round> form wins over the env gate
        return _this_rank() == inline
    if site not in _RANK_GATED_SITES:
        return True
    want = os.environ.get("LGBMTPU_FAULT_RANK")
    if want is None:
        return True
    return _this_rank() == want


def _once_marker(site: str, round_i: int) -> Optional[str]:
    d = os.environ.get("LGBMTPU_FAULT_ONCE_DIR")
    if not d:
        return None
    return os.path.join(d, f"lgbmtpu_fault_{site}_{round_i}.fired")


def armed(site: str) -> bool:
    """True when the env spec arms ``site`` at ANY round — lets hot paths
    skip injection scaffolding (e.g. the snapshot writer's split-write)
    entirely when no fault is armed."""
    return site in _spec()


def fire(site: str, round_i: Optional[int] = None) -> bool:
    """True exactly once when ``site`` is armed for this round.

    ``round_i`` is the caller's 1-based round for round-stamped sites;
    call-counted sites (trace-time Pallas sites) pass None and match on
    the per-site call counter instead."""
    spec = _spec()
    if site not in spec:
        return False
    if round_i is None:
        if site not in _CALL_COUNTED_SITES:
            raise ValueError(f"site {site!r} needs an explicit round")
        round_i = _call_counts.get(site, 0)
        _call_counts[site] = round_i + 1
    if spec[site] != round_i:
        return False
    if not _rank_allows(site):
        return False
    key = (site, round_i)
    if key in _fired:
        return False
    marker = _once_marker(site, round_i)
    if marker is not None and os.path.exists(marker):
        return False
    _fired.add(key)
    if marker is not None:
        try:
            with open(marker, "w") as fh:
                fh.write(f"{os.getpid()}\n")
        except OSError:
            pass  # marker is best-effort; in-process registry still holds
    # telemetry (lazy import: this module must stay importable without the
    # package's jax-importing __init__ cost mattering — obs is stdlib-only).
    # Crash sites record BEFORE dying, so the event reaches the JSONL sink
    # (the in-memory ring dies with the process, the file line survives).
    from ..obs import metrics as _obs

    _obs.counter("faults_injected_total").inc()
    _obs.event("fault", site=site, round=round_i)
    return True


def maybe_crash(site: str, round_i: Optional[int] = None) -> None:
    """Hard, unclean process death — no atexit, no finally blocks, no
    flushing: the closest a test can get to a preemption."""
    if fire(site, round_i):
        # make the death visible in worker logs before dying unflushed
        print(f"[LightGBM-TPU] [Fault] injected {site} crash "
              f"(round {round_i})", flush=True)
        os._exit(CRASH_EXIT_CODE)


def maybe_hang(site: str, round_i: Optional[int] = None) -> None:
    """Sleep FOREVER when the site fires — the wedged-in-a-collective
    failure class (a rank stuck in an all-reduce never exits, so exit-code
    watchdogs never fire; only heartbeat staleness catches it).  The fault
    event and the cross-process once-marker are written by :func:`fire`
    BEFORE the hang, so a watchdog relaunch runs clean."""
    if fire(site, round_i):
        print(f"[LightGBM-TPU] [Fault] injected {site} hang "
              f"(round {round_i}) — sleeping forever", flush=True)
        while True:
            time.sleep(3600)


def maybe_fail(site: str, round_i: Optional[int] = None) -> None:
    """Raise :class:`InjectedFault` when the site fires (kernel-failure
    sites — the degradation path in utils/degrade.py recognizes it)."""
    if fire(site, round_i):
        raise InjectedFault(site, round_i if round_i is not None else -1)


def corrupt_nonfinite(site: str, round_i: int, arr):
    """Return ``arr`` with element 0 set to NaN when the site fires —
    the non-finite-gradient failure class for the guard-rail tests.
    Device arrays stay device arrays (jnp ``.at[]`` update)."""
    if not fire(site, round_i):
        return arr
    import numpy as np

    if hasattr(arr, "at"):  # jax array
        return arr.at[(0,) * arr.ndim].set(np.nan)
    arr = np.asarray(arr, dtype=np.float64).copy()
    arr[(0,) * arr.ndim] = np.nan
    return arr


def reset() -> None:
    """Clear the fired registry and call counters (tests only; marker
    files in LGBMTPU_FAULT_ONCE_DIR are the caller's to clean)."""
    global _spec_cache
    _fired.clear()
    _call_counts.clear()
    _spec_cache = (None, {}, {})
