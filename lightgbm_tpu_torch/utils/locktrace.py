"""Runtime lock tracing: the dynamic half of the concurrency layer.

The static lint (the JAX package's ``analysis/locks.py``, rules L1-L5) proves what
it can see lexically; this module watches what actually happens.  Every
named lock minted through the :func:`lock` / :func:`rlock` /
:func:`condition` factories is a thin wrapper around the matching
``threading`` primitive that, when tracing is enabled, additionally

* keeps a **per-thread held set** (thread-local; no extra locking on the
  hot path beyond the wrapped primitive itself),
* maintains a process-wide **witness graph** of observed acquisition
  orders keyed by lock *name* — the first time the process acquires
  ``B`` while holding ``A`` the edge ``A -> B`` is recorded together
  with its call site; a later acquire that would close a cycle raises
  :class:`LockOrderError` (strict mode) naming **both** sites, or counts
  it (record mode),
* converts every blocking acquire into a **timeout acquire**
  (``LGBMTPU_LOCK_TIMEOUT_S``, default 60s) so a true deadlock surfaces
  as a typed :class:`LockTimeoutError` instead of a hung process,
* exports ``lock_wait_ms{lock=<name>}`` / ``lock_held_ms{lock=<name>}``
  reservoirs and the ``lock_order_violations_total`` /
  ``lock_deadlock_timeouts_total`` counters through the obs registry.

Same-name, different-instance nesting (e.g. two ``GBDT`` pack locks held
by one rollover thread) records no self-edge: the witness graph is a
*name*-level order discipline, and a name never orders against itself.

Layering: :mod:`lightgbm_tpu_torch.obs` is stdlib-only and must stay importable
without this package, so obs-internal locks remain plain ``threading``
locks (covered by the static layer only) and this module imports
``obs.metrics`` lazily, inside functions, behind a thread-local mute
guard.  Enable for a whole run with ``LGBMTPU_LOCKTRACE=1`` or from code
via :func:`enable`; the tier-1 suite turns it on (strict) in conftest.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = [
    "LockOrderError", "LockTimeoutError", "TracedCondition", "TracedLock",
    "condition", "enable", "enabled", "lock", "rlock", "reset", "stats",
    "timeout_s",
]


class LockOrderError(RuntimeError):
    """Acquiring this lock would close a cycle in the witness graph."""


class LockTimeoutError(RuntimeError):
    """A traced acquire exceeded the deadlock timeout (or a thread
    re-acquired a non-reentrant traced lock it already holds)."""


def _env_flag(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() not in ("", "0", "false", "off", "no")


_ENABLED = _env_flag("LGBMTPU_LOCKTRACE", False)
_STRICT = _env_flag("LGBMTPU_LOCKTRACE_STRICT", True)
_TIMEOUT_S = float(os.environ.get("LGBMTPU_LOCK_TIMEOUT_S", "60"))

# Witness graph + counters.  _graph_lock is a leaf: nothing (traced or
# not) is ever acquired while holding it, and no blocking call runs
# under it — the obs export happens after release, behind the mute TLS.
_graph_lock = threading.Lock()
_edges: Dict[Tuple[str, str], Tuple[str, int]] = {}  # (held, acq) -> site
_order_violations = 0
_deadlock_timeouts = 0

_tls = threading.local()  # .held: List[TracedLock], .mute: bool


def _held_stack() -> List["TracedLock"]:
    st = getattr(_tls, "held", None)
    if st is None:
        st = _tls.held = []
    return st


def _call_site() -> Tuple[str, int]:
    """First frame outside this module — the acquire's real call site."""
    f = sys._getframe(1)
    while f is not None and f.f_code.co_filename == __file__:
        f = f.f_back
    if f is None:  # pragma: no cover — only if called at module top level
        return ("<unknown>", 0)
    return (f.f_code.co_filename, f.f_lineno)


def _reaches(src: str, dst: str) -> Optional[List[Tuple[str, str]]]:
    """DFS path src -> dst over the witness edges (caller holds
    _graph_lock); returns the edge list of one path, else None."""
    stack: List[Tuple[str, List[Tuple[str, str]]]] = [(src, [])]
    seen = {src}
    adj: Dict[str, List[str]] = {}
    for (a, b) in _edges:
        adj.setdefault(a, []).append(b)
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in adj.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [(node, nxt)]))
    return None


def _record(fn) -> None:
    """Run an obs-recording thunk behind the reentrancy mute guard."""
    if getattr(_tls, "mute", False):
        return
    _tls.mute = True
    try:
        fn()
    except Exception:
        pass  # observability must never take down the locked path
    finally:
        _tls.mute = False


def _obs_counter_inc(name: str) -> None:
    def thunk():
        from ..obs import metrics as _m
        _m.counter(name).inc()
    _record(thunk)


def _obs_observe_ms(family: str, lock_name: str, ms: float) -> None:
    def thunk():
        from ..obs import metrics as _m
        _m.histogram(_m.labeled(family, lock=lock_name)).observe(ms)
    _record(thunk)


class TracedLock:
    """Named wrapper over ``threading.Lock``/``RLock`` with witness-graph
    order checking, timeout acquire, and wait/held timing.

    When tracing is disabled the wrapper is a plain pass-through (one
    attribute hop per acquire/release) so factory call sites never need
    to branch on the mode themselves.
    """

    __slots__ = ("name", "reentrant", "_inner", "_depth", "_acquired_at")

    def __init__(self, name: str, reentrant: bool = False) -> None:
        self.name = name
        self.reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()
        self._depth: Dict[int, int] = {}       # thread ident -> hold depth
        self._acquired_at: Dict[int, float] = {}  # ident -> monotonic ts

    # -- order discipline -------------------------------------------------

    def _check_order(self) -> None:
        """Witness-graph update for acquiring self while holding the
        thread's current stack; raises LockOrderError on a cycle."""
        global _order_violations
        held = _held_stack()
        if not held:
            return
        me = self.name
        site = _call_site()
        violation: Optional[str] = None
        with _graph_lock:
            for h in held:
                if h.name == me:
                    continue  # same name never orders against itself
                edge = (h.name, me)
                if edge in _edges:
                    continue
                back = _reaches(me, h.name)
                if back is not None:
                    first_a, first_b = back[0]
                    f_file, f_line = _edges[(first_a, first_b)]
                    _order_violations += 1
                    violation = (
                        f"lock-order inversion: acquiring '{me}' while "
                        f"holding '{h.name}' at {site[0]}:{site[1]}, but "
                        f"the witness graph orders '{first_a}' before "
                        f"'{first_b}' (first seen at {f_file}:{f_line})"
                    )
                    break
                _edges[edge] = site
        if violation is not None:
            _obs_counter_inc("lock_order_violations_total")
            if _STRICT:
                raise LockOrderError(violation)

    # -- lock protocol ----------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not _ENABLED:
            return self._inner.acquire(blocking, timeout)
        global _deadlock_timeouts
        ident = threading.get_ident()
        depth = self._depth.get(ident, 0)
        if depth and not self.reentrant:
            with _graph_lock:
                _deadlock_timeouts += 1
            _obs_counter_inc("lock_deadlock_timeouts_total")
            raise LockTimeoutError(
                f"self-deadlock: thread re-acquired non-reentrant lock "
                f"'{self.name}' it already holds "
                f"(at {':'.join(map(str, _call_site()))})"
            )
        if depth == 0:
            self._check_order()
        t0 = time.monotonic()
        if not blocking:
            ok = self._inner.acquire(False)
        else:
            eff = timeout if timeout is not None and timeout >= 0 else _TIMEOUT_S
            ok = self._inner.acquire(True, eff)
            if not ok and (timeout is None or timeout < 0):
                with _graph_lock:
                    _deadlock_timeouts += 1
                _obs_counter_inc("lock_deadlock_timeouts_total")
                raise LockTimeoutError(
                    f"deadlock suspected: lock '{self.name}' not acquired "
                    f"within {_TIMEOUT_S:.1f}s "
                    f"(at {':'.join(map(str, _call_site()))})"
                )
        if ok:
            if depth == 0:
                self._acquired_at[ident] = time.monotonic()
                _held_stack().append(self)
                _obs_observe_ms(
                    "lock_wait_ms", self.name,
                    (time.monotonic() - t0) * 1000.0)
            self._depth[ident] = depth + 1
        return ok

    def release(self) -> None:
        if not _ENABLED:
            self._inner.release()
            return
        ident = threading.get_ident()
        depth = self._depth.get(ident, 0)
        if depth <= 0:
            # never acquired through the traced path (e.g. tracing was
            # flipped on mid-hold) — fall through to the primitive
            self._inner.release()
            return
        if depth == 1:
            del self._depth[ident]
            t0 = self._acquired_at.pop(ident, None)
            st = _held_stack()
            if self in st:
                st.remove(self)
            if t0 is not None:
                _obs_observe_ms(
                    "lock_held_ms", self.name,
                    (time.monotonic() - t0) * 1000.0)
        else:
            self._depth[ident] = depth - 1
        self._inner.release()

    def locked(self) -> bool:
        if self.reentrant:
            return bool(self._depth)
        return self._inner.locked()

    def _is_owned(self) -> bool:
        """threading.Condition hook: does the current thread hold us?"""
        if not _ENABLED:
            # best-effort probe, mirroring Condition's default fallback
            if self._inner.acquire(False):
                self._inner.release()
                return False
            return True
        return self._depth.get(threading.get_ident(), 0) > 0

    def __enter__(self) -> "TracedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        kind = "rlock" if self.reentrant else "lock"
        return f"<TracedLock {kind} '{self.name}' depth={dict(self._depth)}>"


class TracedCondition(threading.Condition):
    """``threading.Condition`` over a named non-reentrant TracedLock.

    Condition's own wait/notify machinery calls ``self._lock.acquire`` /
    ``release`` directly, so the witness bookkeeping stays consistent
    across ``wait()``'s release/re-acquire; ``_is_owned`` comes from the
    traced lock's thread-local depth instead of the probe fallback.
    """

    def __init__(self, name: str) -> None:
        self.name = name
        super().__init__(TracedLock(name, reentrant=False))


def lock(name: str) -> TracedLock:
    """A named, traced ``threading.Lock``."""
    return TracedLock(name, reentrant=False)


def rlock(name: str) -> TracedLock:
    """A named, traced ``threading.RLock``."""
    return TracedLock(name, reentrant=True)


def condition(name: str) -> TracedCondition:
    """A named ``threading.Condition`` over a traced lock."""
    return TracedCondition(name)


def enable(on: bool = True, strict: bool = True) -> None:
    """Flip runtime tracing for the whole process.

    ``strict=True`` raises :class:`LockOrderError` on a witnessed
    inversion; ``strict=False`` only counts it (record mode).  Locks
    minted before the flip participate from their next acquire on.
    """
    global _ENABLED, _STRICT
    _ENABLED = bool(on)
    _STRICT = bool(strict)


def enabled() -> bool:
    return _ENABLED


def timeout_s() -> float:
    return _TIMEOUT_S


def set_timeout_s(s: float) -> None:
    """Deadlock-suspicion bound for blocking acquires (tests)."""
    global _TIMEOUT_S
    _TIMEOUT_S = float(s)


def reset() -> None:
    """Clear the witness graph and the violation counters (tests).

    Obs-side counters are owned by the registry — reset those with
    ``lightgbm_tpu_torch.obs.reset()``."""
    global _order_violations, _deadlock_timeouts
    with _graph_lock:
        _edges.clear()
        _order_violations = 0
        _deadlock_timeouts = 0


def stats() -> Dict[str, int]:
    """Internal tallies, independent of the obs registry lifecycle."""
    with _graph_lock:
        return {
            "witness_edges": len(_edges),
            "order_violations": _order_violations,
            "deadlock_timeouts": _deadlock_timeouts,
        }


def witness_edges() -> Dict[Tuple[str, str], Tuple[str, int]]:
    """Snapshot of the witness graph: (held, acquired) -> first site."""
    with _graph_lock:
        return dict(_edges)
