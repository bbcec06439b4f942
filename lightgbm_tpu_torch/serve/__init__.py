"""In-process async serving runtime (README "Serving").

Continuous micro-batching of concurrent predicts onto one warm
executable: a request queue + coalescer packs concurrent requests into
the smallest covering pow-2 bucket rung (responses bitwise equal to
individual ``Booster.predict`` calls), pinned double-buffered host
staging feeds the device one batch ahead, and p99-SLO / queue-bound load
shedding turns overload into a typed :class:`Overloaded` error instead
of a hang.  Multi-model multi-tenant: N packed ensembles resident behind
one bucket ladder, hot-swappable without cooling the cache.

:class:`ServingFleet` replicates the dispatch side behind the same
admission queue: health-aware routing with an ejection/readmission
circuit breaker, ``serve_deadline_ms`` deadlines (typed
:class:`DeadlineExceeded`), exactly-once retry with a token budget,
optional p99-derived hedging, and a per-replica restart watchdog — the
resilient front door the chaos drills in tests/test_serve_fleet.py
exercise.
"""

from .fleet import ServingFleet
from .runtime import (MAX_BATCH_ROWS, DeadlineExceeded, Overloaded,
                      ServingRuntime)

__all__ = ["ServingRuntime", "ServingFleet", "Overloaded",
           "DeadlineExceeded", "MAX_BATCH_ROWS"]
