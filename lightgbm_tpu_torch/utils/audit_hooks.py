"""Recorder hooks for the trace audit (analysis/trace_audit.py).

The kernel wrappers (ops/hist_cuda.py, partition_cuda.py, round_cuda.py,
predict_cuda.py) are opaque ctypes calls on the card, and the collectives
(parallel/collectives.py) are c10d calls; the audit sees neither at
torch's dispatcher level.  So each wrapper entry is decorated with
``audited(entry)``, and each collective reports itself through
``collective``: with no recorder installed (every run but an audit) the
decorator is one list check and the report returns at once.  They read
nothing on the card and launch nothing.
"""

from __future__ import annotations

import functools
from typing import Callable, List

_recorders: List[object] = []


def install(recorder) -> None:
    _recorders.append(recorder)


def remove(recorder) -> None:
    _recorders.remove(recorder)


def audited(entry: str) -> Callable:
    """Decorate a kernel wrapper: a recorder sees (entry, args, kwargs)
    before the call and (entry, result) after it."""
    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _recorders:
                return fn(*args, **kwargs)
            for r in _recorders:
                r.wrapper_enter(entry, args, kwargs)
            out = None
            try:
                out = fn(*args, **kwargs)
                return out
            finally:
                for r in _recorders:
                    r.wrapper_exit(entry, out)
        return wrapper
    return deco


def collective(op: str, axis: str, nbytes: int) -> None:
    """A collective of parallel/collectives.py over the mesh axis ``axis``
    moving ``nbytes`` input bytes is about to be issued."""
    for r in _recorders:
        r.collective(op, axis, nbytes)
