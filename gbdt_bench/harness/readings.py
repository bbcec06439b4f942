"""Helpers the per-layer readers (``metrics/<name>.py``) share."""

from __future__ import annotations

import re
from typing import Iterable, Optional

from ..roofline.peaks import hbm_bytes_per_s


def device_seconds(readings: dict, kernels: Iterable[str]) -> float:
    """Device seconds in the traced stretch of the ops whose names hold one
    of ``kernels`` as a whole identifier."""
    pats = [re.compile(r"\b" + re.escape(k) + r"\b") for k in kernels]
    return sum(sec for name, (sec, _) in readings["stretch"]["device_ops"].items()
               if any(p.search(name) for p in pats))


def roofline_pct(readings: dict, nbytes_per_step: float, seconds: float,
                 steps: int) -> Optional[float]:
    """Share of the bandwidth roofline, in %: the bytes the steps need at the
    card's peak, over ``seconds``; nothing where no time was read."""
    if seconds <= 0 or nbytes_per_step <= 0:
        return None
    peak = hbm_bytes_per_s(readings.get("device_kind", ""))
    return 100.0 * nbytes_per_step * steps / peak / seconds


def of_kind(readings: dict, kind: str) -> bool:
    return readings.get("kind") == kind and readings.get("stretch") is not None
