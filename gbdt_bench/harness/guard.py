"""The import guard: no module of JAX or of the JAX package may be loaded in
the process that prints a result.  Names are compared by their top-level
part, whole: ``lightgbm_tpu_torch`` is the port, ``lightgbm_tpu`` is not."""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "lightgbm_tpu")


def forbidden(modules: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: those
    loaded now)."""
    names = sys.modules.keys() if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(t for t in tops if t in FORBIDDEN)
