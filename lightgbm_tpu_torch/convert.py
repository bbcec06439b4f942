"""Carry a model across from the JAX package.

A model's weights are its trees.  The device form (TreeArrays) and the text
form (the LightGBM `.txt` model) are shared by both packages; these helpers
move them into this package.  Neither imports the JAX package: callers hand
over numpy arrays or text.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .basic import Booster
from .ops.treegrow import TreeArrays


def tree_arrays_from_numpy(d: Dict[str, np.ndarray],
                           device: Optional[torch.device] = None) -> TreeArrays:
    """The JAX package's TreeArrays, moved to numpy as {field: array}, as
    this package's TreeArrays on ``device`` (default: the CPU)."""
    device = device if device is not None else torch.device("cpu")
    missing = [f for f in TreeArrays._fields if f != "path_features" and f not in d]
    if missing:
        raise ValueError(f"TreeArrays fields missing: {missing}")
    return TreeArrays(*[
        None if d.get(f) is None else torch.as_tensor(np.array(d[f]), device=device)
        for f in TreeArrays._fields])


def booster_from_jax_model_string(s: str, device_type: str = "cuda") -> Booster:
    """The JAX package's model text as a Booster of this package.  The text
    format is shared; this checks the header and loads."""
    head = s.split("\nTree=", 1)[0]
    if not head.startswith("tree\n") or "version=" not in head:
        raise ValueError("not a LightGBM text model (missing 'tree' header)")
    return Booster(params={"device_type": device_type}, model_str=s)
