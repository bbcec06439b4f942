"""Carry a model across from the JAX package.

A model's weights are its trees.  The device form (TreeArrays) and the text
form (the LightGBM `.txt` model) are shared by both packages; these helpers
move them into this package, and ``fleet_from_numpy`` a fleet's stacked
per-lane trees.  Neither imports the JAX package: callers hand over numpy
arrays or text.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .basic import Booster
from .config import Config
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


def fleet_from_numpy(iters: List[Dict[str, np.ndarray]], train_set, params, *,
                     init_scores: Sequence[float], shrinkages: Sequence[float],
                     rounds: Optional[Sequence[int]] = None):
    """A JAX FleetBooster's lanes as this package's FleetBooster: ``iters``
    holds its stacked trees of each iteration as numpy, {field: (B, ...)}
    (its ``_host_iter(i)``), ``shrinkages`` each iteration's shrinkage,
    ``init_scores`` each lane's init score and ``rounds`` each lane's
    budget (default: every iteration).  ``train_set`` is this package's
    Dataset over the fleet's feature data (its bin mappers read the
    thresholds).  Its ``booster(b)`` predicts, saves and serves lane b."""
    from .models.fleet import FleetBooster, _lane_inits

    if not iters:
        raise ValueError("fleet_from_numpy: no iterations")
    lanes = int(np.shape(iters[0]["num_leaves"])[0])
    n = train_set.construct().num_data()
    fb = FleetBooster.__new__(FleetBooster)
    fb.params = dict(params or {})
    fb.cfg = Config.from_dict(dict(fb.params))
    fb.fleet_size = lanes
    fb.train_set = train_set
    fb.device = torch.device("cpu") if fb.cfg.device_type == "cpu" else torch.device(
        "cuda", torch.cuda.current_device())
    fb.binner = train_set.binner
    fb.feature_names = list(train_set.feature_names)
    fb._objectives = _lane_inits(fb.cfg, np.zeros((lanes, n)), None, fb.device)[0]
    fb.init_scores = [float(v) for v in init_scores]
    fb._rounds = (np.full(lanes, len(iters), np.int64) if rounds is None
                  else np.asarray(rounds, np.int64))
    fb._iters = [([tree_arrays_from_numpy({k: np.asarray(v)[b] for k, v in it.items()},
                                          fb.device) for b in range(lanes)], float(s))
                 for it, s in zip(iters, shrinkages)]
    fb._bad = torch.zeros(lanes, dtype=torch.int32, device=fb.device)
    fb._lanes, fb.round_stats, fb._graphs, fb._trained = {}, [], None, True
    return fb
