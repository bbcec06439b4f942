"""Continuous training: streaming refit and zero-downtime rollover
(README "Continuous training"; the train-while-serving loop beside
lightgbm_tpu_torch/serve)."""

from .refit import ContinualError, fleet_refit_leaves, make_refit_entry, refit_leaves
from .runtime import ContinualRunner

__all__ = ["ContinualRunner", "ContinualError", "refit_leaves", "make_refit_entry",
           "fleet_refit_leaves"]
