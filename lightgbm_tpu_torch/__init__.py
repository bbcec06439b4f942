"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu (JAX, TPU).

Trains and predicts single-device serial GBDTs (every objective and
metric of the JAX package, multiclass and ranking included; GBDT, GOSS,
DART and random forests) with the strict, round-batched or windowed grower,
through train, cv, Booster, the scikit-learn estimators and the command
line (python -m lightgbm_tpu_torch); prediction
gives margins, leaf ids, SHAP contributions and early-stopped margins
from an ensemble cached on the device.  train() writes snapshots and
resumes from them; serve() runs the coalescing serving runtime (or a
fleet of replicas); obs/ holds the metrics, traces and the /metrics
endpoint.  train_fleet trains B boosters over one Dataset as one batch of
lanes (models/fleet.py), out_of_core Datasets stream their bins in chunks
(the spill grower, ops/treegrow_ooc.py, when they exceed
max_rows_in_hbm), continual_train keeps a served model learning
(continual/), parallel/ trains over the ranks of a torch.distributed
world (data, voting, feature, 2-D and hierarchical; the launcher with its
recovery, and the Dask-style estimators of dask.py over it), and
plotting.py draws importances, metrics and trees (matplotlib and graphviz
imported at call time).
The histogram, partition and round kernels are CUDA written for Hopper
(csrc/).  Entry points run on the CUDA card unless the parameters say
device_type='cpu'.  The JAX package (lightgbm_tpu) is the reference; this
package imports neither it nor JAX.
"""

from .basic import Booster, CorruptModelError, Dataset, LightGBMError
from .callback import EarlyStopException, early_stopping, log_evaluation, record_evaluation, reset_parameter
from . import serve as _serve_pkg
from .serve import DeadlineExceeded, Overloaded, ServingFleet, ServingRuntime
from .serve import runtime as _serve_runtime_mod
# imported after the serve package, so the package attribute ``serve`` is
# the entry-point function (engine.serve); the subpackage's names are
# grafted onto it below, so ``lgb.serve.ServingRuntime`` works as well
from .engine import CVBooster, continual_train, cv, serve, train, train_fleet  # noqa: E402
from .models.fleet import FleetBooster, FleetError  # noqa: E402
from .utils.log import register_logger

for _name in _serve_pkg.__all__:
    setattr(serve, _name, getattr(_serve_pkg, _name))
serve.runtime = _serve_runtime_mod
del _name, _serve_pkg, _serve_runtime_mod

__all__ = [
    "Dataset",
    "Booster",
    "LightGBMError",
    "CorruptModelError",
    "train",
    "train_fleet",
    "continual_train",
    "FleetBooster",
    "FleetError",
    "serve",
    "ServingRuntime",
    "ServingFleet",
    "Overloaded",
    "DeadlineExceeded",
    "cv",
    "CVBooster",
    "early_stopping",
    "log_evaluation",
    "record_evaluation",
    "reset_parameter",
    "EarlyStopException",
    "register_logger",
]

from .sklearn import LGBMClassifier, LGBMModel, LGBMRanker, LGBMRegressor  # noqa: E402

__all__ += ["LGBMModel", "LGBMClassifier", "LGBMRegressor", "LGBMRanker"]

from .dask import DaskLGBMClassifier, DaskLGBMRanker, DaskLGBMRegressor  # noqa: E402
from .plotting import (create_tree_digraph, plot_importance, plot_metric,  # noqa: E402
                       plot_split_value_histogram, plot_tree)

__all__ += ["DaskLGBMClassifier", "DaskLGBMRegressor", "DaskLGBMRanker",
            "plot_importance", "plot_split_value_histogram", "plot_metric",
            "plot_tree", "create_tree_digraph"]
