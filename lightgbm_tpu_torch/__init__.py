"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu (JAX, TPU).

Trains and predicts single-device serial GBDTs (every objective and
metric of the JAX package, multiclass and ranking included; GBDT, GOSS,
DART and random forests) with the strict, round-batched or windowed grower,
through train, cv, Booster and the scikit-learn estimators; prediction
gives margins, leaf ids, SHAP contributions and early-stopped margins.
The histogram, partition and round kernels are CUDA written for Hopper
(csrc/).  Entry points run on the CUDA card unless the parameters say
device_type='cpu'.  The JAX package (lightgbm_tpu) is the reference; this
package imports neither it nor JAX.
"""

from .basic import Booster, Dataset, LightGBMError
from .callback import EarlyStopException, early_stopping, log_evaluation, record_evaluation, reset_parameter
from .engine import CVBooster, cv, train
from .utils.log import register_logger

__all__ = [
    "Dataset",
    "Booster",
    "LightGBMError",
    "train",
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
