"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu (JAX, TPU).

Trains and predicts single-device serial GBDTs with the round-batched
grower; the multi-leaf histogram pass is a CUDA kernel written for Hopper
(csrc/hist.cu).  Entry points run on the CUDA card unless the parameters
say device_type='cpu'.  The JAX package (lightgbm_tpu) is the reference;
this package imports neither it nor JAX.
"""

from .basic import Booster, Dataset, LightGBMError
from .callback import EarlyStopException, early_stopping, log_evaluation, record_evaluation, reset_parameter
from .engine import train
from .utils.log import register_logger

__all__ = [
    "Dataset",
    "Booster",
    "LightGBMError",
    "train",
    "early_stopping",
    "log_evaluation",
    "record_evaluation",
    "reset_parameter",
    "EarlyStopException",
    "register_logger",
]
