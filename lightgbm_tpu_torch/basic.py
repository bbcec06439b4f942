"""Dataset and Booster.

Counterpart of lightgbm_tpu/basic.py for dense in-memory data (reference:
python-package/lightgbm/basic.py).  A Dataset is binned on the host
(binning.py, bitwise the JAX package's bins) and shipped to the device as an
(N, F) int16 matrix; a Booster wraps models/gbdt.py.

Not ported yet, and raising when asked for: file and bin-cache input,
out-of-core, EFB bundling, sparse and arrow input (ROADMAP queue A2).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from .binning import DatasetBinner
from .config import Config
from .models.gbdt import GBDT


class LightGBMError(Exception):
    """reference: LightGBMError in python-package/lightgbm/basic.py."""


def _to_2d_float(data) -> np.ndarray:
    """numpy arrays, nested lists and pandas frames (categorical columns as
    their codes) -> (N, F) float64."""
    if isinstance(data, (str, os.PathLike)):
        raise NotImplementedError("file and bin-cache input are not ported to "
                                  "lightgbm_tpu_torch yet (ROADMAP queue A2)")
    if hasattr(data, "tocsr") and hasattr(data, "toarray"):
        raise NotImplementedError("sparse input is not ported to "
                                  "lightgbm_tpu_torch yet (ROADMAP queue A2)")
    if hasattr(data, "schema") and hasattr(data, "column"):
        raise NotImplementedError("arrow input is not ported to "
                                  "lightgbm_tpu_torch yet (ROADMAP queue A2)")
    if hasattr(data, "dtypes") and hasattr(data, "columns"):  # pandas frame
        import pandas as pd  # local: pandas is optional

        cols = []
        for c in data.columns:
            col = data[c]
            if isinstance(col.dtype, pd.CategoricalDtype):
                codes = col.cat.codes.to_numpy().astype(np.float64)
                codes[codes < 0] = np.nan  # NA category -> missing
                cols.append(codes)
            else:
                cols.append(col.to_numpy(dtype=np.float64, na_value=np.nan))
        return np.stack(cols, axis=1)
    if hasattr(data, "values"):  # pandas series
        data = data.values
    arr = np.asarray(data, dtype=np.float64)
    return arr.reshape(-1, 1) if arr.ndim == 1 else arr


class Dataset:
    """reference: class Dataset in python-package/lightgbm/basic.py.
    Lazily constructed: raw data is held until `construct()`, which the
    training entry calls."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List[int]] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True, position=None):
        self.data = data
        self.label = None if label is None else np.asarray(label, dtype=np.float64).ravel()
        self.reference = reference
        self.weight = None if weight is None else np.asarray(weight, dtype=np.float64).ravel()
        # query sizes in row order (ranking objectives and metrics)
        self.group = None if group is None else np.asarray(group, dtype=np.int64).ravel()
        # each row's display position (LambdaRank position bias)
        self.position = (None if position is None
                         else np.asarray(position, dtype=np.int64).ravel())
        # (N,) or, for K trees an iteration, (N, K) or N * K row-major
        self.init_score = None if init_score is None else np.asarray(init_score, dtype=np.float64)
        self.params = dict(params or {})
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.free_raw_data = free_raw_data
        self._constructed = False
        self.binner: Optional[DatasetBinner] = None
        self.bins: Optional[np.ndarray] = None
        self.feature_names: List[str] = []

    def construct(self, reference: Optional["Dataset"] = None,
                  device: Optional[torch.device] = None) -> "Dataset":
        """Bin on the host and upload the (N, F) int16 matrix to ``device``
        (default: the one the parameters' device_type names)."""
        if self._constructed:
            return self
        from .models.gbdt import resolve_device

        ref = reference if reference is not None else self.reference
        cfg = Config.from_dict(self.params)
        for name in ("out_of_core", "two_round"):
            if getattr(cfg, name):
                raise NotImplementedError(f"{name} is not ported to "
                                          "lightgbm_tpu_torch yet (ROADMAP queue A2)")
        if cfg.is_set("enable_bundle") and cfg.enable_bundle:
            raise NotImplementedError("EFB bundling (enable_bundle=true) is "
                                      "not ported to lightgbm_tpu_torch yet "
                                      "(ROADMAP queue A2)")
        for name in ("label", "weight", "init_score"):
            v = getattr(self, name)
            if v is not None and not np.all(np.isfinite(v)):
                raise ValueError(f"{name} contains non-finite values")
        device = device if device is not None else resolve_device(cfg)
        raw = _to_2d_float(self.data)
        n, f = raw.shape
        if self.group is not None and int(self.group.sum()) != n:
            raise ValueError(f"group sizes sum to {int(self.group.sum())}, "
                             f"but the data has {n} rows")
        if isinstance(self.feature_name, (list, tuple)):
            self.feature_names = list(self.feature_name)
        elif hasattr(self.data, "columns"):
            self.feature_names = [str(c) for c in self.data.columns]
        else:
            self.feature_names = [f"Column_{i}" for i in range(f)]
        if ref is not None:
            ref.construct(device=device)
            self.binner = ref.binner  # bin alignment with the reference set
        else:
            cats = []
            if isinstance(self.categorical_feature, (list, tuple)):
                cats = [self.feature_names.index(c) if isinstance(c, str) else int(c)
                        for c in self.categorical_feature]
            if cats:
                raise NotImplementedError("categorical features are not ported "
                                          "to lightgbm_tpu_torch yet (ROADMAP queue A5)")
            if cfg.forcedbins_filename:
                raise NotImplementedError("forcedbins_filename is not ported "
                                          "yet (ROADMAP queue A2)")
            self.binner = DatasetBinner.fit(
                raw, max_bin=cfg.max_bin, min_data_in_bin=cfg.min_data_in_bin,
                sample_cnt=cfg.bin_construct_sample_cnt,
                use_missing=cfg.use_missing, zero_as_missing=cfg.zero_as_missing,
                max_bin_by_feature=cfg.max_bin_by_feature,
                seed=cfg.data_random_seed)
        self.bins = self.binner.transform(raw)
        self.bins_device = torch.as_tensor(self.bins.astype(np.int16), device=device)
        self.num_bins_pf_device = torch.as_tensor(
            self.binner.num_bins_per_feature, dtype=torch.int32, device=device)
        self.missing_bin_pf_device = torch.as_tensor(
            self.binner.missing_bin_per_feature, dtype=torch.int32, device=device)
        self.max_num_bins = int(self.binner.max_num_bins)
        self._num_data, self._num_feature = n, f
        if self.free_raw_data:
            self.data = None
        self._constructed = True
        return self

    def num_data(self) -> int:
        if self._constructed:
            return self._num_data
        return _to_2d_float(self.data).shape[0]

    def num_feature(self) -> int:
        if self._constructed:
            return self._num_feature
        return _to_2d_float(self.data).shape[1]

    @property
    def query_boundaries(self) -> Optional[np.ndarray]:
        """(Q + 1,) row offsets of the queries, or None without groups."""
        if self.group is None:
            return None
        return np.concatenate([[0], np.cumsum(self.group)]).astype(np.int64)

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params)


class Booster:
    """reference: class Booster in python-package/lightgbm/basic.py."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self.params = dict(params or {})
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        if model_file is not None:
            model_str = Path(model_file).read_text(encoding="utf-8")
        if model_str is not None:
            device_type = Config.from_dict(self.params).device_type
            self._gbdt = GBDT.load_model_from_string(model_str, device_type)
            self.cfg = self._gbdt.cfg
        elif train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("Training data should be Dataset instance")
            merged = dict(train_set.params or {})
            merged.update(self.params)
            train_set.params = merged
            self.cfg = Config.from_dict(self.params)
            self._gbdt = GBDT(self.cfg, train_set)
        else:
            raise LightGBMError("need either params+train_set or a model")

    # -- training -------------------------------------------------------
    def update(self) -> bool:
        """One boosting iteration; True if training should stop."""
        return self._gbdt.train_one_iter()

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        self._gbdt.add_valid(data, name)
        return self

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """Runtime-resettable params (learning_rate etc.; reference:
        Booster.reset_parameter)."""
        self.params.update(params)
        self._gbdt.cfg.update(params)
        self._gbdt.reset_split_params()
        return self

    def current_iteration(self) -> int:
        return self._gbdt.iter_

    def num_trees(self) -> int:
        return len(self._gbdt.models)

    def num_feature(self) -> int:
        return len(self._gbdt.feature_names)

    def feature_name(self) -> List[str]:
        return list(self._gbdt.feature_names)

    def feature_importance(self, importance_type: str = "split") -> np.ndarray:
        return self._gbdt.feature_importance(importance_type)

    # -- eval -------------------------------------------------------------
    def eval_train(self):
        return self._eval(0, self._gbdt.train_name)

    def eval_valid(self):
        out = []
        for i, name in enumerate(self._gbdt.valid_names):
            out.extend(self._eval(i + 1, name))
        return out

    def _eval(self, data_idx: int, name: str):
        return [(name, mname, val, hib)
                for (_n, mname, val, hib) in self._gbdt.eval_at(data_idx)]

    # -- prediction -------------------------------------------------------
    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False, **kwargs) -> np.ndarray:
        for k in ("pred_leaf", "pred_contrib", "mesh"):
            if kwargs.get(k):
                raise NotImplementedError(f"{k} is not ported to "
                                          "lightgbm_tpu_torch yet (ROADMAP queue A3)")
        if num_iteration is None:
            num_iteration = self.best_iteration if self.best_iteration > 0 else -1
        X = _to_2d_float(data)
        n_feat = self.num_feature()
        if (n_feat and X.shape[1] != n_feat
                and not kwargs.get("predict_disable_shape_check", False)):
            raise LightGBMError(
                f"The number of features in data ({X.shape[1]}) is not the same "
                f"as it was in training data ({n_feat}). You can set "
                f"predict_disable_shape_check=true to discard this error.")
        return self._gbdt.predict(X, raw_score=raw_score,
                                  start_iteration=start_iteration,
                                  num_iteration=num_iteration)

    # -- serialization ----------------------------------------------------
    def model_to_string(self, num_iteration: int = -1, start_iteration: int = 0,
                        importance_type: Optional[str] = None) -> str:
        return self._gbdt.save_model_to_string(num_iteration, start_iteration,
                                               importance_type)

    def save_model(self, filename, num_iteration: int = -1,
                   start_iteration: int = 0,
                   importance_type: Optional[str] = None) -> "Booster":
        tmp = f"{filename}.tmp"
        Path(tmp).write_text(self.model_to_string(
            num_iteration, start_iteration, importance_type), encoding="utf-8")
        os.replace(tmp, filename)  # atomic: never a torn model file
        return self

    @classmethod
    def model_from_string(cls, model_str: str,
                          params: Optional[Dict[str, Any]] = None) -> "Booster":
        return cls(params=params, model_str=model_str)
