"""Command-line driver: `python -m lightgbm_tpu_torch config=train.conf [key=value ...]`.

Counterpart of lightgbm_tpu/cli.py (reference: src/main.cpp +
src/application/application.cpp, Application::{Run, LoadData, InitTrain,
Train, Predict, ConvertModel}, and the CLI's conventions: a config= file
of `key = value` lines, `key=value` arguments over it, tasks train,
predict, convert_model and refit).  Training and prediction run on the
card unless ``device_type=cpu``.  The network parameters (num_machines,
machines, local_listen_port, ...) bring one rank of a torch.distributed
world up, as lightgbm_tpu_torch.train does with them.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset
from .config import Config
from .engine import train as train_fn
from .io.parser import load_data_file
from .utils.log import log_info, log_warning


def parse_config_file(path: str) -> Dict[str, str]:
    """LightGBM conf format: `key = value` per line, `#` comments."""
    out: Dict[str, str] = {}
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def parse_argv(argv: List[str]) -> Dict[str, str]:
    params: Dict[str, str] = {}
    conf_file = None
    for tok in argv:
        if "=" not in tok:
            log_warning(f"ignoring malformed argument: {tok!r}")
            continue
        k, v = tok.split("=", 1)
        k = k.strip()
        if k in ("config", "config_file"):
            conf_file = v.strip()
        else:
            params[k] = v.strip()
    if conf_file:
        file_params = parse_config_file(conf_file)
        file_params.update(params)  # CLI overrides file (reference behavior)
        params = file_params
    return params


def _load_dataset(cfg: Config, path: str, params: Dict, reference=None) -> Dataset:
    if cfg.two_round:
        # streaming two-pass load (reference: two_round=true): the Dataset
        # takes the path and bins per chunk without a raw float matrix
        return Dataset(path, params=params, reference=reference)
    loaded = load_data_file(
        path,
        header=cfg.header,
        label_column=cfg.label_column,
        weight_column=cfg.weight_column,
        group_column=cfg.group_column,
        ignore_column=cfg.ignore_column,
    )
    return Dataset(
        loaded["data"],
        label=loaded["label"],
        weight=loaded["weight"],
        group=loaded["group"],
        feature_name=loaded["feature_names"],
        params=params,
        reference=reference,
    )


def run(argv: Optional[List[str]] = None) -> int:
    params = parse_argv(list(argv if argv is not None else sys.argv[1:]))
    cfg = Config.from_dict(params)
    task = cfg.task
    if task == "train":
        return _task_train(cfg, params)
    if task in ("predict", "prediction", "test"):
        return _task_predict(cfg, params)
    if task == "convert_model":
        return _task_convert(cfg)
    if task == "refit":
        return _task_refit(cfg, params)
    log_warning(f"unknown task {task!r}")
    return 1


def _task_train(cfg: Config, params: Dict) -> int:
    if not cfg.data:
        log_warning("task=train requires data=<file>")
        return 1
    train_set = _load_dataset(cfg, cfg.data, params)
    valid_sets = []
    valid_names = []
    for i, vpath in enumerate(cfg.valid if isinstance(cfg.valid, list) else [cfg.valid]):
        if not vpath:
            continue
        valid_sets.append(_load_dataset(cfg, vpath, params, reference=train_set))
        valid_names.append(f"valid_{i}")
    from .callback import log_evaluation

    init_model = cfg.input_model if cfg.input_model else None
    bst = train_fn(
        params,
        train_set,
        num_boost_round=cfg.num_iterations,
        valid_sets=valid_sets,
        valid_names=valid_names,
        init_model=init_model,
        callbacks=[log_evaluation(max(cfg.metric_freq, 1))],
    )
    bst.save_model(cfg.output_model)
    log_info(f"finished training; model written to {cfg.output_model}")
    return 0


def _task_predict(cfg: Config, params: Dict) -> int:
    if not cfg.input_model or not cfg.data:
        log_warning("task=predict requires input_model=<file> and data=<file>")
        return 1
    bst = Booster(model_file=cfg.input_model, params={"device_type": cfg.device_type})
    loaded = load_data_file(
        cfg.data, header=cfg.header, label_column=cfg.label_column,
        weight_column=cfg.weight_column, group_column=cfg.group_column,
        ignore_column=cfg.ignore_column,
    )
    pred = bst.predict(
        loaded["data"],
        raw_score=cfg.predict_raw_score,
        pred_leaf=cfg.predict_leaf_index,
        pred_contrib=cfg.predict_contrib,
        num_iteration=cfg.num_iteration_predict,
        start_iteration=cfg.start_iteration_predict,
    )
    pred = np.asarray(pred)
    with open(cfg.output_result, "w") as fh:
        if pred.ndim == 1:
            fh.write("\n".join(f"{v:.18g}" for v in pred) + "\n")
        else:
            fh.write(
                "\n".join("\t".join(f"{v:.18g}" for v in row) for row in pred) + "\n"
            )
    log_info(f"predictions written to {cfg.output_result}")
    return 0


def _task_convert(cfg: Config) -> int:
    if not cfg.input_model:
        log_warning("task=convert_model requires input_model=<file>")
        return 1
    if cfg.convert_model_language not in ("", "cpp"):
        log_warning(f"convert_model_language={cfg.convert_model_language} unsupported (cpp only)")
        return 1
    bst = Booster(model_file=cfg.input_model, params={"device_type": cfg.device_type})
    code = bst._gbdt.to_if_else()
    with open(cfg.convert_model, "w") as fh:  # jaxlint: disable=R12 (generated C++ SOURCE, not a loadable model artifact: nothing ever parses it back as a checkpoint, so torn-write atomicity buys nothing here)
        fh.write(code)
    log_info(f"standalone C++ predictor written to {cfg.convert_model}")
    return 0


def _task_refit(cfg: Config, params: Dict) -> int:
    if not cfg.input_model or not cfg.data:
        log_warning("task=refit requires input_model=<file> and data=<file>")
        return 1
    bst = Booster(model_file=cfg.input_model, params={"device_type": cfg.device_type})
    loaded = load_data_file(
        cfg.data, header=cfg.header, label_column=cfg.label_column,
        weight_column=cfg.weight_column, group_column=cfg.group_column,
        ignore_column=cfg.ignore_column,
    )
    # CLI-only keys (task/data/input_model/...) must not reach refit(); the
    # refitted booster keeps the loaded model's own hyperparameters.
    new_bst = bst.refit(
        data=loaded["data"], label=loaded["label"], decay_rate=cfg.refit_decay_rate
    )
    new_bst.save_model(cfg.output_model)
    log_info(f"refitted model written to {cfg.output_model}")
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
