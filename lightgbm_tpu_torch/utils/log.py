"""Logging with redirect support.

Reference: include/LightGBM/utils/log.h (Log::{Debug,Info,Warning,Fatal},
Log::ResetCallBack) and python-package/lightgbm/basic.py register_logger.
"""

from __future__ import annotations

import logging
from typing import Optional

_logger: Optional[logging.Logger] = None
_info_method = "info"
_warning_method = "warning"
_verbosity = 1


def register_logger(logger: logging.Logger, info_method_name: str = "info",
                    warning_method_name: str = "warning") -> None:
    """Route framework log lines into a user logger (reference:
    lightgbm.register_logger)."""
    global _logger, _info_method, _warning_method
    _logger = logger
    _info_method = info_method_name
    _warning_method = warning_method_name


def set_verbosity(v: int) -> None:
    global _verbosity
    _verbosity = v


def log_debug(msg: str) -> None:
    if _verbosity >= 2:
        _emit(_info_method, f"[LightGBM-TPU] [Debug] {msg}")


def log_info(msg: str) -> None:
    if _verbosity >= 1:
        _emit(_info_method, f"[LightGBM-TPU] [Info] {msg}")


def log_warning(msg: str) -> None:
    if _verbosity >= 0:
        _emit(_warning_method, f"[LightGBM-TPU] [Warning] {msg}")


def log_fatal(msg: str):
    raise RuntimeError(f"[LightGBM-TPU] [Fatal] {msg}")


def _emit(method: str, line: str) -> None:
    if _logger is not None:
        getattr(_logger, method)(line)
    else:
        print(line)
