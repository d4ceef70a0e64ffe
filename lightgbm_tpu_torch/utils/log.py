"""Logging for lightgbm_tpu_torch.

Copy of ``lightgbm_tpu/utils/log.py`` (the port imports nothing of the JAX
package). Re-design of the reference's ``Log`` singleton
(reference: include/LightGBM/utils/log.h:78-180): levels Fatal/Warning/Info/Debug,
redirectable callback (the reference's ``Log::ResetCallBack``; Python side routes
through ``register_logger`` in python-package/lightgbm/basic.py:232-301).
"""
from __future__ import annotations

import logging
import sys
from typing import Any

_logger: Any = logging.getLogger("lightgbm_tpu_torch")
_logger.addHandler(logging.StreamHandler(sys.stdout))
_logger.setLevel(logging.INFO)

_info_method_name = "info"
_warning_method_name = "warning"

# verbosity: <0 = fatal only, 0 = warning+, 1 = info+, >1 = debug
_verbosity = 1


def register_logger(
    logger: Any,
    info_method_name: str = "info",
    warning_method_name: str = "warning",
) -> None:
    """Redirect lightgbm_tpu_torch's logging to a custom logger object."""
    global _logger, _info_method_name, _warning_method_name
    if not callable(getattr(logger, info_method_name, None)) or not callable(
        getattr(logger, warning_method_name, None)
    ):
        raise TypeError("logger must provide callable info/warning methods")
    _logger = logger
    _info_method_name = info_method_name
    _warning_method_name = warning_method_name


def set_verbosity(verbosity: int) -> None:
    global _verbosity
    _verbosity = verbosity


def get_verbosity() -> int:
    return _verbosity


def debug(msg: str) -> None:
    if _verbosity >= 2:
        getattr(_logger, _info_method_name)(f"[LightGBM-Torch] [Debug] {msg}")


def info(msg: str) -> None:
    if _verbosity >= 1:
        getattr(_logger, _info_method_name)(f"[LightGBM-Torch] [Info] {msg}")


def warning(msg: str) -> None:
    if _verbosity >= 0:
        getattr(_logger, _warning_method_name)(f"[LightGBM-Torch] [Warning] {msg}")


class LightGBMError(Exception):
    """Error raised by lightgbm_tpu_torch (mirrors the reference's LightGBMError)."""


def fatal(msg: str) -> None:
    raise LightGBMError(msg)
