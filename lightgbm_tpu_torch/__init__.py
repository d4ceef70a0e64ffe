"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

The same user surface as the JAX package (``Dataset``, ``Booster``,
``train``, ``cv``, the scikit-learn estimators, plotting, the text-file
loader and ``python -m lightgbm_tpu_torch config=train.conf``) on PyTorch,
with hand-written Hopper kernels for the TPU kernels of the training path
(``ops/pallas_histogram.py`` and ``ops/fused_split.py``, sources in
``csrc/``). The device comes from the ``device_type`` parameter: ``cuda``
(the default, alias ``gpu``) or ``cpu``, where every kernel is replaced by
its plain PyTorch version. The port imports nothing of the JAX package;
the estimators, plotting and ``register_parser`` load at first use
(``__getattr__``), and none of them needs scikit-learn, pandas or
matplotlib to import.
"""
from __future__ import annotations

from .basic import Booster, Dataset, Sequence
from .callback import (EarlyStopException, early_stopping, log_evaluation,
                       record_evaluation, reset_parameter)
from .config import Config
from .engine import CVBooster, cv, train

__version__ = "0.1.0"

_SKLEARN = ("LGBMModel", "LGBMRegressor", "LGBMClassifier", "LGBMRanker")
_PLOTTING = ("plot_importance", "plot_metric", "plot_split_value_histogram",
             "plot_tree", "create_tree_digraph")

__all__ = ["Booster", "CVBooster", "Config", "Dataset", "EarlyStopException",
           "Sequence", "cv", "early_stopping", "log_evaluation",
           "record_evaluation", "register_parser", "reset_parameter",
           "train", *_SKLEARN, *_PLOTTING]


def __getattr__(name):
    # the estimators, plotting and the parser registry load lazily, as the
    # JAX package's do (lightgbm_tpu/__init__.py:44-70)
    if name in _SKLEARN:
        from . import sklearn
        return getattr(sklearn, name)
    if name in _PLOTTING:
        from . import plotting
        return getattr(plotting, name)
    if name == "register_parser":
        from .io.loader import register_parser
        return register_parser
    raise AttributeError(
        f"module 'lightgbm_tpu_torch' has no attribute {name!r}")
