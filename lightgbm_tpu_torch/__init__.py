"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

The same user surface as the JAX package (``Dataset``, ``Booster``,
``train``) on PyTorch, with hand-written Hopper kernels for the two TPU
kernels of the training path (``ops/pallas_histogram.py`` and
``ops/fused_split.py``, sources in ``csrc/``). The device comes from the
``device_type`` parameter: ``cuda`` (the default, alias ``gpu``) or
``cpu``, where every kernel is replaced by its plain PyTorch version.
The port imports nothing of the JAX package.
"""
from __future__ import annotations

from .basic import Booster, Dataset
from .callback import log_evaluation, record_evaluation
from .config import Config
from .engine import train

__version__ = "0.1.0"

__all__ = ["Booster", "Config", "Dataset", "log_evaluation",
           "record_evaluation", "train"]
