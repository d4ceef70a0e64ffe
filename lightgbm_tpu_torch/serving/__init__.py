"""The serving layer over the device prediction engines.

Counterpart of ``lightgbm_tpu/serving/``: a micro-batch coalescer that
gathers concurrent small requests into one ladder-rung batch a tick
(``coalescer.py``), bounded admission with typed load shedding,
per-request deadlines, a model registry with warm-then-flip hot swaps and
rollback (``registry.py``), health and readiness probes
(``server.py``) and a command line (``cli.py``).

Entry point: ``Booster.serve(...)`` or :class:`PredictionServer`.
"""
from .coalescer import MicroBatchCoalescer, ServeFuture
from .errors import (ServerClosed, ServerOverloaded, ServingError,
                     ServingTimeout, SwapFailed)
from .registry import ModelRegistry
from .server import PredictionServer

__all__ = [
    "PredictionServer", "ModelRegistry", "MicroBatchCoalescer",
    "ServeFuture", "ServingError", "ServingTimeout", "ServerOverloaded",
    "ServerClosed", "SwapFailed",
]
