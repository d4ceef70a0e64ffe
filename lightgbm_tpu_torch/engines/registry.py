"""The serving engine's resolution.

Counterpart of ``resolve_serving_engine`` of ``lightgbm_tpu/engines/
registry.py:630-704``: which per-row router serves a model, the
depth-batched walk (``walk``) or the level-order engine (``level``). The
user's ``tpu_predict_engine`` comes first (``batched`` and ``walk`` are the
walk, the default; ``level``; ``scan`` never reaches here, the callers
branch to the plain walk first); ``level`` above ``tpu_level_depth_cap``
keeps the walk, with a warning. ``auto`` takes the depth heuristic, the
level engine up to the cap: the JAX package's autotuner, which races the
two on the model's own trees, comes with ROADMAP A19, and its environment
override (``LGBM_TPU_PREDICT_ENGINE``) with it.
"""
from __future__ import annotations

from typing import NamedTuple

from ..utils import log

SERVING_ENGINE_VALUES = ("batched", "walk", "level", "auto", "scan")


class ServingResolution(NamedTuple):
    """The resolved router and where the choice came from (``user`` or
    ``default``)."""
    engine: str
    source: str


def resolve_serving_engine(engine: str, depth: int,
                           level_cap: int) -> ServingResolution:
    """``tpu_predict_engine`` (``engine``) as a router for trees whose
    deepest leaf is at ``depth``."""
    value = str(engine or "batched").lower()
    if value in ("batched", "walk"):
        return ServingResolution("walk", "user")
    if value == "level":
        if depth > level_cap:
            log.warning(f"tpu_predict_engine=level: stacked depth {depth} "
                        f"exceeds tpu_level_depth_cap={level_cap}; the "
                        "model keeps the depth-batched walk")
            return ServingResolution("walk", "user")
        return ServingResolution("level", "user")
    if value != "auto":
        log.warning(f"tpu_predict_engine={value!r} is not one of "
                    f"{'|'.join(SERVING_ENGINE_VALUES)}; using the "
                    "depth-batched walk")
        return ServingResolution("walk", "user")
    eng = "level" if depth <= level_cap else "walk"
    return ServingResolution(eng, "default")
