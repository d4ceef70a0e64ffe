"""Boosting algorithms (counterpart of ``lightgbm_tpu/boosting``): GBDT,
DART and random forest."""
from __future__ import annotations

from .dart import DART
from .gbdt import GBDT, HostTree
from .rf import RF


def create_boosting(config, train_set, objective, device) -> GBDT:
    """(reference: Boosting::CreateBoosting, src/boosting/boosting.cpp;
    ``lightgbm_tpu/boosting/__init__.py:13-21``)"""
    cls = {"gbdt": GBDT, "dart": DART, "rf": RF}.get(config.boosting)
    if cls is None:
        raise ValueError(f"Unknown boosting type: {config.boosting}")
    return cls(config, train_set, objective, device)


__all__ = ["GBDT", "DART", "RF", "HostTree", "create_boosting"]
