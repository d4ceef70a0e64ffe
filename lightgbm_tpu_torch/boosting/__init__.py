"""Boosting algorithms (counterpart of ``lightgbm_tpu/boosting``)."""
from __future__ import annotations

from .gbdt import GBDT, HostTree


def create_boosting(config, train_set, objective, device) -> GBDT:
    """(reference: Boosting::CreateBoosting, src/boosting/boosting.cpp)"""
    if config.boosting != "gbdt":
        raise NotImplementedError(
            f"boosting={config.boosting!r} is not in the PyTorch port yet "
            "(ROADMAP A14)")
    return GBDT(config, train_set, objective, device)


__all__ = ["GBDT", "HostTree", "create_boosting"]
