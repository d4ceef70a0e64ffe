"""Distributed training (counterpart of ``lightgbm_tpu/parallel``): so far
only the single-process step watchdog of ``multihost`` (the rest is
ROADMAP A18)."""
