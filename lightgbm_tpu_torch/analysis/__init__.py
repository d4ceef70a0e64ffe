"""Tooling of the port (counterpart of ``lightgbm_tpu/analysis``): so far
the fault-injection harness, ``faultinject``."""
