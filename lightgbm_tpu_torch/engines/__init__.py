"""Engine choices of the port (``lightgbm_tpu/engines/``): so far the
serving engine's resolution (``registry.py``)."""
