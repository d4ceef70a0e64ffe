"""Serving-quality observation (``lightgbm_tpu/obs/``): so far the drift
monitor, the latency histograms and the SLO tracker (``drift.py``). The
flight recorder, spans and the metrics stream and endpoint are ROADMAP
A19."""
