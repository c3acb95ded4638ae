"""Telemetry of the PyTorch/CUDA port (counterpart of
``flexflow_tpu/telemetry``).

This slice carries what the online server and the load generator need:
``metrics.percentile`` and the SLO burn-rate monitor (``slo.py``). The
metrics registry, histograms, span tracing, the flight recorder and the
metrics HTTP server are a later slice; importing this package loads
nothing heavy.
"""
