"""Utilities of the PyTorch/CUDA port (counterpart of
``flexflow_tpu/utils``): the device fence and profiler context the
serving telemetry times with (``profiling.py``)."""
