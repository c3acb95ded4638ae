"""Command-line harnesses of the port (counterparts of the repository's
``tools/loadtest.py`` and ``tools/faulttest.py``): run them as
``python -m flexflow_tpu_torch.tools.loadtest`` and
``python -m flexflow_tpu_torch.tools.faulttest``."""
