"""reference import path: flexflow.keras.backend.internal"""

from flexflow_tpu_torch.keras.backend import gather, rsqrt, sum  # noqa: F401
