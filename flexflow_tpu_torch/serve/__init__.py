"""Serving layer of the PyTorch/CUDA port: batch descriptors, the step
dispatcher, the continuous-batching request manager and the ``LLM`` API."""

from flexflow_tpu_torch.serve.api import LLM
from flexflow_tpu_torch.serve.batch_config import (BatchMeta,
                                                   GenerationConfig,
                                                   make_batch_meta)
from flexflow_tpu_torch.serve.inference_manager import InferenceManager
from flexflow_tpu_torch.serve.request_manager import (GenerationResult,
                                                      Request,
                                                      RequestManager)

__all__ = ["BatchMeta", "GenerationConfig", "GenerationResult",
           "InferenceManager", "LLM", "Request", "RequestManager",
           "make_batch_meta"]
