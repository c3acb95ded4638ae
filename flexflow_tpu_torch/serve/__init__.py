"""Serving layer of the PyTorch/CUDA port: batch descriptors, the step
dispatcher, the speculative engines, the continuous-batching request
manager and the ``LLM``/``SSM`` API."""

from flexflow_tpu_torch.serve.api import LLM, SSM
from flexflow_tpu_torch.serve.batch_config import (BatchMeta,
                                                   GenerationConfig,
                                                   TreeBatchMeta,
                                                   make_batch_meta)
from flexflow_tpu_torch.serve.inference_manager import InferenceManager
from flexflow_tpu_torch.serve.request_manager import (GenerationResult,
                                                      Request,
                                                      RequestManager)

__all__ = ["BatchMeta", "GenerationConfig", "GenerationResult",
           "InferenceManager", "LLM", "Request", "RequestManager", "SSM",
           "TreeBatchMeta", "make_batch_meta"]
