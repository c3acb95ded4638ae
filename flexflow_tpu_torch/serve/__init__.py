"""Serving layer of the PyTorch/CUDA port: batch descriptors, the step
dispatcher, the speculative engines, the continuous-batching request
manager with its request lifecycle (deadlines, cancellation, priorities,
preemption, the shared-prefix KV pool), the ``LLM``/``SSM`` API with its
background server, admission control, the load generator, fault
injection (``faultinject``), the replica pool (``replica``) and the CLI
(``python -m flexflow_tpu_torch.serve``)."""

from flexflow_tpu_torch.serve.admission import (AdmissionController,
                                                AdmissionPolicy,
                                                RejectedError)
from flexflow_tpu_torch.serve.api import LLM, SSM
from flexflow_tpu_torch.serve.batch_config import (BatchMeta,
                                                   GenerationConfig,
                                                   TreeBatchMeta,
                                                   make_batch_meta)
from flexflow_tpu_torch.serve.inference_manager import InferenceManager
from flexflow_tpu_torch.serve.loadgen import (EngineHandle, LoadRunner,
                                              TenantSpec, WorkloadSpec,
                                              build_schedule, overload_run,
                                              summarize, sweep)
from flexflow_tpu_torch.serve.request_manager import (GenerationResult,
                                                      Request,
                                                      RequestManager)

__all__ = ["AdmissionController", "AdmissionPolicy", "BatchMeta",
           "EngineHandle", "GenerationConfig", "GenerationResult",
           "InferenceManager", "LLM", "LoadRunner", "RejectedError",
           "Request", "RequestManager", "SSM", "TenantSpec",
           "TreeBatchMeta", "WorkloadSpec", "build_schedule",
           "make_batch_meta", "overload_run", "summarize", "sweep"]
