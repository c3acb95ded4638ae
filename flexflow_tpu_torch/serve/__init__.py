"""Serving layer of the PyTorch/CUDA port: batch descriptors, the step
dispatcher, the speculative engines, the continuous-batching request
manager with its request lifecycle (deadlines, cancellation, priorities,
preemption, the shared-prefix KV pool), the ``LLM``/``SSM`` API with its
background server, admission control, the load generator, fault
injection (``faultinject``), the replica pool (``replica``) and the CLI
(``python -m flexflow_tpu_torch.serve``); ``init`` sets FFConfig fields
for every later ``LLM``."""

from flexflow_tpu_torch.serve.admission import (AdmissionController,
                                                AdmissionPolicy,
                                                RejectedError)
from flexflow_tpu_torch.serve.api import LLM, SSM, init
from flexflow_tpu_torch.serve.batch_config import (MAX_BEAM_DEPTH,
                                                   MAX_BEAM_WIDTH,
                                                   MAX_NUM_REQUESTS,
                                                   MAX_NUM_TOKENS, BatchMeta,
                                                   GenerationConfig,
                                                   TreeBatchMeta,
                                                   make_batch_meta)
from flexflow_tpu_torch.serve.faultinject import (EngineFault,
                                                  FaultInjector, run_chaos)
from flexflow_tpu_torch.serve.inference_manager import InferenceManager
from flexflow_tpu_torch.serve.loadgen import (EngineHandle, LoadRunner,
                                              TenantSpec, WorkloadSpec,
                                              build_schedule, overload_run,
                                              summarize, sweep)
from flexflow_tpu_torch.serve.request_manager import (GenerationResult,
                                                      Request,
                                                      RequestManager,
                                                      get_request_manager)
from flexflow_tpu_torch.telemetry import (ServingTelemetry,
                                          disable_telemetry,
                                          enable_telemetry, get_telemetry)

__all__ = ["AdmissionController", "AdmissionPolicy", "BatchMeta",
           "EngineFault", "EngineHandle", "FaultInjector",
           "GenerationConfig", "GenerationResult", "InferenceManager", "LLM",
           "LoadRunner", "MAX_BEAM_DEPTH", "MAX_BEAM_WIDTH",
           "MAX_NUM_REQUESTS", "MAX_NUM_TOKENS", "RejectedError", "Request",
           "RequestManager", "SSM", "ServingTelemetry", "TenantSpec",
           "TreeBatchMeta", "WorkloadSpec", "build_schedule",
           "disable_telemetry", "enable_telemetry", "get_request_manager",
           "get_telemetry", "init", "make_batch_meta", "overload_run",
           "run_chaos", "summarize", "sweep"]
