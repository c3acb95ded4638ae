"""flexflow_tpu_torch: the PyTorch/CUDA port of flexflow_tpu for NVIDIA
Hopper (H100).

The JAX package ``flexflow_tpu`` is the reference and stays as it is; this
package imports torch and never jax, and nothing of ``flexflow_tpu``. Its
layout mirrors the JAX package's module names. Every Pallas TPU kernel on
a ported path has a hand-written CUDA kernel under ``kernels/csrc`` with a
plain PyTorch version beside it: CUDA tensors launch the kernel, CPU
tensors take the plain version.

It serves the JAX package's five model families (LLaMA, OPT, Falcon, MPT
and StarCoder; ``models.FAMILIES``), from an HF ``(config, state_dict)``
pair or an HF-layout checkpoint directory (``LLM.from_checkpoint``), by
incremental decoding (greedy, or top-p sampling with
``GenerationConfig(do_sample=True)``) or, with draft models
attached, by speculative inference (greedy chains, or beams with
``compile(..., max_beam_width=2)``), with float weights or int8/int4
weight-only quantized ones (``compile(..., quantization_type="int8")``,
served on the card by the dequant-GEMM K3, ``kernels/csrc/qmatmul.cu``)::

    from flexflow_tpu_torch import LLM, SSM
    llm = LLM((hf_config_dict, state_dict)).compile(
        max_requests_per_batch=8, max_seq_length=256)   # device="cuda"
    results = llm.generate([[1, 2, 3], [4, 5]], max_new_tokens=16)
    spec = LLM((hf_config_dict, state_dict)).compile(
        max_requests_per_batch=8, max_seq_length=256,
        ssms=[SSM((draft_hf_config_dict, draft_state_dict))])

Online: ``llm.start_server()`` runs the continuous batch on a background
thread that concurrent ``generate`` calls join (with ``timeout_s``,
``tenant``, ``priority``; ``llm.cancel(guid)``), ``AdmissionPolicy``
bounds its front door, ``GenerationConfig(prefix_cache=True)`` reuses
shared prompt prefixes' KV, and ``serve.loadgen`` drives open-loop
traffic through it and reports TTFT, latency and goodput.
"""

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.model import FFModel
from flexflow_tpu_torch.ffconst import (ActiMode, AggrMode, CompMode,
                                        DataType, InferenceMode, OpType)
from flexflow_tpu_torch.serve import (SSM, AdmissionPolicy, EngineHandle,
                                     GenerationConfig, LLM, RejectedError,
                                     RequestManager, WorkloadSpec)

__all__ = ["ActiMode", "AdmissionPolicy", "AggrMode", "CompMode",
           "DataType", "EngineHandle", "FFConfig", "FFModel",
           "GenerationConfig", "InferenceMode", "LLM", "OpType",
           "RejectedError", "RequestManager", "SSM", "WorkloadSpec"]
