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
traffic through it and reports TTFT, latency and goodput. Telemetry
(``compile(..., telemetry=True)``, ``telemetry/``) records the JAX
package's ``ffsv_*`` metrics and per-request span traces, served by
``llm.start_metrics_server``; ``serve.replica.ReplicaPool`` runs replicas
cold-started from checkpoints behind one front door with crash failover;
``python -m flexflow_tpu_torch.serve`` is the serving CLI. The host side
is the JAX package's too: incremental decoding on the native C++
scheduler (``native/``, built with g++ at first use), the GPT-2 BPE and
SentencePiece tokenizers, ``LLM("<local HF directory>")``, the ``ffsv_*``
C serving ABI and ``inference_debugging``'s per-op dumps.

It serves in parallel over ``torch.distributed``: with
``tensor_parallelism_degree``, ``pipeline_parallelism_degree`` or
``sequence_parallelism_degree`` above 1 each rank (one process, started
by torchrun or ``parallel/launch.py``) holds its shard of the weights and
KV caches and runs the same loop (``parallel/``,
``serve/pipeline_plan.py``); ``compile(..., cpu_offload=True)`` pages
the serving weights to pinned host memory (``offload.py``).

It trains, through the JAX package's verbs: ``compile(optimizer=,
loss_type=, metrics=)`` then ``train_one_batch``, ``train_batches``,
``fit``, ``evaluate`` and ``predict``, with autograd for the backward
pass and SGD or Adam updating the parameters in place::

    import flexflow_tpu_torch as ff
    m = ff.FFModel(ff.FFConfig(batch_size=64))          # device="cuda"
    t = m.create_tensor([64, 784], ff.DataType.DT_FLOAT)
    m.softmax(m.dense(m.dense(t, 512, ff.ActiMode.AC_MODE_RELU), 10))
    m.compile(optimizer=ff.SGDOptimizer(m, 0.01),
              loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              metrics=[ff.MetricsType.METRICS_ACCURACY])
    history = m.fit(x=X, y=Y, epochs=2)
"""

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.model import FFModel
from flexflow_tpu_torch.core.initializer import (ConstantInitializer,
                                                 GlorotUniformInitializer,
                                                 NormInitializer,
                                                 UniformInitializer,
                                                 ZeroInitializer)
from flexflow_tpu_torch.ffconst import (ActiMode, AggrMode, CompMode,
                                        DataType, InferenceMode, LossType,
                                        MetricsType, OpType,
                                        ParameterSyncType, PoolType)
from flexflow_tpu_torch.serve import (SSM, AdmissionPolicy, EngineHandle,
                                     GenerationConfig, LLM, RejectedError,
                                     RequestManager, WorkloadSpec)
from flexflow_tpu_torch.training.checkpoint import (CheckpointManager,
                                                    fit_with_recovery,
                                                    load_weights_npz,
                                                    save_weights_npz)
from flexflow_tpu_torch.training.dataloader import SingleDataLoader
from flexflow_tpu_torch.training.optimizer import (AdamOptimizer,
                                                   SGDOptimizer)

__all__ = ["ActiMode", "AdamOptimizer", "AdmissionPolicy", "AggrMode",
           "CheckpointManager", "CompMode", "ConstantInitializer", "DataType", "EngineHandle",
           "FFConfig", "FFModel", "GenerationConfig",
           "GlorotUniformInitializer", "InferenceMode", "LLM", "LossType",
           "MetricsType", "NormInitializer", "OpType", "ParameterSyncType",
           "PoolType", "RejectedError", "RequestManager", "SGDOptimizer",
           "SSM", "SingleDataLoader", "UniformInitializer", "WorkloadSpec",
           "ZeroInitializer", "fit_with_recovery", "load_weights_npz",
           "save_weights_npz"]
