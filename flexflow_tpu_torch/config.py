"""FFConfig of the PyTorch/CUDA port: the training batch and epochs, the
parallelism degrees and mesh, and the serving, offload, quantization,
fusion, telemetry, host-side and search fields of
``flexflow_tpu.config.FFConfig``, plus ``device`` and ``use_kernels``, and
``remat``.

``auto_parallel=True`` runs the Unity search (``search/``) at ``compile``
over the ranks of the process group, costed on ``search_chip``'s machine
model (``"h100-sxm"`` for the card, ``"cpu-sim"``, the default, for
tests), and executes the strategy it finds; ``search_mesh`` lets it pick
the mesh factorization too.

The parallelism degrees lay a mesh over the ranks of the process group
(``parallel/mesh.py``): each rank is one process, started by torchrun or
by ``parallel/launch.py``, and serves or trains its shard of the weights
(and caches, or batch).

The device decides the kernel path: CUDA tensors go to the hand-written
kernels, CPU tensors to their plain PyTorch versions. ``use_kernels``
(the counterpart of the JAX package's ``use_pallas``) is the one switch
that puts the plain versions on the card, and only when asked for; the
launch counters of ``flexflow_tpu_torch.kernels`` show which ran. There
is no silent CPU fallback: asking for ``cuda`` where CUDA is missing
raises (``resolve_device``).

``from_args`` parses the JAX package's flag set (the reference's
``FFConfig::parse_args``).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

import torch

from flexflow_tpu_torch.quant import normalize_qtype


@dataclasses.dataclass
class FFConfig:
    # --- training (the JAX package's defaults): the batch size of fit,
    # evaluate and SingleDataLoader, and fit's epochs ---
    batch_size: int = 64
    epochs: int = 1
    # the reference's --lr/--wd: the examples hand them to their optimizer
    # (``SGDOptimizer(model, lr=config.learning_rate)``); nothing in the
    # package reads them on its own
    learning_rate: float = 0.01
    weight_decay: float = 0.0001
    # accepted as the JAX package's config accepts it; nothing reads it
    iterations: int = 1

    # --- parallelism degrees (reference config.h:156-159; sequence and
    # expert are the JAX package's additions). Their product is the number
    # of ranks the mesh lays out; leftover ranks go to data parallelism ---
    data_parallelism_degree: int = 1
    tensor_parallelism_degree: int = 1
    pipeline_parallelism_degree: int = 1
    sequence_parallelism_degree: int = 1
    expert_parallelism_degree: int = 1
    # an explicit mesh overrides the degree-derived one
    mesh_shape: Optional[Sequence[int]] = None
    mesh_axis_names: Sequence[str] = ("data", "model")
    # cluster geometry for the search: ranks in all (None: the process
    # group's world size) and nodes they span (groups larger than a node
    # pay the inter-node network)
    num_devices: Optional[int] = None
    num_nodes: int = 1
    # accepted as the JAX package's config accepts it; nothing reads it
    workers_per_node: Optional[int] = None

    # --- auto-parallelization search (reference config.h:131-143; the JAX
    # package's fields and defaults). auto_parallel=True runs the Unity
    # search at compile() and executes the strategy it finds; a strategy
    # set on the model before compile is kept. ---
    auto_parallel: bool = False
    # the cost model's chip (search/machine_model.py GPU_CHIPS):
    # "h100-sxm" | "cpu-sim"
    search_chip: str = "cpu-sim"
    only_data_parallel: bool = False
    search_budget: int = -1
    search_alpha: float = 1.2
    # accepted as the JAX package's config accepts it; nothing reads it
    search_overlap_backward_update: bool = False
    substitution_json_path: Optional[str] = None
    # joint search: interleave algebraic GraphXfer rewrites with the
    # parallelization DP (reference GraphSearchHelper::base_optimize)
    enable_substitutions: bool = True
    # default substitution vocabulary: the packaged full JSON rule file
    # (search/substitutions/); False keeps the 5 builtin rules. An explicit
    # substitution_json_path wins over both
    use_json_rules: bool = True
    # wall-clock bound (seconds) on each joint rewrite loop; 0 = unbounded
    search_deadline_s: float = 60.0
    # profiled re-rank of the top strategies with the ops timed on the
    # model's device (reference Op::measure_operator_cost). None = on when
    # the model lives on the card, off on the CPU
    search_profile: Optional[bool] = None
    # also search the mesh factorization (every data x model and data x
    # seq split of the ranks); compile adopts the winning degrees
    search_mesh: bool = False
    # memory-aware search (reference graph.cc:2126 lambda binary search):
    # accepted as the JAX package's config accepts it; nothing reads it
    # (the search grows its memory lambda on its own, graph_search.py)
    mem_search_budget: int = -1
    # inter-node fabric for the cost model: a search.network
    # NetworkTopology over the num_nodes nodes
    dcn_topology: Optional[object] = None

    # where the model's parameters, KV caches and activations live
    device: str = "cuda"
    # the layer graph as Graphviz dot, written at compile (the reference's
    # --export-strategy-computation-graph-file; utils/dot.py)
    export_strategy_file: str = ""
    # add each layer's estimated forward seconds (the search's cost model
    # on search_chip) to that graph
    include_costs_dot_graph: bool = False
    # training: recompute each layer's forward in the backward instead of
    # keeping its activations (torch.utils.checkpoint; core/model.py)
    remat: bool = False
    seed: int = 0
    # activations compute in compute_dtype; params keep their WeightSpec dtype
    compute_dtype: str = "float32"
    # accepted as the JAX package's config accepts them; nothing reads them
    # (the parameters' dtype is each WeightSpec's)
    param_dtype: str = "float32"
    computation_mode: str = "training"

    # --- serving shapes (reference BatchConfig::max_requests_per_batch /
    # max_tokens_per_batch / max_sequence_length) ---
    max_requests_per_batch: int = 8
    max_tokens_per_batch: int = 128
    max_sequence_length: int = 256
    kv_cache_dtype: str = "bfloat16"
    # decode steps / speculation rounds per host readback (serve/engine.py
    # decode block and speculative engines)
    decode_block_steps: int = 8
    spec_rounds_per_call: int = 4
    # draft beam width (reference BeamSearchBatchConfig::MAX_BEAM_WIDTH):
    # a BEAM_SEARCH_MODE graph built at a width above 1 ends in the packed
    # [top-W probs, top-W ids] head that beam drafting reads
    max_beam_width: int = 1
    # incremental-decode step width; 0 = auto: the padded verify width (8)
    # where the CUDA kernel serves the config, 1 elsewhere
    # (InferenceManager._resolve_decode_width)
    decode_width: int = 0

    # --- weights ---
    # weight-only quantization of the serving matmul weights: None | "int8"
    # | "int4" (normalized from the aliases quant.normalize_qtype takes);
    # each layer is quantized as it is initialized, and LLM.compile
    # quantizes again after loading (quant.py)
    quantization_type: Optional[str] = None
    # serving weights paged to pinned host memory and streamed back per
    # layer (offload.py, the reference's -offload); the reserve bounds the
    # bytes prefetched ahead of the layer that computes
    cpu_offload: bool = False
    offload_reserve_space_size: int = 8 * 1024 * 1024 * 1024
    # runtime fusion switch (the reference's --fusion); gemm_fusion needs it
    enable_fusion: bool = True
    # serving gemm fusion: wq|wk|wv -> one wqkv, SwiGLU gate|up -> one
    # [E, 2I] Linear (serve/gemm_fusion.py). Off by default, as in the JAX
    # package, where it measured slower end to end
    gemm_fusion: bool = False

    # --- serving telemetry (flexflow_tpu_torch/telemetry) ---
    # enables the process-global metrics registry and per-request span
    # tracing at LLM.compile. Off by default: the disabled decode path
    # records nothing. telemetry_trace_path writes the JSONL span trace
    # (Perfetto-loadable through export_chrome_trace).
    telemetry: bool = False
    telemetry_trace_path: str = ""

    # --- host-side serving (serve/request_manager.py) ---
    # incremental decoding's slot fill, batch assembly and EOS/length
    # bookkeeping in the native C++ scheduler (native/src/
    # batch_scheduler.cpp, built by flexflow_tpu_torch/native at first
    # use); a library that cannot build raises. Requests with priorities
    # and the shared-prefix pool take the Python loop.
    use_native_scheduler: bool = True
    # dump every op's inputs, weights and outputs per serving step to
    # ./inference_tensors (utils/debugging.py); turns gemm fusion off and
    # routes speculation through the host tree path, as in the JAX package
    inference_debugging: bool = False
    # the hand-written kernels serve CUDA tensors; False puts the plain
    # PyTorch versions on the card (counted as plain_attend_cuda and
    # qmatmul_plain_cuda in kernels.counts)
    use_kernels: bool = True

    # --- profiling and logging (reference config.h:127-130) ---
    # fit() fences and times every step and prints the per-step summary
    # with each epoch's line (utils/profiling.StepTimer)
    profiling: bool = False
    # accepted as the JAX package's config accepts them; nothing reads them
    benchmarking: bool = False
    perform_fusion_checks: bool = False
    log_instance_creation: bool = False

    def __post_init__(self):
        self.quantization_type = normalize_qtype(self.quantization_type)

    def resolve_num_devices(self) -> int:
        """``num_devices``, else the process group's world size (started,
        or named by ``WORLD_SIZE``), else 1."""
        if self.num_devices is not None:
            return self.num_devices
        import os

        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size()
        return int(os.environ.get("WORLD_SIZE", 1))

    @property
    def total_parallelism_degree(self) -> int:
        return (self.data_parallelism_degree
                * self.tensor_parallelism_degree
                * self.pipeline_parallelism_degree
                * self.sequence_parallelism_degree
                * self.expert_parallelism_degree)

    # ------------------------------------------------------------------
    # the JAX package's flag set (reference FFConfig::parse_args)
    # ------------------------------------------------------------------
    @classmethod
    def from_args(cls, argv: Optional[Sequence[str]] = None,
                  **overrides) -> "FFConfig":
        """An FFConfig from the JAX package's command-line flags; unknown
        flags are ignored (``parse_known_args``), as there. Every parsed
        flag is stored: the training hyperparameters (``--lr``, ``--wd``,
        which the examples hand to their optimizer), the device and node
        counts, the parallelism degrees, the Unity search flags,
        ``--profiling`` and ``--offload``. ``overrides`` set fields after
        parsing (``device``, for one)."""
        p = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
        p.add_argument("-b", "--batch-size", type=int, default=64)
        p.add_argument("-e", "--epochs", type=int, default=1)
        p.add_argument("--lr", "--learning-rate", dest="learning_rate",
                       type=float, default=0.01)
        p.add_argument("--wd", "--weight-decay", dest="weight_decay",
                       type=float, default=0.0001)
        p.add_argument("-ll:gpu", "--devices", dest="num_devices", type=int,
                       default=None)
        p.add_argument("--nodes", type=int, default=1)
        p.add_argument("-dp", "--data-parallelism-degree", type=int,
                       default=1)
        p.add_argument("-tp", "--tensor-parallelism-degree", type=int,
                       default=1)
        p.add_argument("-pp", "--pipeline-parallelism-degree", type=int,
                       default=1)
        p.add_argument("-sp", "--sequence-parallelism-degree", type=int,
                       default=1)
        p.add_argument("--only-data-parallel", action="store_true")
        p.add_argument("--budget", "--search-budget", dest="search_budget",
                       type=int, default=-1)
        p.add_argument("--alpha", "--search-alpha", dest="search_alpha",
                       type=float, default=1.2)
        p.add_argument("--fusion", dest="enable_fusion", action="store_true",
                       default=True)
        p.add_argument("--no-fusion", dest="enable_fusion",
                       action="store_false")
        p.add_argument("--profiling", action="store_true")
        p.add_argument("--offload", dest="cpu_offload", action="store_true")
        p.add_argument("--4bit-quantization", dest="q4", action="store_true")
        p.add_argument("--8bit-quantization", dest="q8", action="store_true")
        p.add_argument("--inference-debugging", action="store_true")
        p.add_argument("--seed", type=int, default=0)
        args, _unknown = p.parse_known_args(argv)
        quant = "int4" if args.q4 else ("int8" if args.q8 else None)
        kw = dict(batch_size=args.batch_size, epochs=args.epochs,
                  learning_rate=args.learning_rate,
                  weight_decay=args.weight_decay, profiling=args.profiling,
                  enable_fusion=args.enable_fusion, quantization_type=quant,
                  inference_debugging=args.inference_debugging,
                  seed=args.seed,
                  data_parallelism_degree=args.data_parallelism_degree,
                  tensor_parallelism_degree=args.tensor_parallelism_degree,
                  pipeline_parallelism_degree=(
                      args.pipeline_parallelism_degree),
                  sequence_parallelism_degree=(
                      args.sequence_parallelism_degree),
                  num_devices=args.num_devices, num_nodes=args.nodes,
                  only_data_parallel=args.only_data_parallel,
                  search_budget=args.search_budget,
                  search_alpha=args.search_alpha,
                  cpu_offload=args.cpu_offload)
        kw.update(overrides)
        return cls(**kw)


def resolve_device(name) -> torch.device:
    """The config's device, checked: a CUDA device that this process
    cannot reach raises instead of falling back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"FFConfig.device={str(name)!r} but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    return dev
