"""FFModel of the PyTorch/CUDA port (counterpart of
``flexflow_tpu/core/model.py``): the serving and the training halves.

The op-builder methods record a layer graph; ``compile`` initializes
every weight on ``config.device`` from a ``torch.Generator`` seeded per
weight and walks the layers eagerly in ``_run_graph``.

Inference (``compile()`` with no optimizer and no loss, the port's
default): each serving op's KV caches are allocated and stacked into one
``[L, R, KH, S, D]`` pair; with ``config.quantization_type`` each layer's
eligible weights are quantized as the layer is initialized
(``quant.py``); ``finalize_gemm_fusion`` fuses the serving GEMMs after
the weights are loaded (``serve/gemm_fusion.py``).

Training (``compile(optimizer=..., loss_type=..., metrics=...)``): the
float parameters require gradients; a train step runs the forward with
grad enabled, the loss (``training/loss.py``), ``loss.backward()``, the
optimizer's in-place update and the step metrics, and reads nothing back
to the host; ``train_one_batch``, ``train_batches``, ``fit``,
``evaluate`` and ``predict`` read once a call. Dropout draws from the
model's own ``torch.Generator``, seeded from ``config.seed``.

Parallel serving: with a tensor, pipeline or sequence parallelism
degree above 1 the model joins the process group (``distributed.py``)
and ``compile`` lays a mesh over its ranks (``parallel/mesh.py``). Each
rank initializes every weight it holds at full size from the same seed,
quantizes it, and keeps its slice (``parallel/spec.py``: column shards of
the projections, whole-head shards of attention, ``S/sp`` rows of the KV
caches); under a pipeline plan (``serve/pipeline_plan.py``) a rank holds
only its stage's layers and caches. The ops run their collectives over
the mesh; a serving forward's final output is broadcast from the rank
that made it, so every rank reads the same tokens and runs the same host
loop. ``offload_weights`` pages the serving weights to pinned host
memory (``offload.py``); ``_apply_layer`` streams them back.

Parallel training: the same degrees, with ``compile(optimizer=...,
loss_type=...)``, train over the ``data``, ``model``, ``seq`` and
``expert`` axes. Each rank holds the weights' slices (the JAX layout:
dense and embedding columns, attention heads, experts) and the optimizer
state beside them; the graph walk keeps each rank's part of the batch
(``parallel/placement.py``: ``data`` splits the rows, ``seq`` the
positions, and the training MHA runs the ring), the loss and metrics are
the whole batch's on every rank, and the parameters' partial gradients
are summed over the batch axes before the update. ``config.remat``
recomputes each layer's forward in the backward. ``training/checkpoint.py``
saves and resumes the whole training state; ``recompile_on_condition``
(``core/recompile.py``) rebuilds the model keeping its weights.

The Unity search: with ``config.auto_parallel`` ``compile`` runs
``search.optimize_model`` (rank 0 searches, the others take its result)
and keeps the strategy in ``strategy``; a strategy set before compile is
kept as it is. A strategy's ``axis_degrees`` become the degrees the mesh
is laid with. Each weight rests sliced by its layer's ``weight_specs``
and each layer's output is moved to its ``output_spec``
(``parallel/placement.py``); fork-join branches tagged by the search run
on their own ranks (``core/branch_exec.py``). ``export_dot``
(``utils/dot.py``) writes the layer graph; ``FFConfig.export_strategy_file``
writes it at compile, with each layer's estimated seconds under
``include_costs_dot_graph`` (``_estimate_layer_costs``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from flexflow_tpu_torch import ops as _ops  # noqa: F401  (registers the ops)
from flexflow_tpu_torch.config import FFConfig, resolve_device
from flexflow_tpu_torch.core.layer import Layer
from flexflow_tpu_torch.core.tensor import Tensor
from flexflow_tpu_torch.ffconst import (ActiMode, AggrMode, CompMode,
                                        DataType, LossType, MetricsType,
                                        OpType, PoolType, torch_dtype)
from flexflow_tpu_torch.ops.base import OpContext, get_op_impl, stable_hash
from flexflow_tpu_torch.quant import (dequantize_array,
                                      dequantize_layer_params, is_quantized,
                                      normalize_qtype, quantize_params,
                                      quantized_nbytes, requantize_into)
from flexflow_tpu_torch.training.dataloader import minibatches
from flexflow_tpu_torch.training.loss import compute_loss
from flexflow_tpu_torch.training.metrics import (PerfMetrics,
                                                 compute_step_metrics)
from flexflow_tpu_torch.utils.profiling import StepTimer


def weight_seed(seed: int, layer_name: str, weight_name: str) -> int:
    """Seed of one weight's generator: the model seed and the same
    ``stable_hash(layer, weight)`` the JAX package folds into its key."""
    return ((int(seed) << 31) | stable_hash(layer_name, weight_name)) \
        & 0x7FFF_FFFF_FFFF_FFFF


def _normalize_regularizer(reg):
    """None, one ("l1"|"l2", coeff) pair or a list of them -> None or a
    non-empty list of pairs; an unknown kind raises."""
    if reg is None:
        return None
    if isinstance(reg, (list, tuple)) and reg \
            and not isinstance(reg[0], (list, tuple)):
        reg = [reg]
    out = []
    for kind, coeff in reg:
        if kind not in ("l1", "l2"):
            raise ValueError(f"unknown regularizer kind {kind!r} "
                             f"(expected 'l1' or 'l2')")
        if coeff:
            out.append((kind, float(coeff)))
    return out or None


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None):
        self.config = config or FFConfig()
        # raises if the config asks for a device this process cannot reach
        self.device = resolve_device(self.config.device)
        self.layers: List[Layer] = []
        self.input_tensors: List[Tensor] = []
        self.params: Dict[str, Dict[str, torch.Tensor]] = {}
        self.op_state: Dict[str, Any] = {}
        self._final_tensor: Optional[Tensor] = None
        self._logits_tensor: Optional[Tensor] = None
        self._layer_name_counts: Dict[str, int] = {}
        self.comp_mode: Optional[CompMode] = None
        self._gemm_fusion_done = False
        # parallel serving (compile builds them when a degree is above 1)
        self.mesh = None
        self.policy = None
        self._pp_plan = None
        # offload.py: {layer: {weight: device}} of the paged weights and
        # the stream that brings them back
        self._offloaded: Dict[str, Dict[str, Any]] = {}
        self._prefetcher = None
        # the serving position input of models with learned position
        # embeddings (OPT, StarCoder): fed with positions + offset
        # (serve/engine.py build_feeds)
        self.position_input_tensor: Optional[Tensor] = None
        self.position_offset: int = 0
        # training (compile with an optimizer or a loss)
        self.label_tensor: Optional[Tensor] = None
        self.optimizer = None
        self.opt_state: Optional[Dict[str, Any]] = None
        self.loss_type: Optional[LossType] = None
        self.metrics: List[MetricsType] = []
        self._logits_tensor: Optional[Tensor] = None
        self._reg_terms: List[Tuple[str, str, str, float]] = []
        self._perf = PerfMetrics()
        # per-step fenced train times under config.profiling, printed with
        # each epoch's line
        self._step_timer = StepTimer(enabled=True)
        self._pending_batch = None
        # parallel training: the last forward's placements
        # (parallel/placement.Walk) and the gradient all-reduce
        self._walk = None
        self._grad_reducer = None
        # the search's per-op strategy (search/strategy.py Strategy): set
        # by compile under auto_parallel, or by the caller before compile;
        # compile turns it into the plan the graph walk executes
        # (parallel/placement.StrategyPlan) and the branch regions
        # (core/branch_exec.BranchPlan)
        self.strategy = None
        self._strategy_plan = None
        self._branch_plan = None
        # a train step's dropout draws (the JAX package's self._rng)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.config.seed)

    # ==================================================================
    # Tensor / layer creation
    # ==================================================================
    def create_tensor(self, dims: Sequence[int],
                      dtype: DataType = DataType.DT_FLOAT,
                      create_grad: bool = True, name: str = "") -> Tensor:
        """``create_grad`` is kept for the JAX signature (an input never
        takes a gradient)."""
        t = Tensor(tuple(dims), dtype,
                   name=name or f"input_{len(self.input_tensors)}",
                   model=self)
        self.input_tensors.append(t)
        return t

    def create_position_tensor(self, dims: Sequence[int]) -> Tensor:
        """Input fed with each token's absolute position + the offset."""
        t = self.create_tensor(dims, DataType.DT_INT32, name="position_input")
        self.position_input_tensor = t
        return t

    def set_position_offset(self, offset: int):
        """What the feed adds to every position (OPT: 2)."""
        self.position_offset = offset

    def _add_layer(self, op_type: OpType, inputs: List[Tensor],
                   attrs: Dict[str, Any], name: Optional[str] = None
                   ) -> Union[Tensor, List[Tensor]]:
        attrs = dict(attrs)
        attrs.setdefault("op_type", op_type)
        layer = Layer(op_type, name, inputs, attrs,
                      counts=self._layer_name_counts)
        impl = get_op_impl(op_type)
        input_specs = [(t.dims, t.dtype) for t in inputs]
        out_specs = impl.infer_output_specs(attrs, input_specs)
        layer.weights = impl.weight_specs(attrs, input_specs)
        outputs = [Tensor(shape, dtype, name=f"{layer.name}.out{i}",
                          owner_layer=layer, owner_idx=i, model=self)
                   for i, (shape, dtype) in enumerate(out_specs)]
        layer.outputs = outputs
        self.layers.append(layer)
        return outputs[0] if len(outputs) == 1 else outputs

    # ==================================================================
    # Op-builder surface (the builders the serving models call)
    # ==================================================================
    def dense(self, input: Tensor, out_dim: int,
              activation: ActiMode = ActiMode.AC_MODE_NONE,
              use_bias: bool = True, datatype: Optional[DataType] = None,
              kernel_initializer=None, bias_initializer=None,
              keep_f32_logits: bool = False,
              data_type: Optional[DataType] = None,
              kernel_regularizer=None,
              name: Optional[str] = None) -> Tensor:
        """``datatype`` and ``data_type`` are synonyms, as in the JAX
        package. ``keep_f32_logits`` emits the gemm's fp32 accumulator
        (logits heads feeding argmax). ``kernel_regularizer``: ("l1" |
        "l2", coeff) pairs added to the training loss."""
        if (datatype is not None and data_type is not None
                and datatype != data_type):
            raise ValueError(
                f"dense(): conflicting datatype={datatype} and "
                f"data_type={data_type} (they are synonyms)")
        return self._add_layer(OpType.LINEAR, [input], dict(
            out_dim=out_dim, activation=activation, use_bias=use_bias,
            data_type=datatype if datatype is not None else data_type,
            kernel_initializer=kernel_initializer,
            bias_initializer=bias_initializer,
            keep_f32_logits=keep_f32_logits,
            kernel_regularizer=_normalize_regularizer(kernel_regularizer)),
            name)

    def conv2d(self, input: Tensor, out_channels: int, kernel_h: int,
               kernel_w: int, stride_h: int, stride_w: int, padding_h: int,
               padding_w: int, activation: ActiMode = ActiMode.AC_MODE_NONE,
               groups: int = 1, use_bias: bool = True,
               kernel_initializer=None, bias_initializer=None,
               kernel_regularizer=None,
               name: Optional[str] = None) -> Tensor:
        return self._add_layer(OpType.CONV2D, [input], dict(
            out_channels=out_channels, kernel_h=kernel_h, kernel_w=kernel_w,
            stride_h=stride_h, stride_w=stride_w, padding_h=padding_h,
            padding_w=padding_w, activation=activation, groups=groups,
            use_bias=use_bias, kernel_initializer=kernel_initializer,
            bias_initializer=bias_initializer,
            kernel_regularizer=_normalize_regularizer(kernel_regularizer)),
            name)

    def pool2d(self, input: Tensor, kernel_h: int, kernel_w: int,
               stride_h: int, stride_w: int, padding_h: int, padding_w: int,
               pool_type: PoolType = PoolType.POOL_MAX,
               activation: ActiMode = ActiMode.AC_MODE_NONE,
               name: Optional[str] = None) -> Tensor:
        return self._add_layer(OpType.POOL2D, [input], dict(
            kernel_h=kernel_h, kernel_w=kernel_w, stride_h=stride_h,
            stride_w=stride_w, padding_h=padding_h, padding_w=padding_w,
            pool_type=pool_type, activation=activation), name)

    def batch_norm(self, input: Tensor, relu: bool = True,
                   name: Optional[str] = None) -> Tensor:
        return self._add_layer(OpType.BATCHNORM, [input],
                               dict(relu=relu), name)

    def dropout(self, input: Tensor, rate: float = 0.5, seed: int = 0,
                name: Optional[str] = None) -> Tensor:
        """``seed`` is kept for the JAX signature; the draws come from the
        model's generator."""
        return self._add_layer(OpType.DROPOUT, [input],
                               dict(rate=rate, seed=seed), name)

    def multihead_attention(self, query: Tensor, key: Tensor, value: Tensor,
                            embed_dim: int, num_heads: int,
                            kdim: int = 0, vdim: int = 0,
                            dropout: float = 0.0, bias: bool = True,
                            add_bias_kv: bool = False,
                            add_zero_attn: bool = False,
                            kernel_initializer=None, causal: bool = False,
                            name: Optional[str] = None) -> Tensor:
        return self._add_layer(
            OpType.MULTIHEAD_ATTENTION, [query, key, value], dict(
                embed_dim=embed_dim, num_heads=num_heads,
                kdim=kdim or embed_dim, vdim=vdim or embed_dim,
                dropout=dropout, causal=causal, bias=bias,
                add_bias_kv=add_bias_kv, add_zero_attn=add_zero_attn,
                kernel_initializer=kernel_initializer), name)

    def layer_norm(self, input: Tensor, axes: Sequence[int],
                   elementwise_affine: bool = True, eps: float = 1e-5,
                   use_bias: bool = True,
                   name: Optional[str] = None) -> Tensor:
        return self._add_layer(OpType.LAYERNORM, [input], dict(
            axes=tuple(axes), elementwise_affine=elementwise_affine, eps=eps,
            use_bias=use_bias), name)

    def residual_layer_norm(self, input: Tensor, residual1: Tensor,
                            residual2: Optional[Tensor] = None,
                            use_two_residuals: bool = False,
                            axes: Sequence[int] = (-1,),
                            elementwise_affine: bool = True,
                            eps: float = 1e-5, use_bias: bool = True,
                            name: Optional[str] = None) -> List[Tensor]:
        inputs = [input, residual1] + ([residual2] if use_two_residuals
                                       else [])
        return self._add_layer(OpType.RESIDUAL_LAYERNORM, inputs, dict(
            axes=tuple(a % input.num_dims for a in axes),
            elementwise_affine=elementwise_affine, eps=eps,
            use_bias=use_bias), name)

    def add_bias_residual_layer_norm(self, input: Tensor, residual: Tensor,
                                     axes: Sequence[int] = (-1,),
                                     elementwise_affine: bool = True,
                                     eps: float = 1e-5, use_bias: bool = True,
                                     name: Optional[str] = None
                                     ) -> List[Tensor]:
        return self._add_layer(
            OpType.ADD_BIAS_RESIDUAL_LAYERNORM, [input, residual], dict(
                axes=tuple(a % input.num_dims for a in axes),
                elementwise_affine=elementwise_affine, eps=eps,
                use_bias=use_bias), name)

    def rms_norm(self, input: Tensor, eps: float = 1e-6,
                 dim: Optional[int] = None,
                 name: Optional[str] = None) -> Tensor:
        return self._add_layer(OpType.RMS_NORM, [input], dict(
            eps=eps, dim=dim or input.dims[-1]), name)

    def residual_rms_norm(self, input1: Tensor, input2: Tensor,
                          eps: float = 1e-6, dim: Optional[int] = None,
                          name: Optional[str] = None) -> List[Tensor]:
        return self._add_layer(OpType.RESIDUAL_RMS_NORM, [input1, input2],
                               dict(eps=eps, dim=dim or input1.dims[-1]),
                               name)

    def sigmoid_silu_multi(self, input1: Tensor, input2: Tensor,
                           name: Optional[str] = None) -> Tensor:
        return self._add_layer(OpType.SIGMOID_SILU_MULTI, [input1, input2],
                               {}, name)

    def embedding(self, input: Tensor, num_entries: int, out_dim: int,
                  aggr: AggrMode = AggrMode.AGGR_MODE_NONE,
                  dtype: DataType = DataType.DT_FLOAT,
                  kernel_initializer=None,
                  name: Optional[str] = None) -> Tensor:
        return self._add_layer(OpType.EMBEDDING, [input], dict(
            num_entries=num_entries, out_dim=out_dim, aggr=aggr,
            data_type=dtype, kernel_initializer=kernel_initializer), name)

    def _serving_attention(self, op_type: OpType, input: Tensor,
                           embed_dim: int, num_q_heads: int,
                           num_kv_heads: int, kdim: int = 0, vdim: int = 0,
                           dropout: float = 0.0, bias: bool = False,
                           add_bias_kv: bool = False,
                           add_zero_attn: bool = False,
                           data_type: Optional[DataType] = None,
                           kernel_initializer=None,
                           apply_rotary_embedding: bool = False,
                           scaling_query: bool = False,
                           scaling_factor: float = 1.0,
                           qk_prod_scaling: bool = True,
                           position_bias: bool = False,
                           rope_theta: float = 10000.0,
                           name: Optional[str] = None) -> Tensor:
        if add_bias_kv or add_zero_attn:
            raise NotImplementedError(
                "add_bias_kv/add_zero_attn are not supported by the serving "
                "attention ops")
        if vdim and vdim != (kdim or embed_dim):
            raise NotImplementedError("vdim != kdim serving attention")
        head_dim = (kdim or embed_dim) // num_q_heads
        return self._add_layer(op_type, [input], dict(
            embed_dim=embed_dim, num_q_heads=num_q_heads,
            num_kv_heads=num_kv_heads, head_dim=head_dim, dropout=dropout,
            bias=bias, data_type=data_type,
            kernel_initializer=kernel_initializer,
            apply_rotary_embedding=apply_rotary_embedding,
            scaling_query=scaling_query, scaling_factor=scaling_factor,
            qk_prod_scaling=qk_prod_scaling, position_bias=position_bias,
            rope_theta=rope_theta,
            max_requests=self.config.max_requests_per_batch,
            max_seq_length=self.config.max_sequence_length,
            cache_dtype=self.config.kv_cache_dtype), name)

    # the multi-head builders: num_kv_heads = num_q_heads
    def inc_multihead_self_attention(self, input: Tensor, embed_dim: int,
                                     num_heads: int, **kw) -> Tensor:
        return self.inc_multiquery_self_attention(input, embed_dim,
                                                  num_heads, num_heads, **kw)

    def spec_inc_multihead_self_attention(self, input: Tensor,
                                          embed_dim: int, num_heads: int,
                                          **kw) -> Tensor:
        return self.spec_inc_multiquery_self_attention(
            input, embed_dim, num_heads, num_heads, **kw)

    def tree_inc_multihead_self_attention(self, input: Tensor,
                                          embed_dim: int, num_heads: int,
                                          **kw) -> Tensor:
        return self.tree_inc_multiquery_self_attention(
            input, embed_dim, num_heads, num_heads, **kw)

    def inc_multiquery_self_attention(self, input: Tensor, embed_dim: int,
                                      num_q_heads: int, num_kv_heads: int,
                                      **kw) -> Tensor:
        return self._serving_attention(OpType.INC_MULTIHEAD_SELF_ATTENTION,
                                       input, embed_dim, num_q_heads,
                                       num_kv_heads, **kw)

    def spec_inc_multiquery_self_attention(self, input: Tensor,
                                           embed_dim: int, num_q_heads: int,
                                           num_kv_heads: int, **kw) -> Tensor:
        return self._serving_attention(
            OpType.SPEC_INC_MULTIHEAD_SELF_ATTENTION, input, embed_dim,
            num_q_heads, num_kv_heads, **kw)

    def tree_inc_multiquery_self_attention(self, input: Tensor,
                                           embed_dim: int, num_q_heads: int,
                                           num_kv_heads: int, **kw) -> Tensor:
        return self._serving_attention(
            OpType.TREE_INC_MULTIHEAD_SELF_ATTENTION, input, embed_dim,
            num_q_heads, num_kv_heads, **kw)

    # --- elementwise binary ---
    def add(self, x: Tensor, y: Tensor, name=None) -> Tensor:
        return self._add_layer(OpType.EW_ADD, [x, y], {}, name)

    def subtract(self, x: Tensor, y: Tensor, name=None) -> Tensor:
        return self._add_layer(OpType.EW_SUB, [x, y], {}, name)

    def multiply(self, x: Tensor, y: Tensor, name=None) -> Tensor:
        return self._add_layer(OpType.EW_MUL, [x, y], {}, name)

    def divide(self, x: Tensor, y: Tensor, name=None) -> Tensor:
        return self._add_layer(OpType.EW_DIV, [x, y], {}, name)

    def max(self, x: Tensor, y: Tensor, name=None) -> Tensor:
        return self._add_layer(OpType.EW_MAX, [x, y], {}, name)

    def min(self, x: Tensor, y: Tensor, name=None) -> Tensor:
        return self._add_layer(OpType.EW_MIN, [x, y], {}, name)

    # --- elementwise unary ---
    def relu(self, x: Tensor, name=None) -> Tensor:
        return self._add_layer(OpType.RELU, [x], {}, name)

    def sigmoid(self, x: Tensor, name=None) -> Tensor:
        return self._add_layer(OpType.SIGMOID, [x], {}, name)

    def tanh(self, x: Tensor, name=None) -> Tensor:
        return self._add_layer(OpType.TANH, [x], {}, name)

    def elu(self, x: Tensor, name=None) -> Tensor:
        return self._add_layer(OpType.ELU, [x], {}, name)

    def gelu(self, x: Tensor, approximate: bool = False,
             name=None) -> Tensor:
        """Exact (erf) by default; the tanh form with ``approximate=True``
        (HF ``gelu_pytorch_tanh``, StarCoder's)."""
        return self._add_layer(OpType.GELU, [x],
                               dict(approximate=approximate), name)

    def identity(self, x: Tensor, name=None) -> Tensor:
        return self._add_layer(OpType.IDENTITY, [x], {}, name)

    def exp(self, x: Tensor, name=None) -> Tensor:
        return self._add_layer(OpType.EXP, [x], {}, name)

    def sin(self, x: Tensor, name=None) -> Tensor:
        return self._add_layer(OpType.SIN, [x], {}, name)

    def cos(self, x: Tensor, name=None) -> Tensor:
        return self._add_layer(OpType.COS, [x], {}, name)

    def rsqrt(self, x: Tensor, name=None) -> Tensor:
        return self._add_layer(OpType.RSQRT, [x], {}, name)

    def pow(self, x: Tensor, exponent: float, name=None) -> Tensor:
        return self._add_layer(OpType.POW, [x], dict(exponent=exponent),
                               name)

    def scalar_multiply(self, x: Tensor, scalar: float, inplace: bool = True,
                        name=None) -> Tensor:
        return self._add_layer(OpType.SCALAR_MULTIPLY, [x],
                               dict(scalar=scalar), name)

    def scalar_add(self, x: Tensor, scalar: float, inplace: bool = True,
                   name=None) -> Tensor:
        return self._add_layer(OpType.SCALAR_ADD, [x], dict(scalar=scalar),
                               name)

    def scalar_sub(self, x: Tensor, scalar: float, inplace: bool = True,
                   name=None) -> Tensor:
        return self._add_layer(OpType.SCALAR_SUB, [x], dict(scalar=scalar),
                               name)

    def scalar_true_divide(self, x: Tensor, scalar: float,
                           inplace: bool = True, name=None) -> Tensor:
        return self._add_layer(OpType.SCALAR_TRUE_DIV, [x],
                               dict(scalar=scalar), name)

    # --- shape ---
    def concat(self, tensors: List[Tensor], axis: int, name=None) -> Tensor:
        return self._add_layer(OpType.CONCAT, list(tensors), dict(axis=axis),
                               name)

    def split(self, input: Tensor, sizes, axis: int,
              name=None) -> List[Tensor]:
        if isinstance(sizes, int):
            sizes = [input.dims[axis] // sizes] * sizes
        return self._add_layer(OpType.SPLIT, [input],
                               dict(sizes=list(sizes), axis=axis), name)

    def reshape(self, input: Tensor, shape: Sequence[int],
                name=None) -> Tensor:
        return self._add_layer(OpType.RESHAPE, [input],
                               dict(shape=tuple(shape)), name)

    def transpose(self, input: Tensor, perm: Sequence[int],
                  name=None) -> Tensor:
        return self._add_layer(OpType.TRANSPOSE, [input],
                               dict(perm=tuple(perm)), name)

    def reverse(self, input: Tensor, axis: int, name=None) -> Tensor:
        return self._add_layer(OpType.REVERSE, [input], dict(axis=axis),
                               name)

    def flat(self, input: Tensor, name=None) -> Tensor:
        return self._add_layer(OpType.FLAT, [input], {}, name)

    def slice_tensor(self, input: Tensor, starts, ends, squeeze_dims=(),
                     name=None) -> Tensor:
        """A static slice: ``starts``/``ends`` per dim (None = the whole
        extent, negatives wrap); ``squeeze_dims`` drops sliced size-1
        dims (BERT's ``x[:, 0]``)."""
        return self._add_layer(OpType.SLICE, [input], dict(
            starts=tuple(starts), ends=tuple(ends),
            squeeze_dims=tuple(squeeze_dims)), name)

    def squeeze(self, input: Tensor, dim: int, name=None) -> Tensor:
        dim = dim % input.num_dims
        if input.dims[dim] != 1:
            raise ValueError(f"squeeze: dim {dim} of {input.dims} is not 1")
        return self.reshape(input, [s for d, s in enumerate(input.dims)
                                    if d != dim], name=name)

    def unsqueeze(self, input: Tensor, dim: int, name=None) -> Tensor:
        shape = list(input.dims)
        shape.insert(dim % (input.num_dims + 1), 1)
        return self.reshape(input, shape, name=name)

    def cast(self, input: Tensor, dtype: DataType, name=None) -> Tensor:
        return self._add_layer(OpType.CAST, [input], dict(dtype=dtype), name)

    def softmax(self, input: Tensor, axis: int = -1, name=None) -> Tensor:
        return self._add_layer(OpType.SOFTMAX, [input], dict(axis=axis),
                               name)

    # --- algebra and reductions ---
    def batch_matmul(self, a: Tensor, b: Tensor, name=None) -> Tensor:
        return self._add_layer(OpType.BATCH_MATMUL, [a, b], {}, name)

    def reduce_sum(self, input: Tensor, axes, keepdims: bool = False,
                   name=None) -> Tensor:
        return self._add_layer(OpType.REDUCE_SUM, [input], dict(
            axes=tuple(axes), keepdims=keepdims), name)

    def reduce_mean(self, input: Tensor, axes, keepdims: bool = False,
                    name=None) -> Tensor:
        return self._add_layer(OpType.REDUCE_MEAN, [input], dict(
            axes=tuple(axes), keepdims=keepdims), name)

    def mean(self, input: Tensor, dims, keepdims: bool = False,
             name=None) -> Tensor:
        return self._add_layer(OpType.MEAN, [input], dict(
            dims=tuple(dims), keepdims=keepdims), name)

    def gather(self, input: Tensor, index: Tensor, dim: int,
               name=None) -> Tensor:
        return self._add_layer(OpType.GATHER, [input, index], dict(dim=dim),
                               name)

    # --- constants, selection and free parameters ---
    def constant_tensor(self, value, dtype: Optional[DataType] = None,
                        name=None) -> Tensor:
        """An embedded literal tensor (``value``: an array or nested
        lists; ``dtype`` defaults to the array's)."""
        arr = np.asarray(value)
        if dtype is None:
            dtype = DataType(str(arr.dtype))
        return self._add_layer(OpType.CONSTANT, [], dict(
            value=arr.tolist(), dtype=dtype.value, shape=list(arr.shape)),
            name)

    def parameter(self, dims: Sequence[int],
                  dtype: DataType = DataType.DT_FLOAT, init: float = 1.0,
                  name=None) -> Tensor:
        """A free-standing trainable parameter (the reference PCG's Weight
        node), initialized to ``init``."""
        return self._add_layer(OpType.WEIGHT, [], dict(
            shape=list(dims), dtype=dtype.value, init=init), name)

    def where(self, cond: Tensor, x: Tensor, y: Tensor, name=None) -> Tensor:
        return self._add_layer(OpType.WHERE, [cond, x, y], {}, name)

    def compare(self, x: Tensor, other, cmp: str, name=None) -> Tensor:
        """Elementwise ``cmp`` (eq/ne/lt/le/gt/ge) against a Tensor or a
        scalar."""
        if isinstance(other, Tensor):
            return self._add_layer(OpType.COMPARE, [x, other],
                                   dict(cmp=cmp), name)
        return self._add_layer(OpType.COMPARE, [x], dict(
            cmp=cmp, scalar=float(other)), name)

    def broadcast_to(self, input: Tensor, shape: Sequence[int],
                     name=None) -> Tensor:
        return self._add_layer(OpType.BROADCAST_TO, [input],
                               dict(shape=list(shape)), name)

    # --- mixture of experts (ops/moe.py) and the activation cache ---
    def group_by(self, data: Tensor, assign: Tensor, n: int,
                 alpha: float = 1.0, name=None) -> List[Tensor]:
        return self._add_layer(OpType.GROUP_BY, [data, assign], dict(
            n=n, k=assign.dims[-1], alpha=alpha), name)

    def aggregate(self, gate_preds: Tensor, gate_assign: Tensor,
                  exp_preds: List[Tensor], n: int, lambda_bal: float = 0.0,
                  name=None) -> Tensor:
        return self._add_layer(OpType.AGGREGATE,
                               [gate_preds, gate_assign] + list(exp_preds),
                               dict(n=n, lambda_bal=lambda_bal), name)

    def aggregate_spec(self, gate_preds: Tensor, gate_assign: Tensor,
                       exp_preds: List[Tensor], n: int,
                       lambda_bal: float = 0.0, name=None) -> Tensor:
        return self._add_layer(OpType.AGG_SPEC,
                               [gate_preds, gate_assign] + list(exp_preds),
                               dict(n=n, lambda_bal=lambda_bal), name)

    def experts(self, input: Tensor, indices: Tensor, gate_weights: Tensor,
                num_experts: int, experts_start_idx: int,
                experts_output_dim_size: int, experts_num_layers: int = 1,
                experts_internal_dim_size: int = 0,
                activation: ActiMode = ActiMode.AC_MODE_NONE,
                use_bias: bool = False, name=None) -> Tensor:
        return self._add_layer(OpType.EXPERTS, [input, indices,
                                                gate_weights], dict(
            num_experts=num_experts, experts_start_idx=experts_start_idx,
            experts_output_dim_size=experts_output_dim_size,
            experts_num_layers=experts_num_layers,
            experts_internal_dim_size=experts_internal_dim_size,
            activation=activation, use_bias=use_bias), name)

    def moe(self, input: Tensor, num_exp: int, num_select: int,
            expert_hidden_size: int, alpha: float = 2.0,
            lambda_bal: float = 0.0) -> Tensor:
        """The composite MoE layer (reference src/ops/moe.cc:44): a
        softmax gate, its top-k, GROUP_BY, a two-dense expert per
        bucket, AGGREGATE."""
        gate = self.softmax(self.dense(input, num_exp))
        values, assign = self.top_k(gate, num_select)
        buckets = self.group_by(input, assign, num_exp, alpha)
        if not isinstance(buckets, list):
            buckets = [buckets]
        outs = [self.dense(self.dense(b, expert_hidden_size,
                                      ActiMode.AC_MODE_RELU),
                           input.dims[-1]) for b in buckets]
        return self.aggregate(values, assign, outs, num_exp, lambda_bal)

    def cache(self, input: Tensor, num_batches: int = 1,
              name=None) -> Tensor:
        """A cross-batch activation cache with a staleness score
        (``ops/cache.py``; read by ``get_cache_score``)."""
        return self._add_layer(OpType.CACHE, [input],
                               dict(num_batches=num_batches), name)

    def get_cache_score(self, layer_name: str) -> float:
        """A Cache layer's staleness score, read from the device."""
        st = (self.op_state or {}).get(layer_name)
        if st is None or "score" not in st:
            raise KeyError(f"no cache state for layer {layer_name!r}")
        return float(st["score"])

    # --- selection and the serving heads ---
    def top_k(self, input: Tensor, k: int, sorted: bool = True,
              name=None) -> List[Tensor]:
        return self._add_layer(OpType.TOPK, [input],
                               dict(k=k, sorted=sorted), name)

    def arg_top_k(self, input: Tensor, k: int, sorted: bool = True,
                  speculative_decoding: bool = False,
                  name=None) -> Union[Tensor, List[Tensor]]:
        return self._add_layer(OpType.ARG_TOPK, [input], dict(
            k=k, sorted=sorted, speculative_decoding=speculative_decoding),
            name)

    def argmax(self, input: Tensor, beam_search: bool = False,
               name=None) -> Union[Tensor, List[Tensor]]:
        return self._add_layer(OpType.ARGMAX, [input],
                               dict(beam_search=beam_search), name)

    def sampling(self, input: Tensor, top_p: float = 1.0,
                 temperature: float = 1.0, name=None) -> Tensor:
        return self._add_layer(OpType.SAMPLING, [input],
                               dict(top_p=top_p, temperature=temperature),
                               name)

    def beam_top_k(self, input: Tensor, max_beam_width: int,
                   sorted: bool = True, name=None) -> List[Tensor]:
        return self._add_layer(OpType.BEAM_TOPK, [input],
                               dict(max_beam_width=max_beam_width,
                                    sorted=sorted), name)

    # --- parallel ops (reference src/parallel_ops/; parallel/ops.py) ---
    def repartition(self, input: Tensor, repartition_dim: int,
                    repartition_degree: int = 0, axis_name: str = "data",
                    name=None) -> Tensor:
        return self._add_layer(OpType.REPARTITION, [input],
                               dict(repartition_dim=repartition_dim,
                                    repartition_degree=repartition_degree,
                                    axis_name=axis_name), name)

    def combine(self, input: Tensor, combine_dim: int = 0,
                combine_degree: int = 0, axis_name: str = "data",
                name=None) -> Tensor:
        return self._add_layer(OpType.COMBINE, [input],
                               dict(combine_dim=combine_dim,
                                    combine_degree=combine_degree,
                                    axis_name=axis_name), name)

    def replicate(self, input: Tensor, replicate_dim: int = 0,
                  replicate_degree: int = 0, name=None) -> Tensor:
        return self._add_layer(OpType.REPLICATE, [input],
                               dict(replicate_dim=replicate_dim,
                                    replicate_degree=replicate_degree), name)

    def reduction(self, input: Tensor, reduction_dim: int = 0,
                  reduction_degree: int = 0, axis_name: str = "model",
                  name=None) -> Tensor:
        return self._add_layer(OpType.REDUCTION, [input],
                               dict(reduction_dim=reduction_dim,
                                    reduction_degree=reduction_degree,
                                    axis_name=axis_name), name)

    def allreduce(self, input: Tensor, axis_name: str = "model",
                  name=None) -> Tensor:
        return self._add_layer(OpType.ALLREDUCE, [input],
                               dict(axis_name=axis_name), name)

    def batch_sharding(self, shape):
        """The Sharding of a batch of ``shape`` on the mesh (dim 0 over
        ``data``), or None without a mesh."""
        if self.policy is None:
            return None
        return self.policy.batch_sharding(tuple(shape))

    # ==================================================================
    # Graph execution
    # ==================================================================
    def _apply_layer(self, layer: Layer, params, values: Dict[int, Any],
                     ctx: OpContext, ins=None, attrs=None):
        """Run one layer into ``values``: its inputs from ``values`` unless
        ``ins`` gives them, with ``attrs`` in place of its own when given
        (a parallel train step's per-rank view, parallel/placement.py)."""
        impl = get_op_impl(layer.op_type)
        if ins is None:
            ins = [values[t.tensor_id] for t in layer.inputs]
        if attrs is None:
            attrs = layer.attrs
        ctx.layer_name = layer.name
        lp = params.get(layer.name, {})
        plan = self._strategy_plan
        if plan is not None and layer.name in plan.weights:
            # weights resting in a searched layout the forward does not
            # take: brought to the form it does (placement.reshard)
            from flexflow_tpu_torch.parallel.placement import reshard

            lp = dict(lp)
            for w, (src, dst) in plan.weights[layer.name].items():
                lp[w] = reshard(lp[w], self.mesh, src, dst)
        if plan is not None and layer.name in plan.attrs:
            attrs = dict(attrs, **plan.attrs[layer.name])
        if layer.name in self._offloaded:
            # paged weights stream back first, still compressed
            from flexflow_tpu_torch.offload import fetch_layer_params

            lp = fetch_layer_params(self, layer.name, lp)
        if not impl.quant_aware:
            lp = dequantize_layer_params(lp, ctx.compute_dtype)
        if ctx.training and self.config.remat and torch.is_grad_enabled():
            outs = self._remat_forward(impl, attrs, lp, ins, ctx)
        else:
            outs = impl.forward(attrs, lp, ins, ctx)
        for t, v in zip(layer.outputs, outs):
            values[t.tensor_id] = v

    @staticmethod
    def _remat_forward(impl, attrs, lp, ins, ctx: OpContext):
        """``impl.forward`` under ``torch.utils.checkpoint``: the layer's
        activations are dropped after the forward and recomputed in the
        backward. The recompute draws from the generator the state the
        forward began from (``checkpoint`` restores only the default
        generators), and writes its op state into a dict that is thrown
        away, so the step's draws and state are those of one forward."""
        from torch.utils.checkpoint import checkpoint

        gen = ctx.generator
        start = gen.get_state() if gen is not None else None
        again = dataclasses.replace(ctx)    # this layer's name and shards
        names = list(lp)
        calls = [0]

        def run(*tensors):
            p = dict(zip(names, tensors[:len(names)]))
            x = list(tensors[len(names):])
            calls[0] += 1
            if calls[0] == 1:
                return tuple(impl.forward(attrs, p, x, ctx))
            now = gen.get_state() if gen is not None else None
            if gen is not None:
                gen.set_state(start)
            try:
                return tuple(impl.forward(
                    attrs, p, x, dataclasses.replace(again, state_out={})))
            finally:
                if gen is not None:
                    gen.set_state(now)

        return list(checkpoint(run, *(lp[n] for n in names), *ins,
                               use_reentrant=False,
                               preserve_rng_state=False))

    def _splits_batch(self) -> bool:
        """Does the mesh split the batch (a ``data`` or ``seq`` axis)?"""
        return self.mesh is not None and (self.mesh.axis_size("data") > 1
                                          or self.mesh.axis_size("seq") > 1)

    def _walks(self) -> bool:
        """Does a train or eval forward take the placement walk
        (``_run_split``): a mesh that splits the batch, or a searched
        strategy on a mesh?"""
        return self._splits_batch() or self._strategy_plan is not None

    def _run_graph(self, params, feeds: Dict[int, Any], ctx: OpContext,
                   state: Optional[Dict[str, Any]] = None):
        """Walk the layer list (creation order is topological order)
        computing every tensor value. Returns (values_by_tensor_id,
        new_state); KV caches in the state were updated in place. The
        kernels serve CUDA tensors unless ``config.use_kernels`` is off.
        A mesh that splits the batch runs each rank's part
        (``_run_split``) outside serving."""
        from flexflow_tpu_torch.kernels import use_kernels

        ctx.mesh = self.mesh
        if self._pp_plan is not None and not ctx.training:
            from flexflow_tpu_torch.serve.pipeline_plan import run_pp_graph

            with use_kernels(self.config.use_kernels):
                values, new_state = run_pp_graph(self, params, feeds, ctx,
                                                 state)
        else:
            values: Dict[int, Any] = dict(feeds)
            ctx.state_in = state or {}
            ctx.state_out = {}
            with use_kernels(self.config.use_kernels):
                if self._walks() and ctx.batch_config is None:
                    self._run_split(params, values, ctx)
                elif (ctx.batch_config is not None
                      and self._strategy_plan is not None
                      and self._strategy_plan.outputs):
                    self._run_serving_walk(params, values, ctx)
                else:
                    for layer in self.layers:
                        self._apply_layer(layer, params, values, ctx)
            new_state = dict(ctx.state_in)
            new_state.update(ctx.state_out)
        if (self.mesh is not None and self.mesh.device_mesh is not None
                and ctx.batch_config is not None):
            self._broadcast_final(values)
        return values, new_state

    def _run_split(self, params, values: Dict[int, Any], ctx: OpContext):
        """The walk of a mesh that splits the batch or executes a searched
        strategy: each batch input keeps this rank's part, every layer
        runs on the part its inputs' placements allow, and a layer's
        output moves to its searched spec (parallel/placement.py);
        ``self._walk`` keeps the placements for the loss and the
        gradient sums."""
        from flexflow_tpu_torch.parallel.collectives import split
        from flexflow_tpu_torch.parallel.placement import (Walk, feed_place,
                                                           local_attrs)

        walk = Walk(self.mesh, ctx.training)
        for t in self.input_tensors:
            if t.tensor_id in values:
                place = feed_place(self.policy, t.dims)
                for axis, d in place.items():
                    values[t.tensor_id] = split(values[t.tensor_id],
                                                self.mesh, axis, d)
                walk.places[t.tensor_id] = place
        outputs = (self._strategy_plan.outputs
                   if self._strategy_plan is not None else {})
        branches = self._branch_plan

        def run(layer):
            ins, active, ctx.row_shards = walk.layer_inputs(layer, values)
            self._apply_layer(layer, params, values, ctx, ins=ins,
                              attrs=local_attrs(layer, active, self.mesh))
            walk.record(layer, active)
            if layer.name in outputs:
                walk.place_output(layer, values, outputs[layer.name])

        for layer in self.layers:
            if branches is not None:
                if layer.name in branches.skip:
                    continue            # runs inside its branch region
                region = branches.by_join.get(layer.name)
                if region is not None:
                    from flexflow_tpu_torch.core.branch_exec import \
                        run_branch_region

                    ctx.row_shards = {}
                    if run_branch_region(self, region, params, values,
                                         ctx, walk):
                        if layer.name in outputs:
                            walk.place_output(layer, values,
                                              outputs[layer.name])
                        continue
                    # the batch does not split over a branch's ranks: the
                    # branches run in turn, then the join
                    for chain in region.chains:
                        for ly in chain:
                            run(ly)
            run(layer)
        ctx.row_shards = {}
        self._walk = walk

    def _run_serving_walk(self, params, values: Dict[int, Any],
                          ctx: OpContext):
        """A serving forward under a strategy that moves outputs: each
        layer's output goes to its searched spec (``policy.constrain``),
        and each layer reads its inputs whole (gathered once a forward;
        the serving ops keep their own tensor-parallel layout inside).
        An output spec is thus placement only: it costs a split and an
        all_gather a forward and shards no consumer. The final output is
        made whole for the broadcast and the host loop."""
        outputs, policy = self._strategy_plan.outputs, self.policy
        placed = {}     # tensor id -> the layout its value holds

        def whole(tid):
            if tid in placed:
                values[tid] = policy.constrain(values[tid], (),
                                               src=placed.pop(tid))
            return values[tid]

        for layer in self.layers:
            ins = [whole(t.tensor_id) for t in layer.inputs]
            self._apply_layer(layer, params, values, ctx, ins=ins)
            if layer.name in outputs:
                tid = layer.outputs[0].tensor_id
                placed[tid] = policy.resolve(outputs[layer.name],
                                             values[tid].shape)
                values[tid] = policy.constrain(values[tid], placed[tid])
        whole(self._final_tensor.tensor_id)

    def _broadcast_final(self, values):
        """Every rank takes the final output of the rank that made it (the
        last pipeline stage, at index 0 of the other axes), so that all
        ranks read the same tokens and their host loops never diverge
        (a diverging loop would leave a collective waiting)."""
        from flexflow_tpu_torch.parallel.collectives import broadcast

        at = {a: 0 for a in self.mesh.axis_names}
        at["pipe"] = self.mesh.axis_size("pipe") - 1
        src = self.mesh.rank_at(**at)
        tid = self._final_tensor.tensor_id
        values[tid] = broadcast(values.get(tid), src, device=self.device)

    # ==================================================================
    # Compile
    # ==================================================================
    def compile(self, optimizer=None, loss_type: Optional[LossType] = None,
                metrics: Optional[List[MetricsType]] = None,
                comp_mode: Optional[CompMode] = None):
        """Initialize parameters and op state on ``self.device``.

        ``comp_mode`` defaults to training when an optimizer or a loss is
        given, else to inference (the JAX package defaults to training;
        the port's serving callers compile with no arguments). Quantization
        at init applies to inference only, as in the JAX package."""
        if comp_mode is None:
            comp_mode = (CompMode.COMP_MODE_TRAINING
                         if optimizer is not None or loss_type is not None
                         else CompMode.COMP_MODE_INFERENCE)
        training = comp_mode == CompMode.COMP_MODE_TRAINING
        dev = self.device
        self.comp_mode = comp_mode
        self._gemm_fusion_done = False
        self._offloaded = {}
        self._prefetcher = None
        self._strategy_plan = self._branch_plan = None
        # --- Unity-style auto-parallelization (reference model.cc:3327
        # launches GRAPH_OPTIMIZE_TASK inside compile). A strategy the
        # caller set before compile (e.g. a Strategy.load of an exported
        # search result) is kept.
        if self.config.auto_parallel:
            from flexflow_tpu_torch import distributed
            from flexflow_tpu_torch.search import optimize_model

            # the ranks agree on one strategy: rank 0's, broadcast
            distributed.initialize(device=str(dev))
            self.strategy = optimize_model(
                self, chip=self.config.search_chip, training=training)
        if (self.strategy is not None
                and self.strategy.axis_degrees is not None):
            # the search explored mesh factorizations and a different one
            # won: the mesh is laid with its degrees
            deg = self.strategy.axis_degrees
            self.config.data_parallelism_degree = deg.get("data", 1)
            self.config.tensor_parallelism_degree = deg.get("model", 1)
            self.config.expert_parallelism_degree = deg.get("expert", 1)
            self.config.sequence_parallelism_degree = deg.get("seq", 1)
        self._setup_mesh(training)
        if self.strategy is not None:
            from flexflow_tpu_torch.parallel.placement import plan_strategy

            self._strategy_plan = plan_strategy(self)

        self.op_state = {}
        for layer in self.layers:
            impl = get_op_impl(layer.op_type)
            if hasattr(impl, "init_state"):
                input_specs = [(t.dims, t.dtype) for t in layer.inputs]
                self.op_state[layer.name] = impl.init_state(
                    layer.attrs, input_specs, dev)
        self._consolidate_kv_caches()
        self._pp_plan = None
        if self.mesh is not None:
            self._plan_and_shard_state()
        if self.config.export_strategy_file:
            # the reference's --export-strategy-computation-graph-file
            # (and --include-costs-dot-graph, model.cc:4218)
            from flexflow_tpu_torch.utils.dot import export_model_dot

            costs = None
            if self.config.include_costs_dot_graph:
                costs = self._estimate_layer_costs()
            export_model_dot(self, self.config.export_strategy_file,
                             include_costs=self.config.include_costs_dot_graph,
                             costs=costs, strategy=self.strategy)

        qtype = None if training else self.config.quantization_type
        shardings = None
        if self.mesh is not None:
            from flexflow_tpu_torch.parallel.spec import (
                layer_weight_shardings, shard_leaf)

            shardings = layer_weight_shardings(self, self.policy)
        params: Dict[str, Dict[str, Any]] = {}
        for layer in self.layers:
            if not layer.weights or not self._holds(layer.name):
                continue
            lp = {}
            for w in layer.weights:
                gen = torch.Generator(device=dev)
                gen.manual_seed(weight_seed(self.config.seed, layer.name,
                                            w.name))
                lp[w.name] = w.initializer(gen, tuple(w.shape),
                                           w.dtype.to_torch(), dev)
            if qtype:
                # quantize each layer as it is initialized: the device
                # holds one float layer at a time, never the float model
                lp = quantize_params({layer.name: lp}, qtype)[layer.name]
            if shardings is not None:
                # this rank's slice of the full (quantized) layer: the
                # values an unsharded run of the same seed holds
                lp = {w: shard_leaf(a, shardings[layer.name][w],
                                    self.mesh.coord)
                      for w, a in lp.items()}
            if training:
                for a in lp.values():
                    if a.is_floating_point():
                        a.requires_grad_(True)
            params[layer.name] = lp
        self.params = params
        # rows of the smallest table the position input indexes (None
        # without one): serve/engine.build_feeds clamps positions below it
        rows = [layer.attrs["num_entries"] for layer in self.layers
                if layer.op_type == OpType.EMBEDDING
                and self.position_input_tensor in layer.inputs]
        self._position_rows = min(rows) if rows else None

        # the label tensor (made from the final output, as the reference's
        # compile does) and the logits a final Softmax consumes
        final = self.layers[-1].outputs[0] if self.layers else None
        self._final_tensor = final
        self._logits_tensor = None
        if final is not None and self.layers[-1].op_type == OpType.SOFTMAX:
            self._logits_tensor = self.layers[-1].inputs[0]
        if final is not None and self.label_tensor is None:
            if loss_type == LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY:
                self.label_tensor = Tensor((final.dims[0], 1),
                                           DataType.DT_INT32, name="label",
                                           model=self)
            else:
                self.label_tensor = Tensor(final.dims, final.dtype,
                                           name="label", model=self)
        self.optimizer = optimizer
        self.loss_type = loss_type
        self.metrics = list(metrics or [])
        self.opt_state = None
        if optimizer is not None:
            # set_learning_rate reaches the live state through the model
            optimizer.ffmodel = self
            self.opt_state = optimizer.init_state(self.params)
        self._reg_terms = [(layer.name, "kernel", kind, coeff)
                           for layer in self.layers
                           for kind, coeff in
                           layer.attrs.get("kernel_regularizer") or []]
        self._walk = None
        # fork-join regions of the strategy's branch tags, run on their
        # own ranks (core/branch_exec.py)
        from flexflow_tpu_torch.core.branch_exec import build_branch_plan

        self._branch_plan = build_branch_plan(self)
        return self

    # ==================================================================
    # Parallel serving: the mesh, the pipeline plan, sharded state
    # ==================================================================
    def _setup_mesh(self, training: bool):
        """Join the process group and lay the mesh when a parallelism
        degree is above 1 or a mesh shape is given; else no mesh.
        Training takes the ``data``, ``model``, ``seq`` and ``expert``
        axes; serving the ``model``, ``pipe`` and ``seq`` axes."""
        cfg = self.config
        self.mesh = self.policy = None
        self._grad_reducer = None
        if cfg.total_parallelism_degree == 1 and cfg.mesh_shape is None:
            return
        pipe = (cfg.pipeline_parallelism_degree > 1
                or (cfg.mesh_shape is not None
                    and "pipe" in tuple(cfg.mesh_axis_names)[
                        :len(cfg.mesh_shape)]))
        if training and pipe:
            raise NotImplementedError(
                "the pipeline axis serves: the port trains over the data, "
                "model, seq and expert axes")
        from flexflow_tpu_torch import distributed
        from flexflow_tpu_torch.parallel.mesh import make_mesh
        from flexflow_tpu_torch.parallel.placement import GradReducer
        from flexflow_tpu_torch.parallel.spec import ShardingPolicy

        distributed.initialize(device=str(self.device))
        mesh = make_mesh(cfg)
        serving = any(layer.op_type in (
            OpType.INC_MULTIHEAD_SELF_ATTENTION,
            OpType.SPEC_INC_MULTIHEAD_SELF_ATTENTION,
            OpType.TREE_INC_MULTIHEAD_SELF_ATTENTION)
            for layer in self.layers)
        for ax in ("data", "expert"):
            if serving and not training and mesh.axis_size(ax) > 1:
                raise NotImplementedError(
                    f"the {ax!r} axis does not serve: set tensor, pipeline "
                    "or sequence parallelism degrees whose product is the "
                    "world size")
        self.mesh = mesh
        self.policy = ShardingPolicy(mesh)
        if self._splits_batch():
            self._grad_reducer = GradReducer(mesh)

    def _plan_and_shard_state(self):
        """Build the pipeline plan (with a ``pipe`` axis) and keep this
        rank's part of every KV cache: its stage's layers, its KV heads
        under tensor parallelism, its S rows under sequence parallelism."""
        from flexflow_tpu_torch.serve.pipeline_plan import (
            build_pipeline_plan, shard_stage_state)

        mesh = self.mesh
        if mesh.axis_size("pipe") > 1:
            plan = build_pipeline_plan(self, mesh.axis_size("pipe"))
            if plan is None:
                raise ValueError(
                    "pipeline_parallelism_degree > 1 needs a homogeneous "
                    "transformer-block serving graph (model-zoo style "
                    "'<prefix>.{i}.' layer naming, num_layers divisible by "
                    "the degree); this graph has no such decomposition")
            self._pp_plan = plan
            shard_stage_state(self, plan, mesh.index("pipe"))
        for st in self.op_state.values():
            if not isinstance(st, dict):
                continue
            for name in ("k", "v", "k_cache", "v_cache"):
                if name in st:
                    sh = self.policy.kv_state_sharding(tuple(st[name].shape))
                    if not sh.is_replicated:
                        st[name] = st[name][sh.index(
                            tuple(st[name].shape), mesh.coord)].clone()

    def _holds(self, layer_name: str) -> bool:
        """Does this rank hold (and run) ``layer_name``? Every layer but
        another pipeline stage's."""
        if self._pp_plan is None:
            return True
        from flexflow_tpu_torch.serve.pipeline_plan import stage_holds

        return stage_holds(self._pp_plan, layer_name,
                           self.mesh.index("pipe"))

    def _weight_sharding(self, layer_name: str, weight_name: str):
        """The Sharding a weight rests in under the mesh (its searched
        ``weight_specs`` entry, else its WeightSpec's: placement.rest_dims),
        or None."""
        if self.policy is None:
            return None
        from flexflow_tpu_torch.parallel.placement import rest_dims

        st = (self.strategy.ops.get(layer_name)
              if self.strategy is not None else None)
        for layer in self.layers:
            if layer.name == layer_name:
                for w in layer.weights:
                    if w.name == weight_name:
                        return self.policy.weight_sharding(
                            w.shape, rest_dims(w, st), w.shard_multiples)
        return None

    def finalize_pipeline(self):
        """Stack this stage's block weights (no-op without a plan; see
        ``serve/pipeline_plan.finalize_pipeline``). Call after loading
        weights; ``LLM.compile`` and the InferenceManager do."""
        if self._pp_plan is not None:
            from flexflow_tpu_torch.serve.pipeline_plan import \
                finalize_pipeline

            finalize_pipeline(self)
        return self

    def offload_weights(self, min_bytes: int = 1 << 20) -> int:
        """Page the big serving weights to pinned host memory; the forward
        streams them back per layer (``offload.py``, the reference's
        -offload). Returns the bytes moved off the device."""
        from flexflow_tpu_torch.offload import offload_model_weights

        moved = offload_model_weights(self, min_bytes=min_bytes)
        if self.config.profiling:
            print(f"offload_weights: {moved / 1e6:.1f}MB -> pinned_host")
        return moved

    def _consolidate_kv_caches(self):
        """Stack homogeneous per-layer KV caches (every serving-attention
        op: incremental, draft and tree verify) into two [L, ...] tensors;
        layers get attrs["cache_layer_idx"] (ops/inc_attention.py reads
        and appends through it, and the attention kernels stream one layer
        of the stack from its base pointer)."""
        names = [n for n, st in self.op_state.items()
                 if isinstance(st, dict) and "k_cache" in st]
        if len(names) < 2:
            return
        shapes = {tuple(self.op_state[n]["k_cache"].shape) for n in names}
        dtypes = {self.op_state[n]["k_cache"].dtype for n in names}
        if len(shapes) != 1 or len(dtypes) != 1:
            return  # heterogeneous caches keep the per-layer layout
        by_name = {layer.name: layer for layer in self.layers}
        for i, n in enumerate(names):
            by_name[n].attrs["cache_layer_idx"] = i
        k = torch.stack([self.op_state[n]["k_cache"] for n in names])
        v = torch.stack([self.op_state[n]["v_cache"] for n in names])
        for n in names:
            del self.op_state[n]
        self.op_state["kv_cache"] = {"k": k, "v": v}

    def finalize_gemm_fusion(self):
        """Fuse the serving decode GEMMs (qkv, SwiGLU gate|up) in place
        where ``serve/gemm_fusion.py`` finds the model eligible. Called
        after the weights are loaded (``LLM.compile``, the
        InferenceManager, the speculative engines); idempotent. A call
        before ``compile`` decides nothing."""
        from flexflow_tpu_torch.serve.gemm_fusion import (apply_gemm_fusion,
                                                          fusion_eligible)

        if self._gemm_fusion_done or self.comp_mode is None:
            return self
        # a pipeline plan stacks its blocks first (fusion is off under it,
        # but every caller that finalizes fusion has its weights loaded)
        self.finalize_pipeline()
        if fusion_eligible(self):
            apply_gemm_fusion(self)
        self._gemm_fusion_done = True
        return self

    def quantize_weights(self, qtype: str):
        """Quantize every eligible weight to int8/int4 on its device
        (inference only; leaves already quantized stay as they are)."""
        before = quantized_nbytes(self.params)
        self.params = quantize_params(self.params, normalize_qtype(qtype))
        if self.config.profiling:
            print(f"quantize_weights({qtype}): {before / 1e6:.1f}MB -> "
                  f"{quantized_nbytes(self.params) / 1e6:.1f}MB")
        return self

    # ==================================================================
    # Training verbs (the JAX package's train/eval/predict steps, eager)
    # ==================================================================
    def _to_device(self, a, dtype: DataType) -> torch.Tensor:
        return torch.as_tensor(a).to(device=self.device,
                                     dtype=dtype.to_torch())

    def _feeds_from_arrays(self, xs) -> Dict[int, torch.Tensor]:
        if len(xs) != len(self.input_tensors):
            raise ValueError(f"model has {len(self.input_tensors)} inputs, "
                             f"got {len(xs)}")
        return {t.tensor_id: self._to_device(x, t.dtype)
                for t, x in zip(self.input_tensors, xs)}

    def _ctx(self, training: bool) -> OpContext:
        return OpContext(training=training,
                         compute_dtype=torch_dtype(self.config.compute_dtype),
                         generator=self.generator if training else None,
                         device=self.device, config=self.config)

    def _loss_and_out(self, feeds, label, ctx: OpContext):
        """One forward: (loss, regularizer terms, output, label, batch,
        new op state). ``output`` and ``label`` are this rank's rows when
        a mesh splits the batch, and ``batch`` then is the ``(psum,
        parts)`` that makes a sum over them the whole batch's (else
        None); the loss is the whole batch's either way."""
        values, new_state = self._run_graph(self.params, feeds, ctx,
                                            self.op_state)
        out, logits, label, batch = self._final_rows(values, label)
        loss = compute_loss(self.loss_type, out, label, logits=logits,
                            batch=batch)
        return loss, self._regularizers(), out, label, batch, new_state

    def _final_rows(self, values, label):
        """(output, logits, label, batch) of a forward: under a split
        batch the output keeps only a split of its rows (any other split
        is gathered) and the label is cut to the same rows."""
        out = values[self._final_tensor.tensor_id]
        lt = self._logits_tensor
        logits = values[lt.tensor_id] if lt is not None else None
        if self._walk is None or not self._walks():
            return out, logits, label, None
        from flexflow_tpu_torch.parallel.collectives import psum

        walk = self._walk
        out, place = walk.whole(self._final_tensor.tensor_id, out,
                                keep_rows=True)
        if logits is not None:
            logits, lplace = walk.whole(lt.tensor_id, logits,
                                        keep_rows=True)
            if lplace != place:
                logits, _ = walk.whole(lt.tensor_id, logits)
                out, _ = walk.whole(self._final_tensor.tensor_id, out)
                place = {}
        if not place:
            return out, logits, label, None
        (axis, _d), = place.items()
        n = self.mesh.axis_size(axis)
        if label.shape[0] != out.shape[0] * n:
            raise ValueError(f"label rows {label.shape[0]} do not match the "
                             f"output's {out.shape[0] * n}")
        label = label.chunk(n, dim=0)[self.mesh.index(axis)]
        return out, logits, label, (
            lambda v: psum(v, self.mesh, axis), n)

    def _regularizers(self) -> List[torch.Tensor]:
        """Each kernel regularizer's term, over the whole weight (a weight
        split over ``model`` or ``expert`` sums its ranks' penalties)."""
        from flexflow_tpu_torch.parallel.collectives import psum

        terms = []
        for lname, wname, kind, coeff in self._reg_terms:
            w = self.params[lname][wname]
            pen = w.abs().sum() if kind == "l1" else w.square().sum()
            sh = self._weight_sharding(lname, wname)
            for axis in (sh.spec if sh is not None else ()):
                if axis is not None:
                    pen = psum(pen, self.mesh, axis)
            terms.append(coeff * pen)
        return terms

    @staticmethod
    def _with_terms(loss, terms):
        for t in terms:
            loss = loss + t
        return loss

    def _step_metrics(self, out, label, batch):
        mets = compute_step_metrics(self.metrics, out, label, self.loss_type)
        if batch is not None and mets:
            keys = list(mets)
            summed = batch[0](torch.stack([mets[k].double() for k in keys]))
            mets = dict(zip(keys, summed.unbind()))
        return mets

    def _train_step(self, feeds, label):
        """Forward, loss, backward, the optimizer's in-place update and the
        step metrics; returns (loss, metrics) as device scalars. The
        gradients stay in each parameter's ``.grad`` until the next step
        (or ``zero_gradients``). Under a split batch the parameters'
        partial gradients are summed over the batch axes before the
        regularizers' gradients, counted once, are added."""
        self.zero_gradients()
        with torch.enable_grad():
            loss, terms, out, label, batch, new_state = self._loss_and_out(
                feeds, label, self._ctx(True))
            if self._grad_reducer is None:
                loss = self._with_terms(loss, terms)
                loss.backward()
            else:
                loss.backward()
                self._grad_reducer(self.params, self._walk.layer_axes)
                if terms:
                    self._with_terms(terms[0], terms[1:]).backward()
                loss = self._with_terms(loss.detach(),
                                        [t.detach() for t in terms])
        grads = {layer: {w: p.grad for w, p in lp.items()}
                 for layer, lp in self.params.items()}
        self.optimizer.update_step(self.params, grads, self.opt_state)
        self.op_state = new_state
        with torch.no_grad():
            step_metrics = self._step_metrics(out.detach(), label, batch)
        return loss.detach(), step_metrics

    @property
    def grad_allreduce_bytes(self) -> int:
        """The bytes the last train step all-reduced to sum the gradients
        over the batch axes (0 without a split batch)."""
        r = self._grad_reducer
        return r.bytes_last_step if r is not None else 0

    def _check_training(self):
        if self.optimizer is None or self.loss_type is None:
            raise RuntimeError("compile(optimizer=..., loss_type=...) "
                               "before training")

    @staticmethod
    def _read(losses, mets) -> Tuple[List[float], List[Dict[str, float]]]:
        """One host read of a block's losses and step metrics."""
        keys = list(mets[0])
        flat = torch.stack([torch.stack([l.double()]
                                        + [m[k].double() for k in keys])
                            for l, m in zip(losses, mets)]).tolist()
        return ([row[0] for row in flat],
                [dict(zip(keys, row[1:])) for row in flat])

    def train_one_batch(self, xs, y) -> float:
        self._check_training()
        feeds = self._feeds_from_arrays(xs)
        label = self._to_device(y, self.label_tensor.dtype)
        t0 = time.perf_counter()
        loss, met = self._train_step(feeds, label)
        (loss,), (met,) = self._read([loss], [met])     # fences the step
        if self.config.profiling:
            self._step_timer.record("train_step", time.perf_counter() - t0)
        self._perf.update(met, y.shape[0])
        return loss

    def train_batches(self, xs, y, unroll: bool = False) -> List[float]:
        """K train steps with one host read at the end. ``xs``: per-input
        arrays stacked [K, batch, ...]; ``y``: [K, batch, ...]. Returns
        the K losses; metrics, parameters, op state and dropout draws end
        as K ``train_one_batch`` calls leave them. ``unroll`` is accepted
        for the JAX signature (whose scan lowers convolutions badly); the
        port's block is the same eager loop either way."""
        self._check_training()
        stacked = self._feeds_from_arrays(xs)       # [K, batch, ...] each
        labels = self._to_device(y, self.label_tensor.dtype)
        losses, mets = [], []
        t0 = time.perf_counter()
        for i in range(labels.shape[0]):
            loss, met = self._train_step(
                {tid: v[i] for tid, v in stacked.items()}, labels[i])
            losses.append(loss)
            mets.append(met)
        losses, mets = self._read(losses, mets)     # fences the block
        if self.config.profiling:
            # per-step time, amortized over the block (as the JAX package)
            dt = (time.perf_counter() - t0) / len(losses)
            for _ in losses:
                self._step_timer.record("train_step", dt)
        for met in mets:
            self._perf.update(met, y.shape[1])
        return losses

    def fit(self, x=None, y=None, batch_size: Optional[int] = None,
            epochs: Optional[int] = None, shuffle: bool = False,
            initial_epoch: int = 0, steps_per_call: int = 1,
            unroll: bool = False):
        """Keras-style fit. ``initial_epoch`` offsets the shuffle seed, so
        an outer loop calling fit(epochs=1) per epoch still gets a fresh
        order each epoch; ``steps_per_call`` > 1 groups the batches
        through ``train_batches`` (an epoch's tail runs step by step)."""
        xs = [np.asarray(a) for a in (x if isinstance(x, (list, tuple))
                                      else [x])]
        y = np.asarray(y)
        bs = batch_size or self.config.batch_size
        epochs = epochs or self.config.epochs
        if y.shape[0] < bs:
            raise ValueError(
                f"fit() needs at least one full batch: {y.shape[0]} samples "
                f"< batch_size {bs}")
        history = []
        for epoch in range(epochs):
            self.reset_metrics()
            losses: List[float] = []
            pend: List[Any] = []
            for *bxs, by in minibatches(xs + [y], bs, shuffle=shuffle,
                                        seed=self.config.seed
                                        + initial_epoch + epoch):
                if steps_per_call <= 1:
                    losses.append(self.train_one_batch(bxs, by))
                    continue
                pend.append((bxs, by))
                if len(pend) == steps_per_call:
                    losses.extend(self.train_batches(
                        [np.stack(a) for a in zip(*(p[0] for p in pend))],
                        np.stack([p[1] for p in pend]), unroll=unroll))
                    pend = []
            for bxs, by in pend:
                losses.append(self.train_one_batch(bxs, by))
            history.append({"epoch": epoch, "loss": float(np.mean(losses)),
                            **self._metrics_summary()})
            print(f"epoch {epoch}: loss={history[-1]['loss']:.4f} "
                  f"{self._perf.report()}"
                  + (f" [{self._step_timer.report()}]"
                     if self.config.profiling else ""))
        return history

    @torch.no_grad()
    def _eval_step(self, feeds, label):
        values, _ = self._run_graph(self.params, feeds, self._ctx(False),
                                    self.op_state)
        out, logits, label, batch = self._final_rows(values, label)
        loss = (compute_loss(self.loss_type, out, label, logits=logits,
                             batch=batch)
                if self.loss_type else torch.zeros((), device=out.device))
        return loss, self._step_metrics(out, label, batch)

    def evaluate(self, x=None, y=None, batch_size: Optional[int] = None):
        xs = [np.asarray(a) for a in (x if isinstance(x, (list, tuple))
                                      else [x])]
        y = np.asarray(y)
        bs = batch_size or self.config.batch_size
        if y.shape[0] < bs:
            raise ValueError(
                f"evaluate() needs at least one full batch: {y.shape[0]} "
                f"samples < batch_size {bs}")
        self.reset_metrics()
        losses, mets = [], []
        for *bxs, by in minibatches(xs + [y], bs):
            loss, met = self._eval_step(
                self._feeds_from_arrays(bxs),
                self._to_device(by, self.label_tensor.dtype))
            losses.append(loss)
            mets.append(met)
        losses, mets = self._read(losses, mets)
        for met in mets:
            self._perf.update(met, bs)
        return {"loss": float(np.mean(losses)), **self._metrics_summary()}

    @torch.no_grad()
    def predict(self, x) -> np.ndarray:
        """The final output for ``x`` (one batch), as fp32 numpy for a
        16-bit output (numpy has no bfloat16); under a mesh, the whole
        batch's on every rank."""
        if self.comp_mode is None:
            raise RuntimeError("FFModel.compile() must be called before "
                               "predict/fit/evaluate")
        xs = x if isinstance(x, (list, tuple)) else [x]
        values, _ = self._run_graph(self.params,
                                    self._feeds_from_arrays(xs),
                                    self._ctx(False), self.op_state)
        out = values[self._final_tensor.tensor_id]
        if self._walk is not None and self._splits_batch():
            # every rank returns the whole batch's output
            out, _ = self._walk.whole(self._final_tensor.tensor_id, out)
        if out.dtype in (torch.bfloat16, torch.float16):
            out = out.float()
        return out.cpu().numpy()

    # the reference's manual-loop verbs, with the JAX package's meaning:
    # forward stages the batch, update(y) runs the whole train step
    def forward(self, xs=None, seq_length: Optional[int] = None):
        if xs is not None:
            self._pending_batch = [np.asarray(a) for a in xs]

    def backward(self, seq_length: Optional[int] = None):
        pass    # the train step runs the backward pass inside update()

    def update(self, y=None):
        if y is None:
            raise ValueError(
                "the train step runs forward, backward and update together: "
                "call train_one_batch(xs, y) (or fit), or pass the label "
                "to update(y)")
        if self._pending_batch is None:
            raise ValueError("update(y) needs a prior forward(xs) call to "
                             "stage the input batch")
        return self.train_one_batch(self._pending_batch, y)

    def zero_gradients(self):
        """Drop every parameter's ``.grad`` (a train step does so first)."""
        for lp in self.params.values():
            for p in lp.values():
                if isinstance(p, torch.Tensor):
                    p.grad = None

    def reset_metrics(self):
        self._perf = PerfMetrics()

    def _metrics_summary(self):
        if MetricsType.METRICS_ACCURACY in self.metrics:
            return {"accuracy": self._perf.accuracy}
        return {}

    @property
    def perf_metrics(self) -> PerfMetrics:
        return self._perf

    # ==================================================================
    # Parameter access
    # ==================================================================
    def _stacked_leaf(self, layer_name: str, weight_name: str):
        """A finalized pipeline block's weight (views of the stacked
        leaf), or None."""
        if self._pp_plan is None:
            return None
        from flexflow_tpu_torch.parallel.pipeline import block_slice
        from flexflow_tpu_torch.serve.pipeline_plan import (
            PP_PARAMS_KEY, stacked_param_lookup)

        hit = stacked_param_lookup(self, layer_name, weight_name)
        if hit is None:
            return None
        pos, j = hit
        stack = self.params[PP_PARAMS_KEY][pos][weight_name]
        return block_slice({weight_name: stack}, j)[weight_name]

    def get_parameter_tensor(self, layer_name: str,
                             weight_name: str) -> Tensor:
        """A handle of one parameter (``get_weights``/``set_weights``)."""
        for layer in self.layers:
            if layer.name == layer_name:
                for w in layer.weights:
                    if w.name == weight_name:
                        return Tensor(w.shape, w.dtype,
                                      name=f"{layer_name}.{weight_name}",
                                      model=self, is_weight=True,
                                      weight_name=(layer_name, weight_name))
        raise KeyError((layer_name, weight_name))

    def get_layers(self) -> Dict[int, Layer]:
        return dict(enumerate(self.layers))

    def get_output_tensor(self) -> Optional[Tensor]:
        return self._final_tensor

    def _estimate_layer_costs(self) -> Dict[str, float]:
        """Per-layer forward-time estimates from the search's cost model
        on ``config.search_chip`` (feeds ``include_costs_dot_graph``; the
        reference attaches simulator costs to the exported graph): each
        layer under its searched strategy, else replicated, over the
        mesh's axes."""
        from flexflow_tpu_torch.search.cost_model import CostModel
        from flexflow_tpu_torch.search.machine_model import MachineModel
        from flexflow_tpu_torch.search.pcg import PCG
        from flexflow_tpu_torch.search.strategy import (OpStrategy,
                                                        replicated)

        pcg = PCG.from_model(self)
        machine = MachineModel.from_name(
            self.config.search_chip, self.config.resolve_num_devices())
        axis_degrees = (dict(self.mesh.shape)
                        if self.mesh is not None else {})
        cm = CostModel(machine, axis_degrees=axis_degrees, training=False)
        costs: Dict[str, float] = {}
        for node in pcg.nodes:
            st = None
            if self.strategy is not None:
                st = self.strategy.ops.get(node.name)
            if st is None:
                out_nd = len(node.output_shapes[0]) if node.output_shapes \
                    else 1
                st = OpStrategy(
                    input_specs=tuple(replicated(len(s))
                                      for s in node.input_shapes),
                    output_spec=replicated(out_nd))
            costs[node.name] = cm.node_compute_time(node, st).forward_time
        return costs

    def export_dot(self, path: str, include_costs: bool = False,
                   costs=None) -> str:
        """Graphviz export of the layer graph to ``path`` (the
        reference's export_strategy_computation_graph_file); ``costs``
        ({layer: seconds}) are the caller's, shown with
        ``include_costs``. Returns ``path``."""
        from flexflow_tpu_torch.utils.dot import export_model_dot

        return export_model_dot(self, path, include_costs=include_costs,
                                costs=costs, strategy=self.strategy)

    def recompile_on_condition(self, recompile_state) -> bool:
        """The reference's dynamic recompilation hook (model.cc:2791;
        ``core/recompile.py``)."""
        from flexflow_tpu_torch.core.recompile import recompile_on_condition

        return recompile_on_condition(self, recompile_state)

    def get_parameter_by_key(self, key: Tuple[str, str]) -> np.ndarray:
        """A copy of the parameter as fp32 numpy: dequantized when
        quantized, sliced out of its fused leaf when gemm fusion folded it
        into one. Under a mesh, this rank's slice (a pipeline stage has
        only its own layers)."""
        from flexflow_tpu_torch.serve.gemm_fusion import fused_param_get

        layer_name, weight_name = key
        leaf = self._stacked_leaf(layer_name, weight_name)
        if leaf is None and weight_name not in self.params.get(layer_name,
                                                               {}):
            got = fused_param_get(self, layer_name, weight_name)
            if got is not None:
                return got
        if leaf is None:
            leaf = self.params[layer_name][weight_name]
        if is_quantized(leaf):
            leaf = dequantize_array(leaf)
        # a copy: a CPU parameter's own storage changes with every step
        return leaf.detach().to("cpu", torch.float32, copy=True).numpy()

    def set_parameter_by_key(self, key: Tuple[str, str], value):
        """Copy ``value`` (numpy array or tensor) into the parameter, in the
        parameter's dtype and on its device, in place (a model sharing the
        leaf sees the new value). A quantized parameter is re-quantized; a
        parameter folded into a fused leaf is spliced back into its
        columns. Under a mesh ``value`` is the whole weight or the rank's
        slice of it: of a whole weight the rank keeps its slice (of the
        whole weight quantized, for a quantized leaf); a layer of another
        pipeline stage is skipped."""
        from flexflow_tpu_torch.serve.gemm_fusion import fused_param_set

        layer_name, weight_name = key
        if not self._holds(layer_name):
            return          # another pipeline stage holds this layer
        old = self._stacked_leaf(layer_name, weight_name)
        if (old is None and weight_name not in self.params.get(layer_name,
                                                               {})
                and fused_param_set(self, layer_name, weight_name, value)):
            return
        if old is None:
            old = self.params[layer_name][weight_name]
        new = torch.as_tensor(value)
        sh = self._weight_sharding(layer_name, weight_name)
        if (sh is not None and not sh.is_replicated
                and tuple(new.shape) != tuple(old.shape)):
            # a full value for a sharded leaf: quantize the whole (a row
            # shard's own scale would differ), then keep this rank's slice
            from flexflow_tpu_torch.parallel.spec import shard_leaf
            from flexflow_tpu_torch.quant import quantize_array

            full = new
            if is_quantized(old):
                full = quantize_array(new.to(device=old.q.device,
                                             dtype=torch_dtype(old.dtype)),
                                      old.qtype)
            part = shard_leaf(full, sh, self.mesh.coord)
            if is_quantized(old):
                old.q.copy_(part.q)
                old.scale.copy_(part.scale)
                return
            new = part
        if tuple(new.shape) != tuple(old.shape):
            raise ValueError(f"{key}: shape {tuple(new.shape)} != "
                             f"{tuple(old.shape)}")
        if is_quantized(old):
            requantize_into(old, new)
            return
        with torch.no_grad():       # a trainable leaf takes the copy too
            old.copy_(new)
