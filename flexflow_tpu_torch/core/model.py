"""FFModel of the PyTorch/CUDA port: the inference half of
``flexflow_tpu/core/model.py``.

The op-builder methods record a layer graph; ``compile`` (inference mode
only) initializes every weight on ``config.device`` from a
``torch.Generator`` seeded per weight, allocates each serving op's KV
caches and stacks them into one ``[L, R, KH, S, D]`` pair; ``_run_graph``
walks the layers eagerly. With ``config.quantization_type`` each layer's
eligible weights are quantized as the layer is initialized (``quant.py``),
so the device never holds the float model; ``finalize_gemm_fusion`` fuses
the serving GEMMs after the weights are loaded (``serve/gemm_fusion.py``).
There is no mesh, strategy search, branch plan, pipeline or offload in
this slice.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from flexflow_tpu_torch import ops as _ops  # noqa: F401  (registers the ops)
from flexflow_tpu_torch.config import FFConfig, resolve_device
from flexflow_tpu_torch.core.layer import Layer
from flexflow_tpu_torch.core.tensor import Tensor
from flexflow_tpu_torch.ffconst import (ActiMode, AggrMode, CompMode,
                                        DataType, OpType)
from flexflow_tpu_torch.ops.base import OpContext, get_op_impl, stable_hash
from flexflow_tpu_torch.quant import (dequantize_array,
                                      dequantize_layer_params, is_quantized,
                                      normalize_qtype, quantize_params,
                                      requantize_into)


def weight_seed(seed: int, layer_name: str, weight_name: str) -> int:
    """Seed of one weight's generator: the model seed and the same
    ``stable_hash(layer, weight)`` the JAX package folds into its key."""
    return ((int(seed) << 31) | stable_hash(layer_name, weight_name)) \
        & 0x7FFF_FFFF_FFFF_FFFF


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
        self._layer_name_counts: Dict[str, int] = {}
        self.comp_mode: Optional[CompMode] = None
        self._gemm_fusion_done = False

    # ==================================================================
    # Tensor / layer creation
    # ==================================================================
    def create_tensor(self, dims: Sequence[int],
                      dtype: DataType = DataType.DT_FLOAT,
                      name: str = "") -> Tensor:
        t = Tensor(tuple(dims), dtype,
                   name=name or f"input_{len(self.input_tensors)}",
                   model=self)
        self.input_tensors.append(t)
        return t

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
              name: Optional[str] = None) -> Tensor:
        """``datatype`` and ``data_type`` are synonyms, as in the JAX
        package. ``keep_f32_logits`` emits the gemm's fp32 accumulator
        (logits heads feeding argmax)."""
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
            keep_f32_logits=keep_f32_logits), name)

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

    def add(self, x: Tensor, y: Tensor, name=None) -> Tensor:
        return self._add_layer(OpType.EW_ADD, [x, y], {}, name)

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

    def cast(self, input: Tensor, dtype: DataType, name=None) -> Tensor:
        return self._add_layer(OpType.CAST, [input], dict(dtype=dtype), name)

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

    # ==================================================================
    # Graph execution
    # ==================================================================
    def _apply_layer(self, layer: Layer, params, values: Dict[int, Any],
                     ctx: OpContext):
        impl = get_op_impl(layer.op_type)
        ins = [values[t.tensor_id] for t in layer.inputs]
        ctx.layer_name = layer.name
        lp = params.get(layer.name, {})
        if not impl.quant_aware:
            lp = dequantize_layer_params(lp, ctx.compute_dtype)
        outs = impl.forward(layer.attrs, lp, ins, ctx)
        for t, v in zip(layer.outputs, outs):
            values[t.tensor_id] = v

    def _run_graph(self, params, feeds: Dict[int, Any], ctx: OpContext,
                   state: Optional[Dict[str, Any]] = None):
        """Walk the layer list (creation order is topological order)
        computing every tensor value. Returns (values_by_tensor_id,
        new_state); KV caches in the state were updated in place."""
        values: Dict[int, Any] = dict(feeds)
        ctx.state_in = state or {}
        ctx.state_out = {}
        for layer in self.layers:
            self._apply_layer(layer, params, values, ctx)
        new_state = dict(ctx.state_in)
        new_state.update(ctx.state_out)
        return values, new_state

    # ==================================================================
    # Compile
    # ==================================================================
    def compile(self, comp_mode: CompMode = CompMode.COMP_MODE_INFERENCE):
        """Initialize parameters and serving state on ``self.device``.

        Only inference is ported; training arrives with a later slice."""
        if comp_mode != CompMode.COMP_MODE_INFERENCE:
            raise NotImplementedError(
                "the PyTorch port compiles COMP_MODE_INFERENCE only")
        dev = self.device
        qtype = self.config.quantization_type
        params: Dict[str, Dict[str, Any]] = {}
        for layer in self.layers:
            if not layer.weights:
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
            params[layer.name] = lp
        self.params = params
        self.comp_mode = comp_mode
        self._gemm_fusion_done = False

        self.op_state = {}
        for layer in self.layers:
            impl = get_op_impl(layer.op_type)
            if hasattr(impl, "init_state"):
                input_specs = [(t.dims, t.dtype) for t in layer.inputs]
                self.op_state[layer.name] = impl.init_state(
                    layer.attrs, input_specs, dev)
        self._consolidate_kv_caches()
        self._final_tensor = (self.layers[-1].outputs[0]
                              if self.layers else None)
        return self

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
        if fusion_eligible(self):
            apply_gemm_fusion(self)
        self._gemm_fusion_done = True
        return self

    def quantize_weights(self, qtype: str):
        """Quantize every eligible weight to int8/int4 on its device
        (inference only; leaves already quantized stay as they are)."""
        self.params = quantize_params(self.params, normalize_qtype(qtype))
        return self

    # ==================================================================
    # Parameter access
    # ==================================================================
    def get_parameter_by_key(self, key: Tuple[str, str]) -> np.ndarray:
        """The parameter as fp32 numpy: dequantized when quantized, sliced
        out of its fused leaf when gemm fusion folded it into one."""
        from flexflow_tpu_torch.serve.gemm_fusion import fused_param_get

        layer_name, weight_name = key
        if weight_name not in self.params.get(layer_name, {}):
            got = fused_param_get(self, layer_name, weight_name)
            if got is not None:
                return got
        leaf = self.params[layer_name][weight_name]
        if is_quantized(leaf):
            leaf = dequantize_array(leaf)
        return leaf.detach().float().cpu().numpy()

    def set_parameter_by_key(self, key: Tuple[str, str], value):
        """Copy ``value`` (numpy array or tensor) into the parameter, in the
        parameter's dtype and on its device, in place (a model sharing the
        leaf sees the new value). A quantized parameter is re-quantized; a
        parameter folded into a fused leaf is spliced back into its
        columns."""
        from flexflow_tpu_torch.serve.gemm_fusion import fused_param_set

        layer_name, weight_name = key
        if (weight_name not in self.params.get(layer_name, {})
                and fused_param_set(self, layer_name, weight_name, value)):
            return
        old = self.params[layer_name][weight_name]
        new = torch.as_tensor(value)
        if tuple(new.shape) != tuple(old.shape):
            raise ValueError(f"{key}: shape {tuple(new.shape)} != "
                             f"{tuple(old.shape)}")
        if is_quantized(old):
            requantize_into(old, new)
            return
        old.copy_(new)
