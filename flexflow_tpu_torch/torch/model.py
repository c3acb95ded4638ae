"""The torch.fx frontend of the PyTorch/CUDA port (counterpart of
``flexflow_tpu/torch/model.py``): torch.fx symbolic trace -> FFModel
op-builder.

``PyTorchModel.torch_to_ff`` walks an fx graph and emits the port's
builder calls; ``torch_to_file``/``file_to_ff`` round-trip the translated
graph through the JSON-lines IR (one op record a line). The IR is the JAX
package's, record for record, so a file written by either package loads
in the other, and the native C graph builder (``native/graph_builder.py``)
writes the same records. ``is_hf_model=True`` traces through
HuggingFace's fx tracer and lowers through a constant-folding interpreter
(``_HFLowering``), the path that handles encoder-decoder models (mT5).

``copy_weights`` copies the module's parameters into the compiled
FFModel's, as tensors on the model's device and in its dtypes (a CUDA or
bf16 module copies as it is): Linear, Conv2d, Embedding and LayerNorm,
as the JAX package does, and MultiheadAttention (whose ``out_proj`` stops
the JAX package's copy). BatchNorm's scale and bias, and its running
statistics, are not copied in either package.

This module is ``flexflow_tpu_torch.torch``: importing it sets that
attribute on the package, where it names this subpackage, not PyTorch.
No module of the port reads PyTorch through the package attribute; every
one imports ``torch`` itself.
"""

from __future__ import annotations

import json
import operator
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.fx
import torch.nn as nn
import torch.nn.functional as F

from flexflow_tpu_torch.ffconst import DataType, PoolType


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class IRNode:
    """One translated op: a serializable record + the builder call."""

    def __init__(self, op: str, name: str, inputs: List[str],
                 attrs: Dict[str, Any]):
        self.op = op
        self.name = name
        self.inputs = inputs
        self.attrs = attrs

    def to_json(self) -> str:
        return json.dumps({"op": self.op, "name": self.name,
                           "inputs": self.inputs, "attrs": self.attrs})

    @staticmethod
    def from_json(line: str) -> "IRNode":
        d = json.loads(line)
        return IRNode(d["op"], d["name"], d["inputs"], d["attrs"])


_ACT_MODULES = {
    nn.ReLU: "relu", nn.Sigmoid: "sigmoid", nn.Tanh: "tanh",
    nn.GELU: "gelu", nn.ELU: "elu", nn.Identity: "identity",
}


class PyTorchModel:
    """fx-trace a torch.nn.Module and lower it onto an FFModel
    (the JAX package's ``PyTorchModel``)."""

    def __init__(self, module, seq_length=None, is_hf_model: bool = False,
                 input_names: Optional[Sequence[str]] = None,
                 batch_size: int = 1):
        """``is_hf_model=True`` traces through HuggingFace's fx tracer
        (reference python/flexflow/torch/model.py:2428 hf_symbolic_trace)
        and lowers via the constant-folding interpreter — this is the
        path that handles encoder-decoder models (mT5/T5): size()/shape
        arithmetic, arange/triu position-bias tables and mask algebra
        fold to constants; only the real data path becomes FF ops.
        ``seq_length`` may be an int or an (encoder, decoder) pair."""
        self.module = module
        self.seq_length = seq_length
        self.is_hf_model = is_hf_model
        self.input_names = list(input_names or [])
        self.batch_size = batch_size
        if is_hf_model:
            from transformers.utils.fx import \
                symbolic_trace as hf_symbolic_trace

            saved_use_cache = getattr(getattr(module, "config", None),
                                      "use_cache", None)
            if saved_use_cache is not None:
                # traced past_key_values would double the op surface for
                # a training-oriented translation nobody consumes
                module.config.use_cache = False
            try:
                self.traced = hf_symbolic_trace(module,
                                                input_names=self.input_names)
            finally:
                if saved_use_cache is not None:
                    # tracing must not permanently mutate the USER's module
                    module.config.use_cache = saved_use_cache
        else:
            self.traced = torch.fx.symbolic_trace(module)
        # drop dead nodes (e.g. the unused getitem(mha, 1) a tuple unpack
        # `out, _ = mha(...)` leaves behind)
        self.traced.graph.eliminate_dead_code()
        self._ir: Optional[List[IRNode]] = None

    # ------------------------------------------------------------------
    # fx graph -> IR
    # ------------------------------------------------------------------
    def to_ir(self) -> List[IRNode]:
        if self._ir is not None:
            return self._ir
        if self.is_hf_model:
            self._ir = _HFLowering(self).run()
            return self._ir
        ir: List[IRNode] = []
        mods = dict(self.traced.named_modules())
        # fx nodes whose *torch* value is a tuple even though our lowering
        # yields one tensor (MultiheadAttention -> (out, weights)):
        # getitem(n, 0) must select the tuple element, not slice a tensor
        self._tuple_nodes = {
            n.name for n in self.traced.graph.nodes
            if n.op == "call_module"
            and isinstance(mods.get(n.target), nn.MultiheadAttention)}
        placeholders = 0
        # fx edge names vs IR layer names: call_module nodes are named
        # from their TARGET (so weight copy matches named_modules), but
        # consumers reference fx's sanitized node.name — for digit-named
        # Sequential children ("0" -> fx "_0") the two diverge. Map every
        # fx name to the IR name it became and rewrite inputs through it.
        # Target-derived names can also COLLIDE with earlier edge names
        # (a submodule attribute named like a forward arg): uniquify and
        # record the rename so copy_weights still finds the layer.
        alias: Dict[str, str] = {}
        used: set = set()
        self._module_renames: Dict[str, str] = {}
        for node in self.traced.graph.nodes:
            if node.op == "placeholder":
                made = IRNode("input", node.name, [],
                              {"index": placeholders})
                placeholders += 1
            elif node.op == "get_attr":
                raise NotImplementedError(
                    f"get_attr node {node.target!r} not supported")
            elif node.op == "call_module":
                made = self._module_ir(node, mods[node.target])
            elif node.op == "call_function":
                made = self._function_ir(node)
            elif node.op == "call_method":
                made = self._method_ir(node)
            elif node.op == "output":
                outs = node.args[0]
                outs = outs if isinstance(outs, (tuple, list)) else [outs]
                made = IRNode("output", node.name,
                              [o.name for o in outs], {})
            else:
                raise NotImplementedError(f"fx op {node.op}")
            made.inputs = [alias.get(i, i) for i in made.inputs]
            base = made.name
            while made.name in used:
                made.name += "_"
            if made.name != base and node.op == "call_module":
                # keyed by the DOTTED module path: two distinct targets can
                # sanitize to the same base ('conv.1' and 'conv_1'), and
                # copy_weights must route each to its own final layer name
                self._module_renames[str(node.target)] = made.name
            used.add(made.name)
            alias[node.name] = made.name
            ir.append(made)
        self._ir = ir
        return ir

    def _module_ir(self, node, mod, allow_shared: bool = False) -> IRNode:
        name = str(node.target).replace(".", "_")
        has_params = any(True for _ in mod.parameters(recurse=False))
        if not hasattr(self, "_module_names"):
            self._module_names = set()
        if name in self._module_names:
            if has_params and not allow_shared:
                # the HF lowering supports this (layers named per call
                # site, weights copied per source); the plain tracer's
                # name-based weight copy cannot
                raise NotImplementedError(
                    f"module {node.target!r} called twice — weight sharing "
                    f"across call sites is not supported by this tracer")
            name = node.name          # reused module: unique per-call name
        self._module_names.add(name)
        ins = [a.name for a in node.args if isinstance(a, torch.fx.Node)]
        if isinstance(mod, nn.Linear):
            return IRNode("linear", name, ins, {
                "out_dim": mod.out_features, "use_bias": mod.bias is not None})
        if isinstance(mod, nn.Conv2d):
            kh, kw = _pair(mod.kernel_size)
            sh, sw = _pair(mod.stride)
            ph, pw = _pair(mod.padding)
            return IRNode("conv2d", name, ins, {
                "out_channels": mod.out_channels, "kernel": [kh, kw],
                "stride": [sh, sw], "padding": [ph, pw],
                "groups": mod.groups, "use_bias": mod.bias is not None})
        if isinstance(mod, (nn.MaxPool2d, nn.AvgPool2d)):
            kh, kw = _pair(mod.kernel_size)
            sh, sw = _pair(mod.stride if mod.stride is not None
                           else mod.kernel_size)
            ph, pw = _pair(mod.padding)
            return IRNode("pool2d", name, ins, {
                "kernel": [kh, kw], "stride": [sh, sw], "padding": [ph, pw],
                "pool": "max" if isinstance(mod, nn.MaxPool2d) else "avg"})
        if isinstance(mod, nn.AdaptiveAvgPool2d):
            return IRNode("adaptive_pool2d", name, ins,
                          {"output_size": list(_pair(mod.output_size)),
                           "pool": "avg"})
        if isinstance(mod, nn.BatchNorm2d):
            return IRNode("batch_norm", name, ins, {})
        if isinstance(mod, nn.LayerNorm):
            return IRNode("layer_norm", name, ins,
                          {"normalized_shape": list(mod.normalized_shape),
                           "eps": mod.eps,
                           "affine": mod.elementwise_affine})
        if isinstance(mod, nn.Dropout):
            return IRNode("dropout", name, ins, {"rate": mod.p})
        if isinstance(mod, nn.Softmax):
            return IRNode("softmax", name, ins, {"axis": mod.dim})
        if isinstance(mod, nn.Flatten):
            return IRNode("flat", name, ins, {})
        if isinstance(mod, nn.Embedding):
            return IRNode("embedding", name, ins, {
                "num_entries": mod.num_embeddings,
                "out_dim": mod.embedding_dim})
        if isinstance(mod, nn.MultiheadAttention):
            if not mod.batch_first:
                # torch's default layout is [S, B, E]; ffmodel.multihead_
                # attention is batch-first, so tracing a default-configured
                # module would silently swap batch and sequence dims.
                raise NotImplementedError(
                    "nn.MultiheadAttention requires batch_first=True "
                    "(the [S, B, E] default layout is not supported)")
            return IRNode("multihead_attention", name, ins, {
                "embed_dim": mod.embed_dim, "num_heads": mod.num_heads,
                "dropout": mod.dropout})
        for klass, act in _ACT_MODULES.items():
            if isinstance(mod, klass):
                return IRNode(act, name, ins, {})
        raise NotImplementedError(f"module {type(mod).__name__}")

    def _function_ir(self, node) -> IRNode:
        ins = [a.name for a in node.args if isinstance(a, torch.fx.Node)]
        t = node.target
        name = node.name
        scalars = [a for a in node.args
                   if not isinstance(a, torch.fx.Node)]
        binops = {operator.add: "add", torch.add: "add",
                  operator.sub: "subtract", torch.sub: "subtract",
                  operator.mul: "multiply", torch.mul: "multiply",
                  operator.truediv: "divide", torch.div: "divide",
                  torch.matmul: "batch_matmul"}
        if t in binops:
            if len(ins) == 1 and scalars:     # tensor <op> scalar
                # non-commutative ops need the operand order: `1.0 - x`
                # traces with the scalar as args[0]
                reverse = not isinstance(node.args[0], torch.fx.Node)
                return IRNode("scalar_" + binops[t], name, ins,
                              {"scalar": float(scalars[0]),
                               "reverse": reverse})
            return IRNode(binops[t], name, ins, {})
        if t in (torch.relu, F.relu):
            return IRNode("relu", name, ins, {})
        if t in (torch.sigmoid, F.sigmoid):
            return IRNode("sigmoid", name, ins, {})
        if t in (torch.tanh, F.tanh):
            return IRNode("tanh", name, ins, {})
        if t is F.gelu:
            return IRNode("gelu", name, ins, {})
        if t in (F.softmax, torch.softmax):
            return IRNode("softmax", name, ins,
                          {"axis": node.kwargs.get(
                              "dim", scalars[0] if scalars else -1)})
        if t is torch.flatten:
            return IRNode("flat", name, ins, {})
        if t is F.dropout:
            return IRNode("dropout", name, ins,
                          {"rate": node.kwargs.get("p", 0.5)})
        if t is torch.cat:
            # args[0] is the tensor LIST (not an fx.Node), so it lands in
            # `scalars`; a positional dim lives at args[1].
            axis = node.kwargs.get(
                "dim", node.args[1] if len(node.args) > 1 else 0)
            seq = node.args[0]
            return IRNode("concat", name, [n.name for n in seq],
                          {"axis": int(axis)})
        if t is torch.reshape:
            return IRNode("reshape", name, ins,
                          {"shape": [int(s) for s in node.args[1]]})
        if t is torch.transpose:
            return IRNode("transpose2", name, ins,
                          {"dims": [int(node.args[1]), int(node.args[2])]})
        if t is torch.permute:
            return IRNode("permute", name, ins,
                          {"perm": [int(p) for p in node.args[1]]})
        if t is operator.getitem:
            src = node.args[0]
            if isinstance(src, torch.fx.Node) \
                    and src.name in getattr(self, "_tuple_nodes", ()):
                if node.args[1] != 0:
                    raise NotImplementedError(
                        "only the output tensor (index 0) of "
                        "MultiheadAttention is available")
                return IRNode("identity", name, ins, {})
            return IRNode("getitem", name, ins,
                          {"index": _serialize_index(node.args[1])})
        if t is torch.mean:
            return IRNode("mean", name, ins,
                          _mean_attrs(node.kwargs, scalars))
        if t is getattr:
            raise NotImplementedError("getattr on tensors not supported")
        raise NotImplementedError(f"function {t}")

    def _method_ir(self, node) -> IRNode:
        ins = [a.name for a in node.args if isinstance(a, torch.fx.Node)]
        name = node.name
        m = node.target
        if m in ("view", "reshape"):
            return IRNode("reshape", name, ins,
                          {"shape": [int(s) for s in node.args[1:]]
                           if not isinstance(node.args[1], (tuple, list))
                           else [int(s) for s in node.args[1]]})
        if m == "flatten":
            return IRNode("flat", name, ins, {})
        if m == "permute":
            perm = node.args[1:] if not isinstance(node.args[1], (tuple, list)) \
                else node.args[1]
            return IRNode("permute", name, ins,
                          {"perm": [int(p) for p in perm]})
        if m == "transpose":
            return IRNode("transpose2", name, ins,
                          {"dims": [int(node.args[1]), int(node.args[2])]})
        if m == "contiguous":
            return IRNode("identity", name, ins, {})
        if m in ("relu", "sigmoid", "tanh"):
            return IRNode(m, name, ins, {})
        if m == "softmax":
            return IRNode("softmax", name, ins,
                          {"axis": node.kwargs.get(
                              "dim", node.args[1] if len(node.args) > 1
                              else -1)})
        if m == "mean":
            return IRNode("mean", name, ins,
                          _mean_attrs(node.kwargs, list(node.args[1:])))
        if m in ("unsqueeze", "squeeze"):
            dim = node.kwargs.get("dim",
                                  node.args[1] if len(node.args) > 1
                                  else None)
            if dim is None:
                raise NotImplementedError(
                    f".{m}() without a dim (squeeze-all is unsupported)")
            return IRNode(m, name, ins, {"dim": int(dim)})
        raise NotImplementedError(f"method {m}")

    # ------------------------------------------------------------------
    # IR -> FFModel ops
    # ------------------------------------------------------------------
    def torch_to_ff(self, ffmodel, input_tensors: Sequence,
                    verbose: bool = False) -> List:
        return ir_to_ff(self.to_ir(), ffmodel, input_tensors, verbose)

    def torch_to_file(self, filename: str):
        """Serialize the translated graph (reference torch_to_file)."""
        with open(filename, "w") as f:
            for n in self.to_ir():
                f.write(n.to_json() + "\n")

    # ------------------------------------------------------------------
    # weight import
    # ------------------------------------------------------------------
    def copy_weights(self, ffmodel):
        """Copy the module's parameters into the compiled FFModel's, on
        the model's device and in its dtypes (``set_parameter_by_key``
        copies a tensor in place): Linear, Conv2d, Embedding and
        LayerNorm, as the JAX package does, and MultiheadAttention, whose
        ``out_proj`` stops the JAX package's copy with a KeyError.
        BatchNorm is not copied, as in the JAX package."""
        if self.is_hf_model:
            # HF layers are named after their fx NODES (module aliases
            # like encoder.embed_tokens have no layer of their own);
            # copying walks the IR's recorded sources instead
            return self._copy_weights_hf(ffmodel)
        self.to_ir()                  # populates _module_renames
        mha = [t for t, m in self.module.named_modules()
               if isinstance(m, nn.MultiheadAttention)]
        for tname, mod in self.module.named_modules():
            if any(tname.startswith(p + ".") for p in mha):
                continue        # out_proj: copied with its attention layer
            name = getattr(self, "_module_renames", {}).get(
                tname, tname.replace(".", "_"))
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.Embedding,
                                nn.MultiheadAttention)) or (
                    isinstance(mod, nn.LayerNorm) and mod.elementwise_affine):
                _copy_module(ffmodel, name, mod)

    def _copy_weights_hf(self, ffmodel):
        pdict = dict(self.module.named_parameters())
        mdict = dict(self.module.named_modules())
        for n in self.to_ir():
            if n.op == "param":
                # bare nn.Parameter reads (fx get_attr, e.g.
                # T5LayerNorm.weight) became free-standing WEIGHT ops
                ffmodel.set_parameter_by_key(
                    (n.name, "weight"), pdict[n.attrs["source"]].detach())
            elif "source" in n.attrs:
                # module-backed layers are named after their (unique) fx
                # node — a shared module called twice copies into each
                # call's layer
                mod = mdict[n.attrs["source"]]
                if isinstance(mod, (nn.Linear, nn.Embedding)) or (
                        isinstance(mod, nn.LayerNorm)
                        and mod.elementwise_affine):
                    _copy_module(ffmodel, n.name, mod)
                elif any(True for _ in mod.parameters(recurse=False)):
                    # never leave a parameterized layer silently at random
                    # init — loud failure beats a misaligned model
                    raise NotImplementedError(
                        f"weight copy for traced module type "
                        f"{type(mod).__name__} ({n.attrs['source']})")


def _copy_module(ffmodel, name: str, mod):
    """One module's parameters into layer ``name`` of ``ffmodel``, under
    the JAX package's weight names: a Linear's weight transposed to the
    ``[in, out]`` kernel; a MultiheadAttention's packed ``in_proj`` split
    into ``wq``/``wk``/``wv`` and ``out_proj`` into ``wo`` (transposed),
    with their biases."""
    def put(weight, value):
        ffmodel.set_parameter_by_key((name, weight), value.detach())

    if isinstance(mod, nn.MultiheadAttention):
        if (not mod._qkv_same_embed_dim or mod.in_proj_bias is None
                or mod.bias_k is not None or mod.add_zero_attn):
            raise NotImplementedError(
                f"weight copy for {name}: only a MultiheadAttention with "
                "equal q/k/v widths, biases, no bias_kv and no zero "
                "attention translates")
        for w, part, b in zip(("wq", "wk", "wv"),
                              mod.in_proj_weight.chunk(3),
                              mod.in_proj_bias.chunk(3)):
            put(w, part.T)
            put("b" + w[1], b)
        put("wo", mod.out_proj.weight.T)
        put("bo", mod.out_proj.bias)
        return
    if isinstance(mod, nn.LayerNorm):
        put("gamma", mod.weight)
        if mod.bias is not None:
            put("beta", mod.bias)
        return
    if isinstance(mod, nn.Embedding):
        put("weight", mod.weight)
        return
    put("kernel", mod.weight.T if isinstance(mod, nn.Linear) else mod.weight)
    if mod.bias is not None:
        put("bias", mod.bias)


def _mean_attrs(kwargs, positional) -> Dict[str, Any]:
    """Shared dim/keepdim extraction for torch.mean / Tensor.mean
    (dim and keepdim may each be positional or keyword)."""
    dim = kwargs.get("dim", positional[0] if positional else None)
    if dim is None:
        raise NotImplementedError("full-tensor mean")
    keepdim = kwargs.get("keepdim",
                         positional[1] if len(positional) > 1 else False)
    return {"dims": [int(dim)] if isinstance(dim, int)
            else [int(d) for d in dim],
            "keepdims": bool(keepdim)}


def _serialize_index(idx) -> List[Dict[str, Any]]:
    """fx getitem index -> JSON-able per-dim records."""
    items = idx if isinstance(idx, tuple) else (idx,)
    out: List[Dict[str, Any]] = []
    for it in items:
        if it is Ellipsis:
            raise NotImplementedError("Ellipsis indexing")
        if it is None:
            out.append({"kind": "newaxis"})
        elif isinstance(it, slice):
            if it.step not in (None, 1):
                raise NotImplementedError("strided slicing")
            for bound in (it.start, it.stop):
                if bound is not None and not isinstance(bound, int):
                    raise NotImplementedError(
                        f"dynamic slice bound {bound!r} (traced values "
                        f"cannot be static slice extents)")
            out.append({"kind": "slice", "start": it.start, "stop": it.stop})
        elif isinstance(it, int):
            out.append({"kind": "int", "index": it})
        else:
            raise NotImplementedError(f"index element {it!r}")
    return out


_TORCH_DTYPE_STR = {
    torch.float32: "float32", torch.float64: "float64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int64: "int64", torch.int32: "int32", torch.bool: "bool",
}


class _HFLowering:
    """Constant-folding lowering of a HuggingFace fx trace to IR.

    A single interpreter pass
    keeps an environment of either CONSTANT torch values or SYMBOLIC IR
    names per fx node. Shape/size arithmetic, position-bias index tables
    (arange/abs/log/triu chains) and dtype probes evaluate eagerly in
    torch; only ops touching real input data emit IR. Shapes come from a
    single torch ShapeProp pass at the declared (batch, seq) geometry,
    which also resolves every view/expand target statically."""

    def __init__(self, pm: "PyTorchModel"):
        self.pm = pm
        self.ir: List[IRNode] = []
        self.env: Dict[Any, tuple] = {}
        self._next_const = 0
        self._const_cache: Dict[Any, str] = {}

    # -- setup ---------------------------------------------------------
    def _example_inputs(self):
        B = self.pm.batch_size
        sl = self.pm.seq_length
        if isinstance(sl, (tuple, list)):
            s_enc, s_dec = sl
        else:
            s_enc = s_dec = sl or 128
        shapes = {"input_ids": (B, s_enc), "attention_mask": (B, s_enc),
                  "decoder_input_ids": (B, s_dec),
                  "decoder_attention_mask": (B, s_dec),
                  "labels": (B, s_dec)}
        out = []
        for nm in self.pm.input_names:
            if nm not in shapes:
                raise NotImplementedError(f"input {nm!r}: no shape rule")
            if "mask" in nm:
                out.append(torch.ones(shapes[nm], dtype=torch.int64))
            else:
                out.append(torch.randint(0, 4, shapes[nm],
                                         dtype=torch.int64))
        return out

    def _meta(self, node):
        tm = node.meta.get("tensor_meta")
        if tm is None:
            raise NotImplementedError(f"no shape metadata for {node}")
        return tm

    # -- environment helpers -------------------------------------------
    def _is_sym(self, v) -> bool:
        return isinstance(v, torch.fx.Node) and self.env[v][0] == "sym"

    def _const_val(self, v):
        if isinstance(v, torch.fx.Node):
            kind, val = self.env[v]
            if kind != "const":
                raise _NotConst()
            return val
        if isinstance(v, (tuple, list)):
            return type(v)(self._const_val(x) for x in v)
        if isinstance(v, slice):
            return slice(self._const_val(v.start), self._const_val(v.stop),
                         self._const_val(v.step))
        return v

    def _sym_name(self, v, dtype_like=None) -> str:
        """IR name for a value; const tensors/scalars materialize as
        CONSTANT nodes (memoized per fx node — a position-bias table
        consumed by every layer serializes once, not per consumer)."""
        src_node = None
        if isinstance(v, torch.fx.Node):
            kind, val = self.env[v]
            if kind == "sym":
                return val
            src_node = v
            cached = self._const_cache.get(src_node)
            if cached is not None:
                return cached
            v = val
        t = torch.as_tensor(v)
        if dtype_like is not None:
            t = t.to(dtype_like)
        if t.dtype not in _TORCH_DTYPE_STR:
            t = t.float()
        name = f"_const{self._next_const}"
        self._next_const += 1
        self.ir.append(IRNode("constant", name, [], {
            "value": t.tolist(), "dtype": _TORCH_DTYPE_STR[t.dtype],
            "shape": list(t.shape)}))
        if src_node is not None and dtype_like is None:
            self._const_cache[src_node] = name
        return name

    def _emit(self, node, op: str, inputs: List[str],
              attrs: Dict[str, Any]):
        self.ir.append(IRNode(op, node.name, inputs, attrs))
        self.env[node] = ("sym", node.name)

    # -- main pass -----------------------------------------------------
    def run(self) -> List[IRNode]:
        from torch.fx.passes.shape_prop import ShapeProp

        traced = self.pm.traced
        ShapeProp(traced).propagate(*self._example_inputs())
        mods = dict(traced.named_modules())
        tparams = dict(traced.named_parameters())
        tbuffers = dict(traced.named_buffers())
        idx = 0
        for node in traced.graph.nodes:
            if node.op == "placeholder":
                self.ir.append(IRNode("input", node.name, [],
                                      {"index": idx}))
                idx += 1
                self.env[node] = ("sym", node.name)
            elif node.op == "get_attr":
                if node.target in tparams:
                    p = tparams[node.target]
                    name = str(node.target).replace(".", "_")
                    self.ir.append(IRNode("param", name, [], {
                        "shape": list(p.shape),
                        "dtype": _TORCH_DTYPE_STR.get(p.dtype, "float32"),
                        "source": str(node.target)}))
                    self.env[node] = ("sym", name)
                elif node.target in tbuffers:
                    self.env[node] = ("const", tbuffers[node.target])
                else:
                    # plain tensor attribute: dotted targets need
                    # per-segment traversal (getattr can't resolve dots)
                    obj = traced
                    for seg in str(node.target).split("."):
                        obj = getattr(obj, seg)
                    self.env[node] = ("const", obj)
            elif node.op == "output":
                outs = self._output_names(node.args[0])
                self.ir.append(IRNode("output", node.name, outs, {}))
            elif node.op == "call_module":
                self._lower_module(node, mods[node.target])
            else:
                self._lower_call(node)
        return self.ir

    def _output_names(self, out) -> List[str]:
        if isinstance(out, dict):
            for key in ("logits", "last_hidden_state"):
                if key in out and isinstance(out[key], torch.fx.Node):
                    return [self._sym_name(out[key])]
            out = [v for v in out.values() if isinstance(v, torch.fx.Node)]
        if isinstance(out, torch.fx.Node):
            out = [out]
        return [self._sym_name(o) for o in out
                if isinstance(o, torch.fx.Node)]

    def _lower_module(self, node, mod):
        irn = self.pm._module_ir(node, mod, allow_shared=True)
        # shared modules (e.g. T5's tied `shared` embedding) are CALLED at
        # several fx nodes: the layer name must be the unique node name,
        # with the module path recorded for weight copy
        irn.name = node.name
        irn.attrs["source"] = str(node.target)
        irn.inputs = [self._sym_name(a) for a in node.args
                      if isinstance(a, torch.fx.Node)]
        self.ir.append(irn)
        self.env[node] = ("sym", irn.name)

    # -- call lowering -------------------------------------------------
    def _lower_call(self, node):
        t = node.target
        fname = t if isinstance(t, str) else getattr(t, "__name__", str(t))
        flat_args = list(node.args) + list(node.kwargs.values())

        def any_sym(v):
            if isinstance(v, torch.fx.Node):
                return self._is_sym(v)
            if isinstance(v, (tuple, list)):
                return any(any_sym(x) for x in v)
            if isinstance(v, slice):
                return any(any_sym(x) for x in (v.start, v.stop, v.step))
            return False

        # shape/dtype probes answer from metadata even on symbolic values
        if fname == "size":
            src = node.args[0]
            shape = tuple(self._meta(src).shape)
            val = shape if len(node.args) == 1 else shape[node.args[1]]
            self.env[node] = ("const", val)
            return
        if fname == "dim":
            self.env[node] = ("const", len(self._meta(node.args[0]).shape))
            return
        if fname == "getattr" and isinstance(node.args[0], torch.fx.Node) \
                and self._is_sym(node.args[0]):
            attr = node.args[1]
            m = self._meta(node.args[0])
            if attr == "shape":
                self.env[node] = ("const", tuple(m.shape))
            elif attr == "dtype":
                self.env[node] = ("const", m.dtype)
            elif attr == "device":
                self.env[node] = ("const", torch.device("cpu"))
            else:
                raise NotImplementedError(f"getattr {attr!r} on tensor")
            return
        # zeros_like/full_like on symbolic args only need the shape
        if fname in ("zeros_like", "ones_like", "full_like") \
                and any_sym(node.args[0]):
            m = self._meta(node.args[0])
            fill = {"zeros_like": 0, "ones_like": 1}.get(fname)
            if fill is None:
                fill = self._const_val(node.args[1])
            self.env[node] = ("const", torch.full(tuple(m.shape), fill,
                                                  dtype=m.dtype))
            return

        if not any(any_sym(a) for a in flat_args):
            # pure-constant subgraph: evaluate in torch (arange/triu/
            # position-bias tables, finfo, shape arithmetic, ...)
            args = self._const_val(tuple(node.args))
            kwargs = {k: self._const_val(v) for k, v in node.kwargs.items()}
            if node.op == "call_function":
                val = t(*args, **kwargs)
            else:
                val = getattr(args[0], t)(*args[1:], **kwargs)
            self.env[node] = ("const", val)
            return
        self._lower_sym_call(node, fname)

    def _lower_sym_call(self, node, fname: str):
        import math

        args = node.args
        kwargs = node.kwargs

        def scalar_or_none(v):
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                return float(v)
            if isinstance(v, torch.fx.Node) and self.env[v][0] == "const":
                c = self.env[v][1]
                if isinstance(c, (int, float)) and not isinstance(c, bool):
                    return float(c)
                if isinstance(c, torch.Tensor) and c.ndim == 0:
                    return float(c)
            return None

        binmap = {"add": "add", "sub": "subtract", "mul": "multiply",
                  "truediv": "divide", "div": "divide"}
        if fname in binmap:
            a, b = args[0], args[1]
            sa, sb = scalar_or_none(a), scalar_or_none(b)
            if sa is not None or sb is not None:
                x = b if sa is not None else a
                s = sa if sa is not None else sb
                op = "scalar_" + binmap[fname]
                self._emit(node, op, [self._sym_name(x)],
                           {"scalar": s, "reverse": sa is not None})
                return
            self._emit(node, binmap[fname],
                       [self._sym_name(a), self._sym_name(b)], {})
            return
        if fname in ("eq", "ne", "lt", "le", "gt", "ge"):
            a, b = args[0], args[1]
            sb = scalar_or_none(b)
            if sb is not None:
                self._emit(node, "compare", [self._sym_name(a)],
                           {"cmp": fname, "scalar": sb})
            else:
                self._emit(node, "compare",
                           [self._sym_name(a), self._sym_name(b)],
                           {"cmp": fname})
            return
        if fname in ("min", "max") and len(args) == 2:
            # only the elementwise two-TENSOR form; torch.max(x, dim) is a
            # reduction returning (values, indices) and must not silently
            # lower to clamp-by-constant
            other = args[1]
            is_tensorish = (
                (isinstance(other, torch.fx.Node)
                 and (self._is_sym(other)
                      or isinstance(self.env[other][1], torch.Tensor)))
                or isinstance(other, torch.Tensor))
            if not is_tensorish:
                raise NotImplementedError(
                    f"torch.{fname}(tensor, dim) reduction form")
            self._emit(node, fname,
                       [self._sym_name(args[0]), self._sym_name(args[1])],
                       {})
            return
        if fname == "where":
            self._emit(node, "where", [self._sym_name(args[0]),
                                       self._sym_name(args[1]),
                                       self._sym_name(args[2])], {})
            return
        if fname == "masked_fill":
            x, mask, val = args[0], args[1], args[2]
            fill_v = self._const_val(val)        # scalar (e.g. finfo.min)
            fill = self._sym_name(torch.tensor(float(fill_v),
                                               dtype=self._meta(x).dtype))
            self._emit(node, "where", [self._sym_name(mask), fill,
                                       self._sym_name(x)], {})
            return
        if fname == "matmul":
            self._emit(node, "batch_matmul",
                       [self._sym_name(args[0]), self._sym_name(args[1])],
                       {})
            return
        if fname == "pow":
            exp = scalar_or_none(args[1])
            if exp is None:
                raise NotImplementedError("tensor exponent")
            self._emit(node, "pow_scalar", [self._sym_name(args[0])],
                       {"exponent": exp})
            return
        if fname == "rsqrt":
            self._emit(node, "rsqrt", [self._sym_name(args[0])], {})
            return
        if fname == "neg":
            self._emit(node, "scalar_multiply", [self._sym_name(args[0])],
                       {"scalar": -1.0})
            return
        if fname in ("relu", "sigmoid", "tanh", "gelu"):
            self._emit(node, fname, [self._sym_name(args[0])], {})
            return
        if fname == "softmax":
            dim = kwargs.get("dim", args[1] if len(args) > 1 else -1)
            self._emit(node, "softmax", [self._sym_name(args[0])],
                       {"axis": int(self._const_val(dim))})
            return
        if fname == "dropout":
            p = kwargs.get("p", args[1] if len(args) > 1 else 0.5)
            self._emit(node, "dropout", [self._sym_name(args[0])],
                       {"rate": float(self._const_val(p))})
            return
        if fname == "mean":
            positional = [self._const_val(a) for a in args[1:]]
            self._emit(node, "mean", [self._sym_name(args[0])],
                       _mean_attrs({k: self._const_val(v)
                                    for k, v in kwargs.items()}, positional))
            return
        if fname in ("view", "reshape"):
            self._emit(node, "reshape", [self._sym_name(args[0])],
                       {"shape": [int(s) for s in self._meta(node).shape]})
            return
        if fname == "expand":
            self._emit(node, "broadcast_to", [self._sym_name(args[0])],
                       {"shape": [int(s) for s in self._meta(node).shape]})
            return
        if fname == "transpose":
            self._emit(node, "transpose2", [self._sym_name(args[0])],
                       {"dims": [int(self._const_val(args[1])),
                                 int(self._const_val(args[2]))]})
            return
        if fname == "permute":
            perm = args[1] if isinstance(args[1], (tuple, list)) else args[1:]
            self._emit(node, "permute", [self._sym_name(args[0])],
                       {"perm": [int(self._const_val(p)) for p in perm]})
            return
        if fname == "unsqueeze":
            self._emit(node, "unsqueeze", [self._sym_name(args[0])],
                       {"dim": int(self._const_val(
                           kwargs.get("dim", args[1])))})
            return
        if fname in ("contiguous", "clone"):
            self._emit(node, "identity", [self._sym_name(args[0])], {})
            return
        if fname == "float":
            self._emit(node, "cast", [self._sym_name(args[0])],
                       {"dtype": "float32"})
            return
        if fname == "to":
            target = args[1] if len(args) > 1 else kwargs.get(
                "dtype", kwargs.get("device"))
            target = self._const_val(target)
            if isinstance(target, torch.dtype):
                self._emit(node, "cast", [self._sym_name(args[0])],
                           {"dtype": _TORCH_DTYPE_STR[target]})
            else:                               # device move: no-op
                self._emit(node, "identity", [self._sym_name(args[0])], {})
            return
        if fname == "type_as":
            dt = self._meta(args[1]).dtype if isinstance(
                args[1], torch.fx.Node) else args[1].dtype
            self._emit(node, "cast", [self._sym_name(args[0])],
                       {"dtype": _TORCH_DTYPE_STR[dt]})
            return
        if fname == "getitem":
            idx = self._const_val(args[1])
            self._emit(node, "getitem", [self._sym_name(args[0])],
                       {"index": _serialize_index(idx)})
            return
        if fname == "setitem":
            x, idx, v = args
            idx = self._const_val(idx)
            xshape = tuple(self._meta(x).shape) if isinstance(
                x, torch.fx.Node) else tuple(torch.as_tensor(
                    self.env[x][1]).shape)
            full = True
            items = idx if isinstance(idx, tuple) else (idx,)
            for d, it in enumerate(items):
                if not (isinstance(it, slice) and it.step in (None, 1)
                        and it.start in (None, 0)
                        and (it.stop is None or it.stop >= xshape[d])):
                    full = False
            if not full:
                raise NotImplementedError(
                    "partial setitem (only whole-tensor overwrite lowers)")
            name = self._sym_name(v)
            # the fx trace mutates x in place: later readers of x must see
            # the overwritten value
            self.env[node] = ("sym", name)
            if isinstance(x, torch.fx.Node):
                self.env[x] = ("sym", name)
            return
        raise NotImplementedError(f"hf-traced op {fname}")


class _NotConst(Exception):
    pass


def file_to_ff(filename: str, ffmodel, input_tensors: Sequence,
               verbose: bool = False) -> List:
    """Rebuild ops from a serialized graph (reference file_to_ff)."""
    with open(filename) as f:
        ir = [IRNode.from_json(line) for line in f if line.strip()]
    return ir_to_ff(ir, ffmodel, input_tensors, verbose)


def ir_to_ff(ir: List[IRNode], ffmodel, input_tensors: Sequence,
             verbose: bool = False) -> List:
    env: Dict[str, Any] = {}
    outputs: List = []
    for n in ir:
        if verbose:
            print(f"[torch_to_ff] {n.op} {n.name} <- {n.inputs}")
        ins = [env[i] for i in n.inputs]
        a = n.attrs
        if n.op == "input":
            env[n.name] = input_tensors[a["index"]]
            continue
        if n.op == "output":
            outputs = ins
            continue
        if n.op == "linear":
            out = ffmodel.dense(ins[0], a["out_dim"],
                                use_bias=a["use_bias"], name=n.name)
        elif n.op == "conv2d":
            out = ffmodel.conv2d(ins[0], a["out_channels"], *a["kernel"],
                                 *a["stride"], *a["padding"],
                                 groups=a["groups"], use_bias=a["use_bias"],
                                 name=n.name)
        elif n.op == "pool2d":
            pool = PoolType.POOL_MAX if a["pool"] == "max" \
                else PoolType.POOL_AVG
            out = ffmodel.pool2d(ins[0], *a["kernel"], *a["stride"],
                                 *a["padding"], pool_type=pool, name=n.name)
        elif n.op == "adaptive_pool2d":
            # lower to a regular pool with computed kernel/stride
            _, _, h, w = ins[0].dims
            oh, ow = a["output_size"]
            kh, kw = h // oh, w // ow
            out = ffmodel.pool2d(ins[0], kh, kw, kh, kw, 0, 0,
                                 pool_type=PoolType.POOL_AVG, name=n.name)
        elif n.op == "batch_norm":
            out = ffmodel.batch_norm(ins[0], relu=False, name=n.name)
        elif n.op == "layer_norm":
            nd = len(a["normalized_shape"])
            axes = list(range(ins[0].num_dims - nd, ins[0].num_dims))
            out = ffmodel.layer_norm(ins[0], axes,
                                     elementwise_affine=a["affine"],
                                     eps=a["eps"], name=n.name)
        elif n.op == "rms_norm":
            # emitted by the C graph-builder ABI (ffgb_rms_norm); the fx
            # tracer has no torch.nn.RMSNorm source yet
            out = ffmodel.rms_norm(ins[0], eps=a.get("eps", 1e-6),
                                   dim=a.get("dim"), name=n.name)
        elif n.op == "dropout":
            out = ffmodel.dropout(ins[0], a["rate"], name=n.name)
        elif n.op == "softmax":
            out = ffmodel.softmax(ins[0], axis=a.get("axis", -1), name=n.name)
        elif n.op == "flat":
            out = ffmodel.flat(ins[0], name=n.name)
        elif n.op == "embedding":
            out = ffmodel.embedding(ins[0], a["num_entries"], a["out_dim"],
                                    name=n.name)
        elif n.op == "multihead_attention":
            q, k, v = (ins + [ins[0], ins[0]])[:3]
            out = ffmodel.multihead_attention(
                q, k, v, a["embed_dim"], a["num_heads"],
                dropout=a.get("dropout", 0.0), name=n.name)
        elif n.op in ("add", "subtract", "multiply", "divide", "max", "min"):
            out = getattr(ffmodel, n.op)(ins[0], ins[1], name=n.name)
        elif n.op == "scalar_add":
            out = ffmodel.scalar_add(ins[0], a["scalar"], name=n.name)
        elif n.op == "scalar_subtract":
            if a.get("reverse"):   # s - x = -x + s
                out = ffmodel.scalar_add(
                    ffmodel.scalar_multiply(ins[0], -1.0, name=n.name + "_neg"),
                    a["scalar"], name=n.name)
            else:
                out = ffmodel.scalar_sub(ins[0], a["scalar"], name=n.name)
        elif n.op == "scalar_multiply":
            out = ffmodel.scalar_multiply(ins[0], a["scalar"], name=n.name)
        elif n.op == "scalar_divide":
            if a.get("reverse"):   # s / x = s * x^-1
                out = ffmodel.scalar_multiply(
                    ffmodel.pow(ins[0], -1.0, name=n.name + "_inv"),
                    a["scalar"], name=n.name)
            else:
                out = ffmodel.scalar_true_divide(ins[0], a["scalar"],
                                                 name=n.name)
        elif n.op in ("relu", "sigmoid", "tanh", "gelu", "elu", "identity"):
            out = getattr(ffmodel, n.op)(ins[0], name=n.name)
        elif n.op == "concat":
            out = ffmodel.concat(ins, a["axis"], name=n.name)
        elif n.op == "reshape":
            shape = list(a["shape"])
            if -1 in shape:  # resolve the single -1 from the element count
                total = int(np.prod(ins[0].dims))
                known = int(np.prod([d for d in shape if d != -1] or [1]))
                shape[shape.index(-1)] = total // known
            out = ffmodel.reshape(ins[0], shape, name=n.name)
        elif n.op == "permute":
            out = ffmodel.transpose(ins[0], a["perm"], name=n.name)
        elif n.op == "transpose2":
            d0, d1 = a["dims"]
            perm = list(range(ins[0].num_dims))
            perm[d0], perm[d1] = perm[d1], perm[d0]
            out = ffmodel.transpose(ins[0], perm, name=n.name)
        elif n.op == "batch_matmul":
            out = ffmodel.batch_matmul(ins[0], ins[1], name=n.name)
        elif n.op == "constant":
            # the CONSTANT op makes the tensor in its dtype (numpy has no
            # bfloat16)
            out = ffmodel.constant_tensor(
                np.asarray(a["value"]).reshape(tuple(a["shape"])),
                dtype=DataType(a["dtype"]), name=n.name)
        elif n.op == "param":
            out = ffmodel.parameter(a["shape"], dtype=DataType(a["dtype"]),
                                    name=n.name)
        elif n.op == "where":
            out = ffmodel.where(ins[0], ins[1], ins[2], name=n.name)
        elif n.op == "compare":
            out = ffmodel.compare(ins[0],
                                  ins[1] if len(ins) > 1 else a["scalar"],
                                  a["cmp"], name=n.name)
        elif n.op == "broadcast_to":
            out = ffmodel.broadcast_to(ins[0], a["shape"], name=n.name)
        elif n.op == "cast":
            out = ffmodel.cast(ins[0], DataType(a["dtype"]), name=n.name)
        elif n.op == "pow_scalar":
            out = ffmodel.pow(ins[0], a["exponent"], name=n.name)
        elif n.op == "rsqrt":
            out = ffmodel.rsqrt(ins[0], name=n.name)
        elif n.op == "getitem":
            nd = ins[0].num_dims
            starts = [None] * nd
            ends = [None] * nd
            squeeze = []
            newaxes = []          # positions in the FINAL (output) layout
            d = 0                 # input-dim cursor
            out_pos = 0           # output-dim cursor (ints squeeze away)
            for rec in a["index"]:
                if rec["kind"] == "newaxis":
                    newaxes.append(out_pos)
                    out_pos += 1
                    continue
                if rec["kind"] == "int":
                    k = rec["index"]
                    starts[d], ends[d] = k, (None if k == -1 else k + 1)
                    squeeze.append(d)
                else:
                    starts[d], ends[d] = rec["start"], rec["stop"]
                    out_pos += 1
                d += 1
            out = ins[0]
            if any(s is not None for s in starts) \
                    or any(e is not None for e in ends) or squeeze:
                out = ffmodel.slice_tensor(out, starts, ends,
                                           squeeze_dims=squeeze,
                                           name=n.name + "_sl"
                                           if newaxes else n.name)
            for i, pos in enumerate(newaxes):
                out = ffmodel.unsqueeze(out, pos,
                                        name=n.name if i == len(newaxes) - 1
                                        else f"{n.name}_ua{i}")
        elif n.op == "mean":
            out = ffmodel.mean(ins[0], dims=a["dims"],
                               keepdims=a.get("keepdims", False), name=n.name)
        elif n.op == "unsqueeze":
            out = ffmodel.unsqueeze(ins[0], a["dim"], name=n.name)
        elif n.op == "squeeze":
            d = a["dim"] % ins[0].num_dims
            if ins[0].dims[d] != 1:   # torch: no-op on non-size-1 dims
                out = ins[0]
            else:
                out = ffmodel.squeeze(ins[0], d, name=n.name)
        else:
            raise NotImplementedError(f"IR op {n.op}")
        env[n.name] = out
    return outputs
