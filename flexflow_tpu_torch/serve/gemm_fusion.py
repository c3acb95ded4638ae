"""Serving GEMM fusion: fewer, wider decode GEMMs (counterpart of
``flexflow_tpu/serve/gemm_fusion.py``, the reference's FusedOp /
``--fusion``).

At decode widths every GEMM streams its whole weight for a few rows, so
each one pays a fixed cost. Two rewrites cut 7 GEMMs a LLaMA layer to 4:

* attention layers: wq|wk|wv -> one ``wqkv`` [E, (H + 2 KH) D] (biases ->
  ``bqkv``); ``ops/inc_attention._qkv`` runs one product and slices it;
* SwiGLU MLPs: the (gate_proj, up_proj) Linear pair feeding a
  SigmoidSiluMulti becomes ONE Linear named ``"<gate>|<up-leaf>"``
  producing [..., 2I], and the SigmoidSiluMulti gets ``packed=True`` and
  splits the halves. Only when both Linears are bias-free and
  activation-free, read the same input, and the SigmoidSiluMulti is the
  sole consumer of both outputs.

Quantized weights concatenate exactly: the per-column scheme keeps one
scale per output column, so column concatenation keeps every column's
payload and scale bit for bit.

Eligibility in the port: ``enable_fusion and gemm_fusion`` on a compiled
model (the port compiles for inference only and has no mesh, pipeline,
offload or debugging dumps, the JAX package's other terms). Off by default, as in
the JAX package, where it measured slower end to end. Applied after the
weights are loaded (``FFModel.finalize_gemm_fusion``), so checkpoint maps
keep writing the separate names; ``fused_param_get``/``fused_param_set``
keep ``get/set_parameter_by_key`` working on them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from flexflow_tpu_torch.ffconst import ActiMode, OpType
from flexflow_tpu_torch.quant import (QuantizedWeight, dequantize_array,
                                      is_quantized, requantize_into)

_ATTN_TYPES = (OpType.INC_MULTIHEAD_SELF_ATTENTION,
               OpType.SPEC_INC_MULTIHEAD_SELF_ATTENTION,
               OpType.TREE_INC_MULTIHEAD_SELF_ATTENTION)


def fusion_eligible(model) -> bool:
    """The port compiles for inference only, so the flags decide."""
    return model.config.enable_fusion and model.config.gemm_fusion


def _concat_cols(leaves: List):
    """Column-concat plain or quantized 2-D weights; None if mixed."""
    if all(is_quantized(w) for w in leaves):
        if (len({w.qtype for w in leaves}) != 1
                or len({w.rows for w in leaves}) != 1
                or len({w.dtype for w in leaves}) != 1):
            return None
        return QuantizedWeight(
            leaves[0].qtype, torch.cat([w.q for w in leaves], dim=1),
            torch.cat([w.scale for w in leaves]), leaves[0].rows,
            leaves[0].dtype)
    if any(is_quantized(w) for w in leaves):
        return None
    if len({w.dtype for w in leaves}) != 1:
        return None
    return torch.cat(leaves, dim=1)


def _fuse_attention_qkv(model) -> int:
    n = 0
    for layer in model.layers:
        if layer.op_type not in _ATTN_TYPES:
            continue
        lp = model.params.get(layer.name)
        if not lp or not all(k in lp for k in ("wq", "wk", "wv")):
            continue
        n_bias = sum(k in lp for k in ("bq", "bk", "bv"))
        if n_bias not in (0, 3):
            # a partial bias set cannot be packed into one bqkv, and the
            # fused path would drop the stragglers: skip
            continue
        fused = _concat_cols([lp["wq"], lp["wk"], lp["wv"]])
        if fused is None:
            continue
        if n_bias == 3:
            lp["bqkv"] = torch.cat([lp.pop(k) for k in ("bq", "bk", "bv")])
        lp["wqkv"] = fused
        for k in ("wq", "wk", "wv"):
            del lp[k]
        n += 1
    return n


def _graph_maps(model):
    """tensor_id -> producing layer, tensor_id -> consuming layers."""
    prod, cons = {}, {}
    for ly in model.layers:
        for t in ly.outputs:
            prod[t.tensor_id] = ly
        for t in ly.inputs:
            cons.setdefault(t.tensor_id, []).append(ly)
    return prod, cons


def _sole_consumer(model, cons, tensor) -> Optional[object]:
    """The one layer consuming ``tensor``, or None (no consumer, several,
    or the graph's final tensor)."""
    if tensor is model._final_tensor:
        return None
    hits = cons.get(tensor.tensor_id, [])
    return hits[0] if len(hits) == 1 else None


def _fusable_gate_up(model, ssm, prod, cons):
    """(gate_layer, up_layer) of a fusable SwiGLU pair, else None."""
    if len(ssm.inputs) != 2 or ssm.attrs.get("packed"):
        return None
    g, u = (prod.get(t.tensor_id) for t in ssm.inputs)
    if g is None or u is None or g is u:
        return None
    for ly in (g, u):
        if (ly.op_type != OpType.LINEAR
                or ly.attrs.get("use_bias", True)
                or ly.attrs.get("activation", ActiMode.AC_MODE_NONE)
                != ActiMode.AC_MODE_NONE
                or ly.attrs.get("keep_f32_logits")
                or len(ly.outputs) != 1
                or set(model.params.get(ly.name, {})) != {"kernel"}):
            return None
    if g.inputs[0].tensor_id != u.inputs[0].tensor_id:
        return None
    if g.attrs["out_dim"] != u.attrs["out_dim"]:
        # the packed half-split assumes equal halves
        return None
    if (_sole_consumer(model, cons, g.outputs[0]) is not ssm
            or _sole_consumer(model, cons, u.outputs[0]) is not ssm):
        return None
    return g, u


def _fuse_swiglu_mlps(model) -> int:
    n = 0
    prod, cons = _graph_maps(model)
    for ssm in list(model.layers):
        if ssm.op_type != OpType.SIGMOID_SILU_MULTI:
            continue
        pair = _fusable_gate_up(model, ssm, prod, cons)
        if pair is None:
            continue
        g, u = pair
        fused = _concat_cols([model.params[g.name]["kernel"],
                              model.params[u.name]["kernel"]])
        if fused is None:
            continue
        new_name = f"{g.name}|{u.name.rsplit('.', 1)[-1]}"
        old_g, old_u = g.name, u.name
        g.name = new_name
        # the pre-fusion names, for the parameter accessors
        g.attrs["fused_gate_layer"] = old_g
        g.attrs["fused_up_layer"] = old_u
        g.attrs["out_dim"] = 2 * g.attrs["out_dim"]
        # a recompile initializes the fused [E, 2I] kernel from these specs
        g.weights = [dataclasses.replace(
            w, shape=(w.shape[0], 2 * w.shape[1])) if w.name == "kernel"
            else w for w in g.weights]
        out = g.outputs[0]
        out.dims = tuple(out.dims[:-1]) + (2 * out.dims[-1],)
        model.params[new_name] = {"kernel": fused}
        del model.params[old_g]
        del model.params[old_u]
        model.layers.remove(u)
        ssm.inputs = [out]
        ssm.attrs["packed"] = True
        n += 1
    return n


def apply_gemm_fusion(model) -> dict:
    """Rewrite ``model`` in place; returns {"qkv": n, "swiglu": n}."""
    return {"qkv": _fuse_attention_qkv(model),
            "swiglu": _fuse_swiglu_mlps(model)}


# ----------------------------------------------------------------------
# Accessors: get/set_parameter_by_key keep working on the PRE-fusion names
# (wq/wk/wv, gate_proj/up_proj) by slicing / splicing the fused leaf.
# ----------------------------------------------------------------------
def _qkv_slices(layer):
    hd = layer.attrs["num_q_heads"] * layer.attrs["head_dim"]
    khd = layer.attrs["num_kv_heads"] * layer.attrs["head_dim"]
    cuts = {"q": (0, hd), "k": (hd, hd + khd), "v": (hd + khd, hd + 2 * khd)}
    return {p + x: cut for x, cut in cuts.items() for p in ("w", "b")}


def _fused_site(model, layer_name: str, weight_name: str):
    """(params layer name, fused weight name, col_lo, col_hi) of a
    pre-fusion key that now lives inside a fused leaf, else None."""
    if weight_name in ("wq", "wk", "wv", "bq", "bk", "bv"):
        for layer in model.layers:
            if layer.name == layer_name and layer.op_type in _ATTN_TYPES:
                fname = "wqkv" if weight_name.startswith("w") else "bqkv"
                if fname in model.params.get(layer_name, {}):
                    lo, hi = _qkv_slices(layer)[weight_name]
                    return layer_name, fname, lo, hi
    if weight_name == "kernel":
        for layer in model.layers:
            if (layer.op_type != OpType.LINEAR
                    or "fused_gate_layer" not in layer.attrs):
                continue
            half = layer.attrs["out_dim"] // 2
            if layer_name == layer.attrs["fused_gate_layer"]:
                return layer.name, "kernel", 0, half
            if layer_name == layer.attrs["fused_up_layer"]:
                return layer.name, "kernel", half, 2 * half
    return None


def fused_param_get(model, layer_name: str, weight_name: str):
    """fp32 numpy copy of a pre-fusion weight (dequantized), or None."""
    site = _fused_site(model, layer_name, weight_name)
    if site is None:
        return None
    pname, fname, lo, hi = site
    leaf = model.params[pname][fname]
    arr = dequantize_array(leaf) if is_quantized(leaf) else leaf
    return arr[..., lo:hi].detach().float().cpu().numpy()


def fused_param_set(model, layer_name: str, weight_name: str, value) -> bool:
    """Write a pre-fusion weight into its columns of the fused leaf, in
    place; a quantized leaf re-quantizes those columns only. Returns False
    if the key is not a fused one."""
    site = _fused_site(model, layer_name, weight_name)
    if site is None:
        return False
    pname, fname, lo, hi = site
    leaf = model.params[pname][fname]
    new = torch.as_tensor(value)
    expect = ((leaf.rows, hi - lo) if is_quantized(leaf)
              else tuple(leaf[..., lo:hi].shape))
    if tuple(new.shape) != expect:
        raise ValueError(f"({layer_name}, {weight_name}): shape "
                         f"{tuple(new.shape)} != {expect}")
    if is_quantized(leaf):
        requantize_into(leaf, new, lo, hi)
    else:
        leaf[..., lo:hi] = new
    return True
