"""Serving attention for incremental decoding (counterpart of
``flexflow_tpu/ops/inc_attention.py``): qkv projection -> rotary ->
per-slot KV-cache append -> attention -> output projection, with GQA/MQA
through a ``[kv_heads, group]`` query packing.

Differences from the JAX package, by design:

* KV updates happen IN PLACE on the cache tensors (``append_kv``,
  ``append_kv_stacked``, ``append_kv_contiguous`` and the fused decode
  append of ``kernels/attention.py``), where the JAX package threads the
  caches functionally and relies on donation + aliasing. ``state_out``
  still names the updated caches, but they are the tensors ``state_in``
  already held.
* On the card the cache head dim is ``head_dim`` rounded up to the next
  kernel head dim (64, 128 or 256: ``cache_head_dim``), where the JAX
  package pads to the TPU's 128 lanes (``padded_head_dim``/``_pad_d``).
  q and the new K/V are zero-padded to the cache's dim and the output
  sliced back; the softmax scale stays ``1/sqrt(head_dim)``. On the CPU
  the cache is allocated at exactly ``head_dim``.
* There is no kernel switch: ``_attend`` always calls
  ``kernels.attention.flash_attend``, which launches the CUDA kernel for
  CUDA tensors and runs the plain version for CPU tensors.
* Tree verification builds its additive ``[R, T, S]`` mask once per
  forward (``OpContext.tree_bias``) rather than once per layer.
* ``commit_tree_kv`` compacts in place; invalid (row, node) pairs are
  selected away before the move, where the JAX scatter drops them at a
  sentinel index that torch would reject.
"""

from __future__ import annotations

import math

import torch

from flexflow_tpu_torch.core.initializer import (ZeroInitializer,
                                                 default_kernel_initializer)
from flexflow_tpu_torch.core.layer import WeightSpec
from flexflow_tpu_torch.ffconst import OpType, torch_dtype
from flexflow_tpu_torch.ops.base import OpImpl, register_op_as
from flexflow_tpu_torch.quant import qmatmul


# ----------------------------------------------------------------------
# Rotary position embedding (HF-LLaMA "NeoX" rotate-half convention)
# ----------------------------------------------------------------------
def rotary_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                   dtype) -> tuple:
    """positions [R, Q] -> cos/sin [R, Q, head_dim]."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                            device=positions.device), exponent)
    angles = positions[..., None].float() * inv_freq             # [R,Q,D/2]
    angles = torch.cat([angles, angles], dim=-1)                 # [R,Q,D]
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                 ) -> torch.Tensor:
    """x [R, Q, heads, D]; cos/sin [R, Q, D]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([-x2, x1], dim=-1)
    return x * cos[:, :, None, :] + rotated * sin[:, :, None, :]


def alibi_slopes(num_heads: int, device=None) -> torch.Tensor:
    """ALiBi per-head slopes (Press et al.; HF MPT build_alibi_bias)."""
    closest = 2 ** math.floor(math.log2(num_heads))
    base = torch.arange(1, closest + 1, dtype=torch.float32, device=device)
    slopes = 2.0 ** (-8.0 * base / closest)
    if closest < num_heads:
        extra = 2.0 ** (-4.0 * base / closest)
        slopes = torch.cat([slopes, extra[: num_heads - closest]])
    return slopes


# ----------------------------------------------------------------------
# KV cache update, in place (reference update_kv_cache_kernel)
# ----------------------------------------------------------------------
def _valid_cols(start_pos, num_tokens, active, Q, S):
    """[R, Q] cache columns of each new token and whether it is written:
    padding tokens, inactive slots and columns past the cache end are
    dropped (the JAX scatter's mode="drop")."""
    q_idx = torch.arange(Q, device=start_pos.device)
    cols = start_pos.long()[:, None] + q_idx[None, :]
    valid = ((q_idx[None, :] < num_tokens[:, None]) & active.bool()[:, None]
             & (cols < S))
    return cols, valid


def append_kv(cache: torch.Tensor, new: torch.Tensor, start_pos, num_tokens,
              active) -> torch.Tensor:
    """Write new [R, Q, KH, D] into cache [R, KH, S, D] at per-slot offsets,
    in place; returns ``cache``."""
    R, Q = new.shape[0], new.shape[1]
    cols, valid = _valid_cols(start_pos, num_tokens, active, Q,
                              cache.shape[2])
    r_idx, q_idx = valid.nonzero(as_tuple=True)
    cache[r_idx, :, cols[r_idx, q_idx]] = new[r_idx, q_idx].to(cache.dtype)
    return cache


def append_kv_stacked(stack: torch.Tensor, layer_idx: int, new: torch.Tensor,
                      start_pos, num_tokens, active) -> torch.Tensor:
    """Write new [R, Q, KH, D] into layer ``layer_idx`` of the stacked cache
    [L, R, KH, S, D], in place (through the layer's view); returns
    ``stack``."""
    append_kv(stack[layer_idx], new, start_pos, num_tokens, active)
    return stack


def append_kv_contiguous(cache, layer_idx, new, start_pos, active):
    """In-place contiguous append of each active row's [KH, Q, D] run at
    start_pos[r] (clipped to [0, S - Q]); inactive rows are left as they
    are. Only valid under the engines' guarantee that every ACTIVE row has
    start_pos + Q <= S; padding tokens land beyond the valid extent, where
    ``lengths`` masks them until a real append overwrites them. An
    inactive row rewrites its own run unchanged, so that no host read
    picks the active rows: the engines' forwards stay asynchronous."""
    c = cache if layer_idx is None else cache[layer_idx]
    R, Q, S = new.shape[0], new.shape[1], c.shape[-2]
    rows = torch.arange(R, device=c.device)[:, None]
    cols = (start_pos.long().clamp(0, S - Q)[:, None]
            + torch.arange(Q, device=c.device)[None, :])
    c[rows, :, cols] = torch.where(active.bool()[:, None, None, None],
                                   new.to(c.dtype), c[rows, :, cols])
    return cache


def cache_head_dim(D: int, pad: bool) -> int:
    """Head dim of the KV cache allocated for head dim D: padded for the
    CUDA kernels (``kernels.attention.padded_head_dim``) when ``pad``
    (the model lives on the card), else D. Padding is a layout chosen
    here, once: the kernels never retry a shape."""
    from flexflow_tpu_torch.kernels.attention import padded_head_dim

    return padded_head_dim(D) if pad else D


def pad_head_dim(x: torch.Tensor, Dp: int) -> torch.Tensor:
    """x [..., D] zero-padded to [..., Dp] (``_pad_d`` of the JAX package)."""
    D = x.shape[-1]
    return x if D == Dp else torch.nn.functional.pad(x, (0, Dp - D))


def _qkv(attrs, params, x, compute_dtype):
    """Project x [R, Q, E] -> q [R,Q,H,D], k/v [R,Q,KH,D]: three products,
    or one over the fused ``wqkv`` (serve/gemm_fusion.py) sliced after.
    Weights may be quantized (``quant.qmatmul``)."""
    H, KH, D = attrs["num_q_heads"], attrs["num_kv_heads"], attrs["head_dim"]
    if "wqkv" in params:
        qkv = qmatmul(x, params["wqkv"])
        if "bqkv" in params:
            qkv = qkv + params["bqkv"]
        hd, khd = H * D, KH * D
        q, k, v = qkv[..., :hd], qkv[..., hd:hd + khd], qkv[..., hd + khd:]
    else:
        q = qmatmul(x, params["wq"])
        k = qmatmul(x, params["wk"])
        v = qmatmul(x, params["wv"])
        n_bias = sum(k_ in params for k_ in ("bq", "bk", "bv"))
        if n_bias == 3:
            q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
        elif n_bias:
            raise ValueError(
                "attention qkv bias set must be all-present or all-absent; "
                f"got {sorted(k_ for k_ in ('bq', 'bk', 'bv') if k_ in params)}")
    R, Q = x.shape[0], x.shape[1]
    return (q.reshape(R, Q, H, D), k.reshape(R, Q, KH, D),
            v.reshape(R, Q, KH, D))


def _attend(attrs, q, k_cache, v_cache, lengths, qpos, out_dtype, ctx,
            bias=None, causal=True, layer_idx=None, append_kv=None):
    """q [R,Q,H,D] x cache [R,KH,S,Dp] (or layer ``layer_idx`` of the
    stacked [L,R,KH,S,Dp] buffers) -> [R, Q, H*D]; with ``append_kv`` the
    decode append is fused into the kernel and (out, k_cache, v_cache)
    returns. A padded cache (Dp > D) takes q and the new K/V zero-padded
    and its output sliced back to D."""
    from flexflow_tpu_torch.kernels.attention import flash_attend

    D = attrs["head_dim"]
    Dp = k_cache.shape[-1]
    scale = (1.0 / math.sqrt(D)) if attrs.get("qk_prod_scaling", True) else 1.0
    if attrs.get("scaling_query", False):
        scale = scale * attrs.get("scaling_factor", 1.0)
    alibi = (alibi_slopes(attrs["num_q_heads"], device=q.device)
             if attrs.get("position_bias", False) else None)
    if append_kv is not None:
        k_new, v_new, appos = append_kv
        append_kv = (pad_head_dim(k_new, Dp), pad_head_dim(v_new, Dp), appos)
    res = flash_attend(pad_head_dim(q, Dp), k_cache, v_cache, lengths, qpos,
                       bias=bias, alibi=alibi, append_kv=append_kv,
                       causal=causal, qk_scale=scale, out_dtype=out_dtype,
                       layer_idx=layer_idx)
    if Dp == D:
        return res
    out = res if append_kv is None else res[0]
    R, Q, H = q.shape[0], q.shape[1], q.shape[2]
    out = out.reshape(R, Q, H, Dp)[..., :D].reshape(R, Q, H * D)
    return out if append_kv is None else (out,) + tuple(res[1:])


def _weight_specs(attrs, input_specs):
    (shape, d) = input_specs[0]
    E = shape[-1]
    H, KH, D = attrs["num_q_heads"], attrs["num_kv_heads"], attrs["head_dim"]
    dt = attrs.get("data_type") or d
    init = attrs.get("kernel_initializer") or default_kernel_initializer()
    specs = [WeightSpec("wq", (E, H * D), dt, init),
             WeightSpec("wk", (E, KH * D), dt, init),
             WeightSpec("wv", (E, KH * D), dt, init),
             WeightSpec("wo", (H * D, E), dt, init)]
    if attrs.get("bias", False):
        zero = ZeroInitializer()
        specs += [WeightSpec("bq", (H * D,), dt, zero),
                  WeightSpec("bk", (KH * D,), dt, zero),
                  WeightSpec("bv", (KH * D,), dt, zero),
                  WeightSpec("bo", (E,), dt, zero)]
    return specs


def _init_kv_state(attrs, input_specs, device):
    R, S = attrs["max_requests"], attrs["max_seq_length"]
    KH = attrs["num_kv_heads"]
    D = cache_head_dim(attrs["head_dim"],
                       pad=torch.device(device).type == "cuda")
    dt = torch_dtype(attrs.get("cache_dtype", "bfloat16"))
    return {"k_cache": torch.zeros((R, KH, S, D), dtype=dt, device=device),
            "v_cache": torch.zeros((R, KH, S, D), dtype=dt, device=device)}


def _project_out(attrs, params, ctx, attn_out):
    out = qmatmul(attn_out, params["wo"])
    if "bo" in params:
        out = out + params["bo"]
    return out


# ----------------------------------------------------------------------
# KV-cache state access. Two layouts:
#  * per-layer: op_state[layer_name] = {"k_cache", "v_cache"}
#  * stacked (FFModel.compile consolidates homogeneous caches):
#    op_state["kv_cache"] = {"k": [L, ...], "v": [L, ...]} and each layer
#    carries attrs["cache_layer_idx"].
# ----------------------------------------------------------------------
def _cache_state(ctx, attrs):
    if attrs.get("cache_layer_idx") is None:
        return ctx.state_out.get(ctx.layer_name) or ctx.state_in[ctx.layer_name]
    return ctx.state_out.get("kv_cache") or ctx.state_in["kv_cache"]


def read_kv(ctx, attrs):
    """This layer's [R, KH, S, D] caches (views into the stack when
    stacked)."""
    st = _cache_state(ctx, attrs)
    idx = attrs.get("cache_layer_idx")
    if idx is None:
        return st["k_cache"], st["v_cache"]
    return st["k"][idx], st["v"][idx]


def write_kv(ctx, attrs, k_cache, v_cache):
    """Record this layer's caches in ``state_out``: the per-layer pair, or
    the stack the layer's caches are views of. The caches were updated in
    place, so this only names them."""
    if attrs.get("cache_layer_idx") is None:
        ctx.state_out[ctx.layer_name] = {"k_cache": k_cache,
                                         "v_cache": v_cache}
    else:
        ctx.state_out["kv_cache"] = _cache_state(ctx, attrs)


def append_and_ref(ctx, attrs, k, v, start_pos, num_tokens, active):
    """Append this step's KV in place and return (k_ref, v_ref, layer_idx)
    to attend over: the layer's own [R,KH,S,D] caches with layer_idx None,
    or the full stacked [L,...] buffers with the layer's index."""
    idx = attrs.get("cache_layer_idx")
    st = _cache_state(ctx, attrs)
    if idx is None:
        kc, vc = st["k_cache"], st["v_cache"]
    else:
        kc, vc = st["k"], st["v"]
    k, v = pad_head_dim(k, kc.shape[-1]), pad_head_dim(v, vc.shape[-1])
    if ctx.kv_contiguous and k.shape[1] != 1:
        append_kv_contiguous(kc, idx, k, start_pos, active)
        append_kv_contiguous(vc, idx, v, start_pos, active)
    elif idx is None:
        append_kv(kc, k, start_pos, num_tokens, active)
        append_kv(vc, v, start_pos, num_tokens, active)
    else:
        append_kv_stacked(kc, idx, k, start_pos, num_tokens, active)
        append_kv_stacked(vc, idx, v, start_pos, num_tokens, active)
    write_kv(ctx, attrs, kc, vc)
    return kc, vc, idx


def tree_bias(ancestor: torch.Tensor, start_pos: torch.Tensor,
              S: int) -> torch.Tensor:
    """fp32 [R, T, S] additive tree mask: 0 on the committed prefix
    (s < start_pos) and on each node's ancestor-or-self columns (node j
    is staged at start_pos + j), NEG_INF everywhere else."""
    from flexflow_tpu_torch.kernels.attention import NEG_INF

    R, T = ancestor.shape[0], ancestor.shape[1]
    node = (torch.arange(S, device=ancestor.device)[None, :]
            - start_pos.long()[:, None])                           # [R, S]
    in_tree = (node >= 0) & (node < T)
    anc = torch.gather(ancestor, 2,
                       node.clamp(0, T - 1)[:, None, :].expand(R, T, S))
    visible = (node < 0)[:, None, :] | (in_tree[:, None, :] & anc)
    return torch.where(visible, 0.0, NEG_INF).to(torch.float32)


@register_op_as(OpType.INC_MULTIHEAD_SELF_ATTENTION,
                OpType.SPEC_INC_MULTIHEAD_SELF_ATTENTION)
class IncMultiHeadSelfAttention(OpImpl):
    """Incremental-decoding attention with a per-slot KV cache. The
    speculative (draft-model) variant is the same computation; the draft
    model owns its own cache."""

    op_type = OpType.INC_MULTIHEAD_SELF_ATTENTION
    quant_aware = True

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        (shape, d) = input_specs[0]
        return [(tuple(shape[:-1]) + (attrs["embed_dim"],),
                 attrs.get("data_type") or d)]

    weight_specs = staticmethod(_weight_specs)
    init_state = staticmethod(_init_kv_state)

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        x = inputs[0]
        meta = ctx.batch_config
        assert meta is not None, "serving ops need ctx.batch_config"
        if hasattr(meta, "ancestor"):
            # beam drafting stages its frontier as tree nodes on the draft
            # model: tree attention over the staged region gives each node
            # its ancestor path, with no per-beam cache
            return TreeIncMultiHeadSelfAttention.forward(attrs, params,
                                                         inputs, ctx)
        q, k, v = _qkv(attrs, params, x, ctx.compute_dtype)
        if attrs.get("apply_rotary_embedding", False):
            cos, sin = rotary_cos_sin(meta.positions, attrs["head_dim"],
                                      attrs.get("rope_theta", 10000.0),
                                      q.dtype)
            q = apply_rotary(q, cos, sin)
            k = apply_rotary(k, cos, sin)
        # causal over absolute cache positions: query token i (at position
        # start+i) sees cache[s] for s <= start+i
        Q = x.shape[1]
        q_abs = (meta.start_pos[:, None]
                 + torch.arange(Q, device=x.device, dtype=torch.int32)[None, :])
        lengths = torch.where(meta.active, meta.start_pos + meta.num_tokens,
                              torch.zeros_like(meta.start_pos))
        append_q = ctx.kv_append_q
        eff_q = append_q if (append_q is not None and Q > append_q) else Q
        if eff_q == 1:
            # one new real token per row (decode; the verify-consistent
            # wide decode has 1 real + padding tokens): the KV append is
            # fused into the attention kernel (K2)
            idx = attrs.get("cache_layer_idx")
            st = _cache_state(ctx, attrs)
            k0, v0 = ((st["k_cache"], st["v_cache"]) if idx is None
                      else (st["k"], st["v"]))
            S = k0.shape[-2]
            appos = torch.where(
                meta.active & (meta.num_tokens > 0) & (meta.start_pos < S),
                meta.start_pos, torch.full_like(meta.start_pos, -1))
            out, knew, vnew = _attend(
                attrs, q, k0, v0, lengths, q_abs, x.dtype, ctx, causal=True,
                layer_idx=idx, append_kv=(k[:, :1], v[:, :1], appos))
            write_kv(ctx, attrs, knew, vnew)
            return [_project_out(attrs, params, ctx, out)]
        k_ref, v_ref, layer_idx = append_and_ref(
            ctx, attrs, k, v, meta.start_pos, meta.num_tokens, meta.active)
        out = _attend(attrs, q, k_ref, v_ref, lengths, q_abs, x.dtype, ctx,
                      causal=True, layer_idx=layer_idx)
        return [_project_out(attrs, params, ctx, out)]


@register_op_as(OpType.TREE_INC_MULTIHEAD_SELF_ATTENTION)
class TreeIncMultiHeadSelfAttention(OpImpl):
    """Verification attention over a speculated token tree (reference
    tree_inc_multihead_self_attention.cu): every node's KV is staged into
    the cache past the committed prefix, at start_pos + node index, and
    each node attends to the committed prefix plus its ancestor chain.
    The mask is K1's additive bias (``causal=False``); the fused decode
    append is never taken here, so a tree of any width goes through K1.
    A plain ``BatchMeta`` (prompt prefill, or a chain engine's causal
    verify) runs as incremental attention."""

    op_type = OpType.TREE_INC_MULTIHEAD_SELF_ATTENTION
    quant_aware = True
    infer_output_specs = staticmethod(
        IncMultiHeadSelfAttention.infer_output_specs)
    weight_specs = staticmethod(_weight_specs)
    init_state = staticmethod(_init_kv_state)

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        x = inputs[0]
        meta = ctx.batch_config
        if not hasattr(meta, "ancestor"):
            return IncMultiHeadSelfAttention.forward(attrs, params, inputs,
                                                     ctx)
        q, k, v = _qkv(attrs, params, x, ctx.compute_dtype)
        if attrs.get("apply_rotary_embedding", False):
            cos, sin = rotary_cos_sin(meta.positions, attrs["head_dim"],
                                      attrs.get("rope_theta", 10000.0),
                                      q.dtype)
            q = apply_rotary(q, cos, sin)
            k = apply_rotary(k, cos, sin)
        k_ref, v_ref, layer_idx = append_and_ref(
            ctx, attrs, k, v, meta.start_pos, meta.num_nodes, meta.active)
        S = k_ref.shape[-2]
        if ctx.tree_bias is None or ctx.tree_bias.shape[-1] != S:
            ctx.tree_bias = tree_bias(meta.ancestor, meta.start_pos, S)
        lengths = torch.where(meta.active, meta.start_pos + meta.num_nodes,
                              torch.zeros_like(meta.start_pos))
        out = _attend(attrs, q, k_ref, v_ref, lengths, meta.positions,
                      x.dtype, ctx, bias=ctx.tree_bias, causal=False,
                      layer_idx=layer_idx)
        return [_project_out(attrs, params, ctx, out)]


def commit_tree_kv(op_state, src_node: torch.Tensor,
                   num_commit: torch.Tensor, start_pos: torch.Tensor,
                   active: torch.Tensor):
    """Compact accepted tree nodes into the committed cache region, in
    place, for every KV-cache layer: cache[r, start + i] <-
    cache[r, start + src_node[r, i]] for i < num_commit[r] on active rows
    (sources clipped to the cache, destinations past its end dropped, as
    the JAX scatter does). Returns ``op_state``.

    The valid (row, i) pairs are selected first with ``nonzero``, which
    waits for the device (once per verify round of the host tree path
    and of the fused engines that commit), and every source is gathered
    before the first write, so no move reads a slot another overwrote.
    Reference: commit_tokens_kernel (tree_inc_multihead_self_attention.cu).
    """
    S = next(st[n] for st in op_state.values() if isinstance(st, dict)
             for n in ("k", "k_cache") if n in st).shape[-2]
    C = src_node.shape[1]
    i = torch.arange(C, device=src_node.device)
    dst = start_pos.long()[:, None] + i[None, :]
    valid = ((i[None, :] < num_commit[:, None]) & active.bool()[:, None]
             & (dst < S))
    rows, cols = valid.nonzero(as_tuple=True)
    src = (start_pos.long()[rows] + src_node.long()[rows, cols]).clamp(
        0, S - 1)
    dst = dst[rows, cols]
    for st in op_state.values():
        if not isinstance(st, dict):
            continue
        for name in ("k", "v", "k_cache", "v_cache"):
            if name in st:
                # the stacked [L, R, KH, S, D] pair or one layer's
                # [R, KH, S, D]
                c = st[name] if st[name].dim() == 5 else st[name][None]
                c[:, rows, :, dst] = c[:, rows, :, src]
    return op_state
