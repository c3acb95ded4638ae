"""Training multi-head attention (counterpart of
``flexflow_tpu/ops/attention.py``): plain einsum -> softmax -> einsum,
as the JAX package computes it outside any Pallas kernel, so the port
has no kernel here either. The ring-attention branch needs a mesh and is
not ported.

Dtypes follow JAX's promotion: a product of a bf16 activation and an
fp32 weight runs in fp32. The scores are fp32 whatever the operands (the
JAX einsum's ``preferred_element_type=float32``; the product of two bf16
values is exact in fp32), and the probabilities return to the query's
dtype before the value product.
"""

from __future__ import annotations

import math

import torch

from flexflow_tpu_torch.core.initializer import (ZeroInitializer,
                                                 default_kernel_initializer)
from flexflow_tpu_torch.core.layer import WeightSpec
from flexflow_tpu_torch.ffconst import OpType
from flexflow_tpu_torch.ops.base import OpImpl, register_op


def _promoted(*xs):
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


def _mm(a, b):
    a, b = _promoted(a, b)
    return a @ b


def mha_forward(q, k, v, params, num_heads, dropout=0.0, causal=False,
                training=False, add_zero_attn=False, ctx=None):
    """q, k, v: [batch, seq, embed]. Weights: wq/wk/wv [embed, heads *
    head_dim], wo [heads * head_dim, embed]; optional biases bq/bk/bv/bo
    and the appended learnable rows bias_k/bias_v (torch
    MultiheadAttention semantics). Probability dropout draws from
    ``ctx.keep_mask`` when training."""
    b, sq, _ = q.shape
    sk = k.shape[1]
    wq = params["wq"]
    head_dim = wq.shape[1] // num_heads
    qp, kp, vp = _mm(q, wq), _mm(k, params["wk"]), _mm(v, params["wv"])
    if "bq" in params:
        qp, kp, vp = qp + params["bq"], kp + params["bk"], vp + params["bv"]
    if "bias_k" in params:      # add_bias_kv: one learnable k/v position
        kp, bk = _promoted(kp, params["bias_k"])
        vp, bv = _promoted(vp, params["bias_v"])
        kp = torch.cat([kp, bk.expand(b, 1, kp.shape[-1])], dim=1)
        vp = torch.cat([vp, bv.expand(b, 1, vp.shape[-1])], dim=1)
        sk += 1
    if add_zero_attn:
        kp = torch.cat([kp, kp.new_zeros(b, 1, kp.shape[-1])], dim=1)
        vp = torch.cat([vp, vp.new_zeros(b, 1, vp.shape[-1])], dim=1)
        sk += 1
    qh = qp.reshape(b, sq, num_heads, head_dim)
    kh = kp.reshape(b, sk, num_heads, head_dim)
    vh = vp.reshape(b, sk, num_heads, head_dim)
    scores = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float())
    scores = scores / math.sqrt(head_dim)
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=scores.device).tril(sk - sq)
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if training and dropout > 0.0 and ctx is not None:
        keep = 1.0 - dropout
        m = ctx.keep_mask(probs.shape, keep, probs.device)
        if m is not None:
            probs = probs * m.to(probs.dtype) / keep
    probs, vh = _promoted(probs, vh)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vh)
    out = _mm(out.reshape(b, sq, num_heads * head_dim), params["wo"])
    if "bo" in params:
        out = out + params["bo"]
    return out


@register_op
class MultiHeadAttention(OpImpl):
    op_type = OpType.MULTIHEAD_ATTENTION

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        (sq, d) = input_specs[0]
        return [(tuple(sq[:-1]) + (attrs["embed_dim"],), d)]

    @staticmethod
    def weight_specs(attrs, input_specs):
        (sq, d) = input_specs[0]
        (sk, _dk) = input_specs[1]
        (sv, _dv) = input_specs[2]
        embed = attrs["embed_dim"]
        nh = attrs["num_heads"]
        kdim = attrs.get("kdim") or embed
        vdim = attrs.get("vdim") or embed
        proj = nh * (kdim // nh)
        vproj = nh * (vdim // nh)
        init = attrs.get("kernel_initializer") or default_kernel_initializer()
        specs = [WeightSpec("wq", (sq[-1], proj), d, init),
                 WeightSpec("wk", (sk[-1], proj), d, init),
                 WeightSpec("wv", (sv[-1], vproj), d, init),
                 WeightSpec("wo", (vproj, embed), d, init)]
        if attrs.get("bias", True):
            zero = ZeroInitializer()
            specs += [WeightSpec("bq", (proj,), d, zero),
                      WeightSpec("bk", (proj,), d, zero),
                      WeightSpec("bv", (vproj,), d, zero),
                      WeightSpec("bo", (embed,), d, zero)]
        if attrs.get("add_bias_kv", False):
            specs += [WeightSpec("bias_k", (1, proj), d, init),
                      WeightSpec("bias_v", (1, vproj), d, init)]
        return specs

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        q, k, v = inputs[0], inputs[1], inputs[2]
        return [mha_forward(q, k, v, params, attrs["num_heads"],
                            dropout=attrs.get("dropout", 0.0),
                            causal=attrs.get("causal", False),
                            training=ctx.training,
                            add_zero_attn=attrs.get("add_zero_attn", False),
                            ctx=ctx)]
