"""Training multi-head attention (counterpart of
``flexflow_tpu/ops/attention.py``): plain einsum -> softmax -> einsum,
as the JAX package computes it outside any Pallas kernel, so the port
has no kernel here either.

Under a mesh it keeps the JAX package's layout. Tensor parallelism splits
at whole heads: ``wq``/``wk``/``wv`` (and their biases) by columns,
``wo`` by rows; each rank attends with its heads. In a train step the
output stays split over ``model`` on the hidden dim, where GSPMD keeps
it in the JAX package's step (``OpContext.split_columns``): the ranks'
partial outputs are summed and scattered (``reduce_scatter``), then the
rank's slice of ``bo`` is added. Inputs split the same way are gathered
for the projections through ``collectives.gather_product``, which saves
only the rank's shard for the backward; a whole input's gradient, a
partial sum over the rank's heads, is summed over ``model``. Outside a
train step's walk the partial outputs are summed whole (``psum``) before
``bo``. Under sequence parallelism the core is ring attention
(``parallel/ring_attention.py``) on the condition the JAX package sets
(``use_ring``); the graph walker (``parallel/placement.py``) then hands
the op each rank's positions.

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
from flexflow_tpu_torch.ops.base import OpImpl, part, register_op


def _promoted(*xs):
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


def _mm(a, b):
    a, b = _promoted(a, b)
    return a @ b


def use_ring(attrs, sq: int, sk: int, mesh, training: bool) -> bool:
    """The JAX package's condition for the ring branch
    (``flexflow_tpu/ops/attention.py:55-60``), on the global lengths: a
    ``seq`` axis above 1, self-attention lengths, no probability dropout
    in training, no appended k/v rows, and ``sq`` divisible by the
    degree."""
    n = 1 if mesh is None else mesh.axis_size("seq")
    return (n > 1 and sq == sk
            and not (training and attrs.get("dropout", 0.0) > 0.0)
            and not attrs.get("add_bias_kv", False)
            and not attrs.get("add_zero_attn", False)
            and sq % n == 0)


def mha_forward(q, k, v, params, num_heads, dropout=0.0, causal=False,
                training=False, add_zero_attn=False, ctx=None,
                head_dim=None, ring=False):
    """q, k, v: [batch, seq, embed]. Weights: wq/wk/wv [embed, heads *
    head_dim], wo [heads * head_dim, embed]; optional biases bq/bk/bv/bo
    and the appended learnable rows bias_k/bias_v (torch
    MultiheadAttention semantics). Probability dropout draws from
    ``ctx.keep_mask`` when training.

    Under tensor parallelism (``wq`` holds fewer than ``num_heads`` heads
    of ``head_dim``) the rank attends with its heads and the outputs are
    summed over ``model`` (scattered on the hidden dim when
    ``ctx.split_columns``); an input narrower than its projection's rows
    is this rank's part of the hidden dim, gathered for the product.
    ``ring`` runs the core as ring attention over ``seq`` on this rank's
    positions."""
    b, sq, _ = q.shape
    sk = k.shape[1]
    wq = params["wq"]
    head_dim = head_dim or wq.shape[1] // num_heads
    heads = wq.shape[1] // head_dim         # this rank's heads
    mesh = ctx.mesh if ctx is not None else None
    qp, kp, vp = _projections((q, k, v), (wq, params["wk"], params["wv"]),
                              heads != num_heads, mesh)
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
    vdim = vp.shape[-1] // heads
    qh = qp.reshape(b, sq, heads, head_dim)
    kh = kp.reshape(b, sk, heads, head_dim)
    vh = vp.reshape(b, sk, heads, vdim)
    if ring:
        from flexflow_tpu_torch.parallel.ring_attention import \
            ring_attention_local

        out = ring_attention_local(qh, kh, vh, mesh, "seq", causal=causal)
        return _out_proj(out.to(q.dtype).reshape(b, sq, heads * vdim),
                         params, heads != num_heads, ctx)
    scores = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float())
    scores = scores / math.sqrt(head_dim)
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=scores.device).tril(sk - sq)
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if training and dropout > 0.0 and ctx is not None:
        keep = 1.0 - dropout
        # the draw of every head and batch row, this rank's part kept
        shards = {d: s for d, s in ctx.row_shards.items() if d == 0}
        if heads != num_heads:
            shards[1] = ("model", num_heads // heads, mesh.index("model"))
        m = ctx.keep_mask(probs.shape, keep, probs.device, shards)
        if m is not None:
            probs = probs * m.to(probs.dtype) / keep
    probs, vh = _promoted(probs, vh)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vh)
    return _out_proj(out.reshape(b, sq, heads * vdim), params,
                     heads != num_heads, ctx)


def _projections(xs, ws, sharded, mesh):
    """``x @ w`` for the (q, k, v) inputs and their projections, an input
    that is two or three of them used once. Under tensor parallelism an
    input narrower than ``w``'s rows (this rank's part of the hidden
    dim) is gathered for its products (``gather_product``); a whole
    input's gradient is summed over ``model`` (``sum_grads``)."""
    if not sharded:
        return [_mm(x, w) for x, w in zip(xs, ws)]
    from flexflow_tpu_torch.parallel.collectives import (gather_product,
                                                         sum_grads)

    groups = {}         # id(input) -> (input, [indices into xs])
    for j, x in enumerate(xs):
        groups.setdefault(id(x), (x, []))[1].append(j)
    out = [None] * len(xs)
    for x, js in groups.values():
        if x.shape[-1] != ws[js[0]].shape[0]:
            ys = gather_product(x, mesh, "model", [ws[j] for j in js])
        else:
            x = sum_grads(x, mesh, "model")
            ys = [_mm(x, ws[j]) for j in js]
        for j, y in zip(js, ys):
            out[j] = y
    return out


def _out_proj(out, params, sharded, ctx):
    """``out @ wo (+ bo)``; a row shard of ``wo`` gives a partial sum,
    added over ``model`` before the bias: whole, or scattered on the
    hidden dim with ``bo`` cut to the rank's slice when
    ``ctx.split_columns``."""
    out = _mm(out, params["wo"])
    bo = params.get("bo")
    if sharded:
        from flexflow_tpu_torch.parallel.collectives import (psum,
                                                             reduce_scatter)

        mesh = ctx.mesh
        if ctx.split_columns:
            out = reduce_scatter(out, mesh, "model",
                                 scatter_dimension=out.dim() - 1)
            if bo is not None:
                bo = part(bo, 0, ("model", mesh.axis_size("model"),
                                  mesh.index("model")))
        else:
            out = psum(out, mesh, "model")
    if bo is not None:
        out = out + bo
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
        # the JAX layout, split at whole heads (a degree that does not
        # divide the heads leaves the weights whole)
        kd, vd = kdim // nh, vdim // nh
        col = dict(sharding_dims=(None, "model"))
        specs = [WeightSpec("wq", (sq[-1], proj), d, init,
                            shard_multiples=(None, kd), **col),
                 WeightSpec("wk", (sk[-1], proj), d, init,
                            shard_multiples=(None, kd), **col),
                 WeightSpec("wv", (sv[-1], vproj), d, init,
                            shard_multiples=(None, vd), **col),
                 WeightSpec("wo", (vproj, embed), d, init,
                            sharding_dims=("model", None),
                            shard_multiples=(vd, None))]
        if attrs.get("bias", True):
            zero = ZeroInitializer()
            vec = dict(sharding_dims=("model",))
            specs += [WeightSpec("bq", (proj,), d, zero,
                                 shard_multiples=(kd,), **vec),
                      WeightSpec("bk", (proj,), d, zero,
                                 shard_multiples=(kd,), **vec),
                      WeightSpec("bv", (vproj,), d, zero,
                                 shard_multiples=(vd,), **vec),
                      WeightSpec("bo", (embed,), d, zero)]
        if attrs.get("add_bias_kv", False):
            specs += [WeightSpec("bias_k", (1, proj), d, init),
                      WeightSpec("bias_v", (1, vproj), d, init)]
        return specs

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        q, k, v = inputs[0], inputs[1], inputs[2]
        nh = attrs["num_heads"]
        ring = ctx.row_shards.get(1, ("",))[0] == "seq"
        return [mha_forward(q, k, v, params, nh,
                            dropout=attrs.get("dropout", 0.0),
                            causal=attrs.get("causal", False),
                            training=ctx.training,
                            add_zero_attn=attrs.get("add_zero_attn", False),
                            ctx=ctx,
                            head_dim=(attrs.get("kdim")
                                      or attrs["embed_dim"]) // nh,
                            ring=ring)]
