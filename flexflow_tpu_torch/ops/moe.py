"""Mixture-of-experts operators: GROUP_BY, AGGREGATE, AGG_SPEC and
EXPERTS (counterpart of ``flexflow_tpu/ops/moe.py``; reference
src/ops/{group_by,aggregate,aggregate_spec,experts}.cc).

The JAX package's dense one-hot dispatch and combine (GShard style), op
for op: ``make_dispatch`` places each (token, choice) in its expert's
queue first come, first served, up to a capacity; the buckets and the
combine are einsums. XLA lowers them there with no Pallas kernel, so
the port computes them with ``torch.einsum``, in the dtypes JAX's
promotion gives.

Expert parallelism: the EXPERTS kernel and bias are split over the
``expert`` mesh axis by their leading (expert) dim. Each rank computes
its experts' share of ``"teo,te->to"`` and a ``psum`` over ``expert``
adds the shares; the input's and the gate weights' gradients, partial
sums over the rank's experts, are summed over the axis.
"""

from __future__ import annotations

import torch

from flexflow_tpu_torch.core.initializer import (ZeroInitializer,
                                                 default_kernel_initializer)
from flexflow_tpu_torch.core.layer import WeightSpec
from flexflow_tpu_torch.ffconst import ActiMode, OpType
from flexflow_tpu_torch.ops.base import OpImpl, register_op
from flexflow_tpu_torch.ops.linear import apply_activation


def _one_hot(idx, n, dtype, start=0):
    """``jax.nn.one_hot``: [..., n] with zeros for an index outside
    ``[start, start + n)``."""
    ids = torch.arange(start, start + n, device=idx.device)
    return (idx.long()[..., None] == ids).to(dtype)


def _einsum(eq, *xs):
    """``torch.einsum`` in the operands' promoted dtype (JAX promotes
    where torch refuses mixed operands)."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return torch.einsum(eq, *(x.to(dt) for x in xs))


def make_dispatch(assign, n_experts: int, capacity: int):
    """assign: [tokens, k] expert ids -> the fp32 dispatch one-hot [tokens,
    k, n_experts, capacity]: 1 where choice j of token t takes position c
    of expert e's queue, first come first served; choices past an
    expert's capacity are dropped."""
    tokens, k = assign.shape
    onehot = _one_hot(assign, n_experts, torch.int64)        # [T, k, E]
    flat = onehot.reshape(tokens * k, n_experts)
    pos = (torch.cumsum(flat, dim=0) - flat).reshape(tokens, k, n_experts)
    disp = (onehot * (pos < capacity)).to(torch.float32)
    pos_onehot = _one_hot(pos.clamp(0, capacity - 1), capacity,
                          torch.float32)                      # [T,k,E,C]
    return disp[..., None] * pos_onehot


@register_op
class GroupBy(OpImpl):
    """Route tokens into per-expert buckets. Inputs: data [tokens, d],
    assign [tokens, k]; outputs: n buckets [capacity, d], zero-padded."""

    op_type = OpType.GROUP_BY

    @staticmethod
    def _capacity(attrs, tokens: int) -> int:
        return int(max(1, attrs.get("alpha", 1.0) * attrs["k"] * tokens
                       / attrs["n"]))

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        (sd, dd) = input_specs[0]
        cap = GroupBy._capacity(attrs, sd[0])
        return [((cap,) + tuple(sd[1:]), dd) for _ in range(attrs["n"])]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        data, assign = inputs[0], inputs[1]
        n = attrs["n"]
        disp = make_dispatch(assign, n, GroupBy._capacity(attrs,
                                                          data.shape[0]))
        buckets = _einsum("tkec,td->ecd", disp, data)
        return [buckets[e] for e in range(n)]


@register_op
class Aggregate(OpImpl):
    """The gate-weighted combine of the expert outputs back into token
    order. Inputs: gate_preds [tokens, k], gate_assign [tokens, k], then
    n expert outputs [capacity, d]; output [tokens, d]."""

    op_type = OpType.AGGREGATE

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        (sg, _dg) = input_specs[0]
        (se, de) = input_specs[2]
        return [((sg[0],) + tuple(se[1:]), de)]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        gate_preds, gate_assign = inputs[0], inputs[1]
        experts = torch.stack(inputs[2:], dim=0)            # [E, C, d]
        disp = make_dispatch(gate_assign, experts.shape[0],
                             experts.shape[1])
        combine = _einsum("tkec,tk->tkec", disp, gate_preds)
        return [_einsum("tkec,ecd->td", combine, experts)]


@register_op
class AggregateSpec(Aggregate):
    """The training-label variant of AGGREGATE (reference
    aggregate_spec.cc): the same combine with the true assignment."""

    op_type = OpType.AGG_SPEC


@register_op
class Experts(OpImpl):
    """A batch of one-layer expert FFNs with a dense dispatch. Inputs: x
    [tokens, d], indices [tokens, k], gate weights [tokens, k]; output
    ``y_t = sum_e w_te * act(x_t @ W_e + b_e)``, where ``w_te`` is the
    gate weight of token t's choices of expert e."""

    op_type = OpType.EXPERTS

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        (sx, dx) = input_specs[0]
        return [((sx[0], attrs["experts_output_dim_size"]), dx)]

    @staticmethod
    def weight_specs(attrs, input_specs):
        (sx, dx) = input_specs[0]
        n = attrs["num_experts"]
        d_out = attrs["experts_output_dim_size"]
        init = attrs.get("kernel_initializer") or default_kernel_initializer()
        specs = [WeightSpec("kernel", (n, sx[-1], d_out), dx, init,
                            sharding_dims=("expert", None, None))]
        if attrs.get("use_bias", False):
            specs.append(WeightSpec("bias", (n, d_out), dx,
                                    ZeroInitializer(),
                                    sharding_dims=("expert", None)))
        return specs

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        x, idx, gates = inputs[0], inputs[1], inputs[2]
        kernel = params["kernel"]
        n_local = kernel.shape[0]
        sharded = n_local != attrs["num_experts"]
        first = attrs.get("experts_start_idx", 0)
        if sharded:
            # this rank's experts: their share of the sum, added over the
            # axis; the inputs' gradients are partial sums
            from flexflow_tpu_torch.parallel.collectives import sum_grads

            first += ctx.mesh.index("expert") * n_local
            x = sum_grads(x, ctx.mesh, "expert")
            gates = sum_grads(gates, ctx.mesh, "expert")
        onehot = _one_hot(idx, n_local, x.dtype, start=first)   # [T,k,E]
        weighted = _einsum("tke,tk->te", onehot, gates)
        per_expert = _einsum("td,edo->teo", x, kernel)
        if "bias" in params:
            per_expert = per_expert + params["bias"][None, :, :]
        per_expert = apply_activation(
            per_expert, attrs.get("activation", ActiMode.AC_MODE_NONE))
        out = _einsum("teo,te->to", per_expert, weighted)
        if sharded:
            from flexflow_tpu_torch.parallel.collectives import psum

            out = psum(out, ctx.mesh, "expert")
        return [out]
