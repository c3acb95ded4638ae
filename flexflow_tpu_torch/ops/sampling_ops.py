"""Token selection for serving (counterpart of
``flexflow_tpu/ops/sampling_ops.py``): ArgMax (greedy; its beam variant
also returns parent ids), Sampling (top-p with temperature) and BeamTopK.

In a serving forward on a ``model`` axis above 1 the logits reach the
head split over ``model`` on the vocabulary, as GSPMD keeps them in the
JAX package. ArgMax then takes its split form (``split_argmax``): each
rank its shard's maximum and first maximal index, offset to a global
index, and one all-gather of the ranks' (value, index) pairs, from which
every rank picks the largest value at the lowest index: the first
maximal index of the whole row, ``torch.argmax``'s bit for bit. Sampling
and BeamTopK read the logits gathered (``parallel/placement.py``).

Random draws come from ``OpContext.generator``, a ``torch.Generator`` on
the model's device that the InferenceManager owns and seeds from
``FFConfig.seed`` (the JAX package's per-step PRNG key). A draw is a
Gumbel-max over the nucleus, as ``jax.random.categorical`` draws, so it
needs no host read.
"""

from __future__ import annotations

import torch

from flexflow_tpu_torch.ffconst import DataType, OpType
from flexflow_tpu_torch.ops.base import OpImpl, register_op
from flexflow_tpu_torch.ops.reduction_ops import stable_top_k


@register_op
class ArgMax(OpImpl):
    op_type = OpType.ARGMAX

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        (s, _d) = input_specs[0]
        out_shape = tuple(s[:-1])
        if attrs.get("beam_search", False):
            # the beam variant also returns parent ids
            return [(out_shape, DataType.DT_INT32),
                    (out_shape, DataType.DT_INT32)]
        return [(out_shape, DataType.DT_INT32)]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        x = inputs[0]
        shard = ctx.split_dims((-1,), x.dim()) if ctx is not None else {}
        if shard:
            idx = split_argmax(x, ctx.mesh, *shard[x.dim() - 1])
        else:
            # torch.argmax, like jnp.argmax, returns the first maximal
            # index
            idx = torch.argmax(x, dim=-1)
        idx = idx.to(torch.int32)
        if attrs.get("beam_search", False):
            return [idx, torch.zeros_like(idx)]
        return [idx]


def split_argmax(x: torch.Tensor, mesh, axis: str, n: int,
                 i: int) -> torch.Tensor:
    """``torch.argmax(whole, -1)`` (int64) of the ``whole`` tensor whose
    last dim is split over ``axis`` (``n`` ranks, this one at index
    ``i`` holding ``x``): each rank's best (value, global index), one
    all-gather of the pairs (packed in float64, which holds any float
    value and an index below 2^53 exactly), then the largest value at
    the lowest rank, whose indices are the lowest: the first maximal
    index of the whole row. A NaN counts as the largest value, as in
    ``torch.argmax``."""
    from flexflow_tpu_torch.parallel.collectives import all_gather

    local = torch.argmax(x, dim=-1, keepdim=True)
    best = torch.gather(x, -1, local)
    pair = torch.cat([best.double(),
                      (local + i * x.shape[-1]).double()], dim=-1)
    pairs = all_gather(pair, mesh, axis, axis=0, tiled=False)   # [n, ...]
    rank = torch.argmax(pairs[..., 0], dim=0, keepdim=True)
    return torch.gather(pairs[..., 1], 0, rank)[0].long()


def top_p_sampling(logits: torch.Tensor, generator: torch.Generator,
                   top_p: float, temperature: float = 1.0) -> torch.Tensor:
    """Top-p (nucleus) sampling over the last dim: sort the probabilities
    descending (ties by lower index), keep each token whose preceding
    cumulative mass is below ``top_p`` (so at least one is kept),
    renormalise, draw. Returns int64 token ids."""
    if temperature != 1.0:
        logits = logits / temperature
    probs = torch.softmax(logits.float(), dim=-1)
    sorted_probs, sorted_idx = stable_top_k(probs, probs.shape[-1])
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep = (cum - sorted_probs) < top_p
    filtered = torch.where(keep, sorted_probs, 0.0)
    filtered = filtered / filtered.sum(dim=-1, keepdim=True)
    u = torch.rand(filtered.shape, generator=generator,
                   device=filtered.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))
    draw = torch.argmax(torch.log(filtered + 1e-30) + gumbel, dim=-1)
    return torch.gather(sorted_idx, -1, draw[..., None])[..., 0]


@register_op
class Sampling(OpImpl):
    op_type = OpType.SAMPLING

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        (s, _d) = input_specs[0]
        return [(tuple(s[:-1]), DataType.DT_INT32)]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        x = inputs[0]
        gen = ctx.generator
        if gen is None:
            # the JAX package draws with PRNGKey(0) when given no key
            gen = torch.Generator(device=x.device)
            gen.manual_seed(0)
        tok = top_p_sampling(x, gen, attrs.get("top_p", 1.0),
                             attrs.get("temperature", 1.0))
        return [tok.to(torch.int32)]


@register_op
class BeamTopK(OpImpl):
    """Per-request beam expansion: the best ``max_beam_width`` (value,
    token, parent beam) triples over ``[..., num_beams, vocab]`` scores
    (already weighted by each beam's prior)."""

    op_type = OpType.BEAM_TOPK

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        (s, _d) = input_specs[0]
        out = tuple(s[:-2]) + (attrs["max_beam_width"],)
        return [(out, DataType.DT_FLOAT), (out, DataType.DT_INT32),
                (out, DataType.DT_INT32)]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        logprobs = inputs[0]
        vocab = logprobs.shape[-1]
        flat = logprobs.reshape(logprobs.shape[:-2] + (-1,))
        values, idx = stable_top_k(flat, attrs["max_beam_width"])
        return [values, (idx % vocab).to(torch.int32),
                (idx // vocab).to(torch.int32)]
