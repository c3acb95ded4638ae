"""Cache operator (counterpart of ``flexflow_tpu/ops/cache.py``;
reference src/ops/cache.cc): a ring of the last ``num_batches``
activations in op state and a staleness score, which the MoE examples
read (``FFModel.get_cache_score``) to trigger a recompile
(``core/recompile.py``). The output is the input.

The score is the mean absolute change against the cached batch of the
same ring slot, relative to that batch's mean magnitude, and 0 while the
ring warms up (its first ``num_batches`` batches), the JAX arithmetic.
The update is out of place, as the JAX package's functional one: a
forward that is run again (remat's recompute) reads the state it began
from.
"""

from __future__ import annotations

import torch

from flexflow_tpu_torch.ffconst import OpType
from flexflow_tpu_torch.ops.base import OpImpl, register_op


@register_op
class Cache(OpImpl):
    op_type = OpType.CACHE

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        return [input_specs[0]]

    @staticmethod
    def init_state(attrs, input_specs, device):
        (shape, _dtype) = input_specs[0]
        n = attrs.get("num_batches", 1)
        return {"cache": torch.zeros((n,) + tuple(shape),
                                     dtype=torch.float32, device=device),
                "batch_ctr": torch.zeros((), dtype=torch.int32,
                                         device=device),
                "score": torch.zeros((), dtype=torch.float32,
                                     device=device)}

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        x = inputs[0]
        st = ctx.state_in.get(ctx.layer_name)
        if st is not None:
            with torch.no_grad():
                ring, ctr = st["cache"], st["batch_ctr"]
                slot = (ctr % ring.shape[0]).long()
                prev = ring[slot]
                xf = x.detach().float()
                denom = torch.clamp_min(prev.abs().mean(), 1e-6)
                score = torch.where(ctr >= ring.shape[0],
                                    (xf - prev).abs().mean() / denom,
                                    torch.zeros_like(denom))
                ctx.state_out[ctx.layer_name] = {
                    "cache": ring.index_copy(0, slot.reshape(1), xf[None]),
                    "batch_ctr": ctr + 1, "score": score}
        return [x]
