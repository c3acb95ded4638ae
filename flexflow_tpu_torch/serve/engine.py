"""Serving forwards and the multi-step decode block (counterpart of
``flexflow_tpu/serve/engine.py``; speculative engines arrive with a later
slice).

The JAX package runs the decode token-feedback loop as a jitted
``while_loop`` so the host reads back once per block. Here the block is a
Python loop over steps whose tokens stay on the device: each step's argmax
feeds the next step's input tensor directly, and the host reads the whole
``[R, n]`` block once at the end. CUDA graphs for the block are later
work.
"""

from __future__ import annotations

import torch

from flexflow_tpu_torch.ops.base import OpContext
from flexflow_tpu_torch.serve.batch_config import BatchMeta


def forward_with_meta(model, params, state, meta, compute_dtype,
                      kv_contiguous=False, kv_append_q=None):
    """One serving forward over a BatchMeta of device tensors.

    ``kv_contiguous=True`` promises every active row's append region
    [start, start+Q) is in bounds (the contiguous KV append applies).
    ``kv_append_q`` declares that only the first kv_append_q tokens per
    row are real: with 1, the KV append fuses into the attention kernel.
    Returns (final output, new_state)."""
    ctx = OpContext(compute_dtype=compute_dtype, batch_config=meta,
                    kv_contiguous=kv_contiguous, kv_append_q=kv_append_q)
    feeds = {model.input_tensors[0].tensor_id: meta.tokens}
    values, new_state = model._run_graph(params, feeds, ctx, state)
    return values[model._final_tensor.tensor_id], new_state


def _forward_tokens(model, params, state, tokens, positions, start_pos,
                    num_tokens, active, compute_dtype):
    """One engine-issued forward over [R, Q] tokens; returns (out,
    new_state). Engine forwards stage contiguous, in-bounds KV runs."""
    meta = BatchMeta(tokens=tokens, positions=positions, start_pos=start_pos,
                     num_tokens=num_tokens, active=active)
    return forward_with_meta(model, params, state, meta, compute_dtype,
                             kv_contiguous=True)


def make_decode_block(model, compute_dtype, max_steps: int, width: int = 1):
    """The multi-step decode program for ``model``.

    Signature: (params, op_state, tok [R], pos [R], active [R], n) ->
    (tokens [R, max_steps], new_op_state, last_tok [R]), all device
    tensors; only the first ``n <= max_steps`` columns are meaningful.
    ``pos[r]`` is the sequence index of the pending token ``tok[r]``.

    ``width > 1`` runs each step at the speculative verify pass's token
    width with one real token per row (verify-consistent decode); only
    the real token's KV is appended (kv_append_q=1), fused into the
    attention kernel."""

    def block(params, op_state, tok, pos, active, n):
        R = tok.shape[0]
        num = active.to(torch.int32)
        out = torch.zeros((R, max_steps), dtype=torch.int32,
                          device=tok.device)
        for i in range(int(n)):
            if width == 1:
                o, op_state = _forward_tokens(
                    model, params, op_state, tok[:, None], pos[:, None], pos,
                    num, active, compute_dtype)
            else:
                toks = torch.zeros((R, width), dtype=torch.int32,
                                   device=tok.device)
                toks[:, 0] = tok
                qpos = pos[:, None] + torch.arange(
                    width, dtype=torch.int32, device=tok.device)[None, :]
                meta = BatchMeta(tokens=toks, positions=qpos, start_pos=pos,
                                 num_tokens=num, active=active)
                o, op_state = forward_with_meta(
                    model, params, op_state, meta, compute_dtype,
                    kv_append_q=1)
            tok = o[:, 0].to(torch.int32)
            out[:, i] = tok
            pos = pos + 1
        return out, op_state, tok

    return block
