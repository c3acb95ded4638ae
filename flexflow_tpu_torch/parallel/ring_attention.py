"""Sequence parallelism: ring attention and sequence-sharded serving
attention (counterpart of ``flexflow_tpu/parallel/ring_attention.py``).

Each rank of the ``seq`` axis holds a contiguous slice of the sequence.
``ring_attention_local`` is the blockwise ring recipe (Liu et al. 2023):
every rank keeps the flash-attention running state (max, denominator,
accumulator) for its query slice while the K/V slices rotate around the
ring (``ppermute_shift``), so the [S, S] score matrix never exists. It
is differentiable: an ``autograd.Function`` whose backward runs the ring
again with the blocks' dK/dV travelling beside them, the probabilities
recomputed from the forward's log-sum-exp (the training MHA's branch
under sequence parallelism, ``ops/attention.py``).

``seq_sharded_attend`` is what serving runs under sequence parallelism,
with the JAX function's contract: the queries are replicated and each
rank scores them against its ``S/deg`` cache rows; one ``pmax`` and two
``psum`` reconcile the softmax exactly. The scoring is the attention
kernels' own: each rank launches K1 or K2 on its rows in partials mode
(``kernels.attention.flash_attend_partials``: the unnormalised output
and each row's max and sum), and the three collectives reconcile those.
On CPU tensors the partials come from their plain version.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from flexflow_tpu_torch.parallel.collectives import (_shift, axis_size, pmax,
                                                     psum)

def _repeat_kv_heads(k, num_q_heads):
    """GQA: expand [b, s, kv_heads, d] to num_q_heads by repetition."""
    kvh = k.shape[2]
    if kvh == num_q_heads:
        return k
    assert num_q_heads % kvh == 0, (num_q_heads, kvh)
    return torch.repeat_interleave(k, num_q_heads // kvh, dim=2)


def ring_attention_local(q, k, v, mesh, axis_name: str = "seq",
                         causal: bool = True,
                         scale: Optional[float] = None):
    """Per-rank ring attention body: q, k, v are this rank's sequence
    slices [batch, s_local, heads, head_dim] (k/v may carry fewer heads:
    GQA). Returns [batch, s_local, heads, head_dim]. Differentiable: the
    backward runs the ring again (``_Ring``)."""
    h, d = q.shape[2], q.shape[3]
    k = _repeat_kv_heads(k, h)
    v = _repeat_kv_heads(v, h)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    return _Ring.apply(q, k, v, mesh, axis_name, causal, scale)


def _block_scores(qf, k_blk, qpos, kpos, causal):
    """[b, h, sq, sk] fp32 scores of the scaled queries against one K
    block, -inf where the causal mask hides a key."""
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.float())
    if causal:
        mask = qpos[:, None] >= kpos[None, :]
        scores = torch.where(mask[None, None], scores,
                             torch.tensor(-math.inf, device=qf.device))
    return scores


class _Ring(torch.autograd.Function):
    """Ring attention over the ``axis_name`` peers. Forward: the flash
    running state (max, denominator, accumulator) of this rank's queries
    while the K/V blocks rotate (i -> i+1). Backward: the reverse pass of
    flash attention over the same rotation, the probabilities recomputed
    from the saved log-sum-exp; each block's dK/dV accumulate on the
    ranks it visits and travel with it, and one more shift brings them
    home."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis_name, causal, scale):
        n = axis_size(mesh, axis_name)
        idx = mesh.index(axis_name) if mesh is not None else 0
        b, sq, h, d = q.shape
        sk = k.shape[1]
        dev = q.device
        qf = q.float() * scale
        qpos = idx * sq + torch.arange(sq, device=dev)
        o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=dev)
        m = torch.full((b, h, sq), -math.inf, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
        k_blk, v_blk = k, v
        for s in range(n):
            j = (idx - s) % n                # global chunk held this step
            kpos = j * sk + torch.arange(sk, device=dev)
            scores = _block_scores(qf, k_blk, qpos, kpos, causal)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            # exp(-inf - -inf) would be nan: fully masked entries give 0
            safe_m = torch.where(torch.isfinite(m_new), m_new,
                                 torch.zeros_like(m_new))
            p = torch.exp(torch.where(torch.isfinite(scores),
                                      scores - safe_m[..., None],
                                      torch.tensor(-math.inf, device=dev)))
            corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m),
                               torch.zeros_like(m))
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                   v_blk.float())
            m = m_new
            if s < n - 1:
                # rotate KV around the ring: i -> i+1 (receive i-1's)
                k_blk = _shift(k_blk, mesh, axis_name, 1)
                v_blk = _shift(v_blk, mesh, axis_name, 1)
        out = o / l.clamp(min=1e-30)[..., None]
        safe_m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        lse = safe_m + torch.log(l.clamp(min=1e-30))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (mesh, axis_name, causal, scale)
        return out.permute(0, 2, 1, 3).to(q.dtype)     # [b, sq, h, d]

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, axis_name, causal, scale = ctx.args
        n = axis_size(mesh, axis_name)
        idx = mesh.index(axis_name) if mesh is not None else 0
        sq, sk = q.shape[1], k.shape[1]
        dev = q.device
        do = g.float().permute(0, 2, 1, 3)              # [b, h, sq, d]
        delta = (do * out).sum(dim=-1)                  # [b, h, sq]
        qf = q.float() * scale
        qpos = idx * sq + torch.arange(sq, device=dev)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=dev)
        k_blk, v_blk = k, v
        dk = torch.zeros(k.shape, dtype=torch.float32, device=dev)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=dev)
        for s in range(n):
            j = (idx - s) % n
            kpos = j * sk + torch.arange(sk, device=dev)
            p = torch.exp(_block_scores(qf, k_blk, qpos, kpos, causal)
                          - lse[..., None])
            dv = dv + torch.einsum("bhqk,bhqd->bkhd", p, do)
            dp = torch.einsum("bhqd,bkhd->bhqk", do, v_blk.float())
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, k_blk.float())
            dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, qf)
            if s < n - 1:
                k_blk = _shift(k_blk, mesh, axis_name, 1)
                v_blk = _shift(v_blk, mesh, axis_name, 1)
            # the block's gradients travel with it; after the last step
            # this shift brings each block's home
            dk = _shift(dk, mesh, axis_name, 1)
            dv = _shift(dv, mesh, axis_name, 1)
        return ((dq * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None)


def dense_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None):
    """Plain attention over whole sequences [b, s, h, d] (GQA k/v)."""
    kk = _repeat_kv_heads(k, q.shape[2]).float()
    vv = _repeat_kv_heads(v, q.shape[2]).float()
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * s, kk)
    if causal:
        sq_, sk_ = q.shape[1], k.shape[1]
        mask = torch.ones((sq_, sk_), dtype=torch.bool,
                          device=q.device).tril(diagonal=sk_ - sq_)
        scores = torch.where(mask, scores,
                             torch.tensor(-math.inf, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vv).to(q.dtype)


def ring_attention(q, k, v, mesh, seq_axis: str = "seq",
                   causal: bool = True, scale: Optional[float] = None):
    """This rank's slices [batch, s_local, heads, head_dim] in and out;
    without a ``seq_axis`` of size > 1 the slices are the whole sequence
    and plain dense attention runs."""
    if axis_size(mesh, seq_axis) <= 1:
        return dense_attention(q, k, v, causal=causal, scale=scale)
    return ring_attention_local(q, k, v, mesh, seq_axis, causal=causal,
                                scale=scale)


def seq_sharded_attend(q, k_cache, v_cache, lengths, qpos, mesh,
                       seq_axis: str = "seq", bias=None, alibi=None,
                       append_kv=None, *, seq_len: Optional[int] = None,
                       causal=True, qk_scale=None, out_dtype=None):
    """Sequence-sharded serving attention over the KV cache.

    The dense contract of ``kernels.attention.flash_attend`` — q
    ``[R, Q, H, D]`` replicated, ``lengths [R]``, ``qpos [R, Q]``
    absolute positions, ALiBi slopes ``[H]``, ``append_kv`` (k_new,
    v_new, appos) at absolute positions — but ``k_cache``/``v_cache``
    are this rank's ``[R, KH, S/deg, D]`` rows (global rows ``idx*S/deg``
    on) and ``bias`` its ``[R, Q, S/deg]`` columns. K1 (K2 with
    ``append_kv``, whose row is written on the rank that holds it) runs
    on the rank's rows in partials mode, with lengths, qpos and appos
    less the rank's first row; the row max is reconciled with ``pmax``,
    then one ``psum`` sums the weighted denominators and one the weighted
    outputs, so the output is the unsharded attention's. ``seq_len`` is
    the global S (default: the local rows times the degree). Where the
    degree is 1 or does not divide ``seq_len``, the caches are whole on
    every rank and ``flash_attend`` runs. Returns [R, Q, H*D] in
    ``out_dtype``."""
    from flexflow_tpu_torch.kernels.attention import (combine_partials,
                                                      flash_attend,
                                                      flash_attend_partials)

    deg = axis_size(mesh, seq_axis)
    SL = k_cache.shape[2]
    S = seq_len if seq_len is not None else SL * deg
    if deg <= 1 or S % deg != 0:
        res = flash_attend(q, k_cache, v_cache, lengths, qpos, bias=bias,
                           alibi=alibi, append_kv=append_kv, causal=causal,
                           qk_scale=qk_scale, out_dtype=out_dtype)
        return res if append_kv is None else res[0]
    if SL * deg != S:
        raise ValueError(f"cache rows {SL} x {deg} ranks != S {S}")
    off = mesh.index(seq_axis) * SL
    if append_kv is not None:
        k_new, v_new, appos = append_kv
        local = appos - off
        append_kv = (k_new, v_new, torch.where(
            (appos >= 0) & (local >= 0) & (local < SL), local,
            torch.full_like(local, -1)))
    part_o, part_ml = flash_attend_partials(
        q, k_cache, v_cache, (lengths - off).clamp(0, SL), qpos - off,
        bias=bias, alibi=alibi, append_kv=append_kv, causal=causal,
        qk_scale=qk_scale)
    return combine_partials(part_o, part_ml, q.dtype, out_dtype,
                            reduce_max=lambda x: pmax(x, mesh, seq_axis),
                            reduce_sum=lambda x: psum(x, mesh, seq_axis))
