#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --phases 1,2,7   # one phase (1 and 2 build)

Phases (each fails loudly; the run exits non-zero if any fails):
  1. the card's name and power limit, torch/CUDA versions, TF32 off;
  2. build every CUDA kernel from ``flexflow_tpu_torch/kernels/csrc``
     with nvcc for sm_90a (one nvcc per source, all started together);
  3. kernel parity: K1 (``flash_attend``) and K2 (``flash_attend`` with
     the fused append) against their plain PyTorch versions on the card,
     at the serving path's shapes (prefill, decode, and the tree verify
     pass: K1 with a chain tree's bias, and with a width-2 beam tree's,
     whose siblings are masked) and on small shapes for the rest
     of their contract, split-S included (ragged lengths, the appended row
     in a later split, D = 64, fp32); the bitwise checks that a width-1
     decode, a width-8 decode and a K1 call give identical rows for the
     same query, and that K1 with a chain tree's bias gives the rows of
     K1 causal and of the width-8 decode; each kernel timed beside its
     bound, its plain version and ``scaled_dot_product_attention`` as a
     yardstick, then three long-cache rows (S 4096, lengths 4000) with
     bound share and GB/s, and beside every row the same timer around a
     PyTorch sum of the row's bytes (what the timer gives a pure read of
     that size); fp16 caches (prefill, decode, tree bias, ALiBi, GQA,
     split-S), each also showing that its limit rejects the same case
     computed at bf16 precision; every cache dtype with every other out
     dtype (K1, and K2 through split-S); head dims 32, 80 and 160
     (through the padded cache) and 256, fp32 among them, against the
     plain version on the unpadded inputs, with timed fp16 and D = 256
     rows; then K3 (``quant.qmatmul`` on a QuantizedWeight)
     against its plain version: int8 and int4, bf16, fp16 and fp32
     operands and results (all nine pairs), M in {1, 8, 64, 256}, the 7B
     int8 path's (K, N) plus an odd-K int4 case and N = 1000, the worst
     error of each pair and the bf16-precision controls that the fp16-
     and fp32-out limits must reject; rows of an
     M = 64 product bitwise equal to the same rows at M = 8 and M = 1;
     timed rows at M = 8, 64 and 256 beside the bound, the read floor,
     the plain version and ``torch.matmul`` on a dequantized bf16 copy of
     the weight;
  4. end-to-end parity: a 2-layer LLaMA at full 7B width in fp32, served
     greedily on the card and on the CPU with the same weights (one
     seeded numpy draw); the tokens must agree; then speculative
     inference on the card must give the CPU's incremental tokens, 128
     of 128, through the tree engine (one 1-layer draft, depth 4), the
     beam engine (a 1-layer beam draft of width 2, depth 3) and the host
     tree path (two beam drafts); and top-p sampling through
     ``LLM.generate`` must repeat its draws under one seed and, at
     top_p 1e-9 and temperature 1.0, give the card's greedy tokens; then
     int8 weights (the same draw, quantized on each device): incremental
     decoding, the chain engine (1-layer draft on the verifier's leaves,
     depth 4) and incremental decoding with gemm fusion on the card must
     each give the CPU's int8 incremental tokens, 128 of 128; then fp16
     weights, activations and cache (at most one request may differ, as
     the fp32 incremental pass) and head dim 32 (128 heads, fp32, the
     card's cache padded to 64; 128 of 128) against the CPU;
  5. the slice at full size: LLaMA-2-7B geometry in bf16 served through
     ``LLM(...).compile(...).generate(...)`` (8 requests x 32-token
     prompts, 64 new tokens); prints prefill ms, decode ms/step,
     tokens/s and peak memory, and checks that every attention call of
     the run launched K1 or K2 (L per step) and none ran the plain
     version;
  6. SpecInfer at full size, as ``bench.py`` runs it: the same verifier
     weights with deep layers damped, a 2-layer draft on the verifier's
     tensors, depth 7, through ``LLM(...).compile(ssms=[SSM(...)])``; an
     incremental and a spec pass (tokens/s, rounds, tokens per round,
     controller parks, spec_matches_incr, launches, peak memory); the
     first 30 tokens must match 8/8 and every verify round must launch
     K1 with the tree bias once per layer. The chain engine and a
     two-draft tree are timed and reported, not asserted;
  7. beam drafting and sampling at full size, on phase 6's verifier (no
     second 7B model): a greedy incremental pass; the beam engine (phase
     6's draft built as a width-2 beam draft, depth 3, the controller
     on) with tokens/s, rounds, tokens per request-round, parks, the
     match with incremental decoding (and the verifier's top-2 logit gap
     where it first differs) and peak memory, its K1-bias launches
     asserted at 32 a verify round + 2 a staged beam level and 0 plain
     calls; top-p sampling (topp 0.6, temperature 0.8) twice under one
     seed, which must repeat, with decode ms/step beside the greedy
     pass's; reported: the beam engine with the controller off (ms a
     round) beside the chain engine at the same depth (what beam search
     prunes), the device time of the argmax, top-p and beam heads on
     one step's logits, and the host tree path with two beam drafts; for
     the beam engine and the host tree path, where they first differ
     from incremental decoding (any position), the verifier's top-2
     logit gap there and the accepted nodes' staged cache positions;
  8. bench.py's headline: LLaMA-2-7B geometry with int8 weights through
     ``LLM(...).compile(quantization_type="int8", ssms=[SSM(...)])``
     (quantized per layer at compile; the deep layers damped through
     dequantize -> scale -> re-quantize; a 2-layer draft on the
     verifier's int8 leaves; depth 7, the controller on): incremental
     and spec passes with tokens/s, decode ms/step beside phase 5's bf16
     step and peak memory; gates: spec_matches_incr_first30 8/8, 7 x 32
     + 1 K3 launches a forward, no plain call of K1/K2/K3 on the card;
     reported: an int4 incremental pass and an int8 pass with gemm
     fusion.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the
repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12,           # dense tensor-core rate
              "float16": 989e12,
              "float32": 67e12}             # fp32 outside the tensor cores
# atol = rtol, as the CPU tests. fp16: two fp16 ulps of the output at any
# magnitude (2^-9 |y|) pass; a bf16-precision computation on the same fp16
# inputs must fail (each fp16 case checks its bf16 control against it)
TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 2e-3}
K1_SOURCE = "flexflow_tpu_torch/kernels/csrc/flash_attend.cu"
K1_REPLACES = "flexflow_tpu/kernels/attention.py:483"
K2_REPLACES = "flexflow_tpu/kernels/attention.py:514"
K3_SOURCE = "flexflow_tpu_torch/kernels/csrc/qmatmul.cu"
K3_REPLACES = "flexflow_tpu/quant.py:138"

# the slice at full size: LLaMA-2-7B geometry
VOCAB, HIDDEN, INTER, LAYERS, HEADS, KV_HEADS = 32000, 4096, 11008, 32, 32, 32
REQUESTS, PROMPT_LEN, MAX_SEQ, NEW_TOKENS = 8, 32, 256, 64
# phase 6 (bench.py:103-130): 2-layer truncation draft, deep layers damped,
# depth 7 (a B = 1 tree of 8 nodes: the decode width), 64 rounds a call
DRAFT_LAYERS, EPS, SPEC_DEPTH, SPEC_ROUNDS = 2, 0.01, 7, 64
# phase 7: phase 6's draft as a beam draft of width 2, depth 3 (7 nodes:
# the decode width 8 once padded)
BEAM_WIDTH, BEAM_DEPTH = 2, 3
VERIFY_START = 92      # phase 3's verify row: a chain staged at 92..99


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0].strip()


# ----------------------------------------------------------------------
# timing helpers
# ----------------------------------------------------------------------
class Timer:
    """Median time of a CUDA call, each launch after an L2 flush (the
    serving path meets each layer's cache cold)."""

    def __init__(self, torch):
        self.torch = torch
        # 512 MiB: the flush also keeps the device busy while the host
        # runs the wrapper, so the events time the kernel, not the host
        self.flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def attention_bound_ms(torch, q, lengths, qpos, S, KH, causal, cache_dtype,
                       extra_bytes=0, bias=None):
    """Least time for the work this call's data needs: each valid cache
    row of K and V read once, q read and the output written once, plus
    ``extra_bytes`` and the bias read once; against the visible (query,
    key) pairs' FLOPs (q.k and p.v, 2 each per element of D). Returns
    (ms, "bytes"|"operations", the bytes counted)."""
    R, Q, H, D = q.shape
    L = lengths.clamp(0, S).to(torch.int64)
    isz = torch.empty((), dtype=cache_dtype).element_size()
    nbytes = (2 * int(L.sum()) * KH * D * isz
              + q.numel() * q.element_size() * 2 + extra_bytes)
    s = torch.arange(S, device=q.device)
    vis = s[None, None, :] < L[:, None, None]
    if causal:
        vis = vis & (s[None, None, :] <= qpos[:, :, None])
    if bias is not None:
        nbytes += bias.numel() * bias.element_size()
        vis = vis & (bias == 0)
    flops = 4 * D * H * int(vis.sum())
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(cache_dtype).replace("torch.", "")]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


# ----------------------------------------------------------------------
# phase 3: kernel parity
# ----------------------------------------------------------------------
def chain_tree_bias(torch, start, S, T=8):
    """The verify pass's [R, T, S] bias for a chain of T nodes staged at
    ``start`` (what the tree engine at B = 1 builds), from the port's own
    functions."""
    import numpy as np

    from flexflow_tpu_torch.ops.inc_attention import tree_bias
    from flexflow_tpu_torch.serve.batch_config import \
        ancestor_mask_from_parents

    parent = np.arange(-1, T - 1)[None].repeat(start.shape[0], 0)
    anc = torch.tensor(ancestor_mask_from_parents(parent),
                       device=start.device)
    return tree_bias(anc, start, S)


def beam_tree_bias(torch, start, S, width=2, depth=3, seed=0):
    """A beam tree's [R, T, S] bias and node depths [T] (T = the tree
    padded to 8): node 0 the root, level t's ``width`` nodes at
    1 + t*width, each child of a node of the level before, picked per
    row from a seeded draw; a node sees the prefix and its own path, not
    its siblings' subtrees. Built by the port's own functions."""
    import numpy as np

    from flexflow_tpu_torch.ops.inc_attention import tree_bias
    from flexflow_tpu_torch.serve.batch_config import \
        ancestor_mask_from_parents

    R, T = start.shape[0], -(-(1 + width * depth) // 8) * 8
    rng = np.random.default_rng(seed)
    parent = np.full((R, T), -1, np.int64)
    node_depth = np.zeros((T,), np.int32)
    for t in range(depth):
        lvl = 1 + t * width
        prev = [0] if t == 0 else list(range(lvl - width, lvl))
        parent[:, lvl:lvl + width] = rng.choice(prev, (R, width))
        node_depth[lvl:lvl + width] = t + 1
    anc = torch.tensor(ancestor_mask_from_parents(parent),
                       device=start.device)
    return (tree_bias(anc, start, S),
            torch.tensor(node_depth, device=start.device))


def invariance_check(torch, ivec, mk):
    """Bitwise: over the same post-append cache, the real query's rows of a
    width-1 decode (K2), a width-8 decode (K2) and a K1 call (causal=False,
    zero bias) are identical, and a K1 call with a chain tree's bias gives
    the rows of a causal K1 call on all 8 queries and the width-8 decode's
    row 0 — speculative verify against incremental decode rests on it. At
    the slice's shape (one split) and at a split-S shape with GQA (the
    real rows sit at other rows of the tile)."""
    from flexflow_tpu_torch.kernels.attention import append_at, flash_attend

    dev = "cuda"
    for R, H, KH, S, app in ((8, 32, 32, 256, 63), (2, 8, 4, 1024, 700)):
        D, bf = 128, torch.bfloat16
        q8, k, v = mk(R, 8, H, KH, D, S, bf, 21)
        g = torch.Generator(device=dev).manual_seed(22)
        kn = torch.randn((R, 1, KH, D), generator=g, device=dev).to(bf)
        vn = torch.randn((R, 1, KH, D), generator=g, device=dev).to(bf)
        appos = ivec([app - 3 * r for r in range(R)])
        lengths = appos + 1
        qpos8 = appos[:, None] + torch.arange(8, dtype=torch.int32,
                                              device=dev)[None]
        k1c, v1c = k.clone(), v.clone()
        out1 = flash_attend(q8[:, :1].contiguous(), k1c, v1c, lengths,
                            appos[:, None].contiguous(),
                            append_kv=(kn, vn, appos))[0]
        k8c, v8c = k.clone(), v.clone()
        out8 = flash_attend(q8, k8c, v8c, lengths, qpos8,
                            append_kv=(kn, vn, appos))[0]
        append_at(k, v, kn, vn, appos)
        outk1 = flash_attend(q8, k, v, lengths, qpos8, causal=False,
                             bias=torch.zeros((R, 8, S), device=dev))
        torch.cuda.synchronize()
        same = (torch.equal(out1[:, 0], out8[:, 0])
                and torch.equal(out8[:, 0], outk1[:, 0]))
        log(f"  invariance R{R} H{H} KH{KH} S{S}: width-1 == width-8 == K1 "
            f"bitwise: {same} {'PASS' if same else 'FAIL'}")
        if not same:
            raise AssertionError("width/K1-vs-K2 bitwise invariance failed")
        # the chain tree staged at appos..appos+7, as the verify pass does
        lens8 = appos + 8
        outb = flash_attend(q8, k, v, lens8, qpos8, causal=False,
                            bias=chain_tree_bias(torch, appos, S))
        outc = flash_attend(q8, k, v, lens8, qpos8)
        torch.cuda.synchronize()
        same = (torch.equal(outb, outc)
                and torch.equal(outb[:, 0], out8[:, 0]))
        log(f"  invariance R{R} H{H} KH{KH} S{S}: K1 chain-tree bias == K1 "
            f"causal (8 rows) == width-8 decode (row 0) bitwise: {same} "
            f"{'PASS' if same else 'FAIL'}")
        if not same:
            raise AssertionError("tree-bias vs causal bitwise invariance "
                                 "failed")


def head_dim_cases(torch, ivec, mk, compare, bf16_control):
    """K1 and K2 at head dims the kernels take directly (256) and through
    the padded cache (32 -> 64, 80 -> 128, 160 -> 256:
    ``ops/inc_attention.py`` ``cache_head_dim``), bf16, fp16 and fp32
    (fp32 at D = 256: the scalar kernel's largest shared-memory tile),
    each against the plain version on the same unpadded inputs (softmax
    scale 1/sqrt(D) of the real D)."""
    from flexflow_tpu_torch.kernels.attention import (append_at,
                                                      flash_attend,
                                                      reference_attend)
    from flexflow_tpu_torch.ops.inc_attention import (cache_head_dim,
                                                      pad_head_dim)

    dev = "cuda"
    for D, dt in ((32, torch.bfloat16), (80, torch.float16),
                  (256, torch.bfloat16), (256, torch.float16),
                  (256, torch.float32), (160, torch.float32)):
        Dp = cache_head_dim(D, pad=True)
        R, Q, H, KH, S = 4, 16, 8, 4, 512
        q, k, v = mk(R, Q, H, KH, D, S, dt, 70 + D)
        lengths = ivec([300, 17, 512, 64])
        qpos = lengths[:, None] - Q + torch.arange(
            Q, dtype=torch.int32, device=dev)[None]
        scale = 1.0 / D ** 0.5
        kp, vp = pad_head_dim(k, Dp), pad_head_dim(v, Dp)
        out = flash_attend(pad_head_dim(q, Dp), kp, vp, lengths, qpos,
                           qk_scale=scale)
        out = out.reshape(R, Q, H, Dp)[..., :D].reshape(R, Q, H * D)
        torch.cuda.synchronize()
        ref = reference_attend(q, k, v, lengths, qpos, qk_scale=scale)
        h16 = dt == torch.float16
        compare(f"K1 D={D} (cache D {Dp}) {str(dt)[6:]}", ref, out, lengths,
                dt, bf16_control(q, k, v, lengths, qpos, qk_scale=scale)
                if h16 else None)
        g = torch.Generator(device=dev).manual_seed(80 + D)
        kn = torch.randn((R, 1, KH, D), generator=g, device=dev).to(dt)
        vn = torch.randn((R, 1, KH, D), generator=g, device=dev).to(dt)
        appos = lengths - 1
        q1 = q[:, :1].contiguous()
        out, _, _ = flash_attend(pad_head_dim(q1, Dp), kp, vp, lengths,
                                 appos[:, None].contiguous(),
                                 append_kv=(pad_head_dim(kn, Dp),
                                            pad_head_dim(vn, Dp), appos),
                                 qk_scale=scale)
        out = out.reshape(R, 1, H, Dp)[..., :D].reshape(R, 1, H * D)
        torch.cuda.synchronize()
        append_at(k, v, kn, vn, appos)
        if not (torch.equal(kp[..., :D], k) and bool((kp[..., D:] == 0).all())):
            raise AssertionError(f"K2 D={D}: padded cache after the append "
                                 "differs from the plain append")
        ref = reference_attend(q1, k, v, lengths, appos[:, None],
                               qk_scale=scale)
        compare(f"K2 D={D} (cache D {Dp}) {str(dt)[6:]}", ref, out, lengths,
                dt, bf16_control(q1, k, v, lengths, appos[:, None],
                                 qk_scale=scale) if h16 else None)


def kernel_phase(torch, timer):
    from flexflow_tpu_torch import kernels
    from flexflow_tpu_torch.kernels.attention import (NEG_INF, append_at,
                                                      flash_attend,
                                                      reference_attend,
                                                      split_attend, split_plan)
    import numpy as np
    import torch.nn.functional as F

    dev = "cuda"

    def mk(R, Q, H, KH, D, S, dtype, seed, L=None):
        g = torch.Generator(device=dev).manual_seed(seed)
        lead = () if L is None else (L,)

        def r(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dtype)

        return r(R, Q, H, D), r(*lead, R, KH, S, D), r(*lead, R, KH, S, D)

    def ivec(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    def compare(name, ref, out, lengths, dtype, control=None):
        """out against ref, |err| <= tol (1 + |ref|) on active rows. With
        ``control`` (a bf16-precision computation of the same fp16 case),
        also show that the same limit rejects it."""
        act = lengths > 0
        tol = TOL[str(dtype).replace("torch.", "")]
        rf = ref.float()[act]

        def min_tol(o):   # the least tol at which o passes
            return float(((rf - o.float()[act]).abs() / (1 + rf.abs())).max())

        err = (rf - out.float()[act]).abs()
        ok = (not bool((err > tol + tol * rf.abs()).any())
              and bool(torch.isfinite(out.float()).all()))
        zeros_ok = bool((out[~act] == 0).all())
        ctl = "" if control is None else (
            f" bf16_control_min_tol={min_tol(control):.3e}")
        ctl_ok = control is None or min_tol(control) > tol
        log(f"  {name:34s} max_abs_err={float(err.max()):.3e} "
            f"min_tol={min_tol(out):.3e} tol={tol:g}{ctl} "
            f"len0_rows_zero={zeros_ok} "
            f"{'PASS' if ok and zeros_ok and ctl_ok else 'FAIL'}")
        if not (ok and zeros_ok):
            raise AssertionError(f"kernel parity failed: {name}")
        if not ctl_ok:
            raise AssertionError(f"{name}: the fp16 limit does not reject "
                                 "a bf16-precision computation")
        return float(err.max())

    def coarser(dtype, out_dtype):
        """The dtype whose tolerance holds a cache-dtype result rounded to
        out_dtype: the coarser of the two."""
        rank = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
        return max(dtype, out_dtype or dtype, key=rank.__getitem__)

    def bf16_control(q, k, v, lengths, qpos, **kw):
        """The plain version at bf16 precision on fp16 inputs (q, K, V, P
        and the output rounded to bf16; out in fp16)."""
        b16 = torch.bfloat16
        return reference_attend(q.to(b16), k.to(b16), v.to(b16), lengths,
                                qpos, out_dtype=torch.float16, **kw)

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def split_check(name, q, k, v, lengths, qpos, out, dtype, **kw):
        """Where this shape splits S on this card, the kernel also against
        the plain split + combine with the same plan."""
        R_, KH_, S_ = k.shape[0], k.shape[1], k.shape[2]
        plan = split_plan(R_, KH_, S_, sms)
        if plan[0] > 1:
            compare(f"  {name[:22]} vs split plain {plan}",
                    split_attend(q, k, v, lengths, qpos, plan=plan, **kw),
                    out, lengths, dtype)

    def k1_case(name, R, Q, H, KH, D, S, dtype, lengths, qpos, seed,
                bias=None, alibi=None, causal=True, out_dtype=None):
        q, k, v = mk(R, Q, H, KH, D, S, dtype, seed)
        out = flash_attend(q, k, v, lengths, qpos, bias=bias, alibi=alibi,
                           causal=causal, out_dtype=out_dtype)
        torch.cuda.synchronize()
        kw = dict(bias=bias, alibi=alibi, causal=causal)
        ref = reference_attend(q, k, v, lengths.clamp(max=S), qpos,
                               out_dtype=out_dtype, **kw)
        if out.dtype != (out_dtype or dtype):
            raise AssertionError(f"{name}: out is {out.dtype}")
        tdt = coarser(dtype, out_dtype)
        split_check(name, q, k, v, lengths, qpos, out, tdt,
                    out_dtype=out_dtype, **kw)
        ctl = (bf16_control(q, k, v, lengths.clamp(max=S), qpos, **kw)
               if dtype == torch.float16 and out_dtype is None else None)
        return compare(name, ref, out, lengths, tdt, ctl), (q, k, v)

    def k2_case(name, R, Q, H, KH, D, S, dtype, appos, seed, L=None,
                layer_idx=None, out_dtype=None):
        q, k, v = mk(R, Q, H, KH, D, S, dtype, seed, L)
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        kn = torch.randn((R, 1, KH, D), generator=g, device=dev).to(dtype)
        vn = torch.randn((R, 1, KH, D), generator=g, device=dev).to(dtype)
        lengths = torch.where(appos >= 0, appos + 1, torch.zeros_like(appos))
        qpos = appos.clamp(min=0)[:, None] + torch.arange(
            Q, dtype=torch.int32, device=dev)[None]
        k_ref, v_ref = k.clone(), v.clone()
        out, k_out, v_out = flash_attend(q, k, v, lengths, qpos,
                                         append_kv=(kn, vn, appos),
                                         layer_idx=layer_idx,
                                         out_dtype=out_dtype)
        torch.cuda.synchronize()
        append_at(k_ref, v_ref, kn, vn, appos, layer_idx=layer_idx)
        kl = k_ref if layer_idx is None else k_ref[layer_idx]
        vl = v_ref if layer_idx is None else v_ref[layer_idx]
        ref = reference_attend(q, kl, vl, lengths, qpos, out_dtype=out_dtype)
        if out.dtype != (out_dtype or dtype):
            raise AssertionError(f"{name}: out is {out.dtype}")
        if not (torch.equal(k_out, k_ref) and torch.equal(v_out, v_ref)):
            raise AssertionError(f"{name}: cache after the fused append "
                                 "differs from the plain append")
        if k_out.data_ptr() != k.data_ptr():
            raise AssertionError(f"{name}: the append was not in place")
        tdt = coarser(dtype, out_dtype)
        split_check(name, q, kl, vl, lengths, qpos, out, tdt,
                    out_dtype=out_dtype)
        ctl = (bf16_control(q, kl, vl, lengths, qpos)
               if dtype == torch.float16 and out_dtype is None else None)
        err = compare(name + " (cache bitwise ok)", ref, out, lengths, tdt,
                      ctl)
        return err, (q, k, v, kn, vn, lengths, qpos)

    bf, f32 = torch.bfloat16, torch.float32
    log("phase 3: kernel parity (kernel vs plain PyTorch version, on the "
        "card; atol = rtol)")
    # --- the serving path's shapes: R=8, H=KH=32, D=128, S=256, bf16 ---
    R, H, KH, D, S = REQUESTS, HEADS, KV_HEADS, HIDDEN // HEADS, MAX_SEQ
    Qp = 64     # prefill chunk: max_tokens_per_batch 256 // min(R, 4)
    pre_len = ivec([PROMPT_LEN - 1] * R)   # all but the pending token
    pre_qpos = torch.arange(Qp, dtype=torch.int32, device=dev)[None].repeat(
        R, 1)
    k1_err, (q1, k1, v1) = k1_case("K1 prefill R8 Q64 H32 D128 S256",
                                   R, Qp, H, KH, D, S, bf, pre_len,
                                   pre_qpos, 1)
    appos_main = ivec([PROMPT_LEN + 31] * R)   # mid-generation decode step
    k2_err, k2_args = k2_case("K2 decode  R8 Q8 stacked L32 idx5", R, 8, H,
                              KH, D, S, bf, appos_main, 2, L=LAYERS,
                              layer_idx=5)
    # tree verify: a depth-7 chain staged at 92..99 (lengths 100)
    vstart = ivec([VERIFY_START] * R)
    v_qpos = vstart[:, None] + torch.arange(8, dtype=torch.int32,
                                            device=dev)[None]
    v_len = vstart + 8
    v_bias = chain_tree_bias(torch, vstart, S)
    kv_err, (qv, kv, vv) = k1_case("K1 verify R8 Q8 chain-tree bias", R, 8,
                                   H, KH, D, S, bf, v_len, v_qpos, 20,
                                   bias=v_bias, causal=False)
    # the beam engine's verify: a width-2 depth-3 beam tree (7 nodes of
    # the 8-wide pass; siblings' subtrees masked) staged at the same place
    for name, R_, H_, KH_, D_, S_, dt, st in (
            ("K1 verify R8 Q8 beam-tree bias", R, H, KH, D, S, bf, vstart),
            ("K1 beam-tree bias fp32 GQA", 3, 8, 4, 64, 128, f32,
             ivec([40, 7, 100]))):
        b_bias, b_depth = beam_tree_bias(torch, st, S_, seed=R_)
        k1_case(name, R_, 8, H_, KH_, D_, S_, dt, st + 7,
                st[:, None] + b_depth[None], 23 + R_, bias=b_bias,
                causal=False)
    # --- the rest of the contract, small shapes ---
    k1_case("K1 GQA G=4 S=200 (ragged tile)", 3, 5, 16, 4, 128, 200, bf,
            ivec([200, 77, 1]), ivec([[195 + i for i in range(5)],
                                      [72 + i for i in range(5)],
                                      [0] * 5]), 3)
    k1_case("K1 D=64 prefill", 2, 16, 8, 8, 64, 256, bf, ivec([16, 9]),
            torch.arange(16, dtype=torch.int32, device=dev)[None].repeat(
                2, 1), 4)
    rng = np.random.RandomState(7)
    tb = np.where(rng.rand(2, 16, 256) < 0.4, NEG_INF, 0.0).astype(
        np.float32)
    tb[:, :, 0] = 0.0
    k1_case("K1 tree bias + ALiBi, causal=False", 2, 16, 8, 4, 128, 256,
            f32, ivec([100, 60]),
            ivec([[i + 40 for i in range(16)], [i + 20 for i in range(16)]]),
            5, bias=torch.tensor(tb, device=dev),
            alibi=torch.tensor((rng.rand(8) * 0.2).astype(np.float32),
                               device=dev), causal=False)
    k1_case("K1 lengths 0 and > S (clamped)", 3, 1, 4, 4, 64, 128, bf,
            ivec([0, 300, 50]), ivec([[0], [127], [49]]), 6)
    k1_case("K1 fp32 prefill", 2, 32, 8, 8, 64, 128, f32, ivec([32, 7]),
            torch.arange(32, dtype=torch.int32, device=dev)[None].repeat(
                2, 1), 8)
    k2_case("K2 appos=-1 row, fp32", 4, 8, 8, 4, 128, 256, f32,
            ivec([37, 0, 255, -1]), 9)
    k2_case("K2 bf16 D=64 GQA", 3, 1, 8, 2, 64, 256, bf, ivec([5, 130, 64]),
            10)
    # --- split-S (R*KH small against the SM count, long S) ---
    for R_, KH_, S_ in ((2, 4, 1024), (1, 2, 2048)):
        log(f"  split plan R{R_} KH{KH_} S{S_} on {sms} SMs: "
            f"(n_split, tiles/split) = {split_plan(R_, KH_, S_, sms)}")
    chunk = torch.arange(16, dtype=torch.int32, device=dev)[None]
    k1_case("K1 split-S ragged lengths", 2, 16, 8, 4, 128, 1024, bf,
            ivec([1000, 300]), ivec([[984], [284]]) + chunk, 11)
    k1_case("K1 split-S len at split boundary", 2, 16, 8, 4, 128, 1024, bf,
            ivec([512, 256]), ivec([[496], [240]]) + chunk, 12)
    k1_case("K1 split-S lengths 0 and > S", 2, 1, 8, 4, 128, 1024, bf,
            ivec([0, 1500]), ivec([[0], [1023]]), 13)
    k2_case("K2 split-S appos in split 2", 2, 8, 8, 4, 128, 1024, bf,
            ivec([700, 130]), 14)
    k2_case("K2 split-S D=64 stacked", 1, 8, 8, 2, 64, 2048, bf,
            ivec([1500]), 15, L=3, layer_idx=2)
    k1_case("K1 split-S fp32 tree bias", 2, 4, 4, 2, 64, 1024, f32,
            ivec([1024, 513]), ivec([[1020 + i for i in range(4)],
                                     [509 + i for i in range(4)]]), 16,
            bias=torch.where(torch.rand(
                (2, 4, 1024), device=dev,
                generator=torch.Generator(device=dev).manual_seed(16)) < 0.3,
                NEG_INF, 0.0), causal=False)
    k2_case("K2 split-S fp32 appos=-1 row", 2, 8, 8, 4, 64, 1024, f32,
            ivec([777, -1]), 17)
    # --- fp16 caches: the serving shapes, then the rest of the contract ---
    h16 = torch.float16
    k1_case("K1 fp16 prefill R8 Q64 H32 D128", R, Qp, H, KH, D, S, h16,
            pre_len, pre_qpos, 60)
    k2_case("K2 fp16 decode R8 Q8 stacked idx5", R, 8, H, KH, D, S, h16,
            appos_main, 61, L=LAYERS, layer_idx=5)
    k1_case("K1 fp16 verify chain-tree bias", R, 8, H, KH, D, S, h16, v_len,
            v_qpos, 62, bias=v_bias, causal=False)
    k1_case("K1 fp16 tree bias + ALiBi", 2, 16, 8, 4, 128, 256, h16,
            ivec([100, 60]),
            ivec([[i + 40 for i in range(16)], [i + 20 for i in range(16)]]),
            63, bias=torch.tensor(tb, device=dev),
            alibi=torch.tensor((rng.rand(8) * 0.2).astype(np.float32),
                               device=dev), causal=False)
    k1_case("K1 fp16 GQA G=4 S=200 (ragged tile)", 3, 5, 16, 4, 128, 200,
            h16, ivec([200, 77, 1]), ivec([[195 + i for i in range(5)],
                                           [72 + i for i in range(5)],
                                           [0] * 5]), 64)
    k2_case("K2 fp16 split-S GQA D=64", 2, 8, 8, 4, 64, 1024, h16,
            ivec([700, 130]), 65)
    # --- every cache dtype with every other out dtype (the serving path's
    #     out is the activations' dtype, the cache's is kv_cache_dtype) ---
    for i, (cdt, odt) in enumerate((c, o) for c in (bf, h16, f32)
                                   for o in (bf, h16, f32) if c != o):
        tag = f"{str(cdt)[6:]} cache -> {str(odt)[6:]} out"
        k1_case(f"K1 {tag}", 2, 16, 8, 4, 128, 256, cdt, ivec([100, 60]),
                ivec([[j + 84 for j in range(16)],
                      [j + 44 for j in range(16)]]), 90 + i,
                out_dtype=odt)
        # split-S: the combine launch writes out
        k2_case(f"K2 split-S {tag}", 3, 1, 8, 2, 64, 1024, cdt,
                ivec([5, 700, 1000]), 100 + i, out_dtype=odt)
    head_dim_cases(torch, ivec, mk, compare, bf16_control)
    invariance_check(torch, ivec, mk)

    # --- times at the serving path's shapes ---
    log("  timing at the serving path's shapes (median of 20, L2 flushed "
        "before each launch)")
    rows = []

    def sdpa_call(q, kc, vc, lengths, qpos, bias=None):
        qh = q.transpose(1, 2)                          # [R, H, Q, D]
        s = torch.arange(kc.shape[-2], device=dev)
        mask = s[None, None, :] < lengths[:, None, None]
        mask = (mask & (s[None, None, :] <= qpos[:, :, None])
                if bias is None else mask & (bias == 0))[:, None]
        gqa = q.shape[2] != kc.shape[1]
        return lambda: F.scaled_dot_product_attention(
            qh, kc, vc, attn_mask=mask, enable_gqa=gqa)

    ms1 = timer(lambda: flash_attend(q1, k1, v1, pre_len, pre_qpos))
    pl1 = timer(lambda: reference_attend(q1, k1, v1, pre_len, pre_qpos))
    lib1 = timer(sdpa_call(q1, k1, v1, pre_len, pre_qpos))
    b1, by1, nb1 = attention_bound_ms(torch, q1, pre_len, pre_qpos, S, KH,
                                      True, bf)
    rows.append(dict(name="flash_attend", route="cuda", source=K1_SOURCE,
                     replaces=K1_REPLACES, max_abs_err=k1_err, ms=ms1,
                     plain_ms=pl1, bound_ms=b1, bound_by=by1,
                     library_ms=lib1))
    q2, k2, v2, kn, vn, len2, qp2 = k2_args

    def k2_plain():
        append_at(k2, v2, kn, vn, appos_main, layer_idx=5)
        return reference_attend(q2, k2[5], v2[5], len2, qp2)

    ms2 = timer(lambda: flash_attend(q2, k2, v2, len2, qp2,
                                     append_kv=(kn, vn, appos_main),
                                     layer_idx=5))
    pl2 = timer(k2_plain)
    lib2 = timer(sdpa_call(q2, k2[5], v2[5], len2, qp2))
    # the append reads k_new/v_new once and writes them once
    b2, by2, nb2 = attention_bound_ms(torch, q2, len2, qp2, S, KH, True, bf,
                                      extra_bytes=4 * kn.numel() * 2)
    rows.append(dict(name="flash_attend_append", route="cuda",
                     source=K1_SOURCE, replaces=K2_REPLACES,
                     max_abs_err=k2_err, ms=ms2, plain_ms=pl2, bound_ms=b2,
                     bound_by=by2, library_ms=lib2))
    msv = timer(lambda: flash_attend(qv, kv, vv, v_len, v_qpos, bias=v_bias,
                                     causal=False))
    plv = timer(lambda: reference_attend(qv, kv, vv, v_len, v_qpos,
                                         bias=v_bias, causal=False))
    libv = timer(sdpa_call(qv, kv, vv, v_len, v_qpos, bias=v_bias))
    bv, byv, nbv = attention_bound_ms(torch, qv, v_len, v_qpos, S, KH, False,
                                      bf, bias=v_bias)
    rows.append(dict(name="flash_attend_bias", route="cuda",
                     source=K1_SOURCE, replaces=K1_REPLACES,
                     max_abs_err=kv_err, ms=msv, plain_ms=plv, bound_ms=bv,
                     bound_by=byv, library_ms=libv))
    # what this timer gives work that is not attention: a one-element
    # kernel, and a PyTorch sum reading a row's bytes once
    tiny = torch.zeros(1, device=dev)
    floor_ms = timer(lambda: tiny.add_(1))

    def read_floor(nbytes):
        buf = torch.ones(nbytes // 2, dtype=bf, device=dev)
        ms = timer(lambda: buf.sum())
        del buf
        return ms

    log(f"  timer floor (one-element kernel): {floor_ms:.4f} ms")
    for r, nb_ in zip(rows, (nb1, nb2, nbv)):
        log(f"  {r['name']:20s} kernel {r['ms']:.4f} ms | bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}) | plain "
            f"{r['plain_ms']:.4f} ms | sdpa {r['library_ms']:.4f} ms | "
            f"sum over the same bytes {read_floor(nb_):.4f} ms")
    del q1, k1, v1, k2_args, q2, k2, v2, qv, kv, vv

    # --- long caches at LLaMA-2-7B's 4096-position context (timed only,
    #     beside SDPA; each also checked once against the plain version) ---
    log("  long-cache rows: S 4096, lengths 4000 (median of 20, L2 flushed "
        "before each launch)")
    long_rows = []

    def long_row(name, fn, sdpa, bound):
        ms, lib = timer(fn), timer(sdpa)
        b, by, nbytes = bound
        rd = read_floor(nbytes)
        long_rows.append(dict(name=name, ms=ms, sdpa_ms=lib, bound_ms=b,
                              bound_by=by, bound_share=b / ms,
                              gb_per_s=nbytes / ms / 1e6, read_floor_ms=rd))
        log(f"  {name:34s} kernel {ms:.4f} ms | bound {b:.4f} ms ({by}), "
            f"{100 * b / ms:.1f}% | {nbytes / ms / 1e6:.0f} GB/s | sdpa "
            f"{lib:.4f} ms | sum over the same bytes {rd:.4f} ms")

    S_l, len_l = 4096, 4000
    for R_ in (8, 1):
        name = f"K2 long R{R_} Q8 S4096 len4000"
        app_l = ivec([len_l - 1] * R_)
        _, (q, k, v, kn_, vn_, ln, qp) = k2_case(name, R_, 8, H, KH, D, S_l,
                                                 bf, app_l, 30 + R_)
        long_row(name, lambda: flash_attend(q, k, v, ln, qp,
                                            append_kv=(kn_, vn_, app_l)),
                 sdpa_call(q, k, v, ln, qp),
                 attention_bound_ms(torch, q, ln, qp, S_l, KH, True, bf,
                                    extra_bytes=4 * kn_.numel() * 2))
        del q, k, v
    name = "K1 long R8 Q64 qpos 3936..3999"
    ln = ivec([len_l] * R)
    qp = (torch.arange(Qp, dtype=torch.int32, device=dev)
          + len_l - Qp)[None].repeat(R, 1)
    _, (q, k, v) = k1_case(name, R, Qp, H, KH, D, S_l, bf, ln, qp, 40)
    long_row(name, lambda: flash_attend(q, k, v, ln, qp),
             sdpa_call(q, k, v, ln, qp),
             attention_bound_ms(torch, q, ln, qp, S_l, KH, True, bf))
    del q, k, v
    targets = [("K1 faster than SDPA at the slice shape", ms1 < lib1),
               ("K2 within 4x of its bound at the slice shape",
                ms2 <= 4 * b2)]
    targets += [(f"{r['name']} at >= 50% of its bound",
                 r["bound_share"] >= 0.5) for r in long_rows]
    for name, met in targets:
        log(f"  target: {name}: {'met' if met else 'MISSED'}")
    log(json.dumps({"long_cache_rows": long_rows}))

    # --- fp16 caches and head dim 256 at the serving shapes (timed only,
    #     each also checked once against the plain version): the same
    #     cache bytes as the bf16 D = 128 rows above (D 256: 16 heads) ---
    log("  fp16 and D = 256 rows (median of 20, L2 flushed before each "
        "launch)")
    dim_rows = []
    for dt, H_, D_ in ((h16, H, D), (bf, H // 2, 2 * D), (h16, H // 2, 2 * D)):
        tag = f"{str(dt)[6:]} H{H_} D{D_}"
        _, (q, k, v) = k1_case(f"K1 prefill {tag}", R, Qp, H_, H_, D_, S, dt,
                               pre_len, pre_qpos, 90 + D_)
        b, by, nbytes = attention_bound_ms(torch, q, pre_len, pre_qpos, S, H_,
                                           True, dt)
        dim_rows.append(dict(
            name=f"K1 prefill R8 Q64 {tag} S256", ms=timer(
                lambda: flash_attend(q, k, v, pre_len, pre_qpos)),
            plain_ms=timer(lambda: reference_attend(q, k, v, pre_len,
                                                    pre_qpos)),
            sdpa_ms=timer(sdpa_call(q, k, v, pre_len, pre_qpos)),
            bound_ms=b, bound_by=by, read_floor_ms=read_floor(nbytes)))
        _, (q, k, v, kn_, vn_, ln, qp) = k2_case(
            f"K2 decode {tag}", R, 8, H_, H_, D_, S, dt, appos_main, 95 + D_)
        b, by, nbytes = attention_bound_ms(torch, q, ln, qp, S, H_, True, dt,
                                           extra_bytes=4 * kn_.numel() * 2)
        dim_rows.append(dict(
            name=f"K2 decode R8 Q8 {tag} S256", ms=timer(
                lambda: flash_attend(q, k, v, ln, qp,
                                     append_kv=(kn_, vn_, appos_main))),
            plain_ms=timer(lambda: reference_attend(q, k, v, ln, qp)),
            sdpa_ms=timer(sdpa_call(q, k, v, ln, qp)),
            bound_ms=b, bound_by=by, read_floor_ms=read_floor(nbytes)))
        del q, k, v
    for r in dim_rows:
        log(f"  {r['name']:34s} kernel {r['ms']:.4f} ms | bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}) | plain "
            f"{r['plain_ms']:.4f} ms | sdpa {r['sdpa_ms']:.4f} ms | sum over "
            f"the same bytes {r['read_floor_ms']:.4f} ms")
    log(json.dumps({"dtype_dim_rows": dim_rows}))
    rows.append(k3_phase(torch, timer, read_floor))
    kernels.reset_counts()
    return rows


# K3 at the shapes of the 7B int8 path: (K, N) of wq/wk/wv/wo, gate/up,
# down, lm_head (fp32 out), the fused wqkv and gate|up; then an odd-K
# int4 case and an N that is not a multiple of the 128-column tile
K3_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000),
             (4096, 12288), (4096, 22016), (4095, 4096), (4096, 1000))
K3_TIMED = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))
# of max|y|, by out dtype. fp16: above one fp16 ulp of max|y| (2^-10),
# below an fp16 product rounded to bf16 (k3_phase checks that control)
K3_TOL = {"bfloat16": 1e-2, "float16": 1.5e-3, "float32": 1e-5}


def k3_bound_ms(M, K, N, out_dtype):
    """(ms, "bytes"|"operations", bytes) of y = (x @ q) * scale: the int8
    payload, the fp32 scale, the bf16 x and the output each moved once,
    against 2*M*K*N bf16 tensor-core operations."""
    out_size = 4 if out_dtype == "float32" else 2
    nbytes = K * N + 4 * N + 2 * M * K + out_size * M * N
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * M * K * N / PEAK_FLOPS["bfloat16"]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def k3_phase(torch, timer, read_floor):
    """K3 (``quant.qmatmul`` on a QuantizedWeight) against its plain
    version on the card: int8 and int4 payloads, bf16, fp16 and fp32
    operands and results (all nine pairs), M in {1, 8, 64, 256}, every
    shape of ``K3_SHAPES``; rows of an M = 64 product bitwise equal to the
    same rows computed at M = 8 and M = 1 (two places); then timed rows
    at M = 8, 64 and 256. Returns the kernel table's K3 row (M = 64, 4096 x
    4096, int8, bf16 out: a decode projection)."""
    from flexflow_tpu_torch.kernels.qmatmul import qmatmul_plain, split_plan
    from flexflow_tpu_torch.quant import dequantize_array, qmatmul, \
        quantize_array

    dev = "cuda"
    bf, h16, f32 = torch.bfloat16, torch.float16, torch.float32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(50)
    log(f"  K3 qmatmul parity (|y - plain| / max|plain| <= {K3_TOL['bfloat16']:g}"
        f" for bf16, {K3_TOL['float16']:g} for fp16, {K3_TOL['float32']:g} for "
        f"fp32 out) and row invariance (M 64 rows == M 8 rows == M 1 row, "
        f"bitwise)")
    errs, pair_worst, ctl_least = {}, {}, {}

    def rel_err(y, ref):
        return float((y.float() - ref.float()).abs().max()) / max(
            float(ref.float().abs().max()), 1e-30)

    for qt in ("int8", "int4"):
        for K, N in K3_SHAPES:
            w = torch.empty((K, N), device=dev).normal_(0, 0.02, generator=g)
            leaf = quantize_array(w.to(bf), qt)
            del w
            worst, inv_ok = 0.0, True
            for cd, od in [(c, o) for c in (bf, h16, f32)
                           for o in (bf, h16, f32)]:
                odn = str(od).replace("torch.", "")
                for M in (1, 8, 64, 256):
                    x = torch.randn((M, K), generator=g, device=dev).to(cd)
                    y = qmatmul(x, leaf, cd, od)
                    torch.cuda.synchronize()
                    ref = qmatmul_plain(x, leaf, cd, od)
                    err = float((y.float() - ref.float()).abs().max())
                    rel = rel_err(y, ref)
                    pair = (str(cd)[6:], odn)
                    pair_worst[pair] = max(pair_worst.get(pair, 0.0), rel)
                    ok = (rel <= K3_TOL[odn]
                          and bool(torch.isfinite(y.float()).all()))
                    worst = max(worst, rel / K3_TOL[odn])
                    if (qt, K, N, cd, od, M) == ("int8", 4096, 4096, bf, bf,
                                                 64):
                        errs["decode"] = err
                    if not ok:
                        log(f"  K3 {qt} K{K} N{N} {cd} -> {od} M{M}: "
                            f"rel err {rel:.3e} FAIL")
                        raise AssertionError("K3 parity failed")
                    if M == 64:
                        inv_ok &= (
                            torch.equal(y[8:16], qmatmul(
                                x[8:16].contiguous(), leaf, cd, od))
                            and torch.equal(y[61:62], qmatmul(
                                x[61:62].contiguous(), leaf, cd, od))
                            and torch.equal(y[:8], qmatmul(
                                x[:8].contiguous(), leaf, cd, od)))
            # bf16-precision controls on fp16 x (M = 64): the product
            # rounded to bf16 (held by the fp16-out limit), x rounded to
            # bf16 (held by the fp32-out limit)
            x = torch.randn((64, K), generator=g, device=dev).to(h16)
            for name, ref, ctl in (
                    ("float16", qmatmul_plain(x, leaf, h16, h16),
                     qmatmul_plain(x, leaf, h16, bf)),
                    ("float32", qmatmul_plain(x, leaf, h16, f32),
                     qmatmul_plain(x, leaf, bf, f32))):
                ctl_least[name] = min(ctl_least.get(name, 1.0),
                                      rel_err(ctl, ref))
            log(f"  K3 {qt} K{K:5d} N{N:5d} plan {split_plan(K, N, sms)}: "
                f"36 cases, worst err / tol {worst:.3f}; row invariance "
                f"{'PASS' if inv_ok else 'FAIL'}")
            if not inv_ok:
                raise AssertionError("K3 row invariance failed")
            del leaf
    log("  K3 worst |y - plain| / max|plain| by x -> out dtype: " + ", ".join(
        f"{c} -> {o} {v:.3e}" for (c, o), v in sorted(pair_worst.items())))
    ctl_ok = all(ctl_least[o] > K3_TOL[o] for o in ctl_least)
    log(f"  K3 bf16-precision controls on fp16 x, least over shapes: out "
        f"rounded to bf16 {ctl_least['float16']:.3e} (fp16-out limit "
        f"{K3_TOL['float16']:g}), x rounded to bf16 {ctl_least['float32']:.3e}"
        f" (fp32-out limit {K3_TOL['float32']:g}): rejected "
        f"{'PASS' if ctl_ok else 'FAIL'}")
    if not ctl_ok:
        raise AssertionError("a K3 limit does not reject its bf16 control")
    log("  K3 timed rows: int8, bf16 x (median of 20, L2 flushed before "
        "each launch); library = torch.matmul on a dequantized bf16 copy")
    k3_rows, row = [], None
    for K, N in K3_TIMED:
        od = f32 if N == 32000 else bf        # the logits head keeps fp32
        odn = str(od).replace("torch.", "")
        w = torch.empty((K, N), device=dev).normal_(0, 0.02, generator=g)
        leaf = quantize_array(w.to(bf), "int8")
        wd = dequantize_array(leaf, bf)
        del w
        for M in (8, 64, 256):
            x = torch.randn((M, K), generator=g, device=dev).to(bf)
            ms = timer(lambda: qmatmul(x, leaf, bf, od))
            pl = timer(lambda: qmatmul_plain(x, leaf, bf, od))
            lib = timer(lambda: torch.matmul(x, wd))
            b, by, nb = k3_bound_ms(M, K, N, odn)
            rd = read_floor(nb)
            r = dict(M=M, K=K, N=N, out=odn, ms=ms, bound_ms=b, bound_by=by,
                     read_floor_ms=rd, plain_ms=pl, library_ms=lib,
                     bound_share=b / ms, gb_per_s=nb / ms / 1e6)
            k3_rows.append(r)
            log(f"  K3 M{M:3d} K{K:5d} N{N:5d} -> {odn:8s} kernel {ms:.4f} "
                f"ms | bound {b:.4f} ms ({by}), {100 * b / ms:.1f}% | "
                f"{nb / ms / 1e6:.0f} GB/s | sum over the same bytes "
                f"{rd:.4f} ms | plain {pl:.4f} ms | bf16 matmul {lib:.4f} ms")
            if (M, K, N) == (64, 4096, 4096):
                row = dict(name="qmatmul", route="cuda", source=K3_SOURCE,
                           replaces=K3_REPLACES,
                           max_abs_err=errs["decode"], ms=ms, plain_ms=pl,
                           bound_ms=b, bound_by=by, library_ms=lib)
        del leaf, wd
    log(json.dumps({"k3_rows": k3_rows}))
    return row


# ----------------------------------------------------------------------
# phase 4: end-to-end parity, card vs CPU
# ----------------------------------------------------------------------
def e2e_parity_phase(torch):
    import numpy as np

    from flexflow_tpu_torch import (LLM, DataType, FFConfig, FFModel,
                                    GenerationConfig)
    from flexflow_tpu_torch import kernels
    from flexflow_tpu_torch.convert import load_params, params_from_jax
    from flexflow_tpu_torch.ffconst import InferenceMode
    from flexflow_tpu_torch.models.llama import (LLAMAConfig,
                                                 create_llama_model,
                                                 hf_weight_map)
    from flexflow_tpu_torch.serve.request_manager import RequestManager

    log("phase 4: end-to-end parity, 2-layer LLaMA at 7B width, fp32, "
        "card vs CPU")
    lc = LLAMAConfig(vocab_size=VOCAB, hidden_size=HIDDEN,
                     intermediate_size=INTER, num_hidden_layers=2,
                     num_attention_heads=HEADS, num_key_value_heads=KV_HEADS,
                     max_position_embeddings=MAX_SEQ)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, VOCAB, PROMPT_LEN).tolist()
               for _ in range(REQUESTS)]
    pnp = None
    outs = {}

    def model(device, mode=InferenceMode.INC_DECODING_MODE, layers=2,
              width=1, quant=None, fusion=False, dtype="float32",
              heads=HEADS):
        cfg = FFConfig(device=device, max_requests_per_batch=REQUESTS,
                       max_sequence_length=MAX_SEQ,
                       max_tokens_per_batch=REQUESTS * PROMPT_LEN,
                       kv_cache_dtype=dtype, compute_dtype=dtype,
                       max_beam_width=width, quantization_type=quant,
                       gemm_fusion=fusion)
        m = FFModel(cfg)
        create_llama_model(m, dataclasses.replace(
            lc, num_hidden_layers=layers, num_attention_heads=heads,
            num_key_value_heads=heads), mode=mode,
            data_type=DataType(dtype))
        m.compile()
        return m

    for device in ("cpu", "cuda"):
        m = model(device)
        if pnp is None:     # one seeded numpy draw, carried to both
            pnp = {
                layer: {w: (np.ones(t.shape, np.float32) if "norm" in layer
                            else 0.02 * rng.standard_normal(
                                t.shape, dtype=np.float32))
                        for w, t in lp.items()}
                for layer, lp in m.params.items()}
        load_params(m, params_from_jax(pnp, device=device))
        rm = RequestManager()
        guids = [rm.register_new_request(p, max_new_tokens=16)
                 for p in prompts]
        t0 = time.perf_counter()
        rm.generate_incr_decoding(m)
        outs[device] = [rm.results[g].output_tokens for g in guids]
        log(f"  {device}: {time.perf_counter() - t0:.2f} s, decode width "
            f"{m._inference_manager.decode_width}")
        del m
    same_req = sum(a == b for a, b in zip(outs["cpu"], outs["cuda"]))
    tot = sum(len(a) for a in outs["cpu"])
    same_tok = sum(x == y for a, b in zip(outs["cpu"], outs["cuda"])
                   for x, y in zip(a, b))
    log(f"  token agreement {same_tok}/{tot}; identical requests "
        f"{same_req}/{REQUESTS}")
    for i, (a, b) in enumerate(zip(outs["cpu"], outs["cuda"])):
        if a != b:
            j = next(k for k, (x, y) in enumerate(zip(a, b)) if x != y)
            log(f"  first divergence: request {i} token {j}: cpu {a[j]} "
                f"vs cuda {b[j]}")
            break
    # fp32 on both sides; only the summation order differs. At most one
    # request may diverge (a near-tie flips its argmax, and greedy decode
    # carries the flip forward).
    if same_req < REQUESTS - 1 or any(len(a) != 16 for a in outs["cuda"]):
        raise AssertionError("end-to-end card/CPU token parity failed")

    # speculative inference on the card (the tree engine at B = 1, depth
    # 4, controller off so that every round drafts and verifies; a 1-layer
    # draft on the verifier's own tensors) against incremental decoding
    # on the CPU
    llm = model("cuda", InferenceMode.TREE_VERIFY_MODE)
    load_params(llm, params_from_jax(pnp, device="cuda"))
    ssm = model("cuda", InferenceMode.BEAM_SEARCH_MODE, layers=1)
    share_params(ssm, llm)
    rm = RequestManager()
    guids = [rm.register_new_request(p, max_new_tokens=16) for p in prompts]
    kernels.reset_counts()
    t0 = time.perf_counter()
    rm.generate_spec_infer(llm, [ssm], spec_depth=4,
                           generation_config=GenerationConfig(
                               adaptive_spec=False))
    spec = [rm.results[g].output_tokens for g in guids]
    counts = dict(kernels.counts)
    same_tok = sum(x == y for a, b in zip(outs["cpu"], spec)
                   for x, y in zip(a, b))
    log(f"  spec (tree engine, B=1, depth 4) on the card: "
        f"{time.perf_counter() - t0:.2f} s, {rm.spec_stats['rounds']} "
        f"rounds; tokens equal to CPU incremental decoding {same_tok}/{tot}; "
        f"launches {counts}")
    if (spec != outs["cpu"] or counts["plain_attend_cuda"]
            or counts["flash_attend_bias"] != 2 * rm.spec_stats["rounds"]
            or not rm.spec_stats["rounds"]):
        raise AssertionError("card speculative inference vs CPU incremental "
                             "decoding parity failed")

    # beam drafting on the card (width 2, depth 3): the beam engine with a
    # 1-layer beam draft, then the host tree path merging two beam drafts
    # (1 and 2 layers, all on the verifier's tensors)
    beams = []
    for layers in (1, 2):
        beams.append(model("cuda", InferenceMode.BEAM_SEARCH_MODE,
                           layers=layers, width=2))
        share_params(beams[-1], llm)
    for what, ssms in (("beam engine, W=2 depth 3, 1-layer draft",
                        beams[:1]),
                       ("host tree path, two beam drafts", beams)):
        rm = RequestManager()
        guids = [rm.register_new_request(p, max_new_tokens=16)
                 for p in prompts]
        levels0 = getattr(getattr(llm, "_beam_engine", None), "levels_run",
                          0)
        kernels.reset_counts()
        t0 = time.perf_counter()
        rm.generate_spec_infer(llm, ssms, spec_depth=3,
                               generation_config=GenerationConfig(
                                   adaptive_spec=False))
        spec = [rm.results[g].output_tokens for g in guids]
        counts = dict(kernels.counts)
        same_tok = sum(x == y for a, b in zip(outs["cpu"], spec)
                       for x, y in zip(a, b))
        rounds = rm.spec_stats["rounds"]
        log(f"  spec ({what}) on the card: "
            f"{time.perf_counter() - t0:.2f} s, {rounds} rounds; tokens "
            f"equal to CPU incremental decoding {same_tok}/{tot}; launches "
            f"{counts}")
        want_bias = None
        if len(ssms) == 1:
            # 2 verifier layers a round, 1 draft layer a staged level
            want_bias = 2 * rounds + (llm._beam_engine.levels_run - levels0)
        if (spec != outs["cpu"] or counts["plain_attend_cuda"] or not rounds
                or (want_bias is not None
                    and counts["flash_attend_bias"] != want_bias)):
            raise AssertionError(f"card beam speculation ({what}) vs CPU "
                                 "incremental decoding parity failed")
    del beams, llm, ssm
    gc.collect()

    # top-p sampling on the card through LLM.generate: one seed gives the
    # same draws twice; top_p 1e-9 at temperature 1.0 is greedy
    sd = {key: (pnp[layer][w].T if tr else pnp[layer][w])
          for key, (layer, w, tr) in hf_weight_map(lc).items()}
    hf = dict(model_type="llama", **dataclasses.asdict(lc))
    serve = dict(max_requests_per_batch=REQUESTS, max_seq_length=MAX_SEQ,
                 max_tokens_per_batch=REQUESTS * PROMPT_LEN,
                 kv_cache_dtype="float32", compute_dtype="float32",
                 device="cuda", seed=3)
    draws = []
    sampler = LLM((hf, dict(sd))).compile(
        generation_config=GenerationConfig(do_sample=True), **serve)
    for _ in range(2):
        res = sampler.generate(prompts, max_new_tokens=16)
        draws.append([r.output_tokens for r in res])
        sampler.ffmodel._inference_manager.generator.manual_seed(3)
    del sampler
    gc.collect()
    sampler = LLM((hf, dict(sd))).compile(
        generation_config=GenerationConfig(do_sample=True, topp=1e-9,
                                           temperature=1.0), **serve)
    tiny_p = [r.output_tokens
              for r in sampler.generate(prompts, max_new_tokens=16)]
    del sampler
    n_greedy = sum(x == y for a, b in zip(draws[0], outs["cuda"])
                   for x, y in zip(a, b))
    log(f"  sampling (topp 0.6, temperature 0.8) through LLM.generate on "
        f"the card: same draws under one seed {draws[0] == draws[1]}; "
        f"tokens equal to greedy {n_greedy}/{tot}; top_p 1e-9 at "
        f"temperature 1.0 equals the card's greedy tokens "
        f"{tiny_p == outs['cuda']}")
    if (draws[0] != draws[1] or tiny_p != outs["cuda"]
            or any(len(a) != 16 for a in draws[0])):
        raise AssertionError("card sampling: not reproducible, or top_p "
                             "1e-9 is not greedy")

    # int8 weights (the same numpy draw, quantized on each device: the
    # scheme gives the same bits on both), card against CPU: incremental
    # decoding through K3's fp32 path, the chain engine with a 1-layer
    # draft on the verifier's leaves, and incremental decoding with the
    # fused qkv and gate|up GEMMs
    def q_incr(device, fusion=False, mode=InferenceMode.INC_DECODING_MODE):
        m = model(device, mode, quant="int8", fusion=fusion)
        load_params(m, params_from_jax(pnp, device=device))
        rm = RequestManager()
        guids = [rm.register_new_request(p, max_new_tokens=16)
                 for p in prompts]
        kernels.reset_counts()
        t0 = time.perf_counter()
        rm.generate_incr_decoding(m)
        return m, [rm.results[g].output_tokens for g in guids], \
            time.perf_counter() - t0, dict(kernels.counts)

    _, q_cpu, s_cpu, _ = q_incr("cpu")
    log(f"  int8 cpu: {s_cpu:.2f} s")
    llm, q_card, s_card, q_counts = q_incr(
        "cuda", mode=InferenceMode.TREE_VERIFY_MODE)
    checks = [("int8 incremental", q_card, q_counts)]
    ssm = model("cuda", InferenceMode.BEAM_SEARCH_MODE, layers=1,
                quant="int8")
    share_params(ssm, llm)
    rm = RequestManager()
    guids = [rm.register_new_request(p, max_new_tokens=16) for p in prompts]
    kernels.reset_counts()
    rm._generate_spec_chain(llm, ssm, spec_depth=4,
                            generation_config=GenerationConfig(
                                adaptive_spec=False))
    checks.append(("int8 chain engine, depth 4, 1-layer draft",
                   [rm.results[g].output_tokens for g in guids],
                   dict(kernels.counts)))
    del llm, ssm
    fused, q_fused, _, f_counts = q_incr("cuda", fusion=True)
    checks.append(("int8 incremental, gemm_fusion", q_fused, f_counts))
    assert "wqkv" in fused.params["layers.0.self_attn"]
    del fused
    gc.collect()
    for what, toks, counts in checks:
        same_tok = sum(x == y for a, b in zip(q_cpu, toks)
                       for x, y in zip(a, b))
        log(f"  {what} on the card: tokens equal to the CPU's int8 "
            f"incremental decoding {same_tok}/{tot}; launches {counts}")
        if (toks != q_cpu or not counts["qmatmul"]
                or counts["qmatmul_plain_cuda"]
                or counts["plain_attend_cuda"]):
            raise AssertionError(f"card {what} vs CPU parity failed")

    # fp16 weights, activations and cache (the same draw), and head dim 32
    # (128 heads of 32, fp32: the card pads the cache to 64), each served
    # greedily on the card and on the CPU
    for what, kw, strict in (
            ("fp16", dict(dtype="float16"), False),
            ("head dim 32 (128 heads), fp32", dict(heads=128), True)):
        toks = {}
        for device in ("cpu", "cuda"):
            m = model(device, **kw)
            load_params(m, params_from_jax(pnp, device=device))
            rm = RequestManager()
            guids = [rm.register_new_request(p, max_new_tokens=16)
                     for p in prompts]
            kernels.reset_counts()
            rm.generate_incr_decoding(m)
            toks[device] = [rm.results[g].output_tokens for g in guids]
            counts = dict(kernels.counts)
            cache = m.op_state["kv_cache"]["k"]
            del m
        same_req = sum(a == b for a, b in zip(toks["cpu"], toks["cuda"]))
        same_tok = sum(x == y for a, b in zip(toks["cpu"], toks["cuda"])
                       for x, y in zip(a, b))
        log(f"  {what} on the card: tokens equal to the CPU's {same_tok}/"
            f"{tot}, identical requests {same_req}/{REQUESTS}; card cache "
            f"{tuple(cache.shape)} {cache.dtype}; launches {counts}")
        for i, (a, b) in enumerate(zip(toks["cpu"], toks["cuda"])):
            if a != b:
                j = next(k for k, (x, y) in enumerate(zip(a, b)) if x != y)
                log(f"    first divergence: request {i} token {j}: cpu "
                    f"{a[j]} vs cuda {b[j]}")
                break
        # fp32: every token; fp16: at most one request may diverge (a
        # near-tie flips one argmax, as in the fp32 incremental pass above)
        bad = (toks["cpu"] != toks["cuda"]) if strict else (
            same_req < REQUESTS - 1)
        if (bad or not counts["flash_attend_append"]
                or counts["plain_attend_cuda"]):
            raise AssertionError(f"card {what} vs CPU parity failed")
        del cache
        gc.collect()


# ----------------------------------------------------------------------
# phase 5: the slice at full size
# ----------------------------------------------------------------------
def profile_decode(torch, llm, prompts, card, new_tokens=16):
    """Device busy share and device time by kernel over one short
    generate call, incremental or speculative as ``llm`` serves
    (torch.profiler; the launch counts were read before)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        llm.generate(prompts, max_new_tokens=new_tokens)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    from torch.autograd import DeviceType

    # device-side events only: a CPU op's self device time repeats the
    # time of the kernels it launched
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(r[2] for r in rows)
    log(f"  profile of generate({new_tokens} new tokens): wall "
        f"{wall_us / 1e3:.2f} ms, "
        f"device busy {busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), "
        f"idle {100 - 100 * busy / wall_us:.1f}%  [{card}]")
    for key, n, us in sorted(rows, key=lambda r: -r[2])[:15]:
        log(f"    {us / 1e3:9.3f} ms {100 * us / busy:5.1f}% x{n:<6d} "
            f"{key[:90]}")


def seven_b(torch, layers=LAYERS):
    """(hf config, state dict) of LLaMA-2-7B geometry cut to ``layers``,
    with random bf16 weights on the card from one seeded generator (the
    same tensors for every call: a draft's are the verifier's first)."""
    from flexflow_tpu_torch.models.llama import LLAMAConfig, hf_weight_map

    hf = dict(model_type="llama", vocab_size=VOCAB, hidden_size=HIDDEN,
              intermediate_size=INTER, num_hidden_layers=layers,
              num_attention_heads=HEADS, num_key_value_heads=KV_HEADS,
              max_position_embeddings=MAX_SEQ)
    hd = HIDDEN // HEADS
    shapes = {"embed_tokens": (VOCAB, HIDDEN), "lm_head": (VOCAB, HIDDEN),
              "q_proj": (HEADS * hd, HIDDEN), "k_proj": (KV_HEADS * hd, HIDDEN),
              "v_proj": (KV_HEADS * hd, HIDDEN), "o_proj": (HIDDEN, HEADS * hd),
              "gate_proj": (INTER, HIDDEN), "up_proj": (INTER, HIDDEN),
              "down_proj": (HIDDEN, INTER)}
    g = torch.Generator(device="cuda").manual_seed(1234)
    sd = {}
    for key in hf_weight_map(LLAMAConfig.from_hf_config(hf)):
        if key.endswith("norm.weight"):
            sd[key] = torch.ones(HIDDEN, dtype=torch.bfloat16, device="cuda")
            continue
        part = key.split(".")[-2]
        sd[key] = torch.empty(shapes[part], dtype=torch.bfloat16,
                              device="cuda").normal_(0.0, 0.02, generator=g)
    return hf, sd


def share_params(draft, llm):
    """Point every weight of the draft FFModel at the verifier's tensor of
    the same name (no copies; the draft's own are freed)."""
    for lname, lp in draft.params.items():
        for w in lp:
            lp[w] = llm.params[lname][w]


SERVE_7B = dict(max_requests_per_batch=REQUESTS, max_seq_length=MAX_SEQ,
                max_tokens_per_batch=REQUESTS * PROMPT_LEN,
                kv_cache_dtype="bfloat16", compute_dtype="bfloat16",
                device="cuda", seed=7)


def full_size_phase(torch, card, profile=False):
    import numpy as np

    from flexflow_tpu_torch import LLM, DataType, kernels
    from flexflow_tpu_torch.serve.inference_manager import InferenceManager

    log(f"phase 5: LLaMA-2-7B geometry, bf16 weights and cache, "
        f"{REQUESTS} requests x {PROMPT_LEN}-token prompts, {NEW_TOKENS} "
        f"new tokens  [{card}]")
    hf, sd = seven_b(torch)
    t0 = time.perf_counter()
    llm = LLM((hf, sd), data_type=DataType.DT_BFLOAT16)
    del sd
    llm.compile(**SERVE_7B)
    torch.cuda.synchronize()
    log(f"  build + load: {time.perf_counter() - t0:.2f} s")
    m = llm.ffmodel
    ifm = m._inference_manager = InferenceManager(m)
    log(f"  decode width {ifm.decode_width}")
    stats = {"prefill_s": [], "decode_s": 0.0, "decode_steps": 0,
             "prefill_steps": 0}
    step, block = ifm.step, ifm.decode_block

    def timed_step(meta, want_output=True):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(meta, want_output)
        torch.cuda.synchronize()
        stats["prefill_s"].append(time.perf_counter() - t)
        stats["prefill_steps"] += 1
        return out

    def timed_block(tok, pos, act, n):
        t = time.perf_counter()
        out = block(tok, pos, act, n)    # ends in a host readback
        stats["decode_s"] += time.perf_counter() - t
        stats["decode_steps"] += min(int(n), m.config.decode_block_steps)
        return out

    ifm.step, ifm.decode_block = timed_step, timed_block
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, VOCAB, PROMPT_LEN).tolist()
               for _ in range(REQUESTS)]
    llm.generate(prompts, max_new_tokens=8)         # warm-up (cuBLAS, ...)
    for k in stats:
        stats[k] = [] if k == "prefill_s" else 0
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()        # counts of the measured run only
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = llm.generate(prompts, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.counts)
    n_tok = sum(len(r.output_tokens) for r in res)
    peak = torch.cuda.max_memory_allocated() / 2**30
    pre_ms = [s * 1e3 for s in stats["prefill_s"]]
    dec_ms = stats["decode_s"] * 1e3 / max(1, stats["decode_steps"])
    log(f"  prefill: {stats['prefill_steps']} chunk(s), "
        f"{', '.join(f'{x:.2f}' for x in pre_ms)} ms  [{card}]")
    log(f"  decode: {stats['decode_steps']} steps, {dec_ms:.3f} ms/step  "
        f"[{card}]")
    log(f"  end to end: {n_tok} tokens in {wall:.3f} s = "
        f"{n_tok / wall:.1f} tokens/s  [{card}]")
    log(f"  peak device memory {peak:.2f} GiB  [{card}]")
    log(f"  kernel launches in the measured run: {counts}")
    if n_tok != REQUESTS * NEW_TOKENS or not all(
            0 <= t < VOCAB for r in res for t in r.output_tokens):
        raise AssertionError("full-size run produced wrong token counts/ids")
    want = {"flash_attend": LAYERS * stats["prefill_steps"],
            "flash_attend_append": LAYERS * stats["decode_steps"],
            "flash_attend_bias": 0, "plain_attend_cuda": 0,
            "qmatmul": 0, "qmatmul_plain_cuda": 0}
    if counts != want or not stats["prefill_steps"]:
        raise AssertionError(f"kernel launch counts {counts} != {want}")
    if profile:
        profile_decode(torch, llm, prompts, card)
    return counts, dict(prefill_ms=pre_ms, decode_ms_per_step=dec_ms,
                        tokens_per_s=n_tok / wall, peak_gib=peak)


# ----------------------------------------------------------------------
# phases 6 and 7: speculative inference at full size
# ----------------------------------------------------------------------
def spec_models(torch):
    """Phase 6's models, which phase 7 reuses: phase 5's weights with the
    deep layers' residual writes damped (bench.py:103-130, 198-234), the
    verifier compiled through ``LLM(...).compile(ssms=[SSM(...)])`` with
    a 2-layer draft on the verifier's own tensors, and the prompts."""
    import types

    import numpy as np

    from flexflow_tpu_torch import LLM, SSM, DataType, GenerationConfig

    hf, sd = seven_b(torch)
    for i in range(DRAFT_LAYERS, LAYERS):
        sd[f"model.layers.{i}.self_attn.o_proj.weight"].mul_(EPS)
        sd[f"model.layers.{i}.mlp.down_proj.weight"].mul_(EPS)
    hf_d = dict(hf, num_hidden_layers=DRAFT_LAYERS)
    sd_d = {k: sd[k] for k in seven_b_keys(hf_d)}
    t0 = time.perf_counter()
    ssm = SSM((hf_d, sd_d), data_type=DataType.DT_BFLOAT16)
    llm = LLM((hf, sd), data_type=DataType.DT_BFLOAT16)
    del sd, sd_d
    # depth 7 through the generation config: LLM.generate's default depth
    # (8) makes a 9-node tree, padded to width 16 — not the decode's 8
    llm.compile(generation_config=GenerationConfig(spec_depth=SPEC_DEPTH),
                **SERVE_7B, decode_block_steps=NEW_TOKENS + 32,
                spec_rounds_per_call=SPEC_ROUNDS, ssms=[ssm])
    share_params(ssm.ffmodel, llm.ffmodel)
    torch.cuda.synchronize()
    log(f"  build + load: {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, VOCAB, PROMPT_LEN).tolist()
               for _ in range(REQUESTS)]
    return types.SimpleNamespace(llm=llm, ssm=ssm, verifier=llm.ffmodel,
                                 hf=hf, prompts=prompts)


def timed_pass(torch, card, prompts, run, new_tokens, what):
    """(results, tokens/s, launch counts, manager) of one pass over
    ``prompts``: ``run(rm)`` on a fresh RequestManager, host clock around
    work that ends in a synchronize."""
    from flexflow_tpu_torch import kernels
    from flexflow_tpu_torch.serve.request_manager import RequestManager

    rm = RequestManager()
    guids = [rm.register_new_request(p, max_new_tokens=new_tokens)
             for p in prompts]
    kernels.reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    run(rm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    res = [rm.results[g].output_tokens for g in guids]
    n_tok = sum(len(r) for r in res)
    log(f"  {what}: {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} "
        f"tokens/s  [{card}]")
    return res, n_tok / wall, dict(kernels.counts), rm


def matches(res, incr, n):
    """Requests whose first ``n`` tokens equal incremental decoding's."""
    return sum(a[:n] == b[:n] for a, b in zip(res, incr))


def spec_phase(torch, card, sm, profile=False):
    """SpecInfer as ``bench.py`` runs it, at LLaMA-2-7B geometry in bf16
    (``spec_models``): depth 7, the adaptive controller on. An
    incremental pass and a spec pass on the same verifier; then the chain
    engine and a two-draft tree, reported only."""
    from flexflow_tpu_torch import DataType, FFModel, kernels
    from flexflow_tpu_torch.ffconst import InferenceMode
    from flexflow_tpu_torch.models.llama import (LLAMAConfig,
                                                 create_llama_model)

    llm, ssm, verifier, prompts = sm.llm, sm.ssm, sm.verifier, sm.prompts

    def timed(run, new_tokens, what):
        return timed_pass(torch, card, prompts, run, new_tokens, what)

    # warm-up (cuBLAS handles, allocator pools) on both paths
    timed(lambda rm: rm.generate_incr_decoding(verifier), 8, "warm-up incr")
    llm.generate(prompts, max_new_tokens=16)
    incr, incr_tps, incr_counts, _ = timed(
        lambda rm: rm.generate_incr_decoding(verifier), NEW_TOKENS,
        "incremental")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = llm.generate(prompts, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = dict(kernels.counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    spec = [r.output_tokens for r in res]
    n_tok = sum(len(r) for r in spec)
    st = llm.rm.spec_stats
    spec_tps = n_tok / wall
    m30, m_full = matches(spec, incr, 30), matches(spec, incr, NEW_TOKENS)
    log(f"  spec (tree engine, B=1, tree width "
        f"{verifier._multi_engine.tree_width}, through LLM.generate): "
        f"{n_tok} tokens in "
        f"{wall:.3f} s = {spec_tps:.1f} tokens/s  [{card}]")
    log(f"  spec/incr tokens/s: {spec_tps / incr_tps:.3f}; verify rounds "
        f"{st['rounds']}; committed tokens per request-round "
        f"{st['committed'] / max(1, st['request_rounds']):.3f} "
        f"({st['committed']} over {st['request_rounds']}); controller parks "
        f"{st['parked']}")
    log(f"  spec_matches_incr_first30 {m30}/{REQUESTS}; full length "
        f"({NEW_TOKENS}) {m_full}/{REQUESTS}")
    log(f"  launches: incremental {incr_counts}; spec {counts}")
    log(f"  peak device memory of the spec pass {peak:.2f} GiB  [{card}]")
    if m30 != REQUESTS:
        raise AssertionError("spec_matches_incr_first30 below 8/8")
    if counts["plain_attend_cuda"] or incr_counts["plain_attend_cuda"]:
        raise AssertionError("plain attention ran on the card")
    if counts["flash_attend_bias"] != LAYERS * st["rounds"] or not all(
            counts[k] for k in ("flash_attend", "flash_attend_append",
                                "flash_attend_bias")):
        raise AssertionError(f"spec launch counts {counts} for "
                             f"{st['rounds']} verify rounds")
    if n_tok != REQUESTS * NEW_TOKENS or not all(
            0 <= t < VOCAB for r in spec for t in r):
        raise AssertionError("spec run produced wrong token counts/ids")
    if profile:
        profile_decode(torch, llm, prompts, card, NEW_TOKENS)

    # reported, not asserted: the chain engine, and a two-draft tree
    chain, chain_tps, _, _ = timed(
        lambda rm: rm._generate_spec_chain(verifier, ssm.ffmodel,
                                           spec_depth=SPEC_DEPTH),
        NEW_TOKENS, "chain engine (reported)")
    log(f"  chain engine: spec/incr {chain_tps / incr_tps:.3f}, matches "
        f"first30 {matches(chain, incr, 30)}/{REQUESTS}")
    draft3 = FFModel(verifier.config)
    create_llama_model(draft3, LLAMAConfig.from_hf_config(
        dict(sm.hf, num_hidden_layers=DRAFT_LAYERS + 1)),
        mode=InferenceMode.BEAM_SEARCH_MODE, data_type=DataType.DT_BFLOAT16)
    draft3.compile()
    share_params(draft3, verifier)
    multi, multi_tps, multi_counts, mrm = timed(
        lambda rm: rm.generate_spec_infer(verifier, [ssm.ffmodel, draft3],
                                          spec_depth=SPEC_DEPTH), 32,
        f"two drafts ({DRAFT_LAYERS} and {DRAFT_LAYERS + 1} layers), 32 "
        f"new tokens (reported)")
    log(f"  two drafts: tree width {verifier._multi_engine.tree_width}, "
        f"{mrm.spec_stats['rounds']} rounds, matches "
        f"incremental (first 32) {matches(multi, incr, 32)}/{REQUESTS}; "
        f"launches {multi_counts}")
    if multi_counts["plain_attend_cuda"]:
        raise AssertionError("plain attention ran on the card")
    return counts, dict(spec_tokens_per_s=spec_tps, incr_tokens_per_s=incr_tps,
                        matches_first30=m30, matches_full=m_full)


def decode_timer(ifm):
    """Wrap ``ifm.decode_block`` (an instance attribute over the class's
    method; ``del ifm.decode_block`` unwraps) to add up its wall time and
    steps (each block ends in a host readback); returns the stats dict."""
    stats = {"s": 0.0, "steps": 0}
    block = ifm.decode_block

    def timed_block(tok, pos, act, n):
        t = time.perf_counter()
        out = block(tok, pos, act, n)
        stats["s"] += time.perf_counter() - t
        stats["steps"] += min(int(n), ifm.model.config.decode_block_steps)
        return out

    ifm.decode_block = timed_block
    return stats


def sampled_twin(model, gen):
    """An FFModel running ``model``'s layers, weights and KV caches with a
    top-p Sampling head (``gen.topp``, ``gen.temperature``) on its fp32
    logits in place of its argmax: the sampled incremental graph of the
    same model, without a second copy of the weights."""
    from flexflow_tpu_torch import FFModel

    twin = FFModel(model.config)
    twin.input_tensors = model.input_tensors
    twin.layers = list(model.layers[:-1])
    assert twin.layers[-1].name == "lm_head", twin.layers[-1].name
    twin._final_tensor = twin.sampling(twin.layers[-1].outputs[0],
                                       top_p=gen.topp,
                                       temperature=gen.temperature)
    twin.params, twin.op_state = model.params, model.op_state
    return twin


def top2_gap(torch, model, seq):
    """The verifier's two best next tokens after ``seq`` and their logit
    gap: one causal forward of the whole sequence in slot 0 (overwrites
    that slot's cache)."""
    import numpy as np

    from flexflow_tpu_torch.ops.base import OpContext
    from flexflow_tpu_torch.serve.batch_config import make_batch_meta

    R, Q = model.config.max_requests_per_batch, len(seq)
    tokens = np.zeros((R, Q), np.int32)
    tokens[0] = seq
    num = np.zeros((R,), np.int32)
    num[0] = Q
    meta = make_batch_meta(
        R, Q, tokens=tokens,
        positions=np.tile(np.arange(Q, dtype=np.int32), (R, 1)),
        num_tokens=num, active=num > 0, device=model.device)
    lm_head = next(layer for layer in model.layers if layer.name == "lm_head")
    values, model.op_state = model._run_graph(
        model.params, {model.input_tensors[0].tensor_id: meta.tokens},
        OpContext(compute_dtype=torch.bfloat16, batch_config=meta),
        model.op_state)
    top = values[lm_head.outputs[0].tensor_id][0, Q - 1].float().topk(2)
    return top.indices.tolist(), float(top.values[0] - top.values[1])


def classify_difference(torch, what, res, incr, verifier, prompts, run,
                        new_tokens=NEW_TOKENS):
    """Reported, not gated: where ``res`` first differs from incremental
    decoding (any position), the verifier's top-2 logit gap there (a
    near-tie in bf16 is not a fault), and the staged cache positions of
    the nodes accepted around it, from a rerun of ``run`` that records
    every ``commit_tree_kv`` (source -> destination positions; a source
    that is not its destination is a node staged off the chain)."""
    from flexflow_tpu_torch.serve import engine, request_manager

    diff = [(i, next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)) for i, (a, b) in enumerate(zip(res, incr))]
    diff = [(i, j) for i, j in diff if j is not None]
    if not diff:
        log(f"  {what}: no difference from incremental decoding")
        return
    i, j = min(diff, key=lambda d: d[1])
    ids, gap = top2_gap(torch, verifier, prompts[i] + incr[i][:j])
    log(f"  {what}: {len(diff)} request(s) differ; first difference at "
        f"request {i} position {j} (sequence position {len(prompts[i]) + j})"
        f": {res[i][j]} vs incremental {incr[i][j]}; the verifier's top-2 "
        f"after incremental's prefix {ids}, logit gap {gap:.4f}")
    commits = []
    base = engine.commit_tree_kv

    def logged(op_state, src_node, num_commit, start_pos, active):
        n, st = int(num_commit[i]), int(start_pos[i])
        if bool(active[i]) and n:
            src = (st + src_node[i, :n].long()).tolist()
            commits.append((list(range(st, st + n)), src))
        return base(op_state, src_node, num_commit, start_pos, active)

    engine.commit_tree_kv = logged
    try:
        rm = request_manager.RequestManager()
        rm._commit = logged
        for p in prompts:
            rm.register_new_request(p, max_new_tokens=new_tokens)
        run(rm)
    finally:
        engine.commit_tree_kv = base
    pos = len(prompts[i]) + j
    near = [(d, s_) for d, s_ in commits if d[0] - 8 <= pos <= d[-1] + 8]
    log(f"    request {i}: {len(commits)} commits; the accepted nodes' "
        f"staged positions (destination <- source) near position {pos}: "
        + ("; ".join(", ".join(f"{a}<-{b}" for a, b in zip(d, s_))
                     for d, s_ in near) or "none"))


def head_times(torch, card):
    """Device time of the three serving heads on one decode step's fp32
    logits [R, 8, VOCAB] (CUDA events, median of 20 warm calls, no L2
    flush: the logits were just written): argmax, top-p Sampling, and a
    beam draft's ArgTopK + cast + concat."""
    from flexflow_tpu_torch.ops.reduction_ops import ArgTopK
    from flexflow_tpu_torch.ops.sampling_ops import top_p_sampling

    g = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn((REQUESTS, 8, VOCAB), generator=g, device="cuda")

    def packed():
        p, i = ArgTopK.forward(dict(k=BEAM_WIDTH, speculative_decoding=True),
                               {}, [logits], None)
        return torch.cat([p, i.float()], dim=-1)

    times = {}
    for name, fn in (("argmax", lambda: logits.argmax(-1)),
                     ("top-p sampling", lambda: top_p_sampling(
                         logits, g, 0.6, 0.8)),
                     ("beam ArgTopK head", packed)):
        for _ in range(3):
            fn()
        ts = []
        for _ in range(20):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        times[name] = statistics.median(ts)
    log(f"  head device time on [{REQUESTS}, 8, {VOCAB}] fp32 logits: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
        + f"  [{card}]")
    return times


def beam_phase(torch, card, sm):
    """Beam drafting and sampling at LLaMA-2-7B geometry in bf16, on phase
    6's verifier (``spec_models``): a greedy incremental pass (the
    baseline), the beam engine (phase 6's 2-layer draft compiled as a
    width-2 beam draft, depth 3, the adaptive controller on), the sampled
    incremental graph (twice under one seed), and the host tree path with
    two beam drafts (reported)."""
    import numpy as np

    from flexflow_tpu_torch import DataType, FFModel, GenerationConfig
    from flexflow_tpu_torch.ffconst import InferenceMode
    from flexflow_tpu_torch.models.llama import (LLAMAConfig,
                                                 create_llama_model)
    from flexflow_tpu_torch.serve.request_manager import RequestManager

    log(f"phase 7: beam drafting (W {BEAM_WIDTH}, depth {BEAM_DEPTH}) and "
        f"top-p sampling, LLaMA-2-7B geometry, bf16, phase 6's verifier, "
        f"{REQUESTS} requests x {PROMPT_LEN}-token prompts, {NEW_TOKENS} new "
        f"tokens  [{card}]")
    verifier, prompts = sm.verifier, sm.prompts

    def timed(run, new_tokens, what):
        return timed_pass(torch, card, prompts, run, new_tokens, what)

    def beam_draft(layers):
        m = FFModel(dataclasses.replace(verifier.config,
                                        max_beam_width=BEAM_WIDTH))
        create_llama_model(m, LLAMAConfig.from_hf_config(
            dict(sm.hf, num_hidden_layers=layers)),
            mode=InferenceMode.BEAM_SEARCH_MODE,
            data_type=DataType.DT_BFLOAT16)
        m.compile()
        share_params(m, verifier)
        return m

    greedy_ifm = RequestManager._ifm(verifier)
    dec = decode_timer(greedy_ifm)
    timed(lambda rm: rm.generate_incr_decoding(verifier), 8, "warm-up incr")
    dec.update(s=0.0, steps=0)
    incr, incr_tps, _, _ = timed(
        lambda rm: rm.generate_incr_decoding(verifier), NEW_TOKENS,
        "greedy incremental (baseline)")
    greedy_ms = dec["s"] * 1e3 / max(1, dec["steps"])
    del greedy_ifm.decode_block          # the class's own, unwrapped

    # --- the beam engine ---
    draft = beam_draft(DRAFT_LAYERS)

    def beam_run(rm):
        rm.generate_spec_infer(verifier, [draft], spec_depth=BEAM_DEPTH,
                               beam_width=BEAM_WIDTH)

    timed(beam_run, 8, "warm-up beam")
    engine = verifier._beam_engine
    levels0 = engine.levels_run
    torch.cuda.reset_peak_memory_stats()
    beam, beam_tps, counts, rm = timed(beam_run, NEW_TOKENS,
                                       f"beam engine (tree width "
                                       f"{engine.tree_width})")
    peak = torch.cuda.max_memory_allocated() / 2**30
    levels = engine.levels_run - levels0
    st = rm.spec_stats
    n_tok = sum(len(r) for r in beam)
    m30, m_full = matches(beam, incr, 30), matches(beam, incr, NEW_TOKENS)
    log(f"  beam/incr tokens/s: {beam_tps / incr_tps:.3f}; verify rounds "
        f"{st['rounds']}; beam levels staged {levels}; committed tokens per "
        f"request-round {st['committed'] / max(1, st['request_rounds']):.3f} "
        f"({st['committed']} over {st['request_rounds']}); controller parks "
        f"{st['parked']}")
    log(f"  spec_matches_incr_first30 {m30}/{REQUESTS}; full length "
        f"({NEW_TOKENS}) {m_full}/{REQUESTS}")
    log(f"  launches {counts}; flash_attend_bias {counts['flash_attend_bias']}"
        f" = {LAYERS} x {st['rounds']} rounds + {DRAFT_LAYERS} x {levels} "
        f"levels: {counts['flash_attend_bias'] == LAYERS * st['rounds'] + DRAFT_LAYERS * levels}")
    log(f"  peak device memory of the beam pass {peak:.2f} GiB  [{card}]")
    classify_difference(torch, "beam engine", beam, incr, verifier, prompts,
                        beam_run)
    if counts["plain_attend_cuda"]:
        raise AssertionError("plain attention ran on the card")
    if (counts["flash_attend_bias"]
            != LAYERS * st["rounds"] + DRAFT_LAYERS * levels
            or not st["rounds"] or not levels):
        raise AssertionError(f"beam launch counts {counts} for "
                             f"{st['rounds']} rounds, {levels} levels")
    if n_tok != REQUESTS * NEW_TOKENS or not all(
            0 <= t < VOCAB for r in beam for t in r):
        raise AssertionError("beam run produced wrong token counts/ids")

    # --- sampled incremental decoding, twice under one seed ---
    gen = GenerationConfig(do_sample=True)
    twin = sampled_twin(verifier, gen)
    ifm = RequestManager._ifm(twin)
    dec = decode_timer(ifm)
    draws = []
    for k in range(2):
        ifm.generator.manual_seed(verifier.config.seed)
        dec.update(s=0.0, steps=0)
        res, tps, s_counts, _ = timed(
            lambda rm: rm.generate_incr_decoding(twin), NEW_TOKENS,
            f"sampled incremental (topp {gen.topp}, temperature "
            f"{gen.temperature}), pass {k + 1}")
        draws.append(res)
        if k == 0:
            sample_counts, sample_tps = s_counts, tps
            sample_ms = dec["s"] * 1e3 / max(1, dec["steps"])
    same = draws[0] == draws[1]
    n_greedy = sum(x == y for a, b in zip(draws[0], incr)
                   for x, y in zip(a, b))
    log(f"  decode ms/step: sampled {sample_ms:.3f}, greedy {greedy_ms:.3f}; "
        f"tokens/s: sampled {sample_tps:.1f}, greedy {incr_tps:.1f}  [{card}]")
    log(f"  sampled draws equal under one seed: {same}; tokens equal to "
        f"greedy {n_greedy}/{REQUESTS * NEW_TOKENS}; launches "
        f"{sample_counts}")
    if (not same or sample_counts["plain_attend_cuda"]
            or any(len(r) != NEW_TOKENS for r in draws[0])):
        raise AssertionError("sampled decoding not reproducible under one "
                             "seed, or wrong")
    del twin, ifm

    # --- reported: what a beam round costs and what the beam prunes ---
    # the beam engine with the controller off (every round drafts, no
    # fallback decode between them), and the chain engine at the same
    # depth with the same draft weights (its graph ends in argmax)
    static = GenerationConfig(adaptive_spec=False)
    _, st_tps, _, srm = timed(
        lambda rm: rm.generate_spec_infer(
            verifier, [draft], spec_depth=BEAM_DEPTH, beam_width=BEAM_WIDTH,
            generation_config=static), NEW_TOKENS,
        "beam engine, controller off (reported)")
    sst = srm.spec_stats
    chain_draft = sm.ssm.ffmodel
    _, ch_tps, _, crm = timed(
        lambda rm: rm._generate_spec_chain(verifier, chain_draft,
                                           spec_depth=BEAM_DEPTH,
                                           generation_config=static),
        NEW_TOKENS, f"chain engine, depth {BEAM_DEPTH}, controller off "
        f"(reported)")
    cst = crm.spec_stats
    st_wall = REQUESTS * NEW_TOKENS / st_tps
    log(f"  controller off: beam {sst['rounds']} rounds, "
        f"{1e3 * st_wall / max(1, sst['rounds']):.1f} ms a round (wall, "
        f"prefill included), committed tokens per request-round "
        f"{sst['committed'] / max(1, sst['request_rounds']):.3f}; chain "
        f"{cst['rounds']} rounds, committed tokens per request-round "
        f"{cst['committed'] / max(1, cst['request_rounds']):.3f}; "
        f"beam/incr {st_tps / incr_tps:.3f}, chain/incr "
        f"{ch_tps / incr_tps:.3f}")
    head_times(torch, card)

    # --- reported: the host tree path with two beam drafts ---
    draft2 = beam_draft(DRAFT_LAYERS + 1)
    host, host_tps, host_counts, hrm = timed(
        lambda rm: rm.generate_spec_infer(verifier, [draft, draft2],
                                          spec_depth=BEAM_DEPTH), 16,
        f"host tree path, two beam drafts ({DRAFT_LAYERS} and "
        f"{DRAFT_LAYERS + 1} layers), 16 new tokens (reported)")
    log(f"  host path: {hrm.spec_stats['rounds']} rounds, committed "
        f"{hrm.spec_stats['committed']}, matches incremental (first 16) "
        f"{matches(host, incr, 16)}/{REQUESTS}; launches {host_counts}")
    classify_difference(
        torch, "host tree path", host, [r[:16] for r in incr], verifier,
        prompts, lambda rm: rm.generate_spec_infer(
            verifier, [draft, draft2], spec_depth=BEAM_DEPTH), 16)
    if host_counts["plain_attend_cuda"]:
        raise AssertionError("plain attention ran on the card")
    return counts, sample_counts


# ----------------------------------------------------------------------
# phase 8: bench.py's headline, LLaMA-2-7B geometry with int8 weights
# ----------------------------------------------------------------------
def quantized_llm(torch, qtype, ssm_layers=None, **kw):
    """LLaMA-2-7B geometry with ``qtype`` weights through
    ``LLM(...).compile(quantization_type=qtype)`` (each layer quantized as
    it is initialized, then the loaded weights re-quantized), from
    ``seven_b``'s bf16 weights; with ``ssm_layers`` a draft of that many
    layers compiles beside it and then shares the verifier's leaves.
    Returns (llm, ssm or None, seconds)."""
    from flexflow_tpu_torch import LLM, SSM, DataType

    hf, sd = seven_b(torch)
    t0 = time.perf_counter()
    ssms = []
    if ssm_layers:
        hf_d = dict(hf, num_hidden_layers=ssm_layers)
        ssms = [SSM((hf_d, {k: sd[k] for k in seven_b_keys(hf_d)}),
                    data_type=DataType.DT_BFLOAT16)]
    llm = LLM((hf, sd), data_type=DataType.DT_BFLOAT16)
    del sd
    llm.compile(**SERVE_7B, quantization_type=qtype, ssms=ssms, **kw)
    if ssms:
        share_params(ssms[0].ffmodel, llm.ffmodel)
    gc.collect()
    torch.cuda.synchronize()
    return llm, (ssms[0] if ssms else None), time.perf_counter() - t0


def int8_phase(torch, card, bf16_decode_ms=None, profile=False):
    """``bench.py``'s headline: LLaMA-2-7B geometry, bf16 compute and
    cache, int8 weights quantized per layer at compile; deep layers
    damped through dequantize -> scale -> re-quantize (bench.py:218-234);
    a 2-layer draft on the verifier's int8 leaves, depth 7, the
    controller on. An incremental and a spec pass with the gates; then an
    int4 incremental pass and an int8 pass with gemm_fusion (reported)."""
    import types

    import numpy as np

    from flexflow_tpu_torch import GenerationConfig, kernels
    from flexflow_tpu_torch.quant import (dequantize_array, quantized_nbytes,
                                          requantize_into)
    from flexflow_tpu_torch.serve.request_manager import RequestManager

    llm, ssm, secs = quantized_llm(
        torch, "int8", ssm_layers=DRAFT_LAYERS,
        generation_config=GenerationConfig(spec_depth=SPEC_DEPTH),
        decode_block_steps=NEW_TOKENS + 32, spec_rounds_per_call=SPEC_ROUNDS)
    verifier = llm.ffmodel
    for i in range(DRAFT_LAYERS, LAYERS):
        for lname, w in ((f"layers.{i}.self_attn", "wo"),
                         (f"layers.{i}.mlp.down_proj", "kernel")):
            leaf = verifier.params[lname][w]
            requantize_into(leaf, dequantize_array(leaf) * EPS)
    wbytes = quantized_nbytes(verifier.params)
    log(f"  build + load + quantize: {secs:.2f} s; verifier weights "
        f"{wbytes / 1e9:.3f} GB (payload + scale)  [{card}]")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, VOCAB, PROMPT_LEN).tolist()
               for _ in range(REQUESTS)]

    def timed(run, new_tokens, what):
        return timed_pass(torch, card, prompts, run, new_tokens, what)

    ifm = RequestManager._ifm(verifier)
    dec = decode_timer(ifm)
    timed(lambda rm: rm.generate_incr_decoding(verifier), 8, "warm-up incr")
    llm.generate(prompts, max_new_tokens=16)
    dec.update(s=0.0, steps=0)
    torch.cuda.reset_peak_memory_stats()
    incr, incr_tps, incr_counts, _ = timed(
        lambda rm: rm.generate_incr_decoding(verifier), NEW_TOKENS,
        "int8 incremental")
    incr_peak = torch.cuda.max_memory_allocated() / 2**30
    dec_ms = dec["s"] * 1e3 / max(1, dec["steps"])
    del ifm.decode_block
    # every forward of the pass (prefill chunk or decode step) runs K1 or
    # K2 once a layer and K3 for the 7 projections a layer + lm_head
    per_fwd = 7 * LAYERS + 1
    fwds = (incr_counts["flash_attend"]
            + incr_counts["flash_attend_append"]) / LAYERS
    log(f"  decode {dec['steps']} steps, {dec_ms:.3f} ms/step (bf16 "
        f"phase 5: {'%.3f' % bf16_decode_ms if bf16_decode_ms else 'not run'}"
        f"); peak device memory {incr_peak:.2f} GiB  [{card}]")
    log(f"  launches: {incr_counts}; qmatmul per forward "
        f"{incr_counts['qmatmul'] / max(1, fwds):.1f} (want {per_fwd})")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = llm.generate(prompts, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = dict(kernels.counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    spec = [r.output_tokens for r in res]
    spec_tps = sum(len(r) for r in spec) / wall
    st = llm.rm.spec_stats
    m30 = matches(spec, incr, 30)
    log(f"  spec (tree engine, B=1, depth {SPEC_DEPTH}, through "
        f"LLM.generate): {spec_tps:.1f} tokens/s; spec/incr "
        f"{spec_tps / incr_tps:.3f}; verify rounds {st['rounds']}; "
        f"committed tokens per request-round "
        f"{st['committed'] / max(1, st['request_rounds']):.3f}; controller "
        f"parks {st['parked']}; peak device memory {peak:.2f} GiB  [{card}]")
    log(f"  spec_matches_incr_first30 {m30}/{REQUESTS}; full length "
        f"({NEW_TOKENS}) {matches(spec, incr, NEW_TOKENS)}/{REQUESTS}; "
        f"launches {counts}")
    if m30 != REQUESTS:
        raise AssertionError("int8 spec_matches_incr_first30 below 8/8")
    if incr_counts["qmatmul"] != per_fwd * fwds or not fwds:
        raise AssertionError(f"int8 incremental: {incr_counts['qmatmul']} "
                             f"K3 launches for {fwds} forwards")
    for c in (incr_counts, counts):
        if c["qmatmul_plain_cuda"] or c["plain_attend_cuda"]:
            raise AssertionError("a plain version ran on the card")
    if not counts["qmatmul"] or counts["flash_attend_bias"] != LAYERS * st[
            "rounds"]:
        raise AssertionError(f"int8 spec launch counts {counts}")
    if sum(len(r) for r in spec) != REQUESTS * NEW_TOKENS or not all(
            0 <= t < VOCAB for r in spec for t in r):
        raise AssertionError("int8 spec run produced wrong token counts/ids")
    if profile:
        def incr_generate(prompts_, max_new_tokens):
            rm = RequestManager()
            for p in prompts_:
                rm.register_new_request(p, max_new_tokens=max_new_tokens)
            rm.generate_incr_decoding(verifier)

        log("  incremental:")
        profile_decode(torch, types.SimpleNamespace(generate=incr_generate),
                       prompts, card)
        log("  spec:")
        profile_decode(torch, llm, prompts, card, NEW_TOKENS)
    del llm, ssm, verifier
    gc.collect()

    # reported: int4 incremental (tokens/s), int8 with gemm fusion (ms/step)
    out = dict(incr_tokens_per_s=incr_tps, spec_tokens_per_s=spec_tps,
               decode_ms_per_step=dec_ms, peak_gib=peak,
               incr_peak_gib=incr_peak, matches_first30=m30)
    for what, qt, kw in (("int4 incremental", "int4", {}),
                         ("int8 incremental, gemm_fusion", "int8",
                          dict(gemm_fusion=True))):
        other, _, _ = quantized_llm(torch, qt, decode_block_steps=NEW_TOKENS
                                    + 32, **kw)
        m = other.ffmodel
        ifm = RequestManager._ifm(m)
        dec = decode_timer(ifm)
        timed(lambda rm: rm.generate_incr_decoding(m), 8, f"warm-up {what}")
        dec.update(s=0.0, steps=0)
        _, tps, c, _ = timed(lambda rm: rm.generate_incr_decoding(m),
                             NEW_TOKENS, f"{what} (reported)")
        ms = dec["s"] * 1e3 / max(1, dec["steps"])
        log(f"  {what}: decode {ms:.3f} ms/step; weights "
            f"{quantized_nbytes(m.params) / 1e9:.3f} GB; launches {c}  "
            f"[{card}]")
        if c["qmatmul_plain_cuda"] or c["plain_attend_cuda"]:
            raise AssertionError("a plain version ran on the card")
        out[qt + ("_fused" if kw else "") + "_decode_ms_per_step"] = ms
        out[qt + ("_fused" if kw else "") + "_tokens_per_s"] = tps
        del other, m, ifm
        gc.collect()
    return incr_counts, out


def seven_b_keys(hf):
    from flexflow_tpu_torch.models.llama import LLAMAConfig, hf_weight_map

    return hf_weight_map(LLAMAConfig.from_hf_config(hf))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8",
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--profile", action="store_true",
                    help="phases 5, 6 and 8 also trace a generate call "
                         "with torch.profiler (device busy share, time by "
                         "kernel)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}

    if not os.path.isdir(os.path.join(HERE, "flexflow_tpu_torch", "kernels",
                                      "csrc")):
        print("chip_smoke.py: the flexflow_tpu_torch package is not beside "
              "this script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 3

    card = nvidia_smi()
    log(card)
    log(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log(f"  allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}; bf16 reduced-precision "
        f"reduction "
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")

    from flexflow_tpu_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"phase 2: built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name in libs:
        lines = build.build_log(name).splitlines()
        regs = [int(w) for line in lines if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt == "registers,"]
        spills, fn = [], ""
        for line in lines:   # ptxas -v: "Function properties for <name>"
            if "Function properties for" in line:
                fn = line.split("for", 1)[1].strip()
            elif ("spill" in line and
                  " 0 bytes spill stores, 0 bytes spill loads" not in line):
                spills.append(f"{fn}: {line.strip()}")
        log(f"  {name}: {len(regs)} kernels, at most {max(regs, default=0)} "
            f"registers a thread; spills: {spills or 'none'}")

    timer = Timer(torch)
    rows = kernel_phase(torch, timer) if 3 in phases else []
    del timer
    # the model <-> InferenceManager reference cycle keeps a phase's model
    # alive until a collection; free it before the next phase's peak
    gc.collect()
    if 4 in phases:
        e2e_parity_phase(torch)
        gc.collect()
    by_path = {}
    bf16_decode_ms = None
    if 5 in phases:
        by_path["incr"], bf16 = full_size_phase(torch, card,
                                                profile=args.profile)
        bf16_decode_ms = bf16["decode_ms_per_step"]
        gc.collect()
    if phases & {6, 7}:
        log(f"phases 6-7: SpecInfer models, LLaMA-2-7B geometry, bf16, "
            f"{DRAFT_LAYERS}-layer draft on the verifier's tensors  [{card}]")
        sm = spec_models(torch)
        if 6 in phases:
            log(f"phase 6: SpecInfer, depth {SPEC_DEPTH}, {REQUESTS} "
                f"requests x {PROMPT_LEN}-token prompts, {NEW_TOKENS} new "
                f"tokens  [{card}]")
            by_path["spec"], _ = spec_phase(torch, card, sm,
                                            profile=args.profile)
            gc.collect()
        if 7 in phases:
            by_path["beam"], by_path["sample"] = beam_phase(torch, card, sm)
        del sm
        gc.collect()
    if 8 in phases:
        log(f"phase 8: LLaMA-2-7B geometry with int8 weights (bench.py's "
            f"headline), bf16 compute and cache, {REQUESTS} requests x "
            f"{PROMPT_LEN}-token prompts, {NEW_TOKENS} new tokens  [{card}]")
        by_path["int8"], int8 = int8_phase(torch, card, bf16_decode_ms,
                                           profile=args.profile)
        log(json.dumps({"int8_phase": int8}))
        gc.collect()
    for r in rows:
        # each kernel's launches on the path it serves: K1 (prefill) and
        # K2 (decode) on incremental decoding, K1's bias mode on spec, K3
        # on the int8 model's incremental decoding
        path = {"flash_attend_bias": "spec", "qmatmul": "int8"}.get(
            r["name"], "incr")
        if path in by_path:
            r["launches"] = by_path[path][r["name"]]
        r["launches_by_path"] = {p: c[r["name"]] for p, c in by_path.items()}
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
