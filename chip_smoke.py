#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --phases 1,2,7   # one phase (1 and 2 build)
    python3 chip_smoke.py --phases 1,2,9   # online serving alone
    python3 chip_smoke.py --phases 1,2,10  # OPT, Falcon, MPT, StarCoder
    python3 chip_smoke.py --phases 1,2,11  # training: BERT, ResNet-50
    python3 chip_smoke.py --phases 1,2,12  # telemetry, the replica fleet
    python3 chip_smoke.py --phases 1,2,13  # the host side of serving
    python3 chip_smoke.py --phases 1,2,14  # offload, sharded serving
    python3 chip_smoke.py --phases 1,2,15  # parallel, resumable training
    python3 chip_smoke.py --phases 1,2,16  # the model frontends
    python3 chip_smoke.py --phases 1,2,17  # the Unity search
    python3 chip_smoke.py --phases 1,2,18  # the engines' programs

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
     dtype (K1, and K2 through split-S); head dims 32, 80, 160 and 320
     (through the padded cache) and 256, 512 and 768, fp32 among them,
     against the plain version on the unpadded inputs, with timed fp16,
     D = 256 and D = 320/512/768 rows (the last at R 8, S 256, H = 4096
     // D; bf16, and fp16 at 512 and 768), the 16-bit wide kernel's
     partials mode at D 512 against ``partials_reference``, a long-cache
     row at D 512, and the bitwise invariance checks at D = 256, 512, 768
     and at D 320's serving shape (12 heads, cache 512) too;
     phase 10's families' shapes in bf16 at R 8, S 256 (Falcon-7B's 71
     query heads on one KV head at D 64, StarCoder's 48 on one at D 128,
     MPT-7B's ALiBi, OPT-6.7B's query-side scale: prefill, decode and
     chain-tree verify each against the plain version; the bitwise
     invariance checks at G = 71 and 48 and with ALiBi; timed rows for
     Falcon's prefill, decode and verify, StarCoder's decode and MPT's
     decode, beside the bound, the read floor, the plain version and
     SDPA); then K3 (``quant.qmatmul`` on a QuantizedWeight)
     against its plain version: int8 and int4, bf16, fp16 and fp32
     operands and results (all nine pairs), M in {1, 8, 64, 256}, the 7B
     int8 path's (K, N) plus an odd-K int4 case and N = 1000, the worst
     error of each pair and the bf16-precision controls that the fp16-
     and fp32-out limits must reject; rows of an
     M = 64 product bitwise equal to the same rows at M = 8 and M = 1;
     timed rows at M = 8, 64 and 256 beside the bound, the read floor,
     the plain version and ``torch.matmul`` on a dequantized bf16 copy of
     the weight; and K3 int8 at every (K, N) of phase 10's families (M 8,
     64, 256, row invariance), timed at Falcon's 4544 x 64 and 4544 x
     65024;
  4. end-to-end parity: a 2-layer LLaMA at full 7B width in fp32, served
     greedily on the card and on the CPU with the same weights (one
     seeded numpy draw), 8 requests x 8 new tokens; the tokens must
     agree; then speculative inference on the card must give the CPU's
     incremental tokens, 64 of 64, through the tree engine (one 1-layer
     draft, depth 4), the beam engine (a 1-layer beam draft of width 2,
     depth 3) and the host tree path (two beam drafts); and top-p
     sampling through
     ``LLM.generate`` must repeat its draws under one seed and, at
     top_p 1e-9 and temperature 1.0, give the card's greedy tokens; then
     int8 weights (the same draw, quantized on each device): incremental
     decoding, the chain engine (1-layer draft on the verifier's leaves,
     depth 4) and incremental decoding with gemm fusion on the card must
     each give the CPU's int8 incremental tokens, 64 of 64; then fp16
     weights, activations and cache (at most one request may differ, as
     the fp32 incremental pass), head dim 32 (128 heads, fp32, the
     card's cache padded to 64; 64 of 64) and head dim 320 (12 heads,
     hidden 3840, the card's cache padded to 512) in fp32 (the FFMA wide
     kernel; 64 of 64) and in bf16 (the 16-bit wide cluster kernel, whose
     launches ``flash_attend_wide`` counts and the kernels line reports;
     at most one request may differ) against the CPU;
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
     fusion;
  9. online serving on phase 8's models (built again), through the
     port's ``start_server`` and ``serve/loadgen.py`` with ``bench.py``'s
     traffic. An offline int8 incremental pass over every scheduled
     prompt gives the reference tokens and the incremental rate
     (base_rps = tokens/s / 64, deadline = 3 x 64 x 8 / tokens/s). 9a: a
     Poisson knee sweep through the SpecInfer server at 0.5x, 1x and 2x
     base_rps, 8 requests a step (resolved 1.0, every ok request's first
     30 tokens equal to the offline tokens); 9b: 16 requests at 2x the
     knee, premium (priority 1) and besteffort (rate-limited) tenants
     behind admission (resolved 1.0, peak queue depth <= 16, first 30
     tokens); 9c: two 96-token shared prefixes through the incremental
     server with the prefix pool off, then on (identical tokens, hits on
     every warm request, fewer prefill tokens, and prefix lengths 13 and
     21 equal to offline); 9d: a mid-stream cancel (latency against a
     decode block), a timeout mid-generation, a deadline-at-risk
     priority-1 arrival preempting a running request (the victim's
     tokens equal an unpreempted run), ``stop_server`` with 8 requests in
     flight, and ``LLM.cancel`` on the SpecInfer server (reported); K1,
     K2 and K3 launched by the server-driven runs (counted from a reset
     just before each to a read just after it, the offline reference
     passes left out), no plain call anywhere in the phase;
 10. the other families: OPT-6.7B, Falcon-7B, MPT-7B and StarCoder
     (their published HF configs). 10a: a 2-layer model at the family's
     full width in fp32, one seeded numpy draw of weights on both
     devices, 8 requests x 16-token prompts, 8 new tokens: incremental
     decoding, SpecInfer (the tree engine, a 1-layer draft, depth 4) and
     int8 incremental decoding on the card each equal to the CPU's, 64
     of 64 (the CPU references run on worker threads beside the card's
     work); 10c: a tiny checkpoint written by ``save_tiny_checkpoint`` on
     the card, cold-started with ``LLM.from_checkpoint``, float and int8,
     tokens equal to the in-memory build's, ``cold_start_s``; then 10b,
     with the host to itself: the published geometry in bf16 through
     ``LLM(...).compile(...).generate(...)`` (8 requests x 32-token
     prompts, 32 new tokens), prefill ms, decode ms/step, tokens/s and
     peak memory, K1 launched L times a prefill chunk, K2 L times a
     decode step, no plain call;
 11. training, ``bench_train.py``'s two models through
     ``FFModel.compile(optimizer=, loss_type=)`` and its train verbs
     (autograd backward, in-place optimizer updates; no TPU kernel lies
     on this path, so it launches none of K1-K3). 11a, card vs CPU in
     fp32 with TF32 off (the CPU references on a worker thread): BERT at
     full width (hidden 1024, 16 heads, vocab 30522, seq 128) cut to 2
     layers and batch 8, 3 SGD steps and, from the same start, 3 Adam
     steps; ResNet-50 cut to the stem, the max pool and stage 1 at 64x64,
     batch 8, 10 classes, 2 SGD steps; each step's loss within 1e-4
     relative of the CPU's; the largest parameter difference and the
     BatchNorm running statistics against the CPU reported. 11b, full
     size in bf16: BERT-large (24 x 1024, batch 64, seq 128, vocab 30522,
     SGD lr 1e-3) and ResNet-50 (batch 256, 224x224), 2 warm steps then 3
     blocks through ``train_batches`` (10 steps a block for BERT,
     ``RESNET_UNROLL`` = 4 for ResNet; one host read a block): step ms
     (median, min, max), TFLOPS from ``bench_train.py``'s model-FLOP
     counts, MFU against the H100 SXM's 989 TFLOP/s dense bf16 (NVIDIA
     data sheet), the loss of each block and the peak memory; gates:
     finite losses falling from the first block to the last on the fixed
     batch, every parameter, gradient and optimizer-state tensor on the
     card, finite running statistics. ``--profile`` adds the device busy
     share of one BERT train step;
 12. serving telemetry and the replica fleet (no new kernel; K1-K3 serve
     every path). 12a: phase 8's models serve the 8 x 32-token prompts,
     64 new tokens, incrementally and by SpecInfer at depth 7, in 2
     alternating pairs of telemetry off and on (the process-global
     ``ServingTelemetry``, a JSONL span trace per on pass): tokens/s off
     and on and the overhead (reported), the fenced prefill, decode and
     speculation block histograms' p50/p99 and each loop's host share,
     1 - fenced block seconds / loop wall (reported); gates: tokens on ==
     off, 8 finished requests and the generated-token counter equal to
     the outputs a pass, speculation rounds > 0 with one acceptance
     sample per round span, one admission and one finish span per
     request, nothing recorded while off, K1, K1-bias, K2 and K3 launched
     and no plain call. 12b: an HF-layout checkpoint at LLaMA-2-7B widths
     cut to 4 layers (fp16), a ``ReplicaPool`` of 2 replicas cold-started
     from it (``checkpoint_replica_factory``, int8 on load, 2 slots, a
     64-position fp32 cache) behind a ``FleetTelemetry``, with
     ``bench.py:457-538``'s traffic at vocab 32000: ``failover_run`` (8
     req/s, 12 requests, a ``FaultInjector`` crash after 6 engine calls)
     and ``spike_run`` (4 req/s x 16, 8 + 16 requests), a
     ``MetricsHTTPServer`` over ``aggregate_registry`` scraped once
     mid-run; gates: every request resolved, the failed-over requests'
     tokens equal to an undisturbed replica's, a loadable incident
     report, one trace pid row per replica, the respawn, the scale-up,
     an alert in the chaos run and none in the steady base,
     ``check_invariants`` clean, every replica's parameters on the card,
     K1, K2 and K3 launched and no plain call; reported: each
     ``cold_start_s``, ``failover_recovery_s``, ``slo_violation_s``, the
     spike's latency p99. 12c: ``python -m flexflow_tpu_torch.serve`` in
     a subprocess with 12b's checkpoint and ``--8bit-quantization`` (its
     tokens equal to ``LLM.from_checkpoint(...).generate`` in process),
     then with no ``--model``; both exit 0;
 13. the host side of serving (no new kernel; K1-K3 serve every path).
     13a: phase 8's models on the native C++ scheduler and on the Python
     loop in 2 alternating pairs (decode ms/step and the loop's host
     share outside the fenced blocks, reported), tokens equal 8/8 at
     full length in every pass, then a mid-run cancel and a deadline on
     the native loop (their partial tokens a prefix, the others'
     unchanged); 13b a local directory at LLaMA-2-7B widths cut to 4
     layers (2 fp16 shards and an index, a synthetic 32000-piece
     ``tokenizer.model``) through ``LLM(dir)`` with text prompts: the
     native SentencePiece ids equal to the oracle's, the tokens to
     ``LLM.from_checkpoint(dir)``'s, one ``output_file`` record a
     request; 13e the same directory with ``use_kernels=False`` (plain
     versions on the card, no K1/K2) then the default (no plain call);
     13c the ``ffsv_*`` C ABI in process from the port's serve library
     (int8 on load: tokens equal to the Python path's; a depth-2 spec
     pair with a non-empty metrics dump), then the unchanged
     ``examples/c/incr_decoding.c`` compiled with ``cc`` and run on the
     card; 13d ``inference_debugging`` dumps of a 1-layer cut at 7B
     widths in fp32, card against CPU: the worst op output within
     ``DUMP_TOL`` of its largest magnitude; 13f the JAX package's
     ``inference/python/incr_decoding.py`` and ``spec_infer.py``, each in
     a process whose ``flexflow_tpu`` imports resolve to the port (an
     import alias of this script's, never the reverse): exit 0, every
     ``flexflow_tpu`` module the port's, K1/K2 launched. K1/K2 (and K3
     with int8 weights) launched and no plain call in every serving
     window but 13e's plain pass;
 14. CPU weight offload and sharded serving (K1-K3 at per-rank shapes;
     K1/K2's partials mode under sequence parallelism). 14a: phase 8's model (7B int8, bf16) built twice,
     offload off and on (``LLM.compile(cpu_offload=True)``, every
     paged weight checked pinned, prefetch reserve 1 GiB), warm-ups,
     then 2 alternating off/on pairs of 8 requests x 32 new tokens:
     tokens equal 8/8 in every pass, bytes paged, max_memory_allocated
     of each pass (and less the other model's card bytes, gated lower
     with offload), decode ms/step median/min/max, the host->device
     GB/s that a step's bytes and time imply, K2/K3 launched and no
     plain call. 14b (``parallel/launch.run_ranks`` subprocesses, each
     with a timeout): the collectives on CUDA tensors on 2 ranks
     (gloo, staged through pinned host buffers) against numpy; then
     LLaMA-2-7B widths, int8, fp32 compute and cache, 8 requests x 16
     new tokens on 1 rank (a world-size-1 NCCL group: the final-output
     broadcast runs on NCCL) and at tp=2, pp=2 and sp=2 on 2 ranks
     sharing the card (gloo): tokens 8/8 equal to the 1-rank run on
     every rank, each rank's K1/K2/K3 launches (at sp=2 every K1/K2
     launch returns its partials, which three collectives reconcile)
     with the shapes they ran at, peak memory and decode ms/step (two
     processes sharing one card through the host: not a speed of the
     parallelism); no plain call. At tp=2 every activation stays split
     over ``model`` on its features, as GSPMD keeps the JAX package's:
     each rank prints the bytes of the layer outputs it holds when the
     prefill returns against the 1-rank run's (gated at
     ``TP2_LAYER_OUTPUT_SHARE``) and the count and bytes of its
     collectives over ``model`` in the prefill and in one decode step. 14b-prefix: at
     tp=2 and sp=2 on the same ranks, 8 requests behind one 96-token
     prefix in 4 slots with the shared-prefix pool off, then on: equal
     tokens, the pool's hit tokens above 0 and equal on both ranks, K1
     launched for the suffixes. 14b-strategy: the same geometry at all
     32 layers, 8 new tokens, one rank in this process, then on 14b's
     tp=2 ranks under an assigned ``Strategy`` (lm_head's int8 kernel in
     row shards with its logits vocabulary-split, every down_proj in row
     shards, one attention's ``wo`` whole at rest) and under the port's
     own search (``auto_parallel``): tokens 8/8 equal to one rank's on
     both ranks, each rank's weight bytes, layer-output bytes and peak
     against one rank's, its ``model`` collectives (count and bytes) of
     the prefill and a decode step, K1/K2/K3 launched with their shapes, no plain call. 14c: each
     kernel at every shape that 14a and 14b launched it at, against its
     plain version (the partials mode over a cache of twice a rank's
     rows, split in halves at their offsets and combined), and the
     partials mode's timed row of the kernel table at the sp=2 decode
     shape.
 15. parallel and resumable training (``parallel_training_phase``);
     15b's tp=2 run keeps every activation split over ``model`` on its
     features and prints each rank's peak as a share of one rank's,
     gated at ``TP2_PEAK_SHARE``;
 16. the model frontends (no kernel; K1-K3 and their plain versions
     launch no time in the phase). 16a: torchvision's ResNet-50
     topology in plain ``torch.nn`` through the fx frontend, written as
     ONNX by the port's encoder and read back by ``ONNXModel``, and
     built as a functional Keras ``Model`` with the module's weights set
     through ``Layer.set_weights``: each FFModel holds 25,557,032
     parameters and its training-mode logits (fp32, TF32 off, batch 8,
     BatchNorm at init) are within 1e-4 of the module's largest logit;
     16b the fx-built ResNet-50 and phase 11's direct-builder model in
     bf16 at batch 256, in 3 alternating blocks of 4 steps (step ms,
     MFU, peak memory; finite losses); 16c a 2-layer encoder at
     BERT-large widths (``nn.MultiheadAttention(batch_first=True)``)
     through fx: its fp32 forward within 1e-4 of the module's, and 2
     ``fit`` steps' loss within 1e-4 of the CPU's from the same weights;
     16d the C graph builder's transformer block at BERT-large widths
     on the card and the CPU: the same IR text and layers, 3 SGD steps'
     losses within 1e-4; 16e ``export_dot`` of 16a's fx model: one node
     a layer and one an input;
 17. the Unity search (``search_phase``; K1-K3 on 17e's path). 17a on
     the host: ``optimize_model`` under the ``"h100-sxm"`` machine model
     with ``search_mesh`` at 1, 2, 8 and 16 GPUs (16: two HGX nodes over
     NDR InfiniBand) on BERT-large (phase 11's batch and length),
     ResNet-50 (phase 11's batch, 1000 classes) and LLaMA-2-7B (its 32
     layers as a training graph at phase 15's batch, 4096 tokens), all
     in bf16 compute, six searches at once in worker processes: search
     seconds, the adopted mesh, each candidate's count, the analytic
     step against data parallelism's (never worse); 17b
     ``CostModel.measure_node`` on the card in bf16 compute at every
     distinct key of 17a's BERT-large 2-GPU strategy:
     measured ms beside the analytic roofline's by op type, the worst
     ratio, the analytic fallbacks (counted, printed); 17c BERT-large
     widths, 2 layers, batch 8, fp32, compiled with ``auto_parallel`` and
     ``search_mesh`` on 2 ranks sharing the card from one rank's weights:
     4 steps' losses within 1e-5 of one rank's, each rank's weights the
     slices their specs name, ``searched_vs_dp_wallclock`` (two ranks on
     one card: not a parallel speed); 17d the four-branch inception
     block at data=4 on 4 ranks with the branch strategy of
     ``tests/test_measured_ab.py:86-124`` (H100 model): a region
     planned and run, losses and gradients within 1e-5 of one rank's
     sequential walk; 17e phase 8's model compiled with ``auto_parallel``
     on the one card: 8/8 requests give phase 8's tokens, K1/K2/K3
     launched, no plain call; 17f BERT-large's costed dot at compile and
     its ``pcg_to_dot``: every node carries a cost;
 18. the engines' programs (``serve/graphs.py``: each engine's stages
     captured as CUDA graphs and replayed; phases 4-17 run with them
     on), on phase 6-7's models (LLaMA-2-7B geometry, bf16, 32 layers,
     built here when phases 6 and 7 do not run). From one prefilled cache
     state (8 prompts), each of the decode block (greedy at width 8, and
     top-p 0.6 / temperature 0.8 under one seed), ``SpecChainEngine``
     (depth 7), ``MultiSpecEngine`` at B = 1 (depth 7) and B = 2 (the
     2- and a 3-layer draft, tree width 16) and ``BeamSpecEngine``
     (width 2, depth 3; adaptive per-row first depths in the spec blocks)
     runs one block through its eager body (``graphs.eager_bodies``) and
     through its program, then 2 alternating timed pairs: gates: tokens
     and ``packed`` bit-equal in every pass, launch counts equal, one
     build per engine, no plain call; reported: decode ms/step (blocks
     of 8 steps) and spec ms/round (blocks of 6 rounds) eager and
     program. Then an adaptive mixed batch (prompt lengths 8-32, budgets
     12-26) through the chain, tree and beam engines: one build each,
     ``ffsv_engine_retraces_total`` 0; phase 5's incremental generate
     (8 new tokens) profiled eager and program
     in 2 pairs (device-busy share); the verifier quantized to int8 and
     its decode block eager against program (K3 inside the captures).

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the
repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
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
F32_SOURCE = "flexflow_tpu_torch/kernels/csrc/flash_attend_f32.cu"
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
    real rows sit at other rows of the tile); at the multi-query shapes
    of Falcon-7B (71 query heads on one KV head, D 64: 9 query tiles of 64
    rows at width 8) and StarCoder (48 on one, D 128: 6 tiles); and at
    MPT-7B's with its ALiBi slopes on every call. Then fp32 caches (the
    FFMA kernels, whose query tile follows G*Q: 8 rows at width 1 and 8 on
    one split, 16 against 8 with GQA on the split-S shape, and at G = 8
    the 64-row tile kernel at width 8 against the 8-row one at width 1)
    at the slice's shape, the split-S GQA shape, G = 8 and D 512 (the
    wide kernel). The 16-bit wide kernel (a cluster of column slices
    summing its partial scores in rank order) at D 256, 512 and 768, at
    D 320's serving shape (12 heads on a cache padded to 512: one wave,
    two blocks an SM), and split-S with GQA at D 512 in bf16 and fp16."""
    from flexflow_tpu_torch.kernels.attention import append_at, flash_attend
    from flexflow_tpu_torch.ops.inc_attention import alibi_slopes

    dev = "cuda"
    bf, f32 = torch.bfloat16, torch.float32
    for R, H, KH, S, app, D, alibi, dt in (
            (8, 32, 32, 256, 63, 128, False, bf),
            (2, 8, 4, 1024, 700, 128, False, bf),
            (8, 16, 16, 256, 63, 256, False, bf),
            (8, 8, 8, 256, 63, 512, False, bf),
            (2, 8, 4, 1024, 700, 512, False, bf),
            (2, 8, 4, 1024, 700, 512, False, torch.float16),
            (8, 12, 12, 256, 63, 512, False, bf),
            (4, 4, 4, 256, 63, 768, False, bf),
            (8, 71, 1, 256, 63, 64, False, bf),
            (8, 48, 1, 256, 63, 128, False, bf),
            (8, 32, 32, 256, 63, 128, True, bf),
            (8, 32, 32, 256, 63, 128, False, f32),
            (2, 8, 4, 1024, 700, 128, False, f32),
            (4, 16, 2, 256, 63, 128, False, f32),
            (8, 8, 8, 256, 63, 512, False, f32)):
        al = alibi_slopes(H, device=dev) if alibi else None
        tag = (" ALiBi" if alibi else "") + f" {str(dt)[6:]}"
        q8, k, v = mk(R, 8, H, KH, D, S, dt, 21)
        g = torch.Generator(device=dev).manual_seed(22)
        kn = torch.randn((R, 1, KH, D), generator=g, device=dev).to(dt)
        vn = torch.randn((R, 1, KH, D), generator=g, device=dev).to(dt)
        appos = ivec([app - 3 * r for r in range(R)])
        lengths = appos + 1
        qpos8 = appos[:, None] + torch.arange(8, dtype=torch.int32,
                                              device=dev)[None]
        k1c, v1c = k.clone(), v.clone()
        out1 = flash_attend(q8[:, :1].contiguous(), k1c, v1c, lengths,
                            appos[:, None].contiguous(), alibi=al,
                            append_kv=(kn, vn, appos))[0]
        k8c, v8c = k.clone(), v.clone()
        out8 = flash_attend(q8, k8c, v8c, lengths, qpos8, alibi=al,
                            append_kv=(kn, vn, appos))[0]
        append_at(k, v, kn, vn, appos)
        outk1 = flash_attend(q8, k, v, lengths, qpos8, causal=False,
                             bias=torch.zeros((R, 8, S), device=dev),
                             alibi=al)
        torch.cuda.synchronize()
        same = (torch.equal(out1[:, 0], out8[:, 0])
                and torch.equal(out8[:, 0], outk1[:, 0]))
        log(f"  invariance R{R} H{H} KH{KH} S{S} D{D}{tag}: width-1 == "
            f"width-8 == K1 bitwise: {same} {'PASS' if same else 'FAIL'}")
        if not same:
            raise AssertionError("width/K1-vs-K2 bitwise invariance failed")
        # the chain tree staged at appos..appos+7, as the verify pass does
        lens8 = appos + 8
        outb = flash_attend(q8, k, v, lens8, qpos8, causal=False,
                            bias=chain_tree_bias(torch, appos, S), alibi=al)
        outc = flash_attend(q8, k, v, lens8, qpos8, alibi=al)
        torch.cuda.synchronize()
        same = (torch.equal(outb, outc)
                and torch.equal(outb[:, 0], out8[:, 0]))
        log(f"  invariance R{R} H{H} KH{KH} S{S} D{D}{tag}: K1 chain-tree "
            f"bias == K1 causal (8 rows) == width-8 decode (row 0) "
            f"bitwise: {same} "
            f"{'PASS' if same else 'FAIL'}")
        if not same:
            raise AssertionError("tree-bias vs causal bitwise invariance "
                                 "failed")


def head_dim_cases(torch, ivec, mk, compare, bf16_control):
    """K1 and K2 at head dims the wide kernels take directly (256, 512,
    768, and 2304: nine 256-column chunks, past one 16-bit cluster of 8,
    so two clusters of five ranks, a rank with two score chunks and a
    block with no output slice) and through the padded cache (32 -> 64,
    80 -> 128, 160 -> 256, 320 -> 512: ``ops/inc_attention.py``
    ``cache_head_dim``), bf16, fp16 and fp32 (fp32 at D = 256 and 320:
    the wide FFMA kernel), each against the plain version on the same
    unpadded inputs (softmax scale 1/sqrt(D) of the real D). R4 x KH4
    streams on S 512 split S, so the wide kernels' split partials and
    combine run too."""
    from flexflow_tpu_torch.kernels.attention import (append_at,
                                                      flash_attend,
                                                      reference_attend)
    from flexflow_tpu_torch.ops.inc_attention import (cache_head_dim,
                                                      pad_head_dim)

    dev = "cuda"
    for D, dt in ((32, torch.bfloat16), (80, torch.float16),
                  (256, torch.bfloat16), (256, torch.float16),
                  (256, torch.float32), (160, torch.float32),
                  (320, torch.bfloat16), (512, torch.bfloat16),
                  (320, torch.float32), (768, torch.bfloat16),
                  (2304, torch.bfloat16)):
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


def wide_partials_cases(torch, ivec, mk, compare):
    """The 16-bit wide kernel's partials mode (out null, the sequence-
    parallel path) at D 512: K1, and K2 with its append, against
    ``partials_reference`` on the same cache. Each split's partial is the
    kernel's; they are combined in order (``combine_partials``) against the
    reference's one split, and where the plan makes one split (R8, 8 kv
    heads, S 256) the kernel's unnormalised O and its row max and sum also
    against the reference's directly. bf16 one split, fp16 split-S GQA."""
    from flexflow_tpu_torch.kernels.attention import (
        append_at, combine_partials, flash_attend_partials,
        partials_reference, wide_split_plan)

    dev = "cuda"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for R, H, KH, S, dt, lens in (
            (8, 8, 8, 256, torch.bfloat16, [31, 64, 200, 256, 1, 130, 63, 97]),
            (2, 8, 4, 1024, torch.float16, [700, 130])):
        D = 512
        plan = wide_split_plan(R, KH, S, D, sms)
        q, k, v = mk(R, 8, H, KH, D, S, dt, 150 + R)
        g = torch.Generator(device=dev).manual_seed(160 + R)
        kn = torch.randn((R, 1, KH, D), generator=g, device=dev).to(dt)
        vn = torch.randn((R, 1, KH, D), generator=g, device=dev).to(dt)
        lengths = ivec(lens)
        qpos = (lengths[:, None] - 8 + torch.arange(
            8, dtype=torch.int32, device=dev)[None]).clamp(min=0)
        appos = lengths - 1
        tag = f"R{R} H{H} KH{KH} S{S} D{D} {str(dt)[6:]} split plan {plan}"
        for what in ("K1", "K2"):
            kk, vv = k.clone(), v.clone()
            if what == "K1":
                po, pm = flash_attend_partials(q, kk, vv, lengths, qpos)
            else:
                po, pm = flash_attend_partials(q, kk, vv, lengths, qpos,
                                               append_kv=(kn, vn, appos))
                append_at(k, v, kn, vn, appos)
                if not (torch.equal(kk, k) and torch.equal(vv, v)):
                    raise AssertionError(f"wide partials {what} {tag}: the "
                                         "append differs from the plain one")
            torch.cuda.synchronize()
            ro, rm = partials_reference(q, k, v, lengths, qpos)
            if po.shape[0] != plan[0]:
                raise AssertionError(f"wide partials {what} {tag}: "
                                     f"{po.shape[0]} splits")
            compare(f"{what} partials {tag}", combine_partials(ro, rm, dt),
                    combine_partials(po, pm, dt), lengths, dt)
            if plan[0] == 1:
                compare(f"  {what} partial O {tag}", ro.reshape(R, 8, -1),
                        po.reshape(R, 8, -1), lengths, dt)
                compare(f"  {what} partial (m, l) {tag}", rm.reshape(R, 8, -1),
                        pm.reshape(R, 8, -1), lengths, dt)


def wide_head_dim_rows(torch, timer, read_floor, ivec, compare, sdpa_call,
                       pre_len, pre_qpos, appos_main):
    """Head dims past 256 at the serving shapes (R 8, S 256; prefill Q 64
    and decode Q 8; H = 4096 // D heads, kv heads alike): K1 and K2 on
    the padded cache the serving path allocates (320 -> 512), each
    checked once against the plain version on the unpadded inputs, then
    timed beside its bound and read floor (the bytes the unpadded q, k
    and v hold: the work the function needs), the plain version and SDPA
    on the unpadded tensors. Where the cache is padded, the read floor of
    the padded bytes the kernel moves is shown beside them."""
    from flexflow_tpu_torch.kernels.attention import (append_at,
                                                      flash_attend,
                                                      reference_attend)
    from flexflow_tpu_torch.ops.inc_attention import (cache_head_dim,
                                                      pad_head_dim)

    dev = "cuda"
    log("  head dims past 256 (median of 20, L2 flushed before each launch)")
    out_rows = []
    for dt, D in ((torch.bfloat16, 320), (torch.bfloat16, 512),
                  (torch.float32, 320), (torch.bfloat16, 768),
                  (torch.float16, 512), (torch.float16, 768)):
        R, H, S = REQUESTS, 4096 // D, MAX_SEQ
        Dp = cache_head_dim(D, pad=True)
        scale = 1.0 / D ** 0.5
        g = torch.Generator(device=dev).manual_seed(D)

        def r(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dt)

        k, v = r(R, H, S, D), r(R, H, S, D)
        kp, vp = pad_head_dim(k, Dp), pad_head_dim(v, Dp)
        tag = f"{str(dt)[6:]} H{H} D{D} (cache D {Dp})"
        # K1 prefill
        q = r(R, 64, H, D)
        qp = pad_head_dim(q, Dp)
        out = flash_attend(qp, kp, vp, pre_len, pre_qpos, qk_scale=scale)
        out = out.reshape(R, 64, H, Dp)[..., :D].reshape(R, 64, H * D)
        torch.cuda.synchronize()
        err = compare(f"K1 prefill {tag}", reference_attend(
            q, k, v, pre_len, pre_qpos, qk_scale=scale), out, pre_len, dt)
        b, by, nbytes = attention_bound_ms(torch, q, pre_len, pre_qpos, S,
                                           H, True, dt)
        _, _, padded = attention_bound_ms(torch, qp, pre_len, pre_qpos, S,
                                          H, True, dt)
        out_rows.append(dict(
            name=f"K1 prefill R8 Q64 {tag} S256", max_abs_err=err,
            ms=timer(lambda: flash_attend(qp, kp, vp, pre_len, pre_qpos,
                                          qk_scale=scale)),
            plain_ms=timer(lambda: reference_attend(
                q, k, v, pre_len, pre_qpos, qk_scale=scale)),
            sdpa_ms=timer(sdpa_call(q, k, v, pre_len, pre_qpos)),
            bound_ms=b, bound_by=by, read_floor_ms=read_floor(nbytes),
            padded_read_floor_ms=read_floor(padded)))
        # K2 decode at the slice's mid-generation step
        q1 = r(R, 8, H, D)
        kn, vn = r(R, 1, H, D), r(R, 1, H, D)
        q1p, knp, vnp = (pad_head_dim(t, Dp) for t in (q1, kn, vn))
        ln = appos_main + 1
        qpos = appos_main[:, None] + torch.arange(
            8, dtype=torch.int32, device=dev)[None]
        kpc, vpc = kp.clone(), vp.clone()
        out = flash_attend(q1p, kpc, vpc, ln, qpos,
                           append_kv=(knp, vnp, appos_main),
                           qk_scale=scale)[0]
        out = out.reshape(R, 8, H, Dp)[..., :D].reshape(R, 8, H * D)
        torch.cuda.synchronize()
        kr, vr = k.clone(), v.clone()
        append_at(kr, vr, kn, vn, appos_main)
        if not (torch.equal(kpc[..., :D], kr)
                and bool((kpc[..., D:] == 0).all())):
            raise AssertionError(f"K2 {tag}: padded cache after the append "
                                 "differs from the plain append")
        err = compare(f"K2 decode {tag} (cache bitwise ok)",
                      reference_attend(q1, kr, vr, ln, qpos,
                                       qk_scale=scale), out, ln, dt)
        b, by, nbytes = attention_bound_ms(
            torch, q1, ln, qpos, S, H, True, dt,
            extra_bytes=4 * kn.numel() * kn.element_size())
        _, _, padded = attention_bound_ms(
            torch, q1p, ln, qpos, S, H, True, dt,
            extra_bytes=4 * knp.numel() * knp.element_size())
        out_rows.append(dict(
            name=f"K2 decode R8 Q8 {tag} S256", max_abs_err=err,
            ms=timer(lambda: flash_attend(q1p, kpc, vpc, ln, qpos,
                                          append_kv=(knp, vnp, appos_main),
                                          qk_scale=scale)),
            plain_ms=timer(lambda: reference_attend(q1, kr, vr, ln, qpos,
                                                    qk_scale=scale)),
            sdpa_ms=timer(sdpa_call(q1, kr, vr, ln, qpos)),
            bound_ms=b, bound_by=by, read_floor_ms=read_floor(nbytes),
            padded_read_floor_ms=read_floor(padded)))
        del k, v, kp, vp, kpc, vpc, kr, vr
    for row in out_rows:
        log(f"  {row['name']:44s} kernel {row['ms']:.4f} ms | bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}) | plain "
            f"{row['plain_ms']:.4f} ms | sdpa {row['sdpa_ms']:.4f} ms | sum "
            f"over the same bytes {row['read_floor_ms']:.4f} ms | over the "
            f"padded cache's {row['padded_read_floor_ms']:.4f} ms")
    return out_rows


# the attention shapes of phase 10's families at R 8, S 256: (name, H, KH,
# D, ALiBi); OPT-6.7B has LLaMA-2-7B's, with the scale passed on q's side
FAMILY_ATTENTION = (("Falcon-7B", 71, 1, 64, False),
                    ("StarCoder", 48, 1, 128, False),
                    ("MPT-7B", 32, 32, 128, True))


def family_attention_rows(torch, timer, read_floor, ivec, k1_case, k2_case,
                          pre_len, pre_qpos, appos_main, vstart):
    """K1 and K2 at the serving shapes of phase 10's families, bf16, R 8,
    S 256, each against the plain version: prefill (Q 64), decode (Q 8,
    the fused append into layer 5 of a 32-layer stack) and the chain-tree
    verify; MPT's with its ALiBi slopes, OPT's with its query-side scale.
    Then timed rows beside the bound, the read floor, the plain version
    and SDPA (``enable_gqa`` for multi-query; ALiBi as a float mask)."""
    import torch.nn.functional as F

    from flexflow_tpu_torch.kernels.attention import (flash_attend,
                                                      reference_attend)
    from flexflow_tpu_torch.ops.inc_attention import alibi_slopes

    dev, bf, R, S = "cuda", torch.bfloat16, REQUESTS, MAX_SEQ
    v_qpos = vstart[:, None] + torch.arange(8, dtype=torch.int32,
                                            device=dev)[None]
    v_len = vstart + 8
    v_bias = chain_tree_bias(torch, vstart, S)
    log("  the families' attention shapes (phase 10), bf16, R 8, S 256")
    k1_case("K1 OPT prefill H32 D128 q-scale", R, 64, 32, 32, 128, S, bf,
            pre_len, pre_qpos, 70, qk_scale=1.0 * 128 ** -0.5)
    k2_case("K2 OPT decode H32 D128", R, 8, 32, 32, 128, S, bf, appos_main,
            71, L=LAYERS, layer_idx=5)

    def sdpa(q, kc, vc, lengths, qpos, bias=None, alibi=None):
        qh = q.transpose(1, 2)                          # [R, H, Q, D]
        s = torch.arange(kc.shape[-2], device=dev)
        vis = s[None, None, :] < lengths[:, None, None]
        vis = (vis & (s[None, None, :] <= qpos[:, :, None])
               if bias is None else vis & (bias == 0))[:, None]
        if alibi is not None:   # the additive form: -slope * (qpos - s)
            dist = (qpos[:, :, None] - s[None, None, :]).float()[:, None]
            mask = torch.where(vis, -alibi[None, :, None, None] * dist,
                               float("-inf")).to(q.dtype)
        else:
            mask = vis
        gqa = q.shape[2] != kc.shape[1]
        return lambda: F.scaled_dot_product_attention(
            qh, kc, vc, attn_mask=mask, enable_gqa=gqa)

    rows = []

    def timed(name, fn, plain, lib, bound, err):
        b, by, nbytes = bound
        rows.append(dict(name=name, max_abs_err=err, ms=timer(fn),
                         plain_ms=timer(plain), sdpa_ms=timer(lib),
                         bound_ms=b, bound_by=by,
                         read_floor_ms=read_floor(nbytes)))

    for fam, H, KH, D, use_alibi in FAMILY_ATTENTION:
        al = alibi_slopes(H, device=dev) if use_alibi else None
        tag = f"{fam} H{H} KH{KH} D{D}" + (" ALiBi" if use_alibi else "")
        seed = 72 + 4 * len(rows)
        err, (q, k, v) = k1_case(f"K1 prefill {tag}", R, 64, H, KH, D, S, bf,
                                 pre_len, pre_qpos, seed, alibi=al)
        if fam == "Falcon-7B":
            timed(f"K1 prefill R8 Q64 {tag} S256",
                  lambda: flash_attend(q, k, v, pre_len, pre_qpos),
                  lambda: reference_attend(q, k, v, pre_len, pre_qpos),
                  sdpa(q, k, v, pre_len, pre_qpos),
                  attention_bound_ms(torch, q, pre_len, pre_qpos, S, KH,
                                     True, bf), err)
        err, (q, k, v, kn, vn, ln, qp) = k2_case(
            f"K2 decode {tag}", R, 8, H, KH, D, S, bf, appos_main, seed + 1,
            L=LAYERS, layer_idx=5, alibi=al)
        timed(f"K2 decode R8 Q8 {tag} S256, stacked",
              lambda: flash_attend(q, k, v, ln, qp, alibi=al, layer_idx=5,
                                   append_kv=(kn, vn, appos_main)),
              lambda: reference_attend(q, k[5], v[5], ln, qp, alibi=al),
              sdpa(q, k[5], v[5], ln, qp, alibi=al),
              attention_bound_ms(torch, q, ln, qp, S, KH, True, bf,
                                 extra_bytes=4 * kn.numel() * 2), err)
        err, (q, k, v) = k1_case(f"K1 verify chain-tree bias {tag}", R, 8, H,
                                 KH, D, S, bf, v_len, v_qpos, seed + 2,
                                 bias=v_bias, alibi=al, causal=False)
        if fam == "Falcon-7B":
            timed(f"K1 verify R8 Q8 chain-tree bias {tag} S256",
                  lambda: flash_attend(q, k, v, v_len, v_qpos, bias=v_bias,
                                       causal=False),
                  lambda: reference_attend(q, k, v, v_len, v_qpos,
                                           bias=v_bias, causal=False),
                  sdpa(q, k, v, v_len, v_qpos, bias=v_bias),
                  attention_bound_ms(torch, q, v_len, v_qpos, S, KH, False,
                                     bf, bias=v_bias), err)
        del q, k, v
    for r in rows:
        log(f"  {r['name']:52s} kernel {r['ms']:.4f} ms | bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}) | plain "
            f"{r['plain_ms']:.4f} ms | sdpa {r['sdpa_ms']:.4f} ms | sum over "
            f"the same bytes {r['read_floor_ms']:.4f} ms")
    return rows


def kernel_phase(torch, timer):
    from flexflow_tpu_torch import kernels
    from flexflow_tpu_torch.kernels.attention import (NEG_INF, append_at,
                                                      flash_attend,
                                                      reference_attend,
                                                      split_attend, split_plan,
                                                      wide_split_plan)
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
        the plain split + combine with the same plan (the 16-bit wide
        kernel's own plan at head dims 256 and past)."""
        R_, KH_, S_, D_ = k.shape[0], k.shape[1], k.shape[2], k.shape[3]
        plan = (wide_split_plan(R_, KH_, S_, D_, sms)
                if k.dtype != torch.float32 and D_ >= 256
                else split_plan(R_, KH_, S_, sms))
        if plan[0] > 1:
            compare(f"  {name[:22]} vs split plain {plan}",
                    split_attend(q, k, v, lengths, qpos, plan=plan, **kw),
                    out, lengths, dtype)

    def k1_case(name, R, Q, H, KH, D, S, dtype, lengths, qpos, seed,
                bias=None, alibi=None, causal=True, out_dtype=None,
                qk_scale=None):
        q, k, v = mk(R, Q, H, KH, D, S, dtype, seed)
        kw = dict(bias=bias, alibi=alibi, causal=causal, qk_scale=qk_scale)
        out = flash_attend(q, k, v, lengths, qpos, out_dtype=out_dtype, **kw)
        torch.cuda.synchronize()
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
                layer_idx=None, out_dtype=None, alibi=None):
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
                                         out_dtype=out_dtype, alibi=alibi)
        torch.cuda.synchronize()
        append_at(k_ref, v_ref, kn, vn, appos, layer_idx=layer_idx)
        kl = k_ref if layer_idx is None else k_ref[layer_idx]
        vl = v_ref if layer_idx is None else v_ref[layer_idx]
        ref = reference_attend(q, kl, vl, lengths, qpos, out_dtype=out_dtype,
                               alibi=alibi)
        if out.dtype != (out_dtype or dtype):
            raise AssertionError(f"{name}: out is {out.dtype}")
        if not (torch.equal(k_out, k_ref) and torch.equal(v_out, v_ref)):
            raise AssertionError(f"{name}: cache after the fused append "
                                 "differs from the plain append")
        if k_out.data_ptr() != k.data_ptr():
            raise AssertionError(f"{name}: the append was not in place")
        tdt = coarser(dtype, out_dtype)
        split_check(name, q, kl, vl, lengths, qpos, out, tdt,
                    out_dtype=out_dtype, alibi=alibi)
        ctl = (bf16_control(q, kl, vl, lengths, qpos, alibi=alibi)
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
    wide_partials_cases(torch, ivec, mk, compare)
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
    for dt in (bf, f32):
        sfx = "" if dt == bf else " fp32"
        for R_ in (8, 1):
            name = f"K2 long R{R_} Q8 S4096 len4000{sfx}"
            app_l = ivec([len_l - 1] * R_)
            _, (q, k, v, kn_, vn_, ln, qp) = k2_case(
                name, R_, 8, H, KH, D, S_l, dt, app_l, 30 + R_)
            long_row(name, lambda: flash_attend(q, k, v, ln, qp,
                                                append_kv=(kn_, vn_, app_l)),
                     sdpa_call(q, k, v, ln, qp),
                     attention_bound_ms(
                         torch, q, ln, qp, S_l, KH, True, dt,
                         extra_bytes=4 * kn_.numel() * kn_.element_size()))
            del q, k, v
        if dt == bf:
            # the 16-bit wide kernel at a long cache: D 512, 8 heads
            name = "K2 long R8 Q8 S4096 len4000 D512"
            app_l = ivec([len_l - 1] * R)
            _, (q, k, v, kn_, vn_, ln, qp) = k2_case(
                name, R, 8, 8, 8, 512, S_l, dt, app_l, 38)
            long_row(name, lambda: flash_attend(q, k, v, ln, qp,
                                                append_kv=(kn_, vn_, app_l)),
                     sdpa_call(q, k, v, ln, qp),
                     attention_bound_ms(
                         torch, q, ln, qp, S_l, 8, True, dt,
                         extra_bytes=4 * kn_.numel() * kn_.element_size()))
            del q, k, v
        name = f"K1 long R8 Q64 qpos 3936..3999{sfx}"
        ln = ivec([len_l] * R)
        qp = (torch.arange(Qp, dtype=torch.int32, device=dev)
              + len_l - Qp)[None].repeat(R, 1)
        _, (q, k, v) = k1_case(name, R, Qp, H, KH, D, S_l, dt, ln, qp, 40)
        long_row(name, lambda: flash_attend(q, k, v, ln, qp),
                 sdpa_call(q, k, v, ln, qp),
                 attention_bound_ms(torch, q, ln, qp, S_l, KH, True, dt))
        del q, k, v
    targets = [("K1 faster than SDPA at the slice shape", ms1 < lib1),
               ("K2 within 4x of its bound at the slice shape",
                ms2 <= 4 * b2)]
    for r in long_rows:
        # fp32's K1 is bound by FFMA issue (operations): its aim is 40%
        fp32_k1 = r["name"].startswith("K1") and r["name"].endswith("fp32")
        aim = 0.4 if fp32_k1 else 0.5
        targets.append((f"{r['name']} at >= {aim:.0%} of its bound",
                        r["bound_share"] >= aim))
    for name, met in targets:
        log(f"  target: {name}: {'met' if met else 'MISSED'}")
    log(json.dumps({"long_cache_rows": long_rows}))

    # --- fp16 and fp32 caches and head dim 256 at the serving shapes
    #     (timed only, each also checked once against the plain version):
    #     the bf16 D = 128 rows' lengths (D 256: 16 heads, the same cache
    #     bytes); fp32 is the replica fleet's and 14b's cache type ---
    log("  fp16, fp32 and D = 256 rows (median of 20, L2 flushed before each "
        "launch)")
    dim_rows = []
    for dt, H_, D_ in ((h16, H, D), (f32, H, D), (bf, H // 2, 2 * D),
                       (h16, H // 2, 2 * D)):
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
        err2, (q, k, v, kn_, vn_, ln, qp) = k2_case(
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
        if dt == f32:
            # the kernels line's row of the fp32 form: the fleet's decode
            rows.append(dict(name="flash_attend_fp32", route="cuda",
                             source=F32_SOURCE, replaces=K2_REPLACES,
                             max_abs_err=err2, ms=dim_rows[-1]["ms"],
                             plain_ms=dim_rows[-1]["plain_ms"], bound_ms=b,
                             bound_by=by,
                             library_ms=dim_rows[-1]["sdpa_ms"]))
        del q, k, v
    for r in dim_rows:
        log(f"  {r['name']:34s} kernel {r['ms']:.4f} ms | bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}) | plain "
            f"{r['plain_ms']:.4f} ms | sdpa {r['sdpa_ms']:.4f} ms | sum over "
            f"the same bytes {r['read_floor_ms']:.4f} ms")
    log(json.dumps({"dtype_dim_rows": dim_rows}))
    wide_rows = wide_head_dim_rows(torch, timer, read_floor, ivec, compare,
                                   sdpa_call, pre_len, pre_qpos,
                                   appos_main)
    log(json.dumps({"wide_head_dim_rows": wide_rows}))
    # the kernels line's row of the 16-bit wide kernel: the decode of
    # phase 4's bf16 head-dim-320 pass (12 heads, cache padded to 512)
    k2w = next(r for r in wide_rows if r["name"].startswith("K2")
               and "bfloat16" in r["name"] and "D320" in r["name"])
    rows.append(dict(name="flash_attend_wide", route="cuda",
                     source=K1_SOURCE, replaces=K2_REPLACES,
                     max_abs_err=k2w["max_abs_err"], ms=k2w["ms"],
                     plain_ms=k2w["plain_ms"], bound_ms=k2w["bound_ms"],
                     bound_by=k2w["bound_by"], library_ms=k2w["sdpa_ms"]))
    fam_rows = family_attention_rows(torch, timer, read_floor, ivec,
                                     k1_case, k2_case, pre_len, pre_qpos,
                                     appos_main, vstart)
    log(json.dumps({"family_attention_rows": fam_rows}))
    # K2's partials mode at a sp=2 rank's decode shape (fp32, 32 cache
    # rows; phase 14c times it again at the shape its run recorded)
    log(json.dumps({"partials_row": partials_row(
        torch, (R, 8, H, KH, 32, D, "float32", "partials", False), None)}))
    rows.append(k3_phase(torch, timer, read_floor))
    kernels.reset_counts()
    return rows


# K3 at the shapes of the 7B int8 path: (K, N) of wq/wk/wv/wo, gate/up,
# down, lm_head (fp32 out), the fused wqkv and gate|up; then an odd-K
# int4 case and an N that is not a multiple of the 128-column tile
K3_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000),
             (4096, 12288), (4096, 22016), (4095, 4096), (4096, 1000))
K3_TIMED = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))
# K3 at the (K, N) of phase 10's families: Falcon-7B (k/v 4544 x 64, one
# N tile; q/o, MLP, head), StarCoder (k/v 6144 x 128; ...), OPT-6.7B's MLP
# and head (50272 columns: not a multiple of the 128-column tile) and
# MPT-7B's head; the heads (N > 32000) keep fp32 logits
K3_FAMILY_SHAPES = ((4544, 64), (4544, 4544), (4544, 18176), (18176, 4544),
                    (4544, 65024), (6144, 128), (6144, 6144), (6144, 24576),
                    (24576, 6144), (6144, 49152), (4096, 16384),
                    (16384, 4096), (4096, 50272), (4096, 50432))
K3_FAMILY_TIMED = ((4544, 64), (4544, 65024))
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
    log(json.dumps({"k3_family_rows": k3_family_rows(
        torch, timer, read_floor, g, rel_err)}))
    return row


def k3_family_rows(torch, timer, read_floor, g, rel_err):
    """K3 at every (K, N) of ``K3_FAMILY_SHAPES`` against its plain
    version (int8, bf16 x, M 8, 64 and 256; fp32 out for the heads) with
    the row invariance at M = 64; then timed rows at ``K3_FAMILY_TIMED``,
    M 8 and 64, beside the bound, the read floor, the plain version and
    ``torch.matmul`` on a dequantized bf16 copy."""
    from flexflow_tpu_torch.kernels.qmatmul import qmatmul_plain, split_plan
    from flexflow_tpu_torch.quant import dequantize_array, qmatmul, \
        quantize_array

    dev, bf, f32 = "cuda", torch.bfloat16, torch.float32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for K, N in K3_FAMILY_SHAPES:
        od = f32 if N > 32000 else bf
        odn = str(od).replace("torch.", "")
        w = torch.empty((K, N), device=dev).normal_(0, 0.02, generator=g)
        leaf = quantize_array(w.to(bf), "int8")
        del w
        worst, inv_ok = 0.0, True
        for M in (8, 64, 256):
            x = torch.randn((M, K), generator=g, device=dev).to(bf)
            y = qmatmul(x, leaf, bf, od)
            torch.cuda.synchronize()
            rel = rel_err(y, qmatmul_plain(x, leaf, bf, od))
            worst = max(worst, rel / K3_TOL[odn])
            if rel > K3_TOL[odn] or not bool(torch.isfinite(y.float()).all()):
                log(f"  K3 family K{K} N{N} M{M}: rel err {rel:.3e} FAIL")
                raise AssertionError("K3 parity failed at a family shape")
            if M == 64:
                inv_ok &= (torch.equal(y[8:16], qmatmul(
                    x[8:16].contiguous(), leaf, bf, od))
                    and torch.equal(y[61:62], qmatmul(
                        x[61:62].contiguous(), leaf, bf, od)))
        log(f"  K3 int8 K{K:5d} N{N:5d} -> {odn:8s} plan "
            f"{split_plan(K, N, sms)}: M 8/64/256 worst err / tol "
            f"{worst:.3f}; row invariance {'PASS' if inv_ok else 'FAIL'}")
        if not inv_ok:
            raise AssertionError("K3 row invariance failed at a family "
                                 "shape")
        if (K, N) in K3_FAMILY_TIMED:
            wd = dequantize_array(leaf, bf)
            for M in (8, 64):
                x = torch.randn((M, K), generator=g, device=dev).to(bf)
                b, by, nb = k3_bound_ms(M, K, N, odn)
                r = dict(M=M, K=K, N=N, out=odn,
                         ms=timer(lambda: qmatmul(x, leaf, bf, od)),
                         plain_ms=timer(lambda: qmatmul_plain(x, leaf, bf,
                                                              od)),
                         library_ms=timer(lambda: torch.matmul(x, wd)),
                         bound_ms=b, bound_by=by, read_floor_ms=read_floor(nb))
                rows.append(r)
                log(f"  K3 M{M:3d} K{K:5d} N{N:5d} -> {odn:8s} kernel "
                    f"{r['ms']:.4f} ms | bound {b:.4f} ms ({by}) | sum over "
                    f"the same bytes {r['read_floor_ms']:.4f} ms | plain "
                    f"{r['plain_ms']:.4f} ms | bf16 matmul "
                    f"{r['library_ms']:.4f} ms")
            del wd
        del leaf
    return rows


# ----------------------------------------------------------------------
# phase 4: end-to-end parity, card vs CPU
# ----------------------------------------------------------------------
# phase 4: new tokens a request (8 requests x 32-token prompts); the pass
# that serves through the 16-bit wide kernel
E2E_NEW = 8
WIDE_PASS = "head dim 320 (12 heads, hidden 3840), bf16"


def e2e_parity_phase(torch):
    """Phase 4. Its CPU references run in turn on one worker thread beside
    the card's work (one thread: two teams of torch's CPU threads at
    most). Returns the launch counts of the bf16 head-dim-320 pass (the
    16-bit wide kernel's serving path)."""
    from concurrent.futures import ThreadPoolExecutor

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
              heads=HEADS, hidden=HIDDEN):
        cfg = FFConfig(device=device, max_requests_per_batch=REQUESTS,
                       max_sequence_length=MAX_SEQ,
                       max_tokens_per_batch=REQUESTS * PROMPT_LEN,
                       kv_cache_dtype=dtype, compute_dtype=dtype,
                       max_beam_width=width, quantization_type=quant,
                       gemm_fusion=fusion)
        m = FFModel(cfg)
        create_llama_model(m, dataclasses.replace(
            lc, hidden_size=hidden, num_hidden_layers=layers,
            num_attention_heads=heads, num_key_value_heads=heads), mode=mode,
            data_type=DataType(dtype))
        m.compile()
        return m

    def draw(m, rng):
        """One seeded numpy draw of ``m``'s weights, carried to both
        devices."""
        return {layer: {w: (np.ones(t.shape, np.float32) if "norm" in layer
                            else 0.02 * rng.standard_normal(
                                t.shape, dtype=np.float32))
                        for w, t in lp.items()}
                for layer, lp in m.params.items()}

    def incr(m, wts, device):
        """(tokens, seconds, launch counts) of incremental decoding of
        ``m`` on ``wts``; the counts are reset only for a card run (the
        CPU runs on the worker thread launch nothing and must not reset
        the card's counts)."""
        load_params(m, params_from_jax(wts, device=device))
        rm = RequestManager()
        guids = [rm.register_new_request(p, max_new_tokens=E2E_NEW)
                 for p in prompts]
        if device == "cuda":
            kernels.reset_counts()
        t0 = time.perf_counter()
        rm.generate_incr_decoding(m)
        return ([rm.results[g].output_tokens for g in guids],
                time.perf_counter() - t0, dict(kernels.counts))

    # the draws (the same numbers as from a CPU model: same shapes, same
    # order), then every CPU reference queued on the worker thread
    m = model("cuda")
    pnp = draw(m, rng)
    m320 = model("cuda", heads=12, hidden=3840)
    w320 = draw(m320, np.random.default_rng(13))
    del m320
    variants = {"fp16": (pnp, dict(dtype="float16")),
                "head dim 32 (128 heads), fp32": (pnp, dict(heads=128)),
                "head dim 320 (12 heads, hidden 3840), fp32":
                    (w320, dict(heads=12, hidden=3840)),
                WIDE_PASS: (w320, dict(heads=12, hidden=3840,
                                       dtype="bfloat16"))}
    worker = ThreadPoolExecutor(1)
    refs = {"fp32": worker.submit(lambda: incr(model("cpu"), pnp, "cpu")),
            "int8": worker.submit(
                lambda: incr(model("cpu", quant="int8"), pnp, "cpu"))}
    for what, (wts, kw) in variants.items():
        refs[what] = worker.submit(
            lambda wts=wts, kw=kw: incr(model("cpu", **kw), wts, "cpu"))
    worker.shutdown(wait=False)
    toks, secs, _ = incr(m, pnp, "cuda")
    outs["cuda"] = toks
    log(f"  cuda: {secs:.2f} s, decode width "
        f"{m._inference_manager.decode_width}")
    del m
    outs["cpu"], secs, _ = refs["fp32"].result()
    log(f"  cpu: {secs:.2f} s (on the worker thread)")
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
    if same_req < REQUESTS - 1 or any(len(a) != E2E_NEW for a in outs["cuda"]):
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
    guids = [rm.register_new_request(p, max_new_tokens=E2E_NEW)
             for p in prompts]
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
        guids = [rm.register_new_request(p, max_new_tokens=E2E_NEW)
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
        res = sampler.generate(prompts, max_new_tokens=E2E_NEW)
        draws.append([r.output_tokens for r in res])
        sampler.ffmodel._inference_manager.generator.manual_seed(3)
    del sampler
    gc.collect()
    sampler = LLM((hf, dict(sd))).compile(
        generation_config=GenerationConfig(do_sample=True, topp=1e-9,
                                           temperature=1.0), **serve)
    tiny_p = [r.output_tokens
              for r in sampler.generate(prompts, max_new_tokens=E2E_NEW)]
    del sampler
    n_greedy = sum(x == y for a, b in zip(draws[0], outs["cuda"])
                   for x, y in zip(a, b))
    log(f"  sampling (topp 0.6, temperature 0.8) through LLM.generate on "
        f"the card: same draws under one seed {draws[0] == draws[1]}; "
        f"tokens equal to greedy {n_greedy}/{tot}; top_p 1e-9 at "
        f"temperature 1.0 equals the card's greedy tokens "
        f"{tiny_p == outs['cuda']}")
    if (draws[0] != draws[1] or tiny_p != outs["cuda"]
            or any(len(a) != E2E_NEW for a in draws[0])):
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
        guids = [rm.register_new_request(p, max_new_tokens=E2E_NEW)
                 for p in prompts]
        kernels.reset_counts()
        t0 = time.perf_counter()
        rm.generate_incr_decoding(m)
        return m, [rm.results[g].output_tokens for g in guids], \
            time.perf_counter() - t0, dict(kernels.counts)

    llm, q_card, s_card, q_counts = q_incr(
        "cuda", mode=InferenceMode.TREE_VERIFY_MODE)
    checks = [("int8 incremental", q_card, q_counts)]
    ssm = model("cuda", InferenceMode.BEAM_SEARCH_MODE, layers=1,
                quant="int8")
    share_params(ssm, llm)
    rm = RequestManager()
    guids = [rm.register_new_request(p, max_new_tokens=E2E_NEW)
             for p in prompts]
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
    q_cpu, s_cpu, _ = refs["int8"].result()
    log(f"  int8 cpu: {s_cpu:.2f} s (on the worker thread)")
    for what, toks, counts in checks:
        same_tok = sum(x == y for a, b in zip(q_cpu, toks)
                       for x, y in zip(a, b))
        log(f"  {what} on the card: tokens equal to the CPU's int8 "
            f"incremental decoding {same_tok}/{tot}; launches {counts}")
        if (toks != q_cpu or not counts["qmatmul"]
                or counts["qmatmul_plain_cuda"]
                or counts["plain_attend_cuda"]):
            raise AssertionError(f"card {what} vs CPU parity failed")

    # fp16 weights, activations and cache (the same draw), head dim 32
    # (128 heads of 32, fp32: the card pads the cache to 64) and head dim
    # 320 (12 heads, hidden 3840, a draw of its own: the card pads the
    # cache to 512) in fp32 (the FFMA wide kernel) and in bf16 (the 16-bit
    # wide cluster kernel), each served greedily on the card and on the CPU
    wide_counts = None
    for what, (wts, kw) in variants.items():
        strict = what.endswith("fp32")
        toks = {}
        m = model("cuda", **kw)
        toks["cuda"], _, counts = incr(m, wts, "cuda")
        cache = m.op_state["kv_cache"]["k"]
        del m
        toks["cpu"] = refs[what].result()[0]
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
        # fp32: every token; fp16 and bf16: at most one request may
        # diverge (a near-tie flips one argmax, as in the fp32 incremental
        # pass above)
        bad = (toks["cpu"] != toks["cuda"]) if strict else (
            same_req < REQUESTS - 1)
        if what == WIDE_PASS:
            wide_counts = counts
            bad = bad or not counts["flash_attend_wide"]
        if (bad or not counts["flash_attend_append"]
                or counts["plain_attend_cuda"]):
            raise AssertionError(f"card {what} vs CPU parity failed")
        del cache
        gc.collect()
    return wide_counts


# ----------------------------------------------------------------------
# phase 5: the slice at full size
# ----------------------------------------------------------------------
def profile_decode(torch, llm, prompts, card, new_tokens=16):
    """Device busy share and device time by kernel over one short
    generate call, incremental or speculative as ``llm`` serves
    (torch.profiler; the launch counts were read before)."""
    profile_window(torch, lambda: llm.generate(
        prompts, max_new_tokens=new_tokens),
        f"generate({new_tokens} new tokens)", card)


def profile_window(torch, fn, what, card, top=15, host_ops=True):
    """Device busy share and device time by kernel (the ``top`` kernels
    printed) over one call of ``fn`` (torch.profiler), against its wall
    time to a synchronize. ``host_ops=False`` traces the kernels only
    (the busy share needs no more, and an eager run's host ops take the
    profiler seconds to process)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA]
    if host_ops:
        acts.append(ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
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
    log(f"  profile of {what}: wall "
        f"{wall_us / 1e3:.2f} ms, "
        f"device busy {busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), "
        f"idle {100 - 100 * busy / wall_us:.1f}%  [{card}]")
    for key, n, us in sorted(rows, key=lambda r: -r[2])[:top]:
        log(f"    {us / 1e3:9.3f} ms {100 * us / busy:5.1f}% x{n:<6d} "
            f"{key[:90]}")
    return busy / wall_us


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

    from flexflow_tpu_torch import LLM, DataType

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
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, VOCAB, PROMPT_LEN).tolist()
               for _ in range(REQUESTS)]
    return serve_and_time(torch, card, llm, prompts, NEW_TOKENS, LAYERS,
                          VOCAB, profile=profile)


def serve_and_time(torch, card, llm, prompts, new_tokens, layers, vocab,
                   profile=False):
    """A warm-up ``generate`` (8 new tokens), then the measured one: prefill
    ms per chunk, decode ms/step, tokens/s, peak memory and the kernel
    launches of the measured run. Gates: every token counted and in the
    vocabulary; K1 launched ``layers`` times a prefill chunk and K2 a
    decode step; no K1 bias, K3 or plain call. Returns (counts, metrics)."""
    from flexflow_tpu_torch import kernels
    from flexflow_tpu_torch.serve.inference_manager import InferenceManager

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
    llm.generate(prompts, max_new_tokens=8)         # warm-up (cuBLAS, ...)
    for k in stats:
        stats[k] = [] if k == "prefill_s" else 0
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()        # counts of the measured run only
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = llm.generate(prompts, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.counts)
    n_tok = sum(len(r.output_tokens) for r in res)
    peak = torch.cuda.max_memory_allocated() / 2**30
    pre_ms = [x * 1e3 for x in stats["prefill_s"]]
    dec_ms = stats["decode_s"] * 1e3 / max(1, stats["decode_steps"])
    log(f"  prefill: {stats['prefill_steps']} chunk(s), "
        f"{', '.join(f'{x:.2f}' for x in pre_ms)} ms  [{card}]")
    log(f"  decode: {stats['decode_steps']} steps, {dec_ms:.3f} ms/step  "
        f"[{card}]")
    log(f"  end to end: {n_tok} tokens in {wall:.3f} s = "
        f"{n_tok / wall:.1f} tokens/s  [{card}]")
    log(f"  peak device memory {peak:.2f} GiB  [{card}]")
    steps_b, dec_b = program_pool_bytes(ifm)
    log(f"  of which graph pools: step programs {steps_b / 2**30:.3f} GiB, "
        f"decode program {dec_b / 2**30:.3f} GiB  [{card}]")
    log(f"  kernel launches in the measured run: {counts}")
    if n_tok != len(prompts) * new_tokens or not all(
            0 <= t < vocab for r in res for t in r.output_tokens):
        raise AssertionError("full-size run produced wrong token counts/ids")
    want = {"flash_attend": layers * stats["prefill_steps"],
            "flash_attend_append": layers * stats["decode_steps"],
            "flash_attend_bias": 0, "flash_attend_partials": 0,
            "flash_attend_fp32": 0, "flash_attend_wide": 0,
            "plain_attend_cuda": 0, "qmatmul": 0, "qmatmul_plain_cuda": 0}
    if counts != want or not stats["prefill_steps"]:
        raise AssertionError(f"kernel launch counts {counts} != {want}")
    if profile:
        profile_decode(torch, llm, prompts, card)
    return counts, dict(prefill_ms=pre_ms, decode_ms_per_step=dec_ms,
                        tokens_per_s=n_tok / wall, peak_gib=peak,
                        step_pool_gib=steps_b / 2**30,
                        decode_pool_gib=dec_b / 2**30)


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
    from flexflow_tpu_torch.serve import engine, graphs, request_manager

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

    def logged(op_state, src_node, num_commit, start_pos, active, **kw):
        n, st = int(num_commit[i]), int(start_pos[i])
        if bool(active[i]) and n:
            src = (st + src_node[i, :n].long()).tolist()
            commits.append((list(range(st, st + n)), src))
        return base(op_state, src_node, num_commit, start_pos, active, **kw)

    engine.commit_tree_kv = logged
    try:
        rm = request_manager.RequestManager()
        rm._commit = logged
        for p in prompts:
            rm.register_new_request(p, max_new_tokens=new_tokens)
        # the engines' eager bodies, where the logging commit runs (and
        # reads the host) at every round
        with graphs.eager_bodies():
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


def headline_int8(torch, **kw):
    """Phase 8's models (``bench.py``'s headline): LLaMA-2-7B geometry,
    bf16 compute and cache, int8 weights quantized per layer at compile,
    deep layers damped through dequantize -> scale -> re-quantize
    (bench.py:218-234), a 2-layer draft on the verifier's int8 leaves,
    depth 7, the controller on; ``kw`` adds compile (FFConfig) fields.
    Returns (llm, ssm, seconds)."""
    from flexflow_tpu_torch import GenerationConfig
    from flexflow_tpu_torch.quant import dequantize_array, requantize_into

    llm, ssm, secs = quantized_llm(
        torch, "int8", ssm_layers=DRAFT_LAYERS,
        generation_config=GenerationConfig(spec_depth=SPEC_DEPTH),
        decode_block_steps=NEW_TOKENS + 32, spec_rounds_per_call=SPEC_ROUNDS,
        **kw)
    for i in range(DRAFT_LAYERS, LAYERS):
        for lname, w in ((f"layers.{i}.self_attn", "wo"),
                         (f"layers.{i}.mlp.down_proj", "kernel")):
            leaf = llm.ffmodel.params[lname][w]
            requantize_into(leaf, dequantize_array(leaf) * EPS)
    return llm, ssm, secs


def int8_phase(torch, card, bf16_decode_ms=None, profile=False):
    """``bench.py``'s headline: LLaMA-2-7B geometry, bf16 compute and
    cache, int8 weights quantized per layer at compile; deep layers
    damped through dequantize -> scale -> re-quantize (bench.py:218-234);
    a 2-layer draft on the verifier's int8 leaves, depth 7, the
    controller on. An incremental and a spec pass with the gates; then an
    int4 incremental pass and an int8 pass with gemm_fusion (reported)."""
    import types

    import numpy as np

    from flexflow_tpu_torch import kernels
    from flexflow_tpu_torch.quant import quantized_nbytes
    from flexflow_tpu_torch.serve.request_manager import RequestManager

    llm, ssm, secs = headline_int8(torch)
    verifier = llm.ffmodel
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
    PHASE8_INCR["tokens"] = incr            # 17e's reference
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


# ----------------------------------------------------------------------
# phase 9: online serving at full width (bench.py's serving sections)
# ----------------------------------------------------------------------
LONG_TOKENS = 192      # 9d: requests that span three decode blocks


def generating(rm, guid) -> bool:
    """The request has tokens (or has already finished)."""
    req = rm.inflight.get(guid)
    return req is None or req.num_generated > 0


def wait_until(pred, what, timeout=120.0):
    """Poll ``pred`` (a cheap host read of the manager's state) until it
    holds; fail after ``timeout`` seconds."""
    t = time.monotonic()
    while not pred():
        if time.monotonic() - t > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


def online_phase(torch, card):
    """Phase 8's models (LLaMA-2-7B geometry, int8 weights, bf16 compute
    and cache, the 2-layer draft, depth 7, the controller on) served
    online through the port's ``start_server`` and ``loadgen``, with
    ``bench.py``'s traffic: 9a a Poisson knee sweep (SpecInfer server),
    9b 2x the knee behind admission control, 9c shared prefixes with the
    pool off and on (incremental server), 9d the lifecycle (cancel,
    timeout, preemption, flush). Tokens are gated against an offline
    int8 incremental pass of the same prompts, launches against the
    plain versions. Returns (the server-driven runs' launch counts,
    report)."""
    import contextlib
    import threading

    from flexflow_tpu_torch import GenerationConfig, kernels
    from flexflow_tpu_torch.serve.admission import AdmissionPolicy
    from flexflow_tpu_torch.serve.loadgen import (EngineHandle, LoadRunner,
                                                  TenantSpec, WorkloadSpec,
                                                  build_schedule,
                                                  format_report,
                                                  overload_run, summarize,
                                                  sweep)
    from flexflow_tpu_torch.serve.request_manager import RequestManager

    t_phase = time.perf_counter()
    llm, ssm, secs = headline_int8(torch)
    verifier = llm.ffmodel
    log(f"  build + load + quantize: {secs:.2f} s  [{card}]")
    report = {}
    # the launches of the server-driven runs alone: the offline reference
    # passes run outside these windows
    online = dict.fromkeys(kernels.counts, 0)

    @contextlib.contextmanager
    def served():
        """Zero the counts before a server-driven run and add them to
        ``online`` after it (its server stopped: no launch comes later)."""
        kernels.reset_counts()
        try:
            yield
        finally:
            for k, v in kernels.counts.items():
                online[k] += v

    def load_spec(deadline):
        return WorkloadSpec(
            prompt_lens=(PROMPT_LEN // 2, PROMPT_LEN),
            output_lens=(NEW_TOKENS // 2, NEW_TOKENS),
            tenants=(TenantSpec("default", 1.0, deadline_s=deadline),),
            vocab_size=VOCAB)

    def over_spec(deadline):
        return WorkloadSpec(
            prompt_lens=(PROMPT_LEN // 2, PROMPT_LEN),
            output_lens=(NEW_TOKENS // 2, NEW_TOKENS),
            tenants=(TenantSpec("premium", 1.0, deadline_s=deadline,
                                priority=1),
                     TenantSpec("besteffort", 1.0, priority=0,
                                timeout_s=None if deadline is None
                                else 2.0 * deadline)),
            vocab_size=VOCAB)

    def offline(prompts, n, what):
        """Offline int8 incremental tokens of ``prompts`` (n new each), and
        the pass's tokens/s and decode ms/step. Outside the counting
        windows, it still may call no plain version."""
        plain = ("plain_attend_cuda", "qmatmul_plain_cuda")
        before = [kernels.counts[k] for k in plain]
        rm = RequestManager()
        guids = [rm.register_new_request(list(p), max_new_tokens=n)
                 for p in prompts]
        ifm = RequestManager._ifm(verifier)
        dec = decode_timer(ifm)
        torch.cuda.synchronize()
        t = time.perf_counter()
        rm.generate_incr_decoding(verifier)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        del ifm.decode_block
        if [kernels.counts[k] for k in plain] != before:
            raise AssertionError(f"{what}: plain versions called "
                                 f"{dict(kernels.counts)}")
        out = {tuple(p): rm.results[g].output_tokens
               for p, g in zip(prompts, guids)}
        n_tok = sum(len(o) for o in out.values())
        ms = dec["s"] * 1e3 / max(1, dec["steps"])
        log(f"  {what}: {len(prompts)} prompts, {n_tok} tokens in "
            f"{wall:.3f} s = {n_tok / wall:.1f} tokens/s; decode {ms:.3f} "
            f"ms/step  [{card}]")
        return out, n_tok / wall, ms

    def by_prompt(rm, prompts):
        """The manager's results for ``prompts`` (absent: rejected at the
        door)."""
        res = {tuple(r.input_tokens): r for r in rm.results.values()}
        return [res.get(tuple(p)) for p in prompts]

    def first30(results, prompts, ref):
        ok = [(r, p) for r, p in zip(results, prompts)
              if r is not None and r.status == "ok"]
        m30 = sum(r.output_tokens[:30] == ref[tuple(p)][:30] for r, p in ok)
        full = sum(r.output_tokens == ref[tuple(p)][:len(r.output_tokens)]
                   for r, p in ok)
        return m30, full, len(ok)

    # the schedules' prompts do not depend on the rate or the deadlines:
    # draw them first, for the offline reference
    sched_a = [build_schedule(load_spec(None), REQUESTS, 1.0, seed=i)
               for i in range(3)]
    sched_b = build_schedule(over_spec(None), 2 * REQUESTS, 1.0, seed=0)
    prompts = list(dict.fromkeys(
        tuple(r.prompt) for s in sched_a + [sched_b] for r in s))
    offline([prompts[0], prompts[1]], 4, "warm-up")
    ref, incr_tps, dec_ms = offline(prompts, NEW_TOKENS,
                                    "offline int8 incremental reference")
    base_rps = max(incr_tps / NEW_TOKENS, 0.25)
    deadline = 3.0 * NEW_TOKENS * REQUESTS / incr_tps
    report.update(incr_tokens_per_s=incr_tps, decode_ms_per_step=dec_ms,
                  base_rps=base_rps, deadline_s=deadline)

    # --- 9a: the knee sweep through the SpecInfer server ---
    rates = [0.5 * base_rps, base_rps, 2.0 * base_rps]
    log(f"phase 9a: load sweep, SpecInfer server (depth {SPEC_DEPTH}, "
        f"controller on), Poisson, {REQUESTS} requests a step at "
        f"{', '.join('%.3f' % r for r in rates)} req/s (base_rps "
        f"{base_rps:.3f} = incremental {incr_tps:.1f} tokens/s / "
        f"{NEW_TOKENS}); deadline {deadline:.3f} s  [{card}]")
    with served():
        try:
            load = sweep(llm, load_spec(deadline), rates=rates,
                         n_per_step=REQUESTS, seed=0, process="poisson",
                         p99_ttft_bound_s=deadline / 2, timeout_s=600.0)
        finally:
            llm.stop_server(flush_timeout_s=120.0)
    log(format_report(load))
    steps = []
    for i, (st, rate) in enumerate(zip(load["steps"], rates)):
        ps = [r.prompt for r in build_schedule(load_spec(deadline),
                                               REQUESTS, rate, seed=i)]
        m30, full, n_ok = first30(by_prompt(llm.rm, ps), ps, ref)
        steps.append({k: st[k] for k in (
            "offered_rps", "achieved_rps", "throughput_tokens_per_s",
            "goodput_tokens_per_s", "ttft_p50_s", "ttft_p99_s",
            "latency_p50_s", "latency_p99_s", "queue_wait_mean_s",
            "resolved_fraction", "n_ok")})
        steps[-1].update(first30_match=m30, full_length_match=full)
        log(f"  step {i}: offered {rate:.3f} req/s; resolved "
            f"{st['resolved_fraction']}; ok {n_ok}; first-30 match with "
            f"offline incremental {m30}/{n_ok}; full length {full}/{n_ok}")
        if st["resolved_fraction"] != 1.0 or m30 != n_ok:
            raise AssertionError(f"9a step {i}: resolved "
                                 f"{st['resolved_fraction']}, first-30 "
                                 f"{m30}/{n_ok}")
    report["load"] = dict(steps=steps, knee_rps=load["knee_rps"],
                          peak_tokens_per_s=load["peak_tokens_per_s"],
                          peak_goodput_tokens_per_s=load[
                              "peak_goodput_tokens_per_s"])
    log(f"  knee {load['knee_rps']} req/s  [{card}]")

    # --- 9b: overload at 2x the knee, behind admission control ---
    knee = load["knee_rps"] or base_rps
    policy = AdmissionPolicy(
        max_queue_depth=2 * REQUESTS,
        tenant_rates={"besteffort": (max(0.5 * knee, 0.1),
                                     max(2.0, 0.5 * knee))})
    log(f"phase 9b: overload, {2 * REQUESTS} requests at 2 x {knee:.3f} "
        f"req/s; premium (priority 1, deadline {deadline:.3f} s) and "
        f"besteffort (timeout {2 * deadline:.3f} s, admission rate "
        f"{policy.tenant_rates['besteffort']}); max queue depth "
        f"{policy.max_queue_depth}  [{card}]")
    with served():
        try:
            over = overload_run(llm, over_spec(deadline), knee,
                                multiple=2.0, n_requests=2 * REQUESTS,
                                seed=0, timeout_s=600.0, admission=policy)
        finally:
            llm.stop_server(flush_timeout_s=120.0)
    ps = [r.prompt for r in build_schedule(over_spec(deadline),
                                           2 * REQUESTS, 2.0 * knee, seed=0)]
    res_b = by_prompt(llm.rm, ps)
    m30, full, n_ok = first30(res_b, ps, ref)
    peak = over["admission"]["peak_queue_depth"]
    preempted = sum(r.preemptions for r in res_b if r is not None)
    report["overload"] = dict(
        priority_goodput=over["priority_goodput"],
        besteffort_shed_fraction=over["besteffort_shed_fraction"],
        resolved_fraction=over["resolved_fraction"], peak_queue_depth=peak,
        preemptions=preempted, first30_match=m30, n_ok=n_ok,
        admission=over["admission"], slo=over["slo"])
    log(f"  priority_goodput {over['priority_goodput']}; besteffort shed "
        f"{over['besteffort_shed_fraction']}; resolved "
        f"{over['resolved_fraction']}; peak queue depth {peak}; "
        f"preemptions {preempted}; ok {n_ok}, first-30 match {m30}/{n_ok}")
    log(f"  admission {over['admission']}")
    log(f"  slo {over['slo']}")
    if (over["resolved_fraction"] != 1.0 or peak > policy.max_queue_depth
            or m30 != n_ok):
        raise AssertionError("9b overload gates failed")

    # --- 9c: shared prefixes, the pool off then on (incremental server) ---
    spec_c = WorkloadSpec(shared_prefix_groups=2, shared_prefix_len=96,
                          prompt_lens=(4, 8), output_lens=(2, 4),
                          vocab_size=VOCAB)
    sched_c = build_schedule(spec_c, 2 * REQUESTS, base_rps, seed=0)
    log(f"phase 9c: shared prefixes (2 groups of 96 tokens, suffixes 4-8, "
        f"2-4 new tokens), {2 * REQUESTS} requests at {base_rps:.3f} req/s, "
        f"incremental server, the pool off then on  [{card}]")
    runs = {}
    for on in (False, True):
        handle = EngineHandle(verifier, generation_config=GenerationConfig(
            prefix_cache=on))
        with served():
            try:
                recs = LoadRunner(handle).run(sched_c, timeout_s=600.0)
            finally:
                handle.stop_server(flush_timeout_s=120.0)
        rep = summarize(recs, offered_rps=base_rps,
                        n_scheduled=len(sched_c))
        res = by_prompt(handle.rm, [r.prompt for r in sched_c])
        runs[on] = (handle, recs, rep, res)
        ok = [r for r in recs if r.status == "ok"]
        log(f"  pool {'on ' if on else 'off'}: ttft p50 "
            f"{rep['ttft_p50_s']:.4f} s; prefill (slot grant -> first "
            f"token) mean {1e3 * statistics.mean(r.prefill_s for r in ok):.3f}"
            f" ms; prefill tokens a request "
            f"{rep['prefill_tokens_per_request']}; hit tokens "
            f"{rep['prefix_hit_tokens_total']}  [{card}]")
    (h_on, recs_on, rep_on, res_on), (_, _, rep_off, res_off) = \
        runs[True], runs[False]
    same = [a is not None and b is not None and a.status == b.status == "ok"
            and a.output_tokens == b.output_tokens
            for a, b in zip(res_on, res_off)]
    # warm: an earlier request of its group finished before it arrived
    warm = []
    for r in recs_on:
        grp = tuple(sched_c[r.idx].prompt[:96])
        warm.append(any(tuple(sched_c[e.idx].prompt[:96]) == grp
                        and e.submitted_s + e.latency_s < r.scheduled_s
                        for e in recs_on if e.idx < r.idx))
    warm_hit = [r.prefix_hit_tokens > 0 for r, w in zip(recs_on, warm) if w]
    pc = h_on.rm.prefix_cache
    pooled, n_pooled, pool_tokens = pc.pool_bytes(), len(pc), pc.pool_tokens
    if not 0 < pooled <= pc.max_bytes:
        raise AssertionError(f"9c pool: {pooled} bytes against a byte "
                             f"budget of {pc.max_bytes}")
    # bytes a pooled cache position: the prompts padded to _PAD positions
    per_pos = pooled / sum(-(-e.length // 8) * 8 for e in pc._entries)
    # a prefix length that is not a multiple of the 8-position pad: a
    # prompt sharing 13 (and 21) leading tokens with a pooled one
    base = sched_c[0].prompt
    odd = [base[:13] + [5, 6, 7, 8, 9], base[:21] + [9, 8, 7]]
    want, _, _ = offline(odd, 8, "offline reference, odd prefix lengths")
    rm = h_on.rm
    guids = [rm.register_new_request(p, max_new_tokens=8) for p in odd]
    rm.generate_incr_decoding(verifier, generation_config=GenerationConfig(
        prefix_cache=True))
    odd_ok = [rm.results[g].output_tokens == want[tuple(p)]
              and rm.results[g].prefix_hit_tokens == n
              for g, p, n in zip(guids, odd, (13, 21))]
    report["prefix"] = dict(
        ttft_p50_s_on=rep_on["ttft_p50_s"], ttft_p50_s_off=rep_off["ttft_p50_s"],
        prefill_tokens_per_request_on=rep_on["prefill_tokens_per_request"],
        prefill_tokens_per_request_off=rep_off["prefill_tokens_per_request"],
        prefill_ms_on=1e3 * statistics.mean(r.prefill_s for r in recs_on
                                            if r.status == "ok"),
        prefill_ms_off=1e3 * statistics.mean(
            r.prefill_s for r in runs[False][1] if r.status == "ok"),
        hit_tokens_total=rep_on["prefix_hit_tokens_total"],
        pooled_entries=n_pooled, pooled_tokens=pool_tokens,
        pooled_bytes=pooled, pool_budget_bytes=pc.max_bytes,
        bytes_per_position=per_pos, warm=sum(warm),
        warm_hit=sum(warm_hit),
        identical=sum(same), odd_prefix_ok=odd_ok)
    log(f"  tokens identical pool on/off {sum(same)}/{len(same)}; warm "
        f"requests {sum(warm)}, with hits {sum(warm_hit)}; pooled "
        f"{n_pooled} prompts, {pool_tokens} tokens, {pooled} bytes "
        f"({per_pos / 1024:.0f} KiB a pooled cache position) of a "
        f"{pc.max_bytes}-byte budget (a quarter of the device memory "
        f"free at the first insert); odd prefix "
        f"lengths 13, 21 tokens equal offline "
        f"with those hits: {odd_ok}")
    if (not all(same) or not warm_hit or not all(warm_hit)
            or rep_on["prefill_tokens_per_request"]
            >= rep_off["prefill_tokens_per_request"] or not all(odd_ok)):
        raise AssertionError("9c prefix-pool gates failed")
    del runs, h_on, rm

    # --- 9d: the lifecycle on the card ---
    log(f"phase 9d: lifecycle, incremental server and the SpecInfer "
        f"server, {LONG_TOKENS}-token requests; decode_block_steps "
        f"{verifier.config.decode_block_steps}  [{card}]")
    lprompts = [r.prompt for r in sched_a[0]]
    block_ms = dec_ms * verifier.config.decode_block_steps
    life = {}
    with served():
        handle = EngineHandle(verifier)
        handle.start_server()
        srv, rm = handle._server, handle.rm
        try:
            # mid-stream cancel
            guids, ev = srv.submit([lprompts[0]], LONG_TOKENS, 0)
            wait_until(lambda: generating(rm, guids[0]), "the first tokens")
            t = time.perf_counter()
            rm.cancel(guids[0])
            if not ev.wait(120.0):
                raise AssertionError("cancel did not resolve")
            life["cancel_to_resolve_ms"] = 1e3 * (time.perf_counter() - t)
            res = rm.results[guids[0]]
            life["cancel_tokens"] = len(res.output_tokens)
            n = min(len(res.output_tokens), NEW_TOKENS)
            if not (res.status == "cancelled" and 0 < len(res.output_tokens)
                    < LONG_TOKENS and res.output_tokens[:n]
                    == ref[tuple(lprompts[0])][:n]):
                raise AssertionError(f"9d cancel: {res.status}, "
                                     f"{len(res.output_tokens)} tokens")
            # a deadline that passes inside the first decode block
            timeout = 0.25 * NEW_TOKENS * dec_ms / 1e3
            guids, ev = srv.submit([lprompts[1]], LONG_TOKENS, 0,
                                   timeout_s=timeout)
            if not ev.wait(120.0):
                raise AssertionError("timeout did not resolve")
            res = rm.results[guids[0]]
            life["timeout_s"] = timeout
            life["timeout_tokens"] = len(res.output_tokens)
            n = min(len(res.output_tokens), NEW_TOKENS)
            if not (res.status == "timed_out" and res.timed_out
                    and 0 < len(res.output_tokens) < LONG_TOKENS
                    and res.output_tokens[:n]
                    == ref[tuple(lprompts[1])][:n]):
                raise AssertionError(f"9d timeout: {res.status}, "
                                     f"{len(res.output_tokens)} tokens")
            # a deadline-at-risk priority-1 arrival preempts a running
            # request
            subs = [srv.submit([p], LONG_TOKENS, 0) for p in lprompts]
            wait_until(lambda: all(generating(rm, g[0]) for g, _ in subs),
                       "every slot generating")
            gc_, evc = srv.submit([lprompts[0][:20]], 8, 0, priority=1,
                                  timeout_s=600.0)
            with srv._work:
                # its deadline budget mostly burned upstream: the arrival
                # shifted into the past, the whole real deadline left
                rm.inflight[gc_[0]].arrival_s -= 1200.0
            for _, e in subs + [(gc_, evc)]:
                if not e.wait(300.0):
                    raise AssertionError("preemption run did not resolve")
            rc = rm.results[gc_[0]]
            victims = [(p, rm.results[g[0]])
                       for p, (g, _) in zip(lprompts, subs)
                       if rm.results[g[0]].preemptions]
            life["preemptions"] = sum(r.preemptions for _, r in victims)
            # its time to first token from the moment it was submitted
            life["priority_ttft_s"] = rc.ttft_s - 1200.0
        finally:
            handle.stop_server(flush_timeout_s=120.0)
    want, _, _ = offline([p for p, _ in victims], LONG_TOKENS,
                         "offline reference of the preempted requests")
    vic_ok = [r.status == "ok" and r.output_tokens == want[tuple(p)]
              for p, r in victims]
    life["victims_identical"] = sum(vic_ok)
    if rc.status != "ok" or not victims or not all(vic_ok):
        raise AssertionError(f"9d preemption: priority-1 {rc.status}, "
                             f"victims {len(victims)}, identical {vic_ok}")
    # stop_server with work in flight: every waiter resolves when it
    # returns; the stragglers' results come once their block ends
    with served():
        handle = EngineHandle(verifier)
        handle.start_server()
        srv, rm = handle._server, handle.rm
        subs = [srv.submit([p], LONG_TOKENS, 0) for p in lprompts]
        wait_until(lambda: all(generating(rm, g[0]) for g, _ in subs),
                   "every slot generating")
        t = time.perf_counter()
        handle.stop_server(flush_timeout_s=1.0)
        life["stop_s"] = time.perf_counter() - t
        resolved = all(e.is_set() for _, e in subs)
        srv._thread.join(120.0)
    statuses = [rm.results[g[0]].status if g[0] in rm.results else None
                for g, _ in subs]
    life["stop_statuses"] = statuses
    if (not resolved or srv._thread.is_alive()
            or not all(s in ("cancelled", "ok") for s in statuses)):
        raise AssertionError(f"9d flush: waiters resolved {resolved}, "
                             f"{statuses}")
    # LLM.cancel on the SpecInfer server (reported: a request may finish
    # inside the engine call that is running when the cancel comes)
    with served():
        llm.start_server()
        out = []
        th = threading.Thread(target=lambda: out.append(llm.generate(
            lprompts[2], max_new_tokens=LONG_TOKENS)))
        th.start()
        try:
            wait_until(lambda: any(r.num_generated > 0
                                   for r in list(llm.rm.inflight.values())),
                       "the spec server's first tokens")
            guid = next(iter(llm.rm.inflight))
            t = time.perf_counter()
            llm.cancel(guid)
            th.join(120.0)
            life["spec_cancel_to_resolve_ms"] = 1e3 * (
                time.perf_counter() - t)
        finally:
            llm.stop_server(flush_timeout_s=120.0)
    res = out[0] if out else None
    n = min(len(res.output_tokens), NEW_TOKENS) if res else 0
    if (th.is_alive() or res is None
            or res.status not in ("cancelled", "ok")
            or res.output_tokens[:n] != ref[tuple(lprompts[2])][:n]):
        raise AssertionError("9d LLM.cancel on the spec server failed")
    life["spec_cancel_status"] = res.status
    life["spec_cancel_tokens"] = len(res.output_tokens)
    report["lifecycle"] = life
    log(f"  cancel -> resolve {life['cancel_to_resolve_ms']:.1f} ms "
        f"(incremental; decode {dec_ms:.3f} ms/step x "
        f"{verifier.config.decode_block_steps} steps a block = "
        f"{block_ms:.1f} ms), {life['cancel_tokens']} tokens kept; spec "
        f"server {life['spec_cancel_to_resolve_ms']:.1f} ms, "
        f"{life['spec_cancel_status']} with "
        f"{life['spec_cancel_tokens']} tokens; timeout "
        f"{timeout:.3f} s -> timed_out with {life['timeout_tokens']} "
        f"tokens; preemptions {life['preemptions']}, victims identical to "
        f"an unpreempted run {life['victims_identical']}/{len(victims)}, "
        f"priority-1 ttft {life['priority_ttft_s']:.3f} s from its "
        f"submission; stop_server(1.0) with "
        f"{len(subs)} in flight: {life['stop_s']:.3f} s, {statuses}  "
        f"[{card}]")

    counts = dict(online)
    log(f"  phase 9 launches (the server-driven runs): {counts}")
    if (not counts["flash_attend"] or not counts["flash_attend_append"]
            or not counts["qmatmul"] or counts["plain_attend_cuda"]
            or counts["qmatmul_plain_cuda"]):
        raise AssertionError(f"phase 9 launch gates: {counts}")
    report["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 9: {report['seconds']:.1f} s  [{card}]")
    del llm, ssm, verifier, handle
    gc.collect()
    return counts, report


# ----------------------------------------------------------------------
# phase 10: the other families
# ----------------------------------------------------------------------
# the published configurations (HF config.json names): facebook/opt-6.7b,
# tiiuae/falcon-7b, mosaicml/mpt-7b, bigcode/starcoder; each with the key
# that holds its depth
FAMILY_CONFIGS = {
    "opt": (dict(model_type="opt", vocab_size=50272, hidden_size=4096,
                 ffn_dim=16384, num_hidden_layers=32, num_attention_heads=32,
                 max_position_embeddings=2048, word_embed_proj_dim=4096,
                 do_layer_norm_before=True, enable_bias=True),
            "num_hidden_layers"),
    "falcon": (dict(model_type="falcon", vocab_size=65024, hidden_size=4544,
                    num_hidden_layers=32, num_attention_heads=71,
                    multi_query=True, parallel_attn=True, bias=False,
                    new_decoder_architecture=False, layer_norm_epsilon=1e-5),
               "num_hidden_layers"),
    "mpt": (dict(model_type="mpt", vocab_size=50432, d_model=4096, n_heads=32,
                 n_layers=32, expansion_ratio=4, max_seq_len=2048,
                 no_bias=True), "n_layers"),
    "gpt_bigcode": (dict(model_type="gpt_bigcode", vocab_size=49152,
                         n_embd=6144, n_inner=24576, n_layer=40, n_head=48,
                         n_positions=8192, multi_query=True), "n_layer"),
}
FAMILY_NAMES = {"opt": "OPT-6.7B", "falcon": "Falcon-7B", "mpt": "MPT-7B",
                "gpt_bigcode": "StarCoder"}
FAM_PROMPT, FAM_NEW = 16, 8       # 10a: 8 requests x 16 prompt, 8 new
FAM_NEW_FULL = 32                 # 10b: 8 x 32-token prompts, 32 new


def family_hf(family, layers=None):
    """The family's published HF config, its depth cut to ``layers``."""
    hf, key = FAMILY_CONFIGS[family]
    return dict(hf) if layers is None else dict(hf, **{key: layers})


def family_model(torch, family, hf, device, mode, dtype="float32",
                 quant=None):
    """An FFModel of ``family`` at ``hf``'s geometry, compiled on
    ``device`` with 8 request slots and a 256-position cache."""
    from flexflow_tpu_torch import DataType, FFConfig, FFModel
    from flexflow_tpu_torch.models import FAMILIES

    fam = FAMILIES[family]
    m = FFModel(FFConfig(device=device, max_requests_per_batch=REQUESTS,
                         max_sequence_length=MAX_SEQ,
                         max_tokens_per_batch=REQUESTS * PROMPT_LEN,
                         kv_cache_dtype=dtype, compute_dtype=dtype,
                         quantization_type=quant))
    fam.build(m, fam.config_cls.from_hf_config(hf), mode=mode,
              data_type=DataType(dtype))
    return m.compile()


def family_shapes(family, hf):
    """{layer: {weight: shape}} of ``family`` at ``hf``'s geometry, from
    the graph it records (nothing is allocated)."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models import FAMILIES

    fam = FAMILIES[family]
    shell = FFModel(FFConfig(device="cpu", max_requests_per_batch=REQUESTS,
                             max_sequence_length=MAX_SEQ))
    fam.build(shell, fam.config_cls.from_hf_config(hf))
    return {layer.name: {w.name: tuple(w.shape) for w in layer.weights}
            for layer in shell.layers if layer.weights}


def draw_family(shapes, seed):
    """One seeded numpy draw of a model's weights: LayerNorm gamma 1 and
    beta 0, everything else N(0, 0.02) in fp32. Each 16M-value chunk of
    each leaf comes from its own generator, seeded by (seed, leaf, chunk),
    so the values do not depend on the threads that fill them."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    out, jobs = {}, []
    for i, (layer, lp) in enumerate(sorted(shapes.items())):
        out[layer] = {}
        for j, (w, shape) in enumerate(sorted(lp.items())):
            if w in ("gamma", "beta"):
                out[layer][w] = np.full(shape, float(w == "gamma"),
                                        np.float32)
                continue
            a = out[layer][w] = np.empty(shape, np.float32)
            flat = a.reshape(-1)
            for c, lo in enumerate(range(0, flat.size, 1 << 24)):
                jobs.append(((seed, i, j, c), flat[lo:lo + (1 << 24)]))

    def fill(job):
        key, view = job
        np.random.default_rng(list(key)).standard_normal(
            out=view, dtype=np.float32)
        view *= 0.02

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(fill, jobs))
    return out


def place_params(torch, m, pnp):
    """Point ``m``'s fp32 leaves at the draw's values, on ``m``'s device
    (no copy on the CPU)."""
    for layer, lp in pnp.items():
        for w, a in lp.items():
            m.params[layer][w] = torch.from_numpy(a).to(m.device)


def family_state_dict(torch, family, hf):
    """A random bf16 HF state dict of ``family`` at ``hf``'s geometry on
    the card, from one seeded generator: the split q/k/v keys the
    family's weight map reads (the fused HF layouts cross the disk in
    10c), LayerNorms at gamma 1 and beta 0, the head left tied to the
    token embedding. Shapes come from the graph the family records."""
    from flexflow_tpu_torch.models import FAMILIES

    fam = FAMILIES[family]
    shapes = family_shapes(family, hf)
    g = torch.Generator(device="cuda").manual_seed(4321)
    sd = {}
    for key, (layer, w, tr) in fam.hf_weight_map(
            fam.config_cls.from_hf_config(hf)).items():
        if key == "lm_head.weight":
            continue
        shape = shapes[layer][w][::-1] if tr else shapes[layer][w]
        if w in ("gamma", "beta"):
            sd[key] = torch.full(shape, float(w == "gamma"),
                                 dtype=torch.bfloat16, device="cuda")
        else:
            sd[key] = torch.empty(shape, dtype=torch.bfloat16,
                                  device="cuda").normal_(0.0, 0.02,
                                                         generator=g)
    return sd


def incr_tokens(model, prompts, new_tokens):
    from flexflow_tpu_torch.serve.request_manager import RequestManager

    rm = RequestManager()
    guids = [rm.register_new_request(p, max_new_tokens=new_tokens)
             for p in prompts]
    rm.generate_incr_decoding(model)
    return [rm.results[g].output_tokens for g in guids]


def family_prompts(family):
    import numpy as np

    rng = np.random.default_rng(17)
    return [rng.integers(0, FAMILY_CONFIGS[family][0]["vocab_size"],
                         FAM_PROMPT).tolist() for _ in range(REQUESTS)]


def cpu_references(torch, family, pnp):
    """10a's references on the CPU: incremental decoding of the 2-layer
    fp32 model on the draw, then of the same leaves quantized to int8 in
    place (the bits an int8-compiled model loading the draw holds).
    Returns (tokens, int8 tokens, seconds)."""
    from flexflow_tpu_torch.ffconst import InferenceMode

    t0 = time.perf_counter()
    m = family_model(torch, family, family_hf(family, layers=2), "cpu",
                     InferenceMode.INC_DECODING_MODE)
    place_params(torch, m, pnp)
    prompts = family_prompts(family)
    ref = incr_tokens(m, prompts, FAM_NEW)
    ref8 = incr_tokens(m.quantize_weights("int8"), prompts, FAM_NEW)
    return ref, ref8, time.perf_counter() - t0


def card_parity(torch, family, pnp):
    """10a on the card, for ``cpu_references`` to hold: incremental
    decoding and SpecInfer (the tree engine, a 1-layer draft on the
    verifier's tensors, depth 4, controller off) on the fp32 draw, then
    incremental decoding on the same leaves quantized to int8. Returns
    [(what, "fp32"|"int8", tokens, launches, spec rounds)]."""
    from flexflow_tpu_torch import GenerationConfig, kernels
    from flexflow_tpu_torch.ffconst import InferenceMode
    from flexflow_tpu_torch.serve.request_manager import RequestManager

    prompts = family_prompts(family)
    llm = family_model(torch, family, family_hf(family, layers=2), "cuda",
                       InferenceMode.TREE_VERIFY_MODE)
    place_params(torch, llm, pnp)
    out = []
    kernels.reset_counts()
    out.append(("incremental", "fp32", incr_tokens(llm, prompts, FAM_NEW),
                dict(kernels.counts), 0))
    ssm = family_model(torch, family, family_hf(family, layers=1), "cuda",
                       InferenceMode.BEAM_SEARCH_MODE)
    share_params(ssm, llm)
    rm = RequestManager()
    guids = [rm.register_new_request(p, max_new_tokens=FAM_NEW)
             for p in prompts]
    kernels.reset_counts()
    rm.generate_spec_infer(llm, [ssm], spec_depth=4,
                           generation_config=GenerationConfig(
                               adaptive_spec=False))
    rounds = rm.spec_stats["rounds"]
    out.append((f"SpecInfer (tree engine, depth 4, {rounds} rounds)",
                "fp32", [rm.results[g].output_tokens for g in guids],
                dict(kernels.counts), rounds))
    del ssm
    llm.quantize_weights("int8")
    gc.collect()
    kernels.reset_counts()
    out.append(("int8 incremental", "int8",
                incr_tokens(llm, prompts, FAM_NEW), dict(kernels.counts), 0))
    del llm
    gc.collect()
    return out


def check_parity(family, card, ref, ref8):
    """10a's gates: every card run 128 of 128 against its CPU reference,
    the kernels launched (K1 with the tree bias twice a verify round, K3
    on int8) and no plain call on the card."""
    tot = REQUESTS * FAM_NEW
    for what, kind, got, counts, rounds in card:
        want = ref8 if kind == "int8" else ref
        same = sum(x == y for a, b in zip(want, got) for x, y in zip(a, b))
        log(f"  10a {family} {what} on the card: tokens equal to the "
            f"CPU's {same}/{tot}; launches {counts}")
        bad = (got != want or any(len(a) != FAM_NEW for a in got)
               or counts["plain_attend_cuda"] or counts["qmatmul_plain_cuda"]
               or not counts["flash_attend_append"])
        if what.startswith("SpecInfer"):
            bad |= not rounds or counts["flash_attend_bias"] != 2 * rounds
        if kind == "int8":
            bad |= not counts["qmatmul"]
        if bad:
            raise AssertionError(f"phase 10a {family}: {what} on the card "
                                 "differs from the CPU")


def family_full_size(torch, card, family):
    """10b: the published geometry in bf16 (weights, cache and compute)
    through ``LLM(...).compile(...).generate(...)``, 8 requests x 32-token
    prompts, 32 new tokens; ``serve_and_time``'s figures and gates."""
    import numpy as np

    from flexflow_tpu_torch import LLM, DataType

    hf = family_hf(family)
    layers = hf[FAMILY_CONFIGS[family][1]]
    t0 = time.perf_counter()
    sd = family_state_dict(torch, family, hf)
    llm = LLM((hf, sd), data_type=DataType.DT_BFLOAT16)
    del sd
    llm.compile(**SERVE_7B)
    gc.collect()
    torch.cuda.synchronize()
    log(f"  10b {FAMILY_NAMES[family]} ({layers} layers): build + load "
        f"{time.perf_counter() - t0:.2f} s, weights "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    rng = np.random.default_rng(19)
    prompts = [rng.integers(0, hf["vocab_size"], PROMPT_LEN).tolist()
               for _ in range(REQUESTS)]
    counts, metrics = serve_and_time(torch, card, llm, prompts,
                                     FAM_NEW_FULL, layers, hf["vocab_size"])
    del llm
    gc.collect()
    return counts, dict(metrics, layers=layers)


def family_cold_start(torch, family, tmp):
    """10c: a tiny checkpoint written by the port's ``save_tiny_checkpoint``
    on the card, cold-started with ``LLM.from_checkpoint(...,
    device="cuda")``: its tokens equal the in-memory build's, float and
    with ``quantize="int8"``. Returns the cold start's seconds."""
    from flexflow_tpu_torch import LLM
    from flexflow_tpu_torch.models import checkpoint_store as cs

    d = os.path.join(tmp, family)
    cs.save_tiny_checkpoint(family, d, seed=0, device="cuda")
    mem, _ = cs.build_tiny(family, seed=0, device="cuda")
    prompts = [[3, 5, 7], list(range(1, 21)), [100, 5, 17, 42]]
    want = incr_tokens(mem, prompts, 12)
    mem.quantize_weights("int8")
    want8 = incr_tokens(mem, prompts, 12)
    del mem
    kw = dict(max_requests_per_batch=2, max_seq_length=64,
              max_tokens_per_batch=16, kv_cache_dtype="float32",
              device="cuda")
    got = {}
    for q in (None, "int8"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        llm = LLM.from_checkpoint(d, quantize=q).compile(**kw)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        got[q] = [r.output_tokens
                  for r in llm.generate(prompts, max_new_tokens=12)]
        del llm
        log(f"  10c {family} cold start{' int8' if q else ''}: "
            f"cold_start_s {cold:.3f}; tokens equal to the in-memory "
            f"build's {got[q] == (want8 if q else want)}")
    if got[None] != want or got["int8"] != want8:
        raise AssertionError(f"phase 10c {family}: cold-start tokens differ "
                             "from the in-memory build's")


def families_phase(torch, card):
    """Phase 10 for OPT, Falcon, MPT and StarCoder. 10a's CPU references
    run on a worker thread per family while the card runs 10a and 10c
    (each reference's model initialization runs on one core); 10b runs
    after them, with the host to itself. Returns (the launches of 10b's
    measured runs, summed, and a report)."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    t_phase = time.perf_counter()
    report = {f: {} for f in FAMILY_CONFIGS}
    log(f"phase 10: {', '.join(FAMILY_NAMES.values())}  [{card}]")
    with ThreadPoolExecutor(len(FAMILY_CONFIGS)) as pool, \
            tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        draws = {f: draw_family(family_shapes(f, family_hf(f, layers=2)),
                                seed=17) for f in FAMILY_CONFIGS}
        log(f"  10a numpy draws (2-layer models at full width, fp32): "
            f"{time.perf_counter() - t0:.1f} s")
        refs = {f: pool.submit(cpu_references, torch, f, draws[f])
                for f in FAMILY_CONFIGS}
        cards = {}
        for f in FAMILY_CONFIGS:
            cards[f] = card_parity(torch, f, draws[f])
            family_cold_start(torch, f, tmp)
        for f in FAMILY_CONFIGS:
            ref, ref8, secs = refs[f].result()
            log(f"  10a {f}: CPU references {secs:.1f} s")
            check_parity(f, cards[f], ref, ref8)
        del draws, cards
        gc.collect()
    log(f"  10a and 10c: {time.perf_counter() - t_phase:.1f} s")
    total = {}
    for f in FAMILY_CONFIGS:
        log(f"phase 10b {FAMILY_NAMES[f]} ({f})  [{card}]")
        counts, report[f] = family_full_size(torch, card, f)
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
    report["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 10: {report['seconds']:.1f} s  [{card}]")
    return total, report


# ----------------------------------------------------------------------
# phase 11: training, bench_train.py's two models
# ----------------------------------------------------------------------
# bench_train.py:31-36: BERT-large at the phase-1 pretraining length
BERT_VOCAB, BERT_HIDDEN, BERT_LAYERS, BERT_HEADS = 30522, 1024, 24, 16
BERT_SEQ, BERT_BATCH, BERT_BLOCK = 128, 64, 10
# bench_train.py:170-172: ResNet-50 at the ImageNet per-device batch
RESNET_BATCH, RESNET_IMG, RESNET_UNROLL = 256, 224, 4
RESNET_STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))
TRAIN_LR, TRAIN_BLOCKS = 1e-3, 3          # bench_train.py's SGD rate
# 11a's cuts (the CPU runs the same steps): BERT at full width, 2 layers,
# batch 8; ResNet-50's stem, max pool and stage 1 at 64x64, batch 8,
# 10 classes
CUT_LAYERS, CUT_BATCH, CUT_IMG, CUT_CLASSES = 2, 8, 64, 10
CUT_STEPS = {"bert": 3, "resnet": 2}
# the H100 SXM's dense bf16 tensor-core rate (NVIDIA data sheet)
H100_BF16_PEAK = PEAK_FLOPS["bfloat16"]


def bert_flops_per_step(batch, layers=BERT_LAYERS):
    """``bench_train.py:40-46``'s model FLOPs: 6 x matmul params x tokens
    (fwd + bwd), attention score and value matmuls included."""
    tokens = batch * BERT_SEQ
    per_layer = 4 * BERT_HIDDEN * BERT_HIDDEN + 2 * BERT_HIDDEN * 4 \
        * BERT_HIDDEN
    matmul_params = layers * per_layer + BERT_VOCAB * BERT_HIDDEN
    attn = layers * 2 * BERT_SEQ * BERT_SEQ * BERT_HIDDEN * batch
    return 6.0 * matmul_params * tokens + 6.0 * attn


def bert_build(ff, config, layers=BERT_LAYERS):
    """``bench_train.py:build_model`` through a package's builders;
    ``config.batch_size`` sets the batch. Also phases 15's and 17's
    builder on the ranks."""
    batch = config.batch_size
    m = ff.FFModel(config)
    tokens = m.create_tensor([batch, BERT_SEQ], ff.DataType.DT_INT32)
    x = m.embedding(tokens, BERT_VOCAB, BERT_HIDDEN, name="embed")
    for i in range(layers):
        attn = m.multihead_attention(x, x, x, embed_dim=BERT_HIDDEN,
                                     num_heads=BERT_HEADS,
                                     name=f"enc.{i}.attn")
        x = m.layer_norm(m.add(attn, x), axes=[-1], name=f"enc.{i}.ln1")
        h = m.dense(x, 4 * BERT_HIDDEN, ff.ActiMode.AC_MODE_GELU,
                    name=f"enc.{i}.fc1")
        h = m.dense(h, BERT_HIDDEN, name=f"enc.{i}.fc2")
        x = m.layer_norm(m.add(h, x), axes=[-1], name=f"enc.{i}.ln2")
    logits = m.dense(x, BERT_VOCAB, name="mlm_head")
    m.softmax(m.reshape(logits, [batch * BERT_SEQ, BERT_VOCAB]))
    return m


def bert_model(device, dtype, layers, batch):
    import flexflow_tpu_torch as ff

    m = bert_build(ff, ff.FFConfig(batch_size=batch, compute_dtype=dtype,
                                   device=device), layers)
    return m, bert_flops_per_step(batch, layers)


def resnet_build(ff, config, img, classes, stages, flops=None):
    """``bench_train.py:build_resnet50`` through a package's builders;
    ``stages`` cuts the depth; ``flops`` (a one-element list) adds up the
    convolutions' and the head's forward FLOPs. Also phase 15's builder
    on the ranks."""
    batch = config.batch_size
    m = ff.FFModel(config)
    flops = flops if flops is not None else [0.0]

    def conv(x, c_out, k, s, pad):
        y = m.conv2d(x, c_out, k, k, s, s, pad, pad, use_bias=False)
        flops[0] += 2.0 * k * k * x.dims[1] * c_out * y.dims[2] \
            * y.dims[3] * batch
        return y

    def bottleneck(x, c_mid, stride):
        c_out = 4 * c_mid
        y = m.batch_norm(conv(x, c_mid, 1, 1, 0), relu=True)
        y = m.batch_norm(conv(y, c_mid, 3, stride, 1), relu=True)
        y = m.batch_norm(conv(y, c_out, 1, 1, 0), relu=False)
        sc = x
        if stride != 1 or x.dims[1] != c_out:
            sc = m.batch_norm(conv(x, c_out, 1, stride, 0), relu=False)
        return m.relu(m.add(y, sc))

    t = m.create_tensor([batch, 3, img, img], ff.DataType.DT_FLOAT)
    x = m.batch_norm(conv(t, 64, 7, 2, 3), relu=True)
    x = m.pool2d(x, 3, 3, 2, 2, 1, 1)
    for c_mid, blocks, stride in stages:
        for b in range(blocks):
            x = bottleneck(x, c_mid, stride if b == 0 else 1)
    x = m.pool2d(x, x.dims[2], x.dims[3], 1, 1, 0, 0, ff.PoolType.POOL_AVG)
    x = m.dense(m.flat(x), classes)
    flops[0] += 2.0 * x.owner_layer.inputs[0].dims[1] * classes * batch
    m.softmax(x)
    return m


def resnet_model(device, dtype, batch, img, classes, stages):
    """``resnet_build`` with its layer-by-layer model FLOPs (convs and the
    head, fwd 1x + bwd 2x)."""
    import flexflow_tpu_torch as ff

    flops = [0.0]
    m = resnet_build(ff, ff.FFConfig(batch_size=batch, compute_dtype=dtype,
                                     device=device), img, classes, stages,
                     flops)
    return m, 3.0 * flops[0]


def train_compile(m, optimizer):
    import flexflow_tpu_torch as ff

    opt = (ff.SGDOptimizer(m, lr=TRAIN_LR) if optimizer == "sgd"
           else ff.AdamOptimizer(m, alpha=TRAIN_LR))
    m.compile(optimizer=opt,
              loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return m


@contextlib.contextmanager
def tf32_off(torch):
    """fp32 matmuls and convolutions in fp32 on the card (cuDNN allows
    TF32 by default), the flags restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def cut_model(kind, device):
    if kind == "bert":
        return bert_model(device, "float32", CUT_LAYERS, CUT_BATCH)[0]
    return resnet_model(device, "float32", CUT_BATCH, CUT_IMG, CUT_CLASSES,
                        RESNET_STAGES[:1])[0]


def cut_data(kind):
    """11a's batches, one seeded numpy draw: [steps, batch, ...] inputs
    and their labels."""
    import numpy as np

    rng = np.random.default_rng(29)
    n = CUT_STEPS[kind]
    if kind == "bert":
        x = rng.integers(0, BERT_VOCAB, (n, CUT_BATCH, BERT_SEQ),
                         dtype=np.int32)
        y = rng.integers(0, BERT_VOCAB, (n, CUT_BATCH * BERT_SEQ, 1),
                         dtype=np.int32)
    else:
        x = rng.standard_normal((n, CUT_BATCH, 3, CUT_IMG, CUT_IMG),
                                dtype=np.float32)
        y = rng.integers(0, CUT_CLASSES, (n, CUT_BATCH, 1), dtype=np.int32)
    return x, y


def cut_run(kind, optimizer, device, init, data):
    """11a's steps on ``device`` from the parameters ``init``: (losses,
    {(layer, weight): CPU tensor}, {(layer, stat): CPU tensor},
    seconds)."""
    from flexflow_tpu_torch.convert import load_params

    t0 = time.perf_counter()
    m = train_compile(cut_model(kind, device), optimizer)
    load_params(m, init)
    x, y = data
    losses = [m.train_one_batch([x[i]], y[i]) for i in range(len(y))]
    params = {(ln, w): p.detach().cpu() for ln, lp in m.params.items()
              for w, p in lp.items()}
    state = {(ln, k): v.cpu() for ln, st in m.op_state.items()
             for k, v in st.items()}
    return losses, params, state, time.perf_counter() - t0


def train_parity(torch, card):
    """11a: each cut's steps on the card (fp32, TF32 off) and on the CPU
    (a worker thread) from one start; the losses within 1e-4 relative."""
    from concurrent.futures import ThreadPoolExecutor

    runs = (("bert", "sgd"), ("bert", "adam"), ("resnet", "sgd"))
    data = {k: cut_data(k) for k in CUT_STEPS}
    init = {}
    for kind in CUT_STEPS:      # one start: the CPU model's seeded init
        m = cut_model(kind, "cpu").compile()
        init[kind] = {ln: {w: p.clone() for w, p in lp.items()}
                      for ln, lp in m.params.items()}
        del m
    report = {}
    with ThreadPoolExecutor(1) as pool:
        refs = {r: pool.submit(cut_run, r[0], r[1], "cpu", init[r[0]],
                               data[r[0]]) for r in runs}
        with tf32_off(torch):
            cards = {r: cut_run(r[0], r[1], "cuda", init[r[0]], data[r[0]])
                     for r in runs}
        for r in runs:
            ref_l, ref_p, ref_s, ref_secs = refs[r].result()
            got_l, got_p, got_s, secs = cards[r]
            rel = max(abs(a - b) / abs(b) for a, b in zip(got_l, ref_l))
            dp = max((got_p[k] - ref_p[k]).abs().max().item()
                     for k in ref_p)
            line = (f"  11a {r[0]} {r[1].upper()} x {len(got_l)}: losses "
                    f"card {[f'{v:.7f}' for v in got_l]} CPU "
                    f"{[f'{v:.7f}' for v in ref_l]}, largest relative "
                    f"difference {rel:.2e}; largest parameter difference "
                    f"{dp:.3e}")
            if got_s:
                ds = max((got_s[k] - ref_s[k]).abs().max().item()
                         for k in ref_s)
                line += (f"; BatchNorm running statistics ({len(got_s)} "
                         f"tensors) largest difference {ds:.3e}")
            log(line + f"; card {secs:.1f} s, CPU {ref_secs:.1f} s  [{card}]")
            report[f"{r[0]}_{r[1]}"] = {"loss_rel": rel, "param_diff": dp}
            if not rel <= 1e-4:
                raise AssertionError(f"phase 11a {r}: card losses {got_l} "
                                     f"differ from the CPU's {ref_l}")
    return report


def on_card(tree) -> bool:
    """Every tensor in a nested dict of tensors lies on the card."""
    import torch

    if isinstance(tree, dict):
        return all(on_card(v) for v in tree.values())
    return not isinstance(tree, torch.Tensor) or tree.device.type == "cuda"


def full_train(torch, card, kind, profile=False):
    """11b: one model at bench_train.py's size in bf16: 2 warm steps, then
    TRAIN_BLOCKS blocks through ``train_batches`` on one fixed batch, each
    ending in its one host read. Returns the figures."""
    import numpy as np

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(23)
    if kind == "bert":
        m, flops = bert_model("cuda", "bfloat16", BERT_LAYERS, BERT_BATCH)
        x = torch.randint(0, BERT_VOCAB, (BERT_BATCH, BERT_SEQ),
                          generator=gen, device="cuda", dtype=torch.int32)
        y = torch.randint(0, BERT_VOCAB, (BERT_BATCH * BERT_SEQ, 1),
                          generator=gen, device="cuda", dtype=torch.int32)
        block = BERT_BLOCK
        what = (f"BERT-large ({BERT_LAYERS} x {BERT_HIDDEN}, {BERT_HEADS} "
                f"heads, seq {BERT_SEQ}, batch {BERT_BATCH}, vocab "
                f"{BERT_VOCAB})")
    else:
        m, flops = resnet_model("cuda", "bfloat16", RESNET_BATCH,
                                RESNET_IMG, 1000, RESNET_STAGES)
        x = torch.randn(RESNET_BATCH, 3, RESNET_IMG, RESNET_IMG,
                        generator=gen, device="cuda")
        y = torch.randint(0, 1000, (RESNET_BATCH, 1), generator=gen,
                          device="cuda", dtype=torch.int32)
        block = RESNET_UNROLL
        what = f"ResNet-50 (batch {RESNET_BATCH}, {RESNET_IMG}x{RESNET_IMG})"
    t0 = time.perf_counter()
    train_compile(m, "sgd")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm = [m.train_one_batch([x], y) for _ in range(2)]
    warm_s = time.perf_counter() - t0
    xs, ys = [x.expand(block, *x.shape)], y.expand(block, *y.shape)
    step_ms, losses = [], []
    for _ in range(TRAIN_BLOCKS):
        t0 = time.perf_counter()
        losses.append(m.train_batches(xs, ys))     # ends in its one read
        step_ms.append((time.perf_counter() - t0) * 1e3 / block)
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(step_ms)
    tflops = flops / (med / 1e3) / 1e12
    mfu = flops / (med / 1e3) / H100_BF16_PEAK
    grads = {ln: {w: p.grad for w, p in lp.items()}
             for ln, lp in m.params.items()}
    stats = [v for st in m.op_state.values() for v in st.values()]
    log(f"  11b {what}, bf16 compute, fp32 weights, SGD lr {TRAIN_LR}: "
        f"build {build_s:.1f} s, 2 warm steps {warm_s:.1f} s (losses "
        f"{[round(v, 4) for v in warm]}); step ms median {med:.2f} (min "
        f"{min(step_ms):.2f}, max {max(step_ms):.2f}) over {TRAIN_BLOCKS} "
        f"blocks of {block}; {flops / 1e12:.3f} model TFLOP a step -> "
        f"{tflops:.1f} TFLOPS, MFU {mfu:.4f} of {H100_BF16_PEAK / 1e12:.0f} "
        f"TFLOP/s (H100 SXM dense bf16, NVIDIA data sheet; fp32 matmul "
        f"TF32 {torch.backends.cuda.matmul.allow_tf32}); loss by block "
        f"{[[round(v, 5) for v in b] for b in losses]}; peak memory "
        f"{peak:.2f} GiB  [{card}]")
    bad = []
    if not all(np.isfinite(v) for b in losses for v in b):
        bad.append("a loss is not finite")
    if not np.mean(losses[-1]) < np.mean(losses[0]):
        bad.append("the loss did not fall from the first block to the last")
    if not (on_card(m.params) and on_card(m.opt_state)
            and all(g is not None for lp in grads.values()
                    for g in lp.values()) and on_card(grads)):
        bad.append("a parameter, gradient or optimizer-state tensor is "
                   "off the card")
    if not all(bool(torch.isfinite(v).all()) for v in stats):
        bad.append("a BatchNorm running statistic is not finite")
    busy = None
    if profile and kind == "bert":
        busy = profile_window(torch, lambda: m.train_one_batch([x], y),
                              "one BERT-large train step", card)
    report = {"step_ms": med, "step_ms_min": min(step_ms),
              "step_ms_max": max(step_ms), "tflops": tflops, "mfu": mfu,
              "model_tflop_per_step": flops / 1e12, "peak_gib": peak,
              "block_losses": losses, "busy_share": busy}
    del m, grads, stats
    gc.collect()
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"phase 11b {what}: {'; '.join(bad)}")
    return report


def training_phase(torch, card, profile=False):
    """Phase 11: 11a card vs CPU on the cuts, then 11b at full size."""
    t_phase = time.perf_counter()
    log(f"phase 11: training, bench_train.py's BERT-large and ResNet-50  "
        f"[{card}]")
    log(f"  11a cuts: BERT {CUT_LAYERS} of {BERT_LAYERS} layers, batch "
        f"{CUT_BATCH} of {BERT_BATCH} (full width, seq and vocab); "
        f"ResNet-50 stem + max pool + stage 1 (3 of 16 bottlenecks), "
        f"{CUT_IMG}x{CUT_IMG} of {RESNET_IMG}, batch {CUT_BATCH} of "
        f"{RESNET_BATCH}, {CUT_CLASSES} of 1000 classes")
    report = {"parity": train_parity(torch, card)}
    log(f"  11a: {time.perf_counter() - t_phase:.1f} s")
    for kind in ("bert", "resnet"):
        report[kind] = full_train(torch, card, kind, profile=profile)
    report["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 11: {report['seconds']:.1f} s  [{card}]")
    return report


# ----------------------------------------------------------------------
# phase 12: serving telemetry and the replica fleet
# ----------------------------------------------------------------------
TEL_PAIRS = 2            # 12a: alternating (off, on) pairs in one process
# 12b: the fleet's checkpoint, LLaMA-2-7B widths cut to FLEET_LAYERS, and
# its replicas (checkpoint_replica_factory's JAX defaults: 2 slots, a
# 64-position fp32 cache, fp32 compute)
FLEET_LAYERS, FLEET_SLOTS, FLEET_MAX_SEQ = 4, 2, 64
CLI_NEW = 16             # 12c: new tokens a CLI prompt


def hist_pcts(h):
    """[p50, p99] in ms of a telemetry histogram (None when empty)."""
    if not h.count:
        return None
    return [1e3 * h.percentile(50), 1e3 * h.percentile(99)]


def telemetry_phase(torch, card):
    """12a: phase 8's models (LLaMA-2-7B geometry, int8 weights, bf16
    compute and cache, the 2-layer draft, SpecInfer at depth 7) serve the
    8 x 32-token prompts, 64 new tokens, incrementally and speculatively,
    in TEL_PAIRS alternating pairs of telemetry off and on (the process-
    global telemetry, a JSONL trace per on pass). Gates: tokens on == off;
    per on pass 8 finished requests, the generated-token counter equal to
    the outputs, speculation rounds > 0 and one acceptance sample per
    round span, one admission and one finish span per request; nothing
    recorded while off; K1, K1-bias, K2 and K3 launched, no plain call.
    Reported: tokens/s off and on, the overhead, the block histograms'
    p50/p99 and each loop's host share. Returns (launch counts, report)."""
    import tempfile

    import numpy as np

    from flexflow_tpu_torch import kernels
    from flexflow_tpu_torch.serve.request_manager import RequestManager
    from flexflow_tpu_torch.telemetry import (disable_telemetry,
                                              enable_telemetry,
                                              get_telemetry, load_jsonl)

    t_phase = time.perf_counter()
    llm, ssm, secs = headline_int8(torch)
    verifier, draft = llm.ffmodel, ssm.ffmodel
    log(f"  build + load + quantize: {secs:.2f} s  [{card}]")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, VOCAB, PROMPT_LEN).tolist()
               for _ in range(REQUESTS)]

    def one_pass(mode, new_tokens=NEW_TOKENS):
        rm = RequestManager()
        guids = [rm.register_new_request(p, max_new_tokens=new_tokens)
                 for p in prompts]
        torch.cuda.synchronize()
        t = time.perf_counter()
        if mode == "spec":
            rm.generate_spec_infer(verifier, [draft],
                                   generation_config=llm.generation_config)
        else:
            rm.generate_incr_decoding(verifier)
        torch.cuda.synchronize()
        return ([rm.results[g] for g in guids], time.perf_counter() - t)

    disable_telemetry()
    for mode in ("incr", "spec"):
        one_pass(mode, 8)                                   # warm-up
    modes = {m: {"off": [], "on": [], "host": [], "hists": None}
             for m in ("incr", "spec")}
    ref = {}
    prev = None          # the last on pass's telemetry, closed
    kernels.reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        for pair in range(TEL_PAIRS):
            for mode in ("incr", "spec"):
                st = modes[mode]
                for on in ((False, True) if pair % 2 == 0
                           else (True, False)):
                    if not on:
                        before = prev.registry.snapshot() if prev else None
                        disable_telemetry()
                        res, wall = one_pass(mode)
                        if get_telemetry() is not None or (
                                prev and prev.registry.snapshot() != before):
                            raise AssertionError("12a: telemetry recorded "
                                                 "while off")
                        fresh = enable_telemetry()
                        if any(m.get("value", 0) or m.get("count", 0) for m
                               in fresh.registry.snapshot().values()):
                            raise AssertionError("12a: a fresh registry is "
                                                 "not empty after the off "
                                                 "pass")
                        disable_telemetry()
                    else:
                        path = os.path.join(tmp, f"{mode}{pair}.jsonl")
                        tel = enable_telemetry(path)
                        res, wall = one_pass(mode)
                        disable_telemetry()        # flushes the trace
                        prev = tel
                        check_telemetry_pass(mode, tel, res,
                                             load_jsonl(path))
                        r = tel.registry
                        fenced = (r.get("ffsv_prefill_step_seconds").sum
                                  + r.get("ffsv_decode_block_seconds").sum
                                  + r.get("ffsv_spec_block_seconds").sum)
                        st["host"].append(1.0 - fenced / wall)
                        st["hists"] = r
                    toks = [x.output_tokens for x in res]
                    if ref.setdefault(mode, toks) != toks:
                        raise AssertionError(f"12a {mode} pair {pair}: "
                                             f"tokens with telemetry "
                                             f"{'on' if on else 'off'} "
                                             f"differ")
                    n_tok = sum(len(t) for t in toks)
                    st["on" if on else "off"].append(n_tok / wall)
                    log(f"  {mode} pair {pair} telemetry "
                        f"{'on ' if on else 'off'}: {n_tok} tokens in "
                        f"{wall:.3f} s = {n_tok / wall:.1f} tokens/s  "
                        f"[{card}]")
    counts = dict(kernels.counts)
    report = {}
    for mode, st in modes.items():
        # a mean over the TEL_PAIRS pairs (each pair's value printed too)
        off, on = statistics.mean(st["off"]), statistics.mean(st["on"])
        over = [1.0 - b / a for a, b in zip(st["off"], st["on"])]
        r = st["hists"]
        h = {name: hist_pcts(r.get(f"ffsv_{name}_seconds"))
             for name in ("prefill_step", "decode_block", "spec_block")}
        report[mode] = dict(
            tokens_per_s_off=st["off"], tokens_per_s_on=st["on"],
            overhead_frac=statistics.mean(over),
            host_share=statistics.mean(st["host"]),
            block_ms_p50_p99=h)
        log(f"  {mode}: tokens/s off {off:.1f} (mean of "
            f"{['%.1f' % x for x in st['off']]}), on {on:.1f} "
            f"({['%.1f' % x for x in st['on']]}); overhead_frac "
            f"{report[mode]['overhead_frac']:.4f} (pairs "
            f"{['%.4f' % x for x in over]}); host share of the loop "
            f"{report[mode]['host_share']:.4f} "
            f"({['%.4f' % x for x in st['host']]})  [{card}]")
        log(f"    fenced blocks, ms p50/p99 (last on pass): "
            + "; ".join(f"{k} {v[0]:.3f}/{v[1]:.3f} "
                        f"(n {r.get(f'ffsv_{k}_seconds').count})"
                        for k, v in h.items() if v))
    log(f"  phase 12a launches: {counts}")
    if (not counts["flash_attend"] or not counts["flash_attend_bias"]
            or not counts["flash_attend_append"] or not counts["qmatmul"]
            or counts["plain_attend_cuda"] or counts["qmatmul_plain_cuda"]):
        raise AssertionError(f"phase 12a launch gates: {counts}")
    report["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 12a: {report['seconds']:.1f} s  [{card}]")
    del llm, ssm, verifier, draft
    gc.collect()
    return counts, report


def check_telemetry_pass(mode, tel, results, events):
    """12a's gates on one telemetry-on pass: its registry and its trace."""
    r = tel.registry
    n_out = sum(len(x.output_tokens) for x in results)
    guids = sorted(x.guid for x in results)
    rounds = [e for e in events if e["name"] == "decode_round"]
    problems = []
    if r.get("ffsv_requests_finished_total").value != REQUESTS:
        problems.append("finished requests")
    if r.get("ffsv_tokens_generated_total").value != n_out:
        problems.append("generated tokens")
    if mode == "spec" and not (
            r.get("ffsv_spec_rounds_total").value > 0
            and r.get("ffsv_acceptance_length").count == len(rounds)):
        problems.append(f"rounds {r.get('ffsv_spec_rounds_total').value}, "
                        f"acceptance samples "
                        f"{r.get('ffsv_acceptance_length').count}, round "
                        f"spans {len(rounds)}")
    for name in ("admission", "finish"):
        tids = sorted(e["tid"] for e in events if e["name"] == name)
        if tids != guids:
            problems.append(f"{name} spans {tids}")
    if problems:
        raise AssertionError(f"12a {mode} telemetry gates: {problems}")


def write_fleet_checkpoint(torch, d):
    """An HF-layout checkpoint (config.json + model.safetensors, fp16) of
    ``seven_b``'s weights cut to FLEET_LAYERS. Returns the bytes written."""
    from flexflow_tpu_torch.models import checkpoint_store as cs
    from flexflow_tpu_torch.models.llama import LLAMAConfig

    hf, sd = seven_b(torch, layers=FLEET_LAYERS)
    tensors = {k: v.to(torch.float16).cpu().numpy() for k, v in sd.items()}
    del sd
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, cs.CONFIG_NAME), "w") as f:
        json.dump(cs.hf_config_dict("llama", LLAMAConfig.from_hf_config(hf)),
                  f, indent=2, sort_keys=True)
    return cs.write_safetensors(os.path.join(d, cs.SAFETENSORS_NAME),
                                tensors, metadata={"format": "pt",
                                                   "model_type": "llama"})


def params_on_card(model) -> int:
    """The count of the model's parameter tensors (a quantized leaf's
    payload and scale included); raises if one is not on the card."""
    import torch

    n = 0
    for lname, lp in model.params.items():
        for w, leaf in lp.items():
            ts = ([leaf] if isinstance(leaf, torch.Tensor)
                  else [leaf.q, leaf.scale])
            for t in ts:
                if t.device.type != "cuda":
                    raise AssertionError(f"12b: ({lname}, {w}) on "
                                         f"{t.device}")
                n += 1
    return n


def fleet_phase(torch, card, tmp):
    """12b: a ReplicaPool of 2 replicas cold-started from an HF-layout
    checkpoint at LLaMA-2-7B widths (FLEET_LAYERS layers), int8 on load,
    behind a FleetTelemetry, with ``bench.py:457-538``'s traffic at vocab
    32000: a seeded FaultInjector crash (``failover_run``: 8 req/s, 12
    requests, crash after 6 engine calls), then ``spike_run`` (4 req/s
    x 16, 8 + 16 requests) with the queue-triggered autoscaler; a
    MetricsHTTPServer over ``aggregate_registry`` scraped once mid-run.
    Returns (launch counts, report, checkpoint dir)."""
    import threading
    import urllib.request

    from flexflow_tpu_torch import kernels
    from flexflow_tpu_torch.serve.faultinject import check_invariants
    from flexflow_tpu_torch.serve.loadgen import TenantSpec, WorkloadSpec
    from flexflow_tpu_torch.serve.replica import (ReplicaPool,
                                                  checkpoint_replica_factory,
                                                  failover_run, spike_run)
    from flexflow_tpu_torch.serve.request_manager import RequestManager
    from flexflow_tpu_torch.telemetry import (MetricsHTTPServer,
                                              aggregate_registry,
                                              load_incident_report)
    from flexflow_tpu_torch.telemetry.fleet import FleetTelemetry
    from flexflow_tpu_torch.telemetry.slo import SLOPolicy

    t_phase = time.perf_counter()
    ckpt = os.path.join(tmp, "fleet_ckpt")
    t = time.perf_counter()
    nbytes = write_fleet_checkpoint(torch, ckpt)
    log(f"  checkpoint: LLaMA-2-7B widths (hidden {HIDDEN}, {HEADS} heads, "
        f"intermediate {INTER}, vocab {VOCAB}) cut to {FLEET_LAYERS} of "
        f"{LAYERS} layers, fp16 safetensors, {nbytes / 1e9:.3f} GB written "
        f"in {time.perf_counter() - t:.2f} s")
    fleet = FleetTelemetry(trace_dir=os.path.join(tmp, "fleet_obs"))
    factory = checkpoint_replica_factory(
        ckpt, slots=FLEET_SLOTS, max_seq=FLEET_MAX_SEQ, quantize="int8",
        device="cuda")
    pool = ReplicaPool(factory, n_replicas=2, telemetry=fleet)
    spec = WorkloadSpec(prompt_lens=(4, 8), output_lens=(24, 32),
                        vocab_size=VOCAB,
                        tenants=(TenantSpec("default", 1.0, deadline_s=1.0),))
    policy = SLOPolicy(name="fleet", fast_burn_threshold=6.0,
                       slow_burn_threshold=3.0)
    kernels.reset_counts()
    pool.start_server()
    log(f"  pool up: cold starts {pool.stats()['cold_starts_s']} s  [{card}]")
    metrics = MetricsHTTPServer(aggregate_registry, host="127.0.0.1", port=0)
    scrape = {}

    def scraper():
        # once mid-run: after half the failover run's requests resolved
        stop = time.monotonic() + 300.0
        while len(pool.rm.results) < 6 and time.monotonic() < stop:
            time.sleep(0.005)
        url = f"http://127.0.0.1:{metrics.port}/metrics"
        with urllib.request.urlopen(url, timeout=30) as resp:
            scrape.update(status=resp.status, text=resp.read().decode(),
                          resolved=len(pool.rm.results))

    th = threading.Thread(target=scraper, daemon=True)
    th.start()
    try:
        fo = failover_run(pool, spec, rate_rps=8.0, n_requests=12, seed=0,
                          crash_after=6, timeout_s=300.0, slo_policy=policy)
        fo_results = dict(pool.rm.results)
        th.join(60.0)
        with pool._work:
            respawned = pool._work.wait_for(lambda: pool.n_alive() == 2,
                                            timeout=300.0)
        sp = spike_run(pool, spec, base_rps=4.0, spike_multiple=16.0,
                       n_base=8, n_spike=16, seed=1, timeout_s=300.0,
                       slo_policy=policy)
        n_params = [params_on_card(r.handle.ffmodel) for r in pool.replicas
                    if r.alive and r.handle is not None]
    finally:
        pool.stop_server(flush_timeout_s=120.0)
        metrics.stop()
    counts = dict(kernels.counts)
    stats = pool.stats()
    problems = check_invariants(pool)
    trace = fleet.stitch_chrome_trace(os.path.join(tmp, "fleet_trace.json"))
    pids = sorted({e["pid"] for e in trace})
    incidents = [load_incident_report(p) for p in pool.incident_reports]
    fleet.close()
    log(f"  failover_run: resolved {fo['resolved_fraction']}, "
        f"{fo['n_failed_over']} failed over ({fo['failovers_total']} "
        f"re-dispatches), injector {fo['injector']}, failover_recovery_s "
        f"{fo['failover_recovery_s']}, alerts fired {fo['alerts_fired']}, "
        f"respawned {respawned}  [{card}]")
    log(f"  spike_run: {sp['base_rps']} -> {sp['spike_rps']} req/s, "
        f"scaled_up {sp['scaled_up']} (trigger at {sp['scale_trigger_s']} "
        f"s, outstanding >= {sp['scale_threshold']}), scale-up cold start "
        f"{sp['cold_start_s']} s, slo_violation_s {sp['slo_violation_s']}, "
        f"spike latency p50/p99 {sp['spike']['latency_p50_s']}/"
        f"{sp['spike']['latency_p99_s']} s, ttft p99 "
        f"{sp['spike']['ttft_p99_s']} s, base alerts "
        f"{sp['slo']['base']['alerts_fired']}, spike alerts "
        f"{sp['slo']['spike']['alerts_fired']}  [{card}]")
    log(f"  cold_start_s each {stats['cold_starts_s']} (2 initial, the "
        f"respawn, the scale-up); replicas {stats['n_replicas']}; incident "
        f"reports {len(incidents)} ({[h['error'] for h, _ in incidents]}, "
        f"{[len(e) for _, e in incidents]} events); stitched trace pids "
        f"{pids}; scrape mid-run: HTTP {scrape.get('status')} after "
        f"{scrape.get('resolved')} results, "
        f"{len(scrape.get('text', '').splitlines())} lines; parameters on "
        f"the card {n_params}; launches {counts}  [{card}]")
    # the failover run's tokens against an undisturbed replica's
    ref = factory(99)
    res = list(fo_results.values())
    rm = RequestManager()
    guids = [rm.register_new_request(r.input_tokens,
                                     max_new_tokens=len(r.output_tokens))
             for r in res]
    rm.generate_incr_decoding(ref.ffmodel)
    same = [r.output_tokens == rm.results[g].output_tokens
            for r, g in zip(res, guids)]
    moved = [s for r, s in zip(res, same) if r.failovers]
    log(f"  tokens equal to an undisturbed replica's: {sum(same)}/"
        f"{len(same)}, failed-over {sum(moved)}/{len(moved)}")
    del ref, rm
    gates = {
        "resolved 1.0": (fo["resolved_fraction"] == 1.0
                         and sp["base"]["resolved_fraction"] == 1.0
                         and sp["spike"]["resolved_fraction"] == 1.0),
        "failed-over tokens": bool(moved) and all(same),
        "incident report": len(incidents) >= 1,
        "one pid per replica": pids == [r.id + 1 for r in pool.replicas],
        "respawned": respawned,
        "scaled_up": sp["scaled_up"],
        "alerts": (fo["alerts_fired"] >= 1
                   and sp["slo"]["base"]["alerts_fired"] == 0),
        "check_invariants": problems == [],
        "on the card": len(n_params) == stats["n_replicas"] and all(
            n_params),
        "scrape": (scrape.get("status") == 200
                   and "ffsv_requests_total" in scrape.get("text", "")),
        "launches": (counts["flash_attend"] > 0
                     and counts["flash_attend_append"] > 0
                     and counts["flash_attend_fp32"] > 0
                     and counts["qmatmul"] > 0
                     and not counts["plain_attend_cuda"]
                     and not counts["qmatmul_plain_cuda"]),
    }
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise AssertionError(f"phase 12b gates failed: {failed}; "
                             f"invariants {problems}")
    report = dict(
        depth_cut=f"{FLEET_LAYERS} of {LAYERS} layers",
        cold_starts_s=stats["cold_starts_s"],
        failover_recovery_s=fo["failover_recovery_s"],
        resolved_fraction=fo["resolved_fraction"],
        n_failed_over=fo["n_failed_over"],
        alerts_fired_chaos=fo["alerts_fired"],
        alerts_fired_steady=sp["slo"]["base"]["alerts_fired"],
        scale_trigger_s=sp["scale_trigger_s"],
        slo_violation_s=sp["slo_violation_s"],
        spike_latency_p99_s=sp["spike"]["latency_p99_s"],
        seconds=time.perf_counter() - t_phase)
    log(f"  phase 12b: {report['seconds']:.1f} s  [{card}]")
    gc.collect()
    return counts, report, ckpt


def cli_phase(torch, card, ckpt):
    """12c: ``python -m flexflow_tpu_torch.serve`` in a subprocess on the
    card, with 12b's checkpoint and ``--8bit-quantization`` (its tokens
    must equal ``LLM.from_checkpoint(...).generate`` in this process),
    then with no ``--model``; both must exit 0."""
    from flexflow_tpu_torch import LLM

    prompts = [[1, 5, 9, 23], [VOCAB - 7, 17, 42], [7] * 12]
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    base = [sys.executable, "-m", "flexflow_tpu_torch.serve",
            "--device", "cuda", "--max-new-tokens", str(CLI_NEW)]
    # both CLI processes at once, the in-process reference beside them
    t = time.perf_counter()
    procs = {what: subprocess.Popen(
        base + extra, cwd=HERE, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for what, extra in (
            ("checkpoint", ["--model", ckpt, "--8bit-quantization"]
             + [a for p in prompts
                for a in ("--prompt", ",".join(map(str, p)))]),
            ("built-in", []))}
    with killed_on_error(procs):
        llm = LLM.from_checkpoint(ckpt).compile(
            max_requests_per_batch=4, max_seq_length=256,
            max_tokens_per_batch=64, quantization_type="int8",
            device="cuda")
        want = [r.output_tokens
                for r in llm.generate(prompts, max_new_tokens=CLI_NEW)]
    del llm
    gc.collect()
    out = {}
    for what, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        secs = time.perf_counter() - t
        toks = [json.loads(line.split("output=", 1)[1])
                for line in stdout.splitlines() if line.startswith("guid=")]
        tail = stdout.strip().splitlines()[-1:] or [""]
        log(f"  CLI ({what}): exit {proc.returncode} in {secs:.1f} s; "
            f"{tail[0]}  [{card}]")
        if proc.returncode != 0:
            raise AssertionError(f"12c CLI ({what}) exited "
                                 f"{proc.returncode}: {stderr[-2000:]}")
        out[what] = toks
    log(f"  CLI tokens equal to LLM.from_checkpoint(...).generate in "
        f"process: {out['checkpoint'] == want}")
    if out["checkpoint"] != want or not out["built-in"]:
        raise AssertionError(f"12c: CLI tokens {out['checkpoint']} vs in "
                             f"process {want}")
    return {"cli_tokens_match": True}


# ----------------------------------------------------------------------
# phase 13: the host side of serving (the native scheduler, the front
# door, the C ABI, inference-debugging dumps, use_kernels=False)
# ----------------------------------------------------------------------
HOST_PAIRS = 2           # 13a: alternating (native, Python) loop pairs
HOST_CANCEL_BLOCK = 8    # 13a: the decode block of the cancel pass
FRONT_NEW = 32           # 13b, 13c: new tokens a request
# 13d: 2 requests of DUMP_PROMPT tokens, one prefill and one decode step;
# the gate on the worst op output, card against CPU in fp32 with TF32 off:
# its largest absolute difference over its largest magnitude (stated in
# PERF.md before the first run)
DUMP_PROMPT, DUMP_TOL = 8, 1e-4
PLAIN_NEW = 16           # 13e: new tokens a request
FRONT_KW = SERVE_7B


def loop_rm(telemetry=None):
    """A RequestManager that records which incremental loop ran."""
    from flexflow_tpu_torch.serve.request_manager import RequestManager

    class LoopRM(RequestManager):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.loops = []

        def _generate_incr_native(self, *a):
            self.loops.append("native")
            return super()._generate_incr_native(*a)

        def _generate_incr_python(self, *a):
            self.loops.append("python")
            return super()._generate_incr_python(*a)

    return LoopRM(telemetry=telemetry)


def check_launches(what, counts, k3=False):
    """K1 and K2 (and K3 with int8 weights) launched, no plain version on
    the card."""
    if (not counts["flash_attend"] or not counts["flash_attend_append"]
            or (k3 and not counts["qmatmul"])
            or counts["plain_attend_cuda"] or counts["qmatmul_plain_cuda"]):
        raise AssertionError(f"{what}: launch counts {counts}")


def native_scheduler_phase(torch, card):
    """13a: phase 8's headline model (LLaMA-2-7B geometry, int8 weights,
    bf16 compute and cache) serves 8 x 32-token prompts, 64 new tokens,
    on the native loop and on the Python loop in HOST_PAIRS alternating
    pairs, each pass with its own explicit ServingTelemetry (prefill steps
    fenced): decode ms/step and the loop's host share outside the fenced
    blocks, reported. Gates: the native passes ran the native loop and the
    others the Python loop, tokens equal on 8/8 requests at full length
    in every pass, K1, K2 and K3 launched and no plain call. Then on the
    native loop with a decode block of HOST_CANCEL_BLOCK: one request
    cancelled once it has 16 tokens and one with a deadline of 0.4 x a
    native pass resolve with a prefix of their tokens, the other six
    requests' tokens unchanged. Returns (launch counts of the last native
    pass, report)."""
    import numpy as np

    from flexflow_tpu_torch import kernels
    from flexflow_tpu_torch.serve.request_manager import RequestManager
    from flexflow_tpu_torch.telemetry import ServingTelemetry

    t_phase = time.perf_counter()
    llm, ssm, secs = headline_int8(torch)
    del ssm
    gc.collect()
    verifier = llm.ffmodel
    log(f"  build + load + quantize: {secs:.2f} s  [{card}]")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, VOCAB, PROMPT_LEN).tolist()
               for _ in range(REQUESTS)]
    dec = decode_timer(RequestManager._ifm(verifier))

    def one_pass(native, new_tokens=NEW_TOKENS, rm=None, extra=()):
        verifier.config.use_native_scheduler = native
        tel = ServingTelemetry()
        rm = rm or loop_rm(tel)
        guids = [rm.register_new_request(p, max_new_tokens=new_tokens,
                                         **kw)
                 for p, kw in zip(prompts, list(extra) + [{}] * REQUESTS)]
        dec.update(s=0.0, steps=0)
        kernels.reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        rm.generate_incr_decoding(verifier)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        r = tel.registry
        fenced = (r.get("ffsv_prefill_step_seconds").sum
                  + r.get("ffsv_decode_block_seconds").sum)
        want = ["native" if native else "python"]
        if getattr(rm, "loops", want) != want:
            raise AssertionError(f"13a: loops {rm.loops}, want {want}")
        return ([rm.results[g] for g in guids], wall, dict(kernels.counts),
                dict(decode_ms=dec["s"] * 1e3 / max(1, dec["steps"]),
                     host_share=1.0 - fenced / wall))

    for native in (True, False):
        one_pass(native, 8)                                  # warm-up
    ref = None
    stats = {"native": [], "python": []}
    native_counts = None
    for pair in range(HOST_PAIRS):
        for native in ((True, False) if pair % 2 == 0 else (False, True)):
            res, wall, counts, st = one_pass(native)
            check_launches("13a", counts, k3=True)
            toks = [r.output_tokens for r in res]
            ref = ref or toks
            same = sum(a == b and len(a) == NEW_TOKENS
                       for a, b in zip(toks, ref))
            name = "native" if native else "python"
            st.update(wall_s=wall, tokens_per_s=sum(map(len, toks)) / wall)
            stats[name].append(st)
            if native:
                native_counts = counts
            log(f"  pair {pair} {name:6s}: {wall:.3f} s, "
                f"{st['tokens_per_s']:.1f} tokens/s, decode "
                f"{st['decode_ms']:.3f} ms/step, host share "
                f"{st['host_share']:.4f}; tokens equal to the first pass "
                f"{same}/{REQUESTS}  [{card}]")
            if same != REQUESTS:
                raise AssertionError(f"13a pair {pair} {name}: tokens "
                                     f"equal on {same}/{REQUESTS}")
    report = {}
    for name, runs in stats.items():
        report[name] = {k: statistics.mean(r[k] for r in runs)
                        for k in runs[0]}
        log(f"  {name} loop (mean of {HOST_PAIRS} passes): decode "
            f"{report[name]['decode_ms']:.3f} ms/step, host share "
            f"{report[name]['host_share']:.4f}, "
            f"{report[name]['tokens_per_s']:.1f} tokens/s  [{card}]")

    # a mid-run cancel and a deadline on the native loop
    block = verifier.config.decode_block_steps
    verifier.config.decode_block_steps = HOST_CANCEL_BLOCK
    timeout = 0.4 * report["native"]["wall_s"]

    class CancelRM(RequestManager):
        """Cancels the first prompt's request once it has 16 tokens, at
        the top of a loop turn (where a host's cancel lands)."""

        def _reap_expired(self, active, max_seq, done, ctrl=None):
            for req in active:
                if (req is not None and req.prompt_tokens == prompts[0]
                        and req.num_generated >= 16):
                    self.cancel(req.guid)
            return super()._reap_expired(active, max_seq, done, ctrl)

    rm = CancelRM()
    try:
        res, wall, counts, _ = one_pass(
            True, rm=rm, extra=[{}, {"timeout_s": timeout}])
    finally:
        verifier.config.decode_block_steps = block
    check_launches("13a cancel pass", counts, k3=True)
    toks = [r.output_tokens for r in res]
    status = [r.status for r in res]
    log(f"  cancel pass (block {HOST_CANCEL_BLOCK}, deadline "
        f"{timeout:.3f} s): statuses {status}, lengths "
        f"{[len(t) for t in toks]}, {wall:.3f} s  [{card}]")
    if (status[:2] != ["cancelled", "timed_out"]
            or not 16 <= len(toks[0]) < NEW_TOKENS
            or len(toks[1]) >= NEW_TOKENS
            or any(t != r[:len(t)] for t, r in zip(toks[:2], ref[:2]))
            or toks[2:] != ref[2:] or status[2:] != ["ok"] * (REQUESTS - 2)
            or rm.pending or rm.inflight):
        raise AssertionError("13a: the cancel/deadline pass")
    report["cancel"] = dict(status=status, lengths=[len(t) for t in toks])
    report["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 13a: {report['seconds']:.1f} s  [{card}]")
    del llm, verifier
    gc.collect()
    return native_counts, report


def synthetic_sp_model(n_pieces=None, seed=0):
    """(model bytes, words): a unigram SentencePiece model of LLaMA's
    vocabulary size and layout (<unk>, <s>, </s>, the 256 byte pieces at
    3..258), then the 26 letters bare and after the whitespace mark, then
    seeded lowercase words of 2-8 letters, each bare or after the mark,
    with seeded scores."""
    import numpy as np

    from flexflow_tpu_torch.native.sp_tokenizer import (BYTE, CONTROL,
                                                        NORMAL, UNKNOWN,
                                                        build_model_proto)

    n_pieces = n_pieces or VOCAB
    rng = np.random.default_rng(seed)
    pieces = [("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL),
              ("</s>", 0.0, CONTROL)]
    pieces += [(f"<0x{b:02X}>", 0.0, BYTE) for b in range(256)]
    letters = "abcdefghijklmnopqrstuvwxyz"
    names = [c for c in letters] + ["▁" + c for c in letters]
    seen = set(names)
    words = []
    while len(names) < n_pieces - len(pieces):
        w = "".join(rng.choice(list(letters), rng.integers(2, 9)))
        p = ("▁" + w) if rng.random() < 0.5 else w
        if p not in seen:
            seen.add(p)
            names.append(p)
            words.append(w)
    pieces += [(p, -float(rng.uniform(1.0, 14.0)), NORMAL) for p in names]
    return build_model_proto(pieces, model_type=1, byte_fallback=True), words


def write_sharded_checkpoint(torch, d):
    """phase 12b's checkpoint (LLaMA-2-7B widths cut to FLEET_LAYERS,
    fp16) as 2 safetensors shards with their index, plus a synthetic
    32000-piece tokenizer.model. Returns (bytes, words)."""
    from flexflow_tpu_torch.models import checkpoint_store as cs
    from flexflow_tpu_torch.models.llama import LLAMAConfig

    hf, sd = seven_b(torch, layers=FLEET_LAYERS)
    tensors = {k: v.to(torch.float16).cpu().numpy() for k, v in sd.items()}
    del sd
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, cs.CONFIG_NAME), "w") as f:
        json.dump(cs.hf_config_dict("llama", LLAMAConfig.from_hf_config(hf)),
                  f, indent=2, sort_keys=True)
    nbytes = cs.write_sharded_safetensors(
        d, tensors, 2, metadata={"format": "pt", "model_type": "llama"})
    model, words = synthetic_sp_model()
    with open(os.path.join(d, "tokenizer.model"), "wb") as f:
        f.write(model)
    return nbytes, words


def front_door_phase(torch, card, tmp):
    """13b: a local model directory at LLaMA-2-7B widths (FLEET_LAYERS
    layers, 2 fp16 shards and their index, a synthetic 32000-piece
    tokenizer.model) served through ``LLM(dir)`` in bf16 with text
    prompts (8 requests, FRONT_NEW new tokens) and ``output_file``.
    Gates: the native SentencePiece ids equal the ``SpModel`` oracle's on
    every prompt; the tokenizer is the native one; each output text is
    the decode of its tokens; the tokens equal ``LLM.from_checkpoint
    (dir)``'s in this process; the output file holds one record a
    request; K1 and K2 launched, no plain call. Returns (launch counts,
    report, dir, the LLM, the text prompts, their token ids)."""
    import numpy as np

    from flexflow_tpu_torch import LLM, DataType, kernels
    from flexflow_tpu_torch.native.sp_tokenizer import \
        SentencePieceTokenizer

    t_phase = time.perf_counter()
    d = os.path.join(tmp, "llama-2-7b-width")
    t = time.perf_counter()
    nbytes, words = write_sharded_checkpoint(torch, d)
    log(f"  wrote {sorted(os.listdir(d))}: {nbytes / 1e9:.3f} GB in "
        f"{time.perf_counter() - t:.2f} s")
    rng = np.random.default_rng(13)
    texts = [" ".join(rng.choice(words, 10 + 2 * i))
             for i in range(REQUESTS)]
    t = time.perf_counter()
    outf = os.path.join(tmp, "outputs.txt")
    llm = LLM(d, data_type=DataType.DT_BFLOAT16,
              output_file=outf).compile(**FRONT_KW)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    tok = llm.tokenizer
    if not isinstance(tok, SentencePieceTokenizer):
        raise AssertionError(f"13b: tokenizer {type(tok).__name__}")
    t = time.perf_counter()
    oracle = [tok.model.encode_ids(x) for x in texts]
    oracle_s = time.perf_counter() - t
    t = time.perf_counter()
    native_ids = [tok.encode_raw(x) for x in texts]
    native_s = time.perf_counter() - t
    if native_ids != oracle:
        raise AssertionError("13b: native SentencePiece ids differ from "
                             "the oracle's")
    kernels.reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = llm.generate(texts, max_new_tokens=FRONT_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = dict(kernels.counts)
    check_launches("13b", counts)
    toks = [r.output_tokens for r in res]
    # the tokenizer's EOS may end a request early
    if any(r.output_text != tok.decode(r.output_tokens) or not r.output_text
           or not 0 < len(r.output_tokens) <= FRONT_NEW for r in res):
        raise AssertionError("13b: output text or lengths")
    ref = LLM.from_checkpoint(d, data_type=DataType.DT_BFLOAT16,
                              tokenizer=tok).compile(**FRONT_KW)
    want = [r.output_tokens for r in ref.generate(
        [r.input_tokens for r in res], max_new_tokens=FRONT_NEW)]
    del ref
    gc.collect()
    same = sum(a == b for a, b in zip(toks, want))
    with open(outf) as f:
        records = f.read().count("output: ")
    log(f"  LLM(dir): load + compile {load_s:.2f} s; {sum(map(len, toks))} "
        f"tokens in {wall:.3f} s; prompt lengths "
        f"{[len(r.input_tokens) for r in res]}; tokenizer ids equal to the "
        f"oracle on {len(texts)} prompts (native {native_s * 1e3:.2f} ms, "
        f"oracle {oracle_s * 1e3:.1f} ms); tokens equal to "
        f"LLM.from_checkpoint(dir) {same}/{REQUESTS}; output file records "
        f"{records}; launches {counts}  [{card}]")
    log(f"  first output: {res[0].output_text[:120]!r}")
    if same != REQUESTS or records != REQUESTS:
        raise AssertionError("13b: tokens against from_checkpoint or the "
                             "output file")
    report = dict(load_s=load_s, wall_s=wall, native_tokenize_ms=native_s
                  * 1e3, oracle_tokenize_ms=oracle_s * 1e3,
                  seconds=time.perf_counter() - t_phase)
    return counts, report, d, llm, texts, [r.input_tokens for r in res]


def plain_kernels_phase(torch, card, d, llm, texts):
    """13e: 13b's directory compiled with ``use_kernels=False`` serves
    13b's prompts for PLAIN_NEW tokens: the plain versions run on the card
    (plain_attend_cuda > 0, no K1 or K2 launch); the default pass right
    after (13b's model) launches K1 and K2 and no plain version. The
    token match between the two is reported."""
    from flexflow_tpu_torch import LLM, DataType, kernels

    plain = LLM(d, data_type=DataType.DT_BFLOAT16).compile(
        **FRONT_KW, use_kernels=False)
    kernels.reset_counts()
    res_p = plain.generate(texts, max_new_tokens=PLAIN_NEW)
    torch.cuda.synchronize()
    c_plain = dict(kernels.counts)
    del plain
    gc.collect()
    kernels.reset_counts()
    res_k = llm.generate(texts, max_new_tokens=PLAIN_NEW)
    torch.cuda.synchronize()
    c_kern = dict(kernels.counts)
    same = sum(a.output_tokens == b.output_tokens
               for a, b in zip(res_p, res_k))
    log(f"  use_kernels=False: {c_plain}; default pass: {c_kern}; tokens "
        f"equal {same}/{REQUESTS} (reported)  [{card}]")
    if (not c_plain["plain_attend_cuda"] or c_plain["flash_attend"]
            or c_plain["flash_attend_append"]):
        raise AssertionError(f"13e: use_kernels=False counts {c_plain}")
    check_launches("13e default pass", c_kern)
    return c_kern, dict(tokens_equal=same)


def ffsv_lib(path):
    """The port's serve library through ctypes (PyDLL: calls hold the
    GIL), its signatures declared."""
    import ctypes as c

    lib = c.PyDLL(path)
    lib.ffsv_init.argtypes = [c.c_char_p]
    lib.ffsv_last_error.restype = c.c_char_p
    for fn in ("ffsv_config_create", "ffsv_llm_create", "ffsv_spec_create",
               "ffsv_metrics_dump"):
        getattr(lib, fn).restype = c.c_void_p
    lib.ffsv_config_set.argtypes = [c.c_void_p, c.c_char_p, c.c_char_p]
    lib.ffsv_llm_create.argtypes = [c.c_void_p, c.c_char_p]
    lib.ffsv_spec_create.argtypes = [c.c_void_p, c.c_char_p, c.c_char_p]
    lib.ffsv_register_request.restype = c.c_long
    lib.ffsv_register_request.argtypes = [c.c_void_p, c.POINTER(c.c_int32),
                                          c.c_int, c.c_int]
    lib.ffsv_generate.argtypes = [c.c_void_p]
    lib.ffsv_generate_spec.argtypes = [c.c_void_p, c.c_int]
    lib.ffsv_get_output.argtypes = [c.c_void_p, c.c_long,
                                    c.POINTER(c.c_int32), c.c_int]
    lib.ffsv_metrics_dump.argtypes = [c.c_char_p]
    lib.ffsv_release.argtypes = [c.c_void_p]
    return lib


def capi_phase(torch, card, d, prompts):
    """13c: the port's C serving ABI on the card, in this process:
    ``ffsv_llm_create({"checkpoint_dir": <13b's dir>, "quantize":
    "int8"})`` serves 13b's prompts (as token ids) for FRONT_NEW tokens
    through ``ffsv_register_request``/``ffsv_generate``/
    ``ffsv_get_output``. Gates: the tokens equal ``LLM.from_checkpoint
    (dir, quantize="int8")``'s with the same config, K1, K2 and K3
    launched, no plain call. Then ``ffsv_spec_create`` with the directory
    as verifier and draft, telemetry on, ``ffsv_generate_spec`` at depth
    2, the adaptive controller off (the match with incremental decoding
    reported; K1 with the tree bias launched) and a non-empty
    ``ffsv_metrics_dump``; then the unchanged ``examples/c/
    incr_decoding.c`` compiled with ``cc`` against the library and
    libpython runs on the card and prints its marker. Returns (launch
    counts, report)."""
    import ctypes

    from flexflow_tpu_torch import LLM, kernels, native
    from flexflow_tpu_torch.telemetry import disable_telemetry

    t_phase = time.perf_counter()
    t = time.perf_counter()
    path = native.build_serve_library()
    lib = ffsv_lib(path)
    log(f"  serve library {os.path.basename(path)}: "
        f"{time.perf_counter() - t:.2f} s")
    if lib.ffsv_init(HERE.encode()) != 0:
        raise AssertionError(f"13c: ffsv_init: {lib.ffsv_last_error()}")
    cfg = lib.ffsv_config_create()
    fields = dict(max_requests_per_batch=REQUESTS,
                  max_sequence_length=MAX_SEQ, max_tokens_per_batch=256,
                  kv_cache_dtype="bfloat16", compute_dtype="bfloat16")
    for k, v in fields.items():
        if lib.ffsv_config_set(cfg, k.encode(), str(v).encode()) != 0:
            raise AssertionError(f"13c: ffsv_config_set {k}")
    spec = json.dumps({"checkpoint_dir": d, "quantize": "int8"}).encode()

    def serve(handle, depth=0):
        guids = []
        for p in prompts:
            arr = (ctypes.c_int32 * len(p))(*p)
            guids.append(lib.ffsv_register_request(handle, arr, len(p),
                                                   FRONT_NEW))
        kernels.reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        n = (lib.ffsv_generate_spec(handle, depth) if depth
             else lib.ffsv_generate(handle))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if n != len(prompts):
            raise AssertionError(f"13c: generate gave {n}: "
                                 f"{lib.ffsv_last_error()}")
        out = []
        for g in guids:
            buf = (ctypes.c_int32 * 256)()
            k = lib.ffsv_get_output(handle, g, buf, 256)
            out.append(list(buf[:k]))
        return out, wall, dict(kernels.counts)

    t = time.perf_counter()
    h = lib.ffsv_llm_create(cfg, spec)
    if not h:
        raise AssertionError(f"13c: ffsv_llm_create: "
                             f"{lib.ffsv_last_error()}")
    create_s = time.perf_counter() - t
    toks, wall, counts = serve(h)
    check_launches("13c ffsv_generate", counts, k3=True)
    lib.ffsv_release(h)
    gc.collect()
    py = LLM.from_checkpoint(d, quantize="int8").compile(
        max_requests_per_batch=REQUESTS, max_seq_length=MAX_SEQ,
        max_tokens_per_batch=256, kv_cache_dtype="bfloat16",
        compute_dtype="bfloat16", device="cuda")
    want = [r.output_tokens for r in py.generate(prompts,
                                                 max_new_tokens=FRONT_NEW)]
    del py
    gc.collect()
    same = sum(a == b for a, b in zip(toks, want))
    log(f"  ffsv_llm_create (checkpoint_dir, int8 on load) "
        f"{create_s:.2f} s; ffsv_generate {sum(map(len, toks))} tokens in "
        f"{wall:.3f} s; "
        f"tokens equal to the Python LLM path {same}/{REQUESTS}; launches "
        f"{counts}  [{card}]")
    if same != REQUESTS:
        raise AssertionError("13c: C ABI tokens differ from the Python path")

    if lib.ffsv_config_set(cfg, b"telemetry", b"true") != 0:
        raise AssertionError("13c: telemetry flag")
    try:
        # the draft is the verifier itself: the adaptive controller would
        # park every request (draft cost 1), so speculation runs static
        vspec = json.dumps({"checkpoint_dir": d, "quantize": "int8",
                            "generation_config": {"adaptive": False}})
        pair = lib.ffsv_spec_create(cfg, vspec.encode(), spec)
        if not pair:
            raise AssertionError(f"13c: ffsv_spec_create: "
                                 f"{lib.ffsv_last_error()}")
        spec_toks, spec_wall, spec_counts = serve(pair, depth=2)
        ptr = lib.ffsv_metrics_dump(b"json")
        dump = ctypes.string_at(ptr).decode() if ptr else ""
        lib.ffsv_release(pair)
    finally:
        disable_telemetry()
    gc.collect()
    spec_same = sum(a == b for a, b in zip(spec_toks, toks))
    log(f"  ffsv_generate_spec depth 2: {sum(map(len, spec_toks))} tokens "
        f"in {spec_wall:.3f} s; equal to incremental {spec_same}/{REQUESTS} "
        f"(reported); metrics dump {len(dump)} bytes; launches "
        f"{spec_counts}  [{card}]")
    if "ffsv_requests_total" not in dump or not spec_counts[
            "flash_attend_bias"] or spec_counts["plain_attend_cuda"]:
        raise AssertionError("13c: speculation or metrics dump")
    lib.ffsv_release(cfg)

    import sysconfig
    import tempfile

    _inc, link = native.python_build_flags()
    with tempfile.TemporaryDirectory() as exe_dir:
        exe = os.path.join(exe_dir, "incr_decoding")
        t = time.perf_counter()
        subprocess.run(["cc", os.path.join(HERE, "examples", "c",
                                           "incr_decoding.c"),
                        "-L" + native.BUILD_DIR,
                        "-lflexflow_tpu_torch_serve", *link, "-o", exe],
                       check=True, timeout=300)
        env = dict(os.environ,
                   PYTHONPATH=os.pathsep.join(p for p in sys.path if p),
                   LD_LIBRARY_PATH=os.pathsep.join(
                       [native.BUILD_DIR,
                        sysconfig.get_config_var("LIBDIR") or ""]))
        env.pop("FFSV_DEVICE", None)          # the card, the default
        proc = subprocess.run([exe, HERE], env=env, capture_output=True,
                              text=True, timeout=600)
        c_s = time.perf_counter() - t
    log(f"  examples/c/incr_decoding.c on the card: exit {proc.returncode} "
        f"in {c_s:.1f} s (compile + run); "
        f"{proc.stdout.strip().splitlines()[-1:]}")
    if proc.returncode != 0 or "C incr_decoding OK" not in proc.stdout:
        raise AssertionError(f"13c: the C example failed: "
                             f"{proc.stderr[-2000:]}")
    report = dict(create_s=create_s, wall_s=wall, spec_wall_s=spec_wall,
                  spec_equal=spec_same, c_example_s=c_s,
                  seconds=time.perf_counter() - t_phase)
    return counts, report


def dumps_phase(torch, card, tmp):
    """13d: ``inference_debugging`` on a 1-layer cut at LLaMA-2-7B widths
    in fp32 (TF32 off since phase 1), 2 requests of DUMP_PROMPT tokens,
    one prefill and one decode step at decode width 1, on the card and on
    the CPU (both the port, one numpy draw of weights). The bytes are
    reckoned first; the dumps go to ``tmp`` and are deleted. Gates: the
    same files and keys, the worst op output (``worst_op``) within
    DUMP_TOL of its largest magnitude, K1 launched and no plain version
    on the card. The tokens' match and ``compare_dumps``'s count at rtol
    1e-4 are reported."""
    import shutil

    import numpy as np

    from flexflow_tpu_torch import LLM, kernels
    from flexflow_tpu_torch.serve.request_manager import RequestManager
    from flexflow_tpu_torch.utils.debugging import compare_dumps, worst_op

    t_phase = time.perf_counter()
    hf, sd = seven_b(torch, layers=1)
    sd = {k: v.float().cpu().numpy() for k, v in sd.items()}
    wbytes = sum(v.nbytes for v in sd.values())
    need = 2 * 2 * wbytes           # every weight dumped, 2 steps, 2 devices
    free = shutil.disk_usage(tmp).free
    log(f"  dumps: about {need / 1e9:.2f} GB of weights (+ activations) "
        f"for 2 steps on 2 devices; {free / 1e9:.1f} GB free")
    if free < 2 * need:
        raise AssertionError("13d: not enough disk for the dumps")
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, VOCAB, DUMP_PROMPT).tolist()
               for _ in range(2)]
    toks, dirs, counts = {}, {}, None
    for name, dev in (("card", "cuda"), ("host", "cpu")):
        llm = LLM((hf, sd)).compile(
            max_requests_per_batch=2, max_seq_length=64,
            max_tokens_per_batch=16, kv_cache_dtype="float32",
            decode_width=1, device=dev, inference_debugging=True)
        dirs[name] = os.path.join(tmp, f"dumps_{name}")
        RequestManager._ifm(llm.ffmodel).debug_dir = dirs[name]
        kernels.reset_counts()
        t = time.perf_counter()
        res = llm.generate(prompts, max_new_tokens=1)
        if name == "card":
            torch.cuda.synchronize()
            counts = dict(kernels.counts)
        toks[name] = [r.output_tokens for r in res]
        log(f"  {dev}: one prefill and one decode step with dumps in "
            f"{time.perf_counter() - t:.2f} s")
        del llm
        gc.collect()
    files = {name: sorted(os.path.relpath(os.path.join(r, f), dirs[name])
                          for r, _, fs in os.walk(dirs[name]) for f in fs)
             for name in dirs}
    t = time.perf_counter()
    worst = worst_op(dirs["host"], dirs["card"])
    mism = compare_dumps(dirs["host"], dirs["card"], rtol=1e-4)
    cmp_s = time.perf_counter() - t
    dumped = sum(os.path.getsize(os.path.join(r, f))
                 for name in dirs for r, _, fs in os.walk(dirs[name])
                 for f in fs)
    for name in dirs:
        shutil.rmtree(dirs[name])
    log(f"  {len(files['card'])} dump files a device, {dumped / 1e9:.2f} GB "
        f"written; worst op output {worst[0]} {worst[1]}: max abs "
        f"{worst[2]:.3e}, relative to its largest magnitude "
        f"{worst[3]:.3e} (gate {DUMP_TOL}); compare_dumps at rtol 1e-4: "
        f"{len(mism)} arrays ({cmp_s:.1f} s); tokens card == CPU "
        f"{toks['card'] == toks['host']} (reported); card launches "
        f"{counts}  [{card}]")
    if (files["card"] != files["host"] or worst is None
            or worst[3] > DUMP_TOL or not counts["flash_attend"]
            or counts["plain_attend_cuda"]):
        raise AssertionError("13d: dumps")
    return dict(worst_op=list(worst), mismatches_rtol_1e4=len(mism),
                files=len(files["card"]), gb_written=dumped / 1e9,
                seconds=time.perf_counter() - t_phase)


# 13f: the JAX package's serving entry points, each run on the card and on
# the CPU in processes of tests/torch_example_run.py, whose alias resolves
# ``flexflow_tpu`` imports to the port's modules (test scaffolding: the
# port has no such alias); a process prints its kernels' launch counts and
# shapes and any flexflow_tpu module that is not the port's
INFERENCE_SCRIPTS = ("inference/python/incr_decoding.py",
                     "inference/python/spec_infer.py")
EXAMPLE_RUNNER = os.path.join("tests", "torch_example_run.py")


@contextlib.contextmanager
def killed_on_error(procs):
    """Kill the processes of ``procs`` ({name: Popen}) when the block
    raises, so that a failed phase leaves none of them running."""
    try:
        yield
    except BaseException:
        for proc in procs.values():
            proc.kill()
            proc.wait()
        raise


def start_inference_scripts():
    """13f's processes, all started at once: each script on the card and
    on the CPU (one thread, no card visible, lowered priority so that
    13b-13d's host work goes first), through ``EXAMPLE_RUNNER`` with
    ``--report``: ({(script, device): process}, start time)."""
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    envs = {"cuda": env,
            "cpu": dict(env, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")}
    procs = {(s, dev): subprocess.Popen(
        [sys.executable, EXAMPLE_RUNNER, "--device", dev, "--report", s,
         "--max-new-tokens", "4"], cwd=HERE, env=envs[dev],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for s in INFERENCE_SCRIPTS for dev in envs}
    for (_s, dev), proc in procs.items():
        if dev == "cpu":
            os.setpriority(os.PRIO_PROCESS, proc.pid, 10)
    return procs, time.perf_counter()


def inference_scripts_phase(card, procs, t):
    """13f's gates on the processes of ``start_inference_scripts``: each
    exits 0 with three requests' tokens and no module of the JAX package
    or of jax loaded; on the card K1/K2 launched and no plain call, and
    the tokens equal the CPU run's. Returns (launch counts summed over
    the card's runs, report, {kernel: the card's launch shapes}), the
    shapes for 14c."""
    total, report, shapes = {}, {}, {}
    runs = {}
    for (script, dev), proc in procs.items():
        out, err = proc.communicate(timeout=600)
        lines = out.splitlines()
        run = [json.loads(x.split(" ", 1)[1]) for x in lines
               if x.startswith("PORT_RUN ")]
        toks = [json.loads(x.split("output_tokens=", 1)[1].split("]")[0]
                           + "]") for x in lines if "output_tokens=" in x]
        c = run[0]["counts"] if run else {}
        log(f"  {script} on the {dev}: exit {proc.returncode}, tokens "
            f"{toks}, launches {c}, foreign modules "
            f"{run[0]['foreign'] if run else '?'}  [{card}]")
        if proc.returncode != 0 or not run or run[0]["foreign"] \
                or len(toks) != 3:
            raise AssertionError(f"13f: {script} on the {dev} exit "
                                 f"{proc.returncode}: {err[-3000:]}")
        runs[script, dev] = toks
        if dev != "cuda":
            continue
        check_launches(f"13f {script}", c)
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
        for kernel, sh in run[0]["shapes"].items():
            shapes.setdefault(kernel, set()).update(tuple(x) for x in sh)
        report[script] = dict(requests=len(toks), counts=c)
    for script in INFERENCE_SCRIPTS:
        equal = sum(a == b for a, b in zip(runs[script, "cuda"],
                                           runs[script, "cpu"]))
        report[script]["tokens_equal_cpu"] = equal
        if equal != 3:
            raise AssertionError(f"13f: {script} card tokens against the "
                                 f"CPU's: {equal}/3")
    report["shapes"] = {k: len(v) for k, v in shapes.items()}
    report["seconds"] = time.perf_counter() - t
    log(f"  13f: card tokens equal to the CPU's, 3/3 a script; launch "
        f"shapes {report['shapes']} (held against the plain versions in "
        f"14c); {report['seconds']:.1f} s  [{card}]")
    return total, report, shapes


def host_side_phase(torch, card):
    """Phase 13 in order 13a, 13b, 13e (on 13b's model), 13c, 13d, with
    13f's processes beside 13b-13d; returns (each sub-phase's launch
    counts by name, 13f's launch shapes on the card)."""
    import tempfile

    t_phase = time.perf_counter()
    by_path, report = {}, {}
    log(f"phase 13a: the native scheduler against the Python loop, phase "
        f"8's headline model, {HOST_PAIRS} alternating pairs, {REQUESTS} "
        f"requests x {PROMPT_LEN}-token prompts, {NEW_TOKENS} new tokens  "
        f"[{card}]")
    by_path["native"], report["13a"] = native_scheduler_phase(torch, card)
    gc.collect()
    # 13f's processes run beside 13b-13d (their times are not measured)
    log(f"phase 13f: the JAX package's serving entry points, "
        f"{', '.join(INFERENCE_SCRIPTS)}, with their flexflow_tpu imports "
        f"resolved to the port, on the card and on the CPU, started beside "
        f"13b-13d  [{card}]")
    scripts = start_inference_scripts()
    with tempfile.TemporaryDirectory() as tmp, killed_on_error(scripts[0]):
        log(f"phase 13b: LLM(dir) at LLaMA-2-7B widths, {FLEET_LAYERS} "
            f"layers, 2 shards, a 32000-piece tokenizer.model, text "
            f"prompts  [{card}]")
        by_path["frontdoor"], report["13b"], d, llm, texts, prompts = \
            front_door_phase(torch, card, tmp)
        log(f"phase 13e: use_kernels=False on the card, 13b's model, "
            f"{PLAIN_NEW} new tokens  [{card}]")
        by_path["default_after_plain"], report["13e"] = plain_kernels_phase(
            torch, card, d, llm, texts)
        del llm
        gc.collect()
        log(f"phase 13c: the C ABI on the card (the port's serve library, "
            f"13b's directory, int8 on load)  [{card}]")
        by_path["capi"], report["13c"] = capi_phase(torch, card, d, prompts)
        gc.collect()
        log(f"phase 13d: inference_debugging dumps, 1 layer at LLaMA-2-7B "
            f"widths, fp32, card against CPU  [{card}]")
        report["13d"] = dumps_phase(torch, card, tmp)
        gc.collect()
    by_path["inference_scripts"], report["13f"], shapes = \
        inference_scripts_phase(card, *scripts)
    report["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 13: {report['seconds']:.1f} s  [{card}]")
    log(json.dumps({"host_side_phase": report}))
    return by_path, shapes


# ----------------------------------------------------------------------
# phase 14: CPU weight offload and sharded serving
# ----------------------------------------------------------------------
# 14a: phase 8's int8 model, offload on and off; the prefetch reserve is
# cut to 1 GiB (FFConfig's default, 8 GiB, would hold the whole int8
# model in flight)
OFFLOAD_NEW, OFFLOAD_PAIRS, OFFLOAD_RESERVE = 32, 2, 1 << 30
# 14b: LLaMA-2-7B widths, int8 weights, fp32 compute and cache (greedy
# tokens compared across layouts whose reductions add in other orders),
# each config's ranks as subprocesses sharing the card through gloo; the
# depth cut to 4 of 32 layers (each pp=2 stage still holds 2) to keep the
# whole script inside its time limit
SHARD_NEW, SHARD_SEQ, SHARD_LAYERS, SHARD_TIMEOUT = 16, 64, 4, 420
SHARD_CONFIGS = (("tp2", dict(tensor_parallelism_degree=2)),
                 ("pp2", dict(pipeline_parallelism_degree=2)),
                 ("sp2", dict(sequence_parallelism_degree=2)))
# 14b-prefix: a 96-token system prompt in front of each 8-token user turn,
# 8 requests in 4 slots (the first 4 fill the pool, the last 4 hit it),
# on 14b's tp=2 and sp=2 ranks
POOL_PREFIX, POOL_TURN, POOL_SLOTS, POOL_NEW, POOL_SEQ = 96, 8, 4, 8, 128
POOL_CONFIGS = ("tp2", "sp2")
# 14b-strategy: phase 8's geometry at all its layers, on 14b's tp=2 ranks
STRAT_NEW = 8
# 14b's tp=2 rank holds at most this share of the 1-rank run's layer-output
# bytes when the prefill returns (split over ``model`` on their features:
# 0.50 and the few whole values, the tokens and the head's indices)
TP2_LAYER_OUTPUT_SHARE = 0.55


def _offloaded_nbytes(m) -> int:
    """Bytes of the weights ``m`` keeps in pinned host memory; checks
    that each one is pinned and off the card."""
    n = 0
    for lname, names in m._offloaded.items():
        for w in names:
            leaf = m.params[lname][w]
            for t in ([leaf.q, leaf.scale] if hasattr(leaf, "q") else [leaf]):
                if t.is_cuda or not t.is_pinned():
                    raise AssertionError(f"14a: {lname}.{w} not pinned")
            n += leaf.nbytes
    return n


def _device_bytes(m) -> int:
    """Bytes of ``m``'s parameters and caches that live on the card."""
    from flexflow_tpu_torch.quant import is_quantized

    n = 0
    for lp in m.params.values():
        for leaf in lp.values():
            ts = [leaf.q, leaf.scale] if is_quantized(leaf) else [leaf]
            n += sum(t.nbytes for t in ts if t.is_cuda)
    for st in m.op_state.values():
        if isinstance(st, dict):
            n += sum(t.nbytes for t in st.values()
                     if hasattr(t, "is_cuda") and t.is_cuda)
    return n


def offload_phase(torch, card):
    """14a: phase 8's model (LLaMA-2-7B geometry, int8 weights, bf16
    compute and cache) twice, offload off and on, in alternating pairs.
    Returns (the offload-on pass's launch counts, report, the offload-on
    passes' launch shapes)."""
    import numpy as np

    from flexflow_tpu_torch import kernels
    from flexflow_tpu_torch.serve import graphs
    from flexflow_tpu_torch.serve.request_manager import RequestManager

    off, _, s_off = quantized_llm(torch, "int8")
    on, _, s_on = quantized_llm(torch, "int8", cpu_offload=True,
                                offload_reserve_space_size=OFFLOAD_RESERVE)
    m_off, m_on = off.ffmodel, on.ffmodel
    moved = _offloaded_nbytes(m_on)
    pf_on = m_on._prefetcher
    ring_bound = max(pf_on.reserve, 2 * max(pf_on.sizes))
    log(f"  the offload ring: {pf_on.ring_bytes / 2**30:.3f} GiB for "
        f"{len(pf_on.order)} units (largest {max(pf_on.sizes) / 2**20:.1f} "
        f"MiB), bound {ring_bound / 2**30:.3f} GiB; the programs capture: "
        f"{graphs.captures(m_on)}  [{card}]")
    if pf_on.ring_bytes > ring_bound or not graphs.captures(m_on):
        raise AssertionError("14a: the ring passes its bound, or the "
                             "offloaded model's programs do not capture")
    log(f"  built in {s_off:.1f} s (off) and {s_on:.1f} s (on, offload at "
        f"compile); {moved / 1e9:.3f} GB paged to pinned host memory in "
        f"{sum(len(v) for v in m_on._offloaded.values())} weights; on the "
        f"card: {_device_bytes(m_off) / 2**30:.2f} GiB (off) vs "
        f"{_device_bytes(m_on) / 2**30:.2f} GiB (on)  [{card}]")
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, VOCAB, PROMPT_LEN).tolist()
               for _ in range(REQUESTS)]
    others = {id(m_off): _device_bytes(m_on), id(m_on): _device_bytes(m_off)}
    on_shapes = {}

    def one(m, what, new_tokens=OFFLOAD_NEW):
        ifm = RequestManager._ifm(m)
        dec = decode_timer(ifm)
        pf = m._prefetcher
        f0 = pf.bytes_fetched if pf is not None else 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with kernels.record_shapes() as sh:
            res, _tps, counts, _rm = timed_pass(
                torch, card, prompts,
                lambda rm: rm.generate_incr_decoding(m), new_tokens, what)
        if m is m_on:
            on_shapes.update({k: set(v) for k, v in sh.items()})
        peak = torch.cuda.max_memory_allocated()
        del ifm.decode_block
        fetched = (pf.bytes_fetched - f0) if pf is not None else 0
        return dict(tokens=res, counts=counts, peak=peak,
                    own_peak=peak - others[id(m)],
                    ms=dec["s"] * 1e3 / max(1, dec["steps"]),
                    fetched=fetched)

    one(m_off, "warm-up, offload off", 8)
    one(m_on, "warm-up, offload on", 8)
    passes = {"off": [], "on": []}
    for i in range(OFFLOAD_PAIRS):
        passes["off"].append(one(m_off, f"pair {i}: offload off"))
        passes["on"].append(one(m_on, f"pair {i}: offload on"))
    ref = passes["off"][0]["tokens"]
    equal = min(sum(a == b for a, b in zip(p["tokens"], ref))
                for p in passes["off"] + passes["on"])

    def stats(key, side):
        v = [p[key] for p in passes[side]]
        return statistics.mean(v), min(v), max(v)

    ms_on, ms_off = stats("ms", "on"), stats("ms", "off")
    c_on = passes["on"][-1]["counts"]
    fetched = passes["on"][-1]["fetched"]
    gbps = moved / (ms_on[0] / 1e3) / 1e9
    log(f"  tokens equal to the first offload-off pass: {equal}/{REQUESTS} "
        f"in every pass")
    log(f"  decode ms/step mean/min/max of {OFFLOAD_PAIRS} passes: off "
        f"{ms_off[0]:.3f}/"
        f"{ms_off[1]:.3f}/{ms_off[2]:.3f}, on {ms_on[0]:.3f}/{ms_on[1]:.3f}"
        f"/{ms_on[2]:.3f} ({ms_on[0] / ms_off[0]:.2f}x)  [{card}]")
    log(f"  max_memory_allocated over a pass (both models resident): off "
        f"{stats('peak', 'off')[0] / 2**30:.2f} GiB, on "
        f"{stats('peak', 'on')[0] / 2**30:.2f} GiB; less the other model's "
        f"card bytes: off {stats('own_peak', 'off')[0] / 2**30:.2f} GiB, on "
        f"{stats('own_peak', 'on')[0] / 2**30:.2f} GiB  [{card}]")
    log(f"  host->device: {fetched / 1e9:.2f} GB streamed in the last "
        f"on pass ({fetched / max(1, moved):.1f} x the paged bytes: one "
        f"fetch a forward); {moved / 1e9:.3f} GB a decode step at "
        f"{ms_on[0]:.3f} ms implies {gbps:.1f} GB/s  [{card}]")
    log(f"  launches, offload on: {c_on}")
    on_steps, on_dec = program_pool_bytes(RequestManager._ifm(m_on))
    log(f"  offload on: the ring {pf_on.ring_bytes / 2**30:.3f} GiB, graph "
        f"pools {on_steps / 2**30:.3f} GiB (steps) + {on_dec / 2**30:.3f} "
        f"GiB (decode), own peak {stats('own_peak', 'on')[0] / 2**30:.2f} "
        f"GiB  [{card}]")
    if (equal != REQUESTS or not c_on["flash_attend_append"]
            or not c_on["qmatmul"] or c_on["plain_attend_cuda"]
            or c_on["qmatmul_plain_cuda"]
            or not stats("own_peak", "on")[0] < stats("own_peak", "off")[0]
            or not moved):
        raise AssertionError("14a: offload gates")
    report = dict(tokens_equal=equal, bytes_moved=moved,
                  decode_ms_off=list(ms_off), decode_ms_on=list(ms_on),
                  peak_gib_off=stats("peak", "off")[0] / 2**30,
                  peak_gib_on=stats("peak", "on")[0] / 2**30,
                  own_peak_gib_off=stats("own_peak", "off")[0] / 2**30,
                  own_peak_gib_on=stats("own_peak", "on")[0] / 2**30,
                  h2d_gb_per_s=gbps, reserve=OFFLOAD_RESERVE,
                  ring_gib=pf_on.ring_bytes / 2**30,
                  step_pool_gib=on_steps / 2**30,
                  decode_pool_gib=on_dec / 2**30)
    del off, on, m_off, m_on
    gc.collect()
    torch.cuda.empty_cache()
    return c_on, report, on_shapes


def _check_collectives(results):
    """The collectives job's results on an axis of n ranks against
    numpy (x = rank * 10 + arange(4 n))."""
    import numpy as np

    n = results[0]["n"]
    xs = np.stack([r["rank"] * 10 + np.arange(4 * n, dtype=np.float32)
                   for r in sorted(results, key=lambda r: r["index"])])
    for r in results:
        i = r["index"]
        want = {"psum": xs.sum(0), "pmax": xs.max(0), "pmean": xs.mean(0),
                "all_gather": np.concatenate([a.reshape(n, 4) for a in xs],
                                             axis=1),
                "all_gather_stacked": xs,
                "reduce_scatter": np.split(xs.sum(0), n)[i],
                "ppermute": xs[(i - 1) % n], "send_recv": xs[(i - 1) % n],
                "all_to_all": np.concatenate(
                    [a.reshape(n, 4)[i:i + 1] for a in xs], axis=1),
                "broadcast": xs[0]}
        for k, v in want.items():
            if not np.allclose(np.asarray(r[k], np.float32), v):
                raise AssertionError(f"14b: collective {k} on rank "
                                     f"{r['rank']}")
    return sorted(want)


def sharded_phase(torch, card, work, device="cuda", model=None):
    """14b: the collectives on the card, then LLaMA-2-7B widths (int8,
    fp32 compute and cache) on one rank (a world-size-1 NCCL group) and
    at tp=2, pp=2 and sp=2 (two ranks sharing the card through gloo),
    each as subprocesses of ``parallel/launch.run_ranks`` (their stores
    and logs under ``work``), every launch started at once and the card
    shared between them. Returns ({config: launch counts summed over its
    ranks}, report, {config: {kernel: launch shapes of its ranks}})."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from flexflow_tpu_torch.parallel.launch import run_ranks

    jobs = "flexflow_tpu_torch.parallel.rank_jobs"
    test_jobs = os.path.join(HERE, "tests", "torch_rank_jobs.py")
    t_phase = time.perf_counter()
    model = model or dict(
        vocab_size=VOCAB, hidden_size=HIDDEN, intermediate_size=INTER,
        num_hidden_layers=SHARD_LAYERS, num_attention_heads=HEADS,
        num_key_value_heads=KV_HEADS, max_position_embeddings=MAX_SEQ)
    cfg = dict(max_requests_per_batch=REQUESTS, max_sequence_length=SHARD_SEQ,
               max_tokens_per_batch=REQUESTS * PROMPT_LEN,
               kv_cache_dtype="float32", compute_dtype="float32",
               quantization_type="int8", seed=7)
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, model["vocab_size"], PROMPT_LEN).tolist()
               for _ in range(REQUESTS)]

    prefix = rng.integers(0, model["vocab_size"], POOL_PREFIX).tolist()
    pool_prompts = [prefix + rng.integers(0, model["vocab_size"],
                                          POOL_TURN).tolist()
                    for _ in range(REQUESTS)]
    pool_cfg = dict(cfg, max_requests_per_batch=POOL_SLOTS,
                    max_sequence_length=POOL_SEQ,
                    max_tokens_per_batch=POOL_SLOTS * len(pool_prompts[0]))

    full, strat_ref, strat_one = strategy_reference(torch, card, model,
                                                    cfg, prompts, device)

    def runs(deg, name=""):
        out = [dict(name="incr", model=model, config=dict(cfg, **deg),
                    prompts=prompts, max_new=SHARD_NEW)]
        if name in POOL_CONFIGS:
            out += [dict(name=f"pool-{on}", model=model,
                         config=dict(pool_cfg, **deg), prompts=pool_prompts,
                         max_new=POOL_NEW, prefix_cache=on == "on")
                    for on in ("off", "on")]
        if name == "tp2":
            out += strategy_runs(full, dict(cfg, **deg), prompts)
        return out

    def timed(*args, **kw):
        t = time.perf_counter()
        return run_ranks(*args, **kw), time.perf_counter() - t

    # a mesh of one rank: the final-output broadcast runs on its group
    one = dict(mesh_shape=[1], mesh_axis_names=["model"])
    with ThreadPoolExecutor(2 + len(SHARD_CONFIGS)) as pool:
        f_coll = pool.submit(
            timed, f"{test_jobs}:collectives", 2,
            {"device": device, "axis": "model",
             "degrees": {"tensor_parallelism_degree": 2}},
            workdir=os.path.join(work, "collectives"), timeout=SHARD_TIMEOUT,
            device=device, backend="gloo")
        f_single = pool.submit(
            timed, f"{jobs}:serve", 1, {"device": device, "runs": runs(one)},
            workdir=os.path.join(work, "single"), timeout=SHARD_TIMEOUT,
            device=device, backend="nccl" if device == "cuda" else "gloo")
        f_cfg = {name: pool.submit(
            timed, f"{jobs}:serve", 2,
            {"device": device, "runs": runs(deg, name)},
            workdir=os.path.join(work, name), timeout=SHARD_TIMEOUT,
            device=device, backend="gloo") for name, deg in SHARD_CONFIGS}
        coll, secs = f_coll.result()
        names = _check_collectives(coll)
        log(f"  collectives on {device} tensors, 2 ranks, gloo through "
            f"pinned host buffers: {', '.join(names)} equal to numpy "
            f"({secs:.1f} s)")
        single, secs = f_single.result()
        single = single[0][0]
        launches = {name: f.result() for name, f in f_cfg.items()}
    ref = single["tokens"]
    log(f"  1 rank ({'NCCL' if device == 'cuda' else 'gloo'} world of 1, "
        f"{model['num_hidden_layers']} layers): decode ms/step of its one "
        f"pass (cold: the first generate after the build; beside the other "
        f"launches) {single['decode_ms_per_step'][-1]:.3f}, peak "
        f"{single['peak_bytes'] / 2**30:.2f} GiB, launches "
        f"{single['counts']}, {secs:.1f} s  [{card}]")
    report = {"single": dict(decode_ms_cold=single["decode_ms_per_step"][-1],
                             peak_gib=single["peak_bytes"] / 2**30,
                             counts=single["counts"],
                             layer_output_bytes=single["prefill"][
                                 "layer_output_bytes"])}
    by_path, shapes = {}, {}
    plain = ("plain_attend_cuda", "qmatmul_plain_cuda")
    one_held = single["prefill"]["layer_output_bytes"]
    for name, deg in SHARD_CONFIGS:
        launched, secs = launches[name]
        ranks = [r[0] for r in launched]
        rep = []
        for r in ranks:
            eq = sum(a == b for a, b in zip(r["tokens"], ref))
            c = r["counts"]
            # sp2: every K1 and K2 launch returns its partials
            part = (c["flash_attend"] + c["flash_attend_append"]
                    if name == "sp2" else 0)
            ok = (eq == REQUESTS and c["qmatmul"] > 0
                  and c["flash_attend"] > 0 and c["flash_attend_append"] > 0
                  and c["flash_attend_partials"] == part
                  and not any(c[k] for k in plain))
            if name == "tp2":
                held = split_report(r, one_held, card, "14b tp2")
                ok = ok and held["layer_output_share"] <= \
                    TP2_LAYER_OUTPUT_SHARE
            ls = r["launch_shapes"]
            for kernel, sh in ls.items():
                shapes.setdefault(name, {}).setdefault(kernel, set()).update(
                    tuple(x) for x in sh)
            log(f"  {name} rank {r['rank']} (mesh {r['mesh']}): tokens "
                f"{eq}/{REQUESTS} equal to 1 rank; launches K1 "
                f"{c['flash_attend']} K2 {c['flash_attend_append']} (of "
                f"them partials {c['flash_attend_partials']}) K3 "
                f"{c['qmatmul']} plain {[c[k] for k in plain]}; held "
                f"{r['shapes']}; K1 at (R, Q, H, KH, S, D, cache, out, "
                f"bias) {ls.get('flash_attend', [])}; K2 at "
                f"{ls.get('flash_attend_append', [])}; K3 at (M, K, N, "
                f"qtype, compute, out) {ls.get('qmatmul', [])}; peak "
                f"{r['peak_bytes'] / 2**30:.2f} GiB; decode ms/step of the "
                f"one pass (cold, beside the other launches) "
                f"{r['decode_ms_per_step'][-1]:.3f}  [{card}]")
            rep.append(dict(rank=r["rank"], tokens_equal=eq, counts=c,
                            peak_gib=r["peak_bytes"] / 2**30,
                            decode_ms_cold=r["decode_ms_per_step"][-1],
                            **(held if name == "tp2" else {})))
            if not ok:
                raise AssertionError(f"14b: {name} rank {r['rank']} gates")
        log(f"  {name}: {secs:.1f} s; its times are two processes sharing "
            f"one card (and the other launches) through host-staged gloo "
            f"collectives, not a speed of {name[:2].upper()}")
        report[name] = rep
        by_path[name] = {k: sum(r["counts"][k] for r in ranks)
                         for k in ranks[0]["counts"]}
        def named(*names):
            return [[r for r in rank if r["name"] in names]
                    for rank in launched]

        if name in POOL_CONFIGS:
            pool = pool_gates(name, named("pool-off", "pool-on"), card)
            report[f"{name}-prefix"] = pool
            by_path[f"{name}-prefix"] = pool["counts"]
            shapes[f"{name}-prefix"] = pool.pop("shapes")
        if name == "tp2":
            strat = strategy_gates(card, named("tp2-strategy", "tp2-auto"),
                                   strat_ref, strat_one)
            for key in ("tp2-strategy", "tp2-auto"):
                by_path[key] = strat[key].pop("counts")
                shapes[key] = strat[key].pop("shapes")
            report["strategy"] = strat
    report["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 14b: {report['seconds']:.1f} s  [{card}]")
    return by_path, report, shapes


def _sum_counts(ranks):
    return {k: sum(r["counts"][k] for r in ranks) for k in ranks[0]["counts"]}


def _union_shapes(ranks):
    out = {}
    for r in ranks:
        for kernel, sh in r["launch_shapes"].items():
            out.setdefault(kernel, set()).update(tuple(x) for x in sh)
    return out


def pool_gates(name, ranks, card):
    """14b-prefix on one config's ranks (each [pool off, pool on]): equal
    tokens, hit tokens above 0 and equal on every rank (counted once:
    one rank's), K1 launched for the suffixes, no plain call. Returns the
    report with the pool-on pass's counts and shapes."""
    t = time.perf_counter()
    on = [r[1] for r in ranks]
    hits = {r["prefix_hit_tokens"][0] for r in on}
    for off_r, on_r in ranks:
        c = on_r["counts"]
        eq = sum(a == b for a, b in zip(on_r["tokens"], off_r["tokens"]))
        log(f"  14b-prefix {name} rank {on_r['rank']}: pool on vs off "
            f"{eq}/{len(on_r['tokens'])} equal; hit tokens "
            f"{on_r['prefix_hit_tokens'][0]} (off "
            f"{off_r['prefix_hit_tokens'][0]}); launches K1 "
            f"{c['flash_attend']} K2 {c['flash_attend_append']} K3 "
            f"{c['qmatmul']} plain {c['plain_attend_cuda']}/"
            f"{c['qmatmul_plain_cuda']}; K1 at "
            f"{on_r['launch_shapes'].get('flash_attend', [])}  [{card}]")
        if (eq != len(on_r["tokens"]) or not c["flash_attend"]
                or off_r["prefix_hit_tokens"][0]
                or c["plain_attend_cuda"] or c["qmatmul_plain_cuda"]):
            raise AssertionError(f"14b-prefix: {name} rank {on_r['rank']} "
                                 f"gates")
    if len(hits) != 1 or not min(hits):
        raise AssertionError(f"14b-prefix: {name} hit tokens {hits}")
    return dict(hit_tokens=hits.pop(), counts=_sum_counts(on),
                shapes=_union_shapes(on), seconds=time.perf_counter() - t)


def assigned_strategy(layers):
    """14b-strategy's assigned Strategy: lm_head's int8 kernel in row
    shards (off the Linear's own column split) with its logits split over
    the vocabulary, every down_proj in row shards, and layer 0's
    attention ``wo`` whole at rest (the op re-splits it to its own
    layout before its forward)."""
    from flexflow_tpu_torch.search.strategy import OpStrategy, Strategy

    def op(output, **weights):
        return OpStrategy(input_specs=(), output_spec=output,
                          weight_specs=weights, name="assigned")

    ops = {"lm_head": op((None, None, "model"), kernel=("model", None)),
           "layers.0.self_attn": op((None, None, None), wo=(None, None))}
    for i in range(layers):
        ops[f"layers.{i}.mlp.down_proj"] = op((None, None, None),
                                              kernel=("model", None))
    return Strategy(ops=ops)


def split_report(r, one_out, card, what):
    """Print a tp rank's ``serve`` result's layer-output bytes after the
    prefill against one rank's (``one_out``), the count and bytes of its
    collectives over ``model`` in the prefill and in a decode step, and
    its peak; returns them."""
    from flexflow_tpu_torch.parallel.rank_jobs import axis_bytes

    pre, dec = r["prefill"], r["decode"]
    out = dict(layer_output_bytes=pre["layer_output_bytes"],
               layer_output_share=pre["layer_output_bytes"] / one_out,
               model_calls_prefill=axis_bytes(pre["calls"], "model"),
               model_bytes_prefill=axis_bytes(pre["moved"], "model"),
               model_calls_decode=axis_bytes(dec["calls"], "model"),
               model_bytes_decode=axis_bytes(dec["moved"], "model"),
               calls_prefill=pre["calls"], moved_prefill=pre["moved"],
               prefill_tokens=pre["tokens"])
    log(f"  {what} rank {r['rank']}: layer outputs held after the prefill "
        f"{out['layer_output_bytes']} B = {out['layer_output_share']:.4f} "
        f"of 1 rank's {one_out} B; collectives over model: prefill "
        f"{pre['tokens']} {out['model_calls_prefill']} calls "
        f"{out['model_bytes_prefill']} B ({pre['calls']}, {pre['moved']}), "
        f"decode step {dec['tokens']} {out['model_calls_decode']} calls "
        f"{out['model_bytes_decode']} B; peak {r['peak_bytes'] / 2**30:.3f} "
        f"GiB  [{card}]")
    return out


def strategy_reference(torch, card, model, cfg, prompts, device):
    """14b-strategy's reference: 14b's geometry at all ``LAYERS`` layers
    on one rank in this process. Returns (its model, its tokens, {its
    ``weight_bytes``, the ``layer_output_bytes`` it held after the
    prefill, its ``peak_bytes`` above what the process held before})."""
    from flexflow_tpu_torch.ffconst import InferenceMode
    from flexflow_tpu_torch.parallel import rank_jobs
    from flexflow_tpu_torch.quant import quantized_nbytes

    t = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    full = dict(model, num_hidden_layers=LAYERS)
    one = dict(name="one", model=full, config=cfg, prompts=prompts,
               max_new=STRAT_NEW)
    m = rank_jobs._build(one, full, None, InferenceMode.INC_DECODING_MODE,
                         torch.device(device))
    probe = rank_jobs.forward_probe(m)
    ref, _ = rank_jobs._generate(m, None, one)
    held = dict(weight_bytes=quantized_nbytes(m.params),
                layer_output_bytes=probe["prefill"]["layer_output_bytes"],
                peak_bytes=(torch.cuda.max_memory_allocated() - base
                            if on_card else 0))
    del m
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  14b-strategy: 1 rank in process, {LAYERS} layers: weights "
        f"{held['weight_bytes'] / 2**30:.3f} GiB, layer outputs after the "
        f"prefill {held['layer_output_bytes']} B, peak "
        f"{held['peak_bytes'] / 2**30:.3f} GiB, "
        f"{time.perf_counter() - t:.1f} s  [{card}]")
    return full, ref, held


def strategy_runs(full, cfg, prompts):
    """14b-strategy's two runs for the tp=2 ranks: ``assigned_strategy``,
    then ``auto_parallel`` (the port's search on the H100 model, analytic
    costs)."""
    auto = dict(cfg, auto_parallel=True, search_chip=SEARCH_CHIP,
                search_profile=False, **SEARCH_KW)
    return [dict(name="tp2-strategy", model=full, config=cfg,
                 strategy=assigned_strategy(LAYERS).to_json(),
                 prompts=prompts, max_new=STRAT_NEW),
            dict(name="tp2-auto", model=full, config=auto, prompts=prompts,
                 max_new=STRAT_NEW)]


def strategy_gates(card, ranks_runs, ref, one):
    """14b-strategy's gates on the tp=2 ranks' two runs (``ranks_runs``:
    each rank's [assigned, auto]): tokens 8/8 equal to one rank's on both
    ranks, K1/K2/K3 launched, no plain call; each rank's weight bytes,
    layer-output bytes and peak against one rank's (``one``, from
    ``strategy_reference``), and its ``model`` collectives
    (``split_report``)."""
    one_bytes, one_out = one["weight_bytes"], one["layer_output_bytes"]
    report = {"one_rank_weight_bytes": one_bytes,
              "one_rank_layer_output_bytes": one_out,
              "one_rank_peak_gib": one["peak_bytes"] / 2**30}
    plain = ("plain_attend_cuda", "qmatmul_plain_cuda")
    for i in range(len(ranks_runs[0])):
        ranks = [runs[i] for runs in ranks_runs]
        name = ranks[0]["name"]
        moved = sorted(json.loads(ranks[0]["strategy"])["ops"])
        held = []
        for r in ranks:
            eq = sum(a == b for a, b in zip(r["tokens"], ref))
            c = r["counts"]
            ls = r["launch_shapes"]
            log(f"  14b-strategy {name} rank {r['rank']}: tokens "
                f"{eq}/{REQUESTS} equal to 1 rank; weights "
                f"{r['weight_bytes'] / 2**30:.3f} GiB against 1 rank's "
                f"{one_bytes / 2**30:.3f} GiB; strategy over {len(moved)} "
                f"layers; launches K1 {c['flash_attend']} K2 "
                f"{c['flash_attend_append']} K3 {c['qmatmul']} plain "
                f"{[c[k] for k in plain]}; K3 at (M, K, N, qtype, compute, "
                f"out) {ls.get('qmatmul', [])}; K1 at "
                f"{ls.get('flash_attend', [])}; K2 at "
                f"{ls.get('flash_attend_append', [])}; generate "
                f"{r['seconds'][-1]:.1f} s  [{card}]")
            held.append(dict(split_report(r, one_out, card,
                                          f"14b-strategy {name}"),
                             peak_gib=r["peak_bytes"] / 2**30))
            log(f"  14b-strategy {name} rank {r['rank']}: peak "
                f"{r['peak_bytes'] / 2**30:.3f} GiB against 1 rank's "
                f"{one['peak_bytes'] / 2**30:.3f} GiB in this process  "
                f"[{card}]")
            if (eq != REQUESTS or not c["qmatmul"] or not c["flash_attend"]
                    or not c["flash_attend_append"]
                    or any(c[k] for k in plain)):
                raise AssertionError(f"14b-strategy: {name} rank "
                                     f"{r['rank']} gates")
        report[name] = dict(
            layers_in_strategy=len(moved),
            weight_bytes=[r["weight_bytes"] for r in ranks], held=held,
            counts=_sum_counts(ranks), shapes=_union_shapes(ranks))
    return report


def _attention_inputs(torch, shape, g, S=None):
    """Card tensors for one recorded K1/K2 launch shape (R, Q, H, KH, S,
    D, cache dtype, out dtype | "partials", bias) over a cache of ``S``
    rows (default: the shape's): q, k, v, lengths in [Q, S], causal qpos
    ending at each row's length (or, with a bias, a random 0 / NEG_INF
    tree mask with column 0 visible), and the new K/V at lengths - 1."""
    from flexflow_tpu_torch.kernels.attention import NEG_INF

    R, Q, H, KH, S0, D, cdt, _odt, bias = shape
    S = S or S0
    dt = getattr(torch, cdt)
    dev = "cuda"

    def r(*sh):
        return torch.randn(sh, generator=g, device=dev).to(dt)

    lengths = torch.randint(Q, S + 1, (R,), generator=g, device=dev,
                            dtype=torch.int32)
    qpos = (lengths[:, None] - Q + torch.arange(Q, device=dev,
                                                dtype=torch.int32)[None])
    b = None
    if bias:
        b = torch.where(torch.rand((R, Q, S), generator=g, device=dev) < 0.7,
                        0.0, NEG_INF)
        b[..., 0] = 0.0
    return dict(q=r(R, Q, H, D), k=r(R, KH, S, D), v=r(R, KH, S, D),
                lengths=lengths, qpos=qpos, bias=b, kn=r(R, 1, KH, D),
                vn=r(R, 1, KH, D), appos=lengths - 1)


def shard_shape_checks(torch, card, shapes_by_run):
    """Each kernel at every shape phase 14's runs launched it at
    (``kernels.record_shapes``: each rank of each 14b config, the 14a
    offload-on pass) and 13f's scripts on the card, on random card
    tensors, against its plain version.
    K1 and K2 at TOL of the coarser of the cache and output dtypes; their
    partials mode (sequence parallelism) on a cache of twice the rank's
    rows split in halves at their offsets, as two ranks hold it, each
    half's partials from the kernel and the two combined
    (``combine_partials``), against the plain version on the whole cache,
    with the halves' appends equal to the plain append; K3 at K3_TOL.
    Returns {run: number of shapes checked}."""
    from flexflow_tpu_torch.kernels.attention import (
        append_at, combine_partials, flash_attend, flash_attend_partials,
        reference_attend)
    from flexflow_tpu_torch.kernels.qmatmul import qmatmul_plain
    from flexflow_tpu_torch.quant import qmatmul, quantize_array

    g = torch.Generator(device="cuda").manual_seed(140)
    rank = {"float32": 0, "float16": 1, "bfloat16": 2}
    done = {}
    for run, by_kernel in shapes_by_run.items():
        n = 0
        worst = {}
        for kernel, shapes in sorted(by_kernel.items()):
            for shape in shapes:
                if kernel == "qmatmul":
                    M, K, N, qt, cd, od = shape
                    w = torch.empty((K, N), device="cuda").normal_(
                        0, 0.02, generator=g)
                    leaf = quantize_array(w, qt)
                    x = torch.randn((M, K), generator=g,
                                    device="cuda").to(getattr(torch, cd))
                    y = qmatmul(x, leaf, getattr(torch, cd),
                                getattr(torch, od))
                    ref = qmatmul_plain(x, leaf, getattr(torch, cd),
                                        getattr(torch, od))
                    err = float((y.float() - ref.float()).abs().max()) / max(
                        float(ref.float().abs().max()), 1e-30)
                    ratio = err / K3_TOL[od]
                    del w, leaf, x, y, ref
                else:
                    R, Q, H, KH, S, D, cdt, odt, _b = shape
                    part = odt == "partials"
                    a = _attention_inputs(torch, shape, g,
                                          S=2 * S if part else None)
                    app = kernel == "flash_attend_append"
                    kw = dict(bias=a["bias"], causal=a["bias"] is None)
                    k0, v0 = a["k"].clone(), a["v"].clone()
                    if app:
                        append_at(k0, v0, a["kn"], a["vn"], a["appos"])
                    ref = reference_attend(a["q"], k0, v0, a["lengths"],
                                           a["qpos"], **kw)
                    if part:
                        pos, pml = [], []
                        for off in (0, S):
                            kh = a["k"][:, :, off:off + S].clone()
                            vh = a["v"][:, :, off:off + S].clone()
                            loc = a["appos"] - off
                            loc = torch.where((loc >= 0) & (loc < S), loc,
                                              torch.full_like(loc, -1))
                            b = (None if a["bias"] is None
                                 else a["bias"][..., off:off + S].contiguous())
                            po, pm = flash_attend_partials(
                                a["q"], kh, vh,
                                (a["lengths"] - off).clamp(0, S),
                                a["qpos"] - off, bias=b,
                                causal=kw["causal"],
                                append_kv=((a["kn"], a["vn"], loc) if app
                                           else None))
                            if not (torch.equal(kh, k0[:, :, off:off + S])
                                    and torch.equal(vh,
                                                    v0[:, :, off:off + S])):
                                raise AssertionError(
                                    f"14: {run} {kernel} partials append")
                            pos.append(po)
                            pml.append(pm)
                        out = combine_partials(torch.cat(pos),
                                               torch.cat(pml), a["q"].dtype)
                        tdt = cdt
                    else:
                        odt_ = getattr(torch, odt)
                        k1, v1 = a["k"].clone(), a["v"].clone()
                        out = flash_attend(
                            a["q"], k1, v1, a["lengths"], a["qpos"],
                            append_kv=((a["kn"], a["vn"], a["appos"]) if app
                                       else None), out_dtype=odt_, **kw)
                        out = out[0] if app else out
                        ref = ref.to(odt_)
                        tdt = max(cdt, odt, key=rank.__getitem__)
                    tol = TOL[tdt]
                    rf = ref.float()
                    ratio = float(((out.float() - rf).abs()
                                   / (tol + tol * rf.abs())).max())
                    if not bool(torch.isfinite(out.float()).all()):
                        ratio = float("inf")
                    del a, k0, v0, ref, out
                worst[kernel] = max(worst.get(kernel, 0.0), ratio)
                n += 1
                if ratio > 1.0:
                    log(f"  14 shape check {run} {kernel} {shape}: err / tol "
                        f"{ratio:.3f} FAIL")
                    raise AssertionError(f"14: {run} {kernel} {shape} "
                                         "against plain")
        log(f"  {run}: {n} launch shapes against the plain versions, worst "
            f"err / tol by kernel {dict((k, round(v, 4)) for k, v in worst.items())}"
            f"  PASS  [{card}]")
        done[run] = n
    torch.cuda.empty_cache()
    return done


def partials_row(torch, shape, launches):
    """The kernels line's row of K1/K2's partials mode: K2 (the decode
    append) at the sp2 rank's decode shape, timed beside its plain
    version; the bound counts the partials written in fp32. No PyTorch
    call returns a softmax's unnormalised output and row max and sum:
    library_ms is null."""
    from flexflow_tpu_torch.kernels.attention import (
        append_at, combine_partials, flash_attend_partials,
        partials_reference, split_plan)

    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(141)
    R, Q, H, KH, S, D, cdt, _o, _b = shape
    a = _attention_inputs(torch, shape, g)
    isz = a["q"].element_size()
    ap = (a["kn"], a["vn"], a["appos"])
    po, pm = flash_attend_partials(a["q"], a["k"], a["v"], a["lengths"],
                                   a["qpos"], append_kv=ap)

    def plain():
        append_at(a["k"], a["v"], *ap)
        return partials_reference(a["q"], a["k"], a["v"], a["lengths"],
                                  a["qpos"])

    ro, rm = plain()
    out = combine_partials(po, pm, a["q"].dtype)
    ref = combine_partials(ro, rm, a["q"].dtype)
    err = float((out - ref).abs().max())
    ms = timer(lambda: flash_attend_partials(
        a["q"], a["k"], a["v"], a["lengths"], a["qpos"], append_kv=ap))
    pl = timer(plain)
    n_split = split_plan(R, KH, S, torch.cuda.get_device_properties(
        0).multi_processor_count)[0]
    part_bytes = 4 * n_split * R * Q * H * (D + 2)
    b, by, nb = attention_bound_ms(
        torch, a["q"], a["lengths"], a["qpos"], S, KH, True,
        getattr(torch, cdt),
        extra_bytes=4 * a["kn"].numel() * isz + part_bytes
        - a["q"].numel() * isz)
    # the timer around a PyTorch sum over the bound's bytes
    buf = torch.ones(nb // 2, dtype=torch.bfloat16, device="cuda")
    floor = timer(lambda: buf.sum())
    del timer, buf
    log(f"  partials row {shape}: kernel {ms:.4f} ms | bound {b:.4f} ms "
        f"({by}) | plain {pl:.4f} ms | sum over the same bytes {floor:.4f} "
        f"ms | max_abs_err {err:.3e}")
    return dict(name="flash_attend_partials", route="cuda",
                source=F32_SOURCE if cdt == "float32" else K1_SOURCE,
                replaces=K2_REPLACES, max_abs_err=err, ms=ms, plain_ms=pl,
                bound_ms=b, bound_by=by, library_ms=None, launches=launches,
                read_floor_ms=floor, shape=list(shape))


def seven_b_keys(hf):
    from flexflow_tpu_torch.models.llama import LLAMAConfig, hf_weight_map

    return hf_weight_map(LLAMAConfig.from_hf_config(hf))


# ----------------------------------------------------------------------
# phase 15: parallel and resumable training
# ----------------------------------------------------------------------
PAR_STEPS = 3            # 15a-15c: steps a run (ResNet's cut: 2)
PAR_BOUND = 1e-5         # relative: a parallel run's losses vs one rank's
TP2_PEAK_SHARE = 0.65    # 15b bert_tp2: a rank's peak over one rank's (the
                         # activations split over model; 0.80 kept whole)
MOE_CPU_BOUND = 1e-4     # relative: 15c card vs CPU (phase 11a's bound)
LARGE_BATCH = 64         # 15a and 15d: BERT-large, bf16 (32 a rank at dp=2)
RESUME_STEPS = 4         # 15e: 2 steps, save, restore, 2 more
PAR_TIMEOUT = 900.0
# examples/python/native/moe.py: 64 wide, 4 experts, top-2, its default
# batch (FFConfig's 64), 10 classes
MOE_WIDTH, MOE_EXPERTS, MOE_TOP, MOE_CLASSES, MOE_BATCH = 64, 4, 2, 10, 64


def moe_build(ff, config):
    """``examples/python/native/moe.py``'s classifier (the ``moe``
    composite) through a package's builders."""
    m = ff.FFModel(config)
    t = m.create_tensor([config.batch_size, MOE_WIDTH], ff.DataType.DT_FLOAT)
    x = m.dense(t, MOE_WIDTH, ff.ActiMode.AC_MODE_RELU)
    x = m.moe(x, num_exp=MOE_EXPERTS, num_select=MOE_TOP,
              expert_hidden_size=MOE_WIDTH)
    m.softmax(m.dense(x, MOE_CLASSES))
    return m


def _rel(a, b) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def _dir_bytes(d) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _d, fs in os.walk(d) for f in fs)


def parallel_training_phase(torch, card, work, device="cuda"):
    """Phase 15: the training path under a mesh, through
    ``parallel/launch.run_ranks`` and the ``train`` job of
    ``parallel/rank_jobs.py`` (stores, logs and checkpoints under
    ``work``). One launch of 2 ranks sharing the card (gloo, staged
    through pinned host buffers) runs every parallel case; one launch of
    1 rank (NCCL world of 1, ``CUBLAS_WORKSPACE_CONFIG`` set) runs the
    references, remat and resume, beside it; the tp=2 checkpoint is
    restored at tp=1 in this process after both. No kernel of K1-K3 lies
    on this path. Returns the report; a failed gate raises."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from flexflow_tpu_torch.parallel import rank_jobs
    from flexflow_tpu_torch.parallel.launch import run_ranks

    t_phase = time.perf_counter()
    me = os.path.abspath(__file__)
    job = "flexflow_tpu_torch.parallel.rank_jobs:train"
    rng = np.random.default_rng(31)

    def save(name, x, y):
        path = os.path.join(work, f"{name}.npz")
        np.savez(path, x0=x, y=y)
        return path

    bx, by = cut_data("bert")
    bert_data = save("bert", bx, by)
    bx4 = rng.integers(0, BERT_VOCAB, (RESUME_STEPS, CUT_BATCH, BERT_SEQ),
                       dtype=np.int32)
    by4 = rng.integers(0, BERT_VOCAB, (RESUME_STEPS, CUT_BATCH * BERT_SEQ,
                                       1), dtype=np.int32)
    resume_data = save("resume", bx4, by4)
    resnet_data = save("resnet", *cut_data("resnet"))
    large_data = save("large", rng.integers(
        0, BERT_VOCAB, (PAR_STEPS, LARGE_BATCH, BERT_SEQ), dtype=np.int32),
        rng.integers(0, BERT_VOCAB, (PAR_STEPS, LARGE_BATCH * BERT_SEQ, 1),
                     dtype=np.int32))
    moe_x = rng.standard_normal((PAR_STEPS, MOE_BATCH, MOE_WIDTH),
                                dtype=np.float32)
    moe_w = rng.standard_normal((MOE_WIDTH, MOE_CLASSES))
    moe_data = save("moe", moe_x, np.argmax(moe_x @ moe_w, axis=-1)[
        ..., None].astype(np.int32))

    sgd = ["sgd", {"lr": TRAIN_LR}]

    def bert(name, layers=CUT_LAYERS, batch=CUT_BATCH, dtype="float32",
             data=bert_data, deg=None, **kw):
        return dict(name=name, builder=f"{me}:bert_build",
                    builder_kw={"layers": layers}, optimizer=sgd,
                    data=data, config=dict(batch_size=batch, seed=7,
                                           compute_dtype=dtype,
                                           **(deg or {})), **kw)

    resnet_kw = {"img": CUT_IMG, "classes": CUT_CLASSES,
                 "stages": [list(s) for s in RESNET_STAGES[:1]]}

    def resnet(name, **deg):
        return dict(name=name, builder=f"{me}:resnet_build",
                    builder_kw=resnet_kw, optimizer=sgd, data=resnet_data,
                    config=dict(batch_size=CUT_BATCH, seed=7, **deg))

    experts_kw = {"d": MOE_WIDTH, "n": MOE_EXPERTS, "k": MOE_TOP,
                  "classes": MOE_CLASSES}

    def experts(name, **deg):
        return dict(name=name, builder=os.path.join(
            HERE, "tests", "torch_rank_jobs.py:experts_net"),
            builder_kw=experts_kw, optimizer=["adam", {"alpha": TRAIN_LR}],
            data=moe_data, config=dict(batch_size=MOE_BATCH, seed=7, **deg))

    tp2_ckpt = os.path.join(work, "ckpt_tp2")
    two = [bert("bert_dp2", deg=dict(data_parallelism_degree=2)),
           resnet("resnet_dp2", data_parallelism_degree=2),
           bert("bert_tp2", deg=dict(tensor_parallelism_degree=2),
                save={"dir": tp2_ckpt, "step": PAR_STEPS},
                out=os.path.join(work, "tp2.npz")),
           bert("bert_sp2", deg=dict(sequence_parallelism_degree=2)),
           experts("experts_ep2", expert_parallelism_degree=2),
           bert("large_dp2", layers=BERT_LAYERS, batch=LARGE_BATCH,
                dtype="bfloat16", data=large_data,
                deg=dict(data_parallelism_degree=2))]
    det = dict(deterministic=True)
    part_ckpt = os.path.join(work, "ckpt_resume")
    one = [bert("bert_ref"), resnet("resnet_ref"), experts("experts_ref")]
    one += [bert(f"large_remat{int(remat)}", layers=BERT_LAYERS,
                 batch=LARGE_BATCH, dtype="bfloat16", data=large_data,
                 deg=dict(remat=remat), **det) for remat in (False, True)]
    one += [bert("straight", data=resume_data, steps=RESUME_STEPS,
                 out=os.path.join(work, "straight.npz"), **det),
            bert("part", data=resume_data, steps=RESUME_STEPS // 2,
                 save={"dir": part_ckpt, "step": RESUME_STEPS // 2}, **det),
            bert("resumed", data=resume_data, restore=part_ckpt,
                 first_step=RESUME_STEPS // 2, steps=RESUME_STEPS // 2,
                 out=os.path.join(work, "resumed.npz"), **det)]

    def timed(fn, *args, **kw):
        t = time.perf_counter()
        return fn(*args, **kw), time.perf_counter() - t

    # the two launches run side by side on the card (a rank's peak is its
    # own process's; their step times are taken beside each other)
    with ThreadPoolExecutor(2) as pool:
        f2 = pool.submit(timed, run_ranks, job, 2, {
            "device": device, "tf32": False, "runs": two},
            workdir=os.path.join(work, "w2"), timeout=PAR_TIMEOUT,
            device=device, backend="gloo")
        f1 = pool.submit(timed, run_ranks, job, 1, {
            "device": device, "tf32": False, "runs": one},
            workdir=os.path.join(work, "w1"), timeout=PAR_TIMEOUT,
            device=device, backend="nccl" if device == "cuda" else "gloo",
            env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))
        res2, s2 = f2.result()
        (res1,), s1 = f1.result()
    # the tp=2 run's checkpoint, restored at tp=1 here once it is written
    res1.append(rank_jobs.train({"device": device, "runs": [
        bert("tp2_at_tp1", restore=tp2_ckpt, steps=0,
             out=os.path.join(work, "tp2_at_tp1.npz"))]})[0])
    log(f"  launches side by side: 2 ranks {s2:.1f} s ({len(two)} runs), "
        f"1 rank {s1:.1f} s ({len(one)} runs)  [{card}]")
    by2 = {r["name"]: [rank[i] for rank in res2] for i, r in enumerate(two)}
    by1 = {r["name"]: r for r in res1}
    bad, report = [], {}

    def parity(sub, name, ref, what):
        ranks = by2[name]
        rel = _rel(ranks[0]["losses"], by1[ref]["losses"])
        same = all(r["losses"] == ranks[0]["losses"] for r in ranks)
        peaks = [round(r["peak_bytes"] / 2**30, 3) for r in ranks]
        ref_peak = by1[ref]["peak_bytes"]
        shares = [r["peak_bytes"] / ref_peak if ref_peak else float("nan")
                  for r in ranks]
        log(f"  {sub} {what}: losses {[f'{v:.7f}' for v in ranks[0]['losses']]}"
            f" vs one rank {[f'{v:.7f}' for v in by1[ref]['losses']]}, "
            f"largest relative difference {rel:.2e} (bound {PAR_BOUND}); "
            f"every rank the same numbers: {same}; peak a rank {peaks} GiB "
            f"(one rank {ref_peak / 2**30:.3f}; shares "
            f"{[round(v, 4) for v in shares]}); all-reduced "
            f"{ranks[0]['allreduce_bytes']} B a step  [{card}]")
        report[name] = dict(loss_rel=rel, peak_gib=peaks,
                            ref_peak_gib=ref_peak / 2**30,
                            peak_share=shares,
                            allreduce_bytes=ranks[0]["allreduce_bytes"])
        if not (rel <= PAR_BOUND and same):
            bad.append(f"{sub} {name}")
        return shares

    log(f"phase 15a: data parallel, 2 ranks sharing the card  [{card}]")
    parity("15a", "bert_dp2", "bert_ref",
           f"BERT cut ({CUT_LAYERS} layers, full width, batch {CUT_BATCH}, "
           f"fp32) dp=2")
    parity("15a", "resnet_dp2", "resnet_ref",
           f"ResNet-50 11a cut (batch {CUT_BATCH}, {CUT_IMG}x{CUT_IMG}, "
           "global BatchNorm statistics) dp=2")
    large = by2["large_dp2"]
    for r in large:
        log(f"  15a BERT-large ({BERT_LAYERS} layers, bf16, batch "
            f"{LARGE_BATCH}, {LARGE_BATCH // 2} a rank) dp=2 rank "
            f"{r['rank']}: step ms (beside the 1-rank launch) "
            f"{[round(v, 1) for v in r['step_ms']]}, "
            f"losses {[round(v, 5) for v in r['losses']]}, peak "
            f"{r['peak_bytes'] / 2**30:.2f} GiB, gradients all-reduced "
            f"{r['allreduce_bytes'] / 2**30:.3f} GiB a step  [{card}]")
    log("  15a: two ranks on one card through host-staged gloo are not a "
        "speed of data parallelism (each step stages every gradient "
        "through host memory)")
    report["large_dp2"] = dict(
        step_ms=large[0]["step_ms"], losses=large[0]["losses"],
        peak_gib=[r["peak_bytes"] / 2**30 for r in large],
        allreduce_bytes=large[0]["allreduce_bytes"])
    if not (all(np.isfinite(r["losses"]).all() for r in large)
            and large[0]["losses"] == large[1]["losses"]):
        bad.append("15a BERT-large dp=2")

    log(f"phase 15b: tensor and sequence parallel, 2 ranks  [{card}]")
    shares = parity("15b", "bert_tp2", "bert_ref",
                    f"BERT cut tp=2 ({BERT_HEADS // 2} heads a rank, every "
                    "activation split over model on its features)")
    log(f"  15b bert_tp2: peak a rank {max(shares):.4f} of one rank's "
        f"(gate <= {TP2_PEAK_SHARE})  [{card}]")
    if device == "cuda" and not max(shares) <= TP2_PEAK_SHARE:
        bad.append("15b bert_tp2 peak share")
    parity("15b", "bert_sp2", "bert_ref",
           f"BERT cut sp=2 ({BERT_SEQ // 2} positions a rank, the ring)")

    log(f"phase 15c: MoE, examples/python/native/moe.py's classifier "
        f"({MOE_WIDTH} wide, {MOE_EXPERTS} experts, top-{MOE_TOP}, batch "
        f"{MOE_BATCH})  [{card}]")
    moe_run = dict(name="moe", builder=f"{me}:moe_build",
                   optimizer=["adam", {"alpha": TRAIN_LR}], data=moe_data,
                   config=dict(batch_size=MOE_BATCH, seed=7),
                   weights=os.path.join(work, "moe_init.pt"))
    # one start: the CPU model's seeded init (a card generator draws
    # other values from the same seed)
    init = rank_jobs.build_trainer(moe_run, torch.device("cpu"))
    torch.save({ln: {w: p.detach() for w, p in lp.items()}
                for ln, lp in init.params.items()}, moe_run["weights"])
    del init
    with tf32_off(torch):
        on_card = rank_jobs.train({"device": device, "runs": [moe_run]})[0]
    on_cpu = rank_jobs.train({"device": "cpu", "runs": [moe_run]})[0]
    rel = _rel(on_card["losses"], on_cpu["losses"])
    log(f"  15c moe composite: losses card "
        f"{[f'{v:.7f}' for v in on_card['losses']]} CPU "
        f"{[f'{v:.7f}' for v in on_cpu['losses']]}, largest relative "
        f"difference {rel:.2e} (bound {MOE_CPU_BOUND})  [{card}]")
    report["moe_card_vs_cpu"] = dict(loss_rel=rel)
    if not rel <= MOE_CPU_BOUND:
        bad.append("15c moe card vs CPU")
    parity("15c", "experts_ep2", "experts_ref",
           f"an EXPERTS layer ({MOE_EXPERTS} experts, {MOE_EXPERTS // 2} a "
           "rank) expert=2 vs expert=1")

    log(f"phase 15d: remat, BERT-large ({BERT_LAYERS} layers, bf16, batch "
        f"{LARGE_BATCH}), one run off then one on, deterministic "
        f"algorithms  [{card}]")
    remat = [by1[f"large_remat{int(on)}"] for on in (False, True)]
    for r in remat:
        log(f"  15d {r['name']}: losses {[f'{v:.6f}' for v in r['losses']]}"
            f", step ms (one unpaired run beside the 2-rank launch: not an "
            f"off/on comparison) "
            f"{[round(v, 1) for v in r['step_ms']]}, peak "
            f"{r['peak_bytes'] / 2**30:.2f} GiB  [{card}]")
    equal = all(r["losses"] == remat[0]["losses"] for r in remat)
    log(f"  15d: remat on == off losses: {equal}")
    report["remat"] = {r["name"]: dict(step_ms=r["step_ms"],
                                       peak_gib=r["peak_bytes"] / 2**30)
                       for r in remat}
    if not equal:
        bad.append("15d remat losses")

    log(f"phase 15e: resume, BERT cut, {RESUME_STEPS} steps straight vs "
        f"{RESUME_STEPS // 2}, save, restore into a fresh model, "
        f"{RESUME_STEPS // 2} more, deterministic algorithms  [{card}]")
    straight, resumed = by1["straight"], by1["resumed"]
    got = by1["part"]["losses"] + resumed["losses"]
    pa = dict(np.load(os.path.join(work, "straight.npz")))
    pb = dict(np.load(os.path.join(work, "resumed.npz")))
    params_eq = pa.keys() == pb.keys() and all(
        np.array_equal(pa[k], pb[k]) for k in pa)
    ckpt_b = _dir_bytes(part_ckpt)
    log(f"  15e: losses straight {[f'{v:.7f}' for v in straight['losses']]}"
        f" resumed {[f'{v:.7f}' for v in got]}, equal "
        f"{got == straight['losses']}; parameters equal {params_eq}; "
        f"checkpoint {ckpt_b / 2**20:.1f} MiB, save "
        f"{by1['part']['save_seconds']:.2f} s, restore "
        f"{resumed['restore_seconds']:.2f} s  [{card}]")
    tp2 = dict(np.load(os.path.join(work, "tp2.npz")))
    at1 = dict(np.load(os.path.join(work, "tp2_at_tp1.npz")))
    tp_eq = tp2.keys() == at1.keys() and all(
        np.array_equal(tp2[k], at1[k]) for k in tp2)
    log(f"  15e: the tp=2 run's checkpoint ({_dir_bytes(tp2_ckpt) / 2**20:.1f}"
        f" MiB, saved in {by2['bert_tp2'][0]['save_seconds']:.2f} s) "
        f"restored at tp=1 in {by1['tp2_at_tp1']['restore_seconds']:.2f} s:"
        f" parameters equal to the ranks' gathered ones {tp_eq}  [{card}]")
    report["resume"] = dict(
        equal=got == straight["losses"], params_equal=params_eq,
        ckpt_bytes=ckpt_b, save_s=by1["part"]["save_seconds"],
        restore_s=resumed["restore_seconds"], tp2_at_tp1=tp_eq)
    if not (got == straight["losses"] and params_eq and tp_eq):
        bad.append("15e resume")
    report["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 15: {report['seconds']:.1f} s  [{card}]")
    if bad:
        raise AssertionError(f"phase 15: {'; '.join(bad)}")
    return report


# ----------------------------------------------------------------------
# phase 16: the model frontends (torch.fx, ONNX, Keras, the C graph
# builder) and the dot export
# ----------------------------------------------------------------------
RESNET50_PARAMS = 25_557_032   # torchvision's ResNet-50; resnet_build's
FRONT_BATCH = 8          # 16a: ResNet-50 forwards, fp32, TF32 off
FRONT_TOL = 1e-4         # 16a, 16c, 16d: of the reference's largest value
FRONT_PAIRS = 3          # 16b: alternating (direct, fx) training blocks
ENC_LAYERS, ENC_BATCH, ENC_CLASSES = 2, 8, 2   # 16c: BERT-large widths
GB_STEPS = 3             # 16d: train steps, card and CPU


def resnet50_module(torch):
    """torchvision's ResNet-50 topology in plain ``torch.nn`` (the card's
    machine has no torchvision): a 7x7/2 stem, a 3x3/2 max pool,
    Bottleneck blocks (a projection shortcut where the shape changes),
    global average pool and ``Linear(2048, 1000)``; torchvision's
    initialization (Kaiming-normal convolutions, BatchNorm at 1 and 0).
    ``out + identity`` stays out of place: an in-place add traces as
    ``operator.iadd``, which the fx frontend does not translate."""
    nn = torch.nn

    class Bottleneck(nn.Module):
        def __init__(self, c_in, c_mid, stride):
            super().__init__()
            c_out = 4 * c_mid
            self.conv1 = nn.Conv2d(c_in, c_mid, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(c_mid)
            self.conv2 = nn.Conv2d(c_mid, c_mid, 3, stride, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(c_mid)
            self.conv3 = nn.Conv2d(c_mid, c_out, 1, bias=False)
            self.bn3 = nn.BatchNorm2d(c_out)
            self.relu = nn.ReLU(inplace=True)
            self.downsample = None
            if stride != 1 or c_in != c_out:
                self.downsample = nn.Sequential(
                    nn.Conv2d(c_in, c_out, 1, stride, bias=False),
                    nn.BatchNorm2d(c_out))

        def forward(self, x):
            out = self.relu(self.bn1(self.conv1(x)))
            out = self.relu(self.bn2(self.conv2(out)))
            out = self.bn3(self.conv3(out))
            identity = x if self.downsample is None else self.downsample(x)
            return self.relu(out + identity)

    class ResNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
            self.bn1 = nn.BatchNorm2d(64)
            self.relu = nn.ReLU(inplace=True)
            self.maxpool = nn.MaxPool2d(3, 2, 1)
            c_in = 64
            for i, (c_mid, blocks, stride) in enumerate(RESNET_STAGES):
                seq = []
                for b in range(blocks):
                    seq.append(Bottleneck(c_in, c_mid, stride if b == 0
                                          else 1))
                    c_in = 4 * c_mid
                setattr(self, f"layer{i + 1}", nn.Sequential(*seq))
            self.avgpool = nn.AdaptiveAvgPool2d((1, 1))
            self.fc = nn.Linear(c_in, 1000)
            for mod in self.modules():
                if isinstance(mod, nn.Conv2d):
                    nn.init.kaiming_normal_(mod.weight, mode="fan_out",
                                            nonlinearity="relu")

        def forward(self, x):
            x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
            for i in range(len(RESNET_STAGES)):
                x = getattr(self, f"layer{i + 1}")(x)
            return self.fc(torch.flatten(self.avgpool(x), 1))

    return ResNet()


def resnet_blocks(module):
    """(name, Bottleneck) of ``resnet50_module``'s blocks, in order."""
    out, i = [], 1
    while hasattr(module, f"layer{i}"):
        out += [(f"layer{i}.{b}", blk)
                for b, blk in enumerate(getattr(module, f"layer{i}"))]
        i += 1
    return out


def resnet_onnx_bytes(module, batch, img):
    """``module`` as an ONNX model through the port's encoder: Conv (no
    bias), BatchNormalization (its four initializers; the frontend keeps
    its own scale and bias, as the JAX package's), Relu, the padded
    MaxPool, Add, GlobalAveragePool, Flatten and a ``transB`` Gemm."""
    from flexflow_tpu_torch.onnx import proto as P

    nodes, init = [], {}

    def arr(t):
        return t.detach().float().cpu().numpy()

    def conv(x, mod, name):
        init[name + ".weight"] = arr(mod.weight)
        nodes.append(P.encode_node(
            "Conv", [x, name + ".weight"], [name], name=name,
            kernel_shape=list(mod.kernel_size), strides=list(mod.stride),
            pads=[mod.padding[0], mod.padding[1]] * 2, group=mod.groups))
        return name

    def bn(x, mod, name):
        keys = []
        for k, t in (("scale", mod.weight), ("bias", mod.bias),
                     ("mean", mod.running_mean), ("var", mod.running_var)):
            init[f"{name}.{k}"] = arr(t)
            keys.append(f"{name}.{k}")
        nodes.append(P.encode_node("BatchNormalization", [x] + keys, [name],
                                   name=name, epsilon=float(mod.eps),
                                   momentum=float(1 - mod.momentum)))
        return name

    def op(kind, ins, name, **attrs):
        nodes.append(P.encode_node(kind, ins, [name], name=name, **attrs))
        return name

    x = op("Relu", [bn(conv("x", module.conv1, "conv1"), module.bn1, "bn1")],
           "relu")
    x = op("MaxPool", [x], "maxpool", kernel_shape=[3, 3], strides=[2, 2],
           pads=[1, 1, 1, 1])
    for p, blk in resnet_blocks(module):
        h = op("Relu", [bn(conv(x, blk.conv1, p + ".conv1"), blk.bn1,
                           p + ".bn1")], p + ".relu1")
        h = op("Relu", [bn(conv(h, blk.conv2, p + ".conv2"), blk.bn2,
                           p + ".bn2")], p + ".relu2")
        h = bn(conv(h, blk.conv3, p + ".conv3"), blk.bn3, p + ".bn3")
        sc = x if blk.downsample is None else bn(
            conv(x, blk.downsample[0], p + ".downsample.0"),
            blk.downsample[1], p + ".downsample.1")
        x = op("Relu", [op("Add", [h, sc], p + ".add")], p + ".relu3")
    x = op("Flatten", [op("GlobalAveragePool", [x], "avgpool")], "flatten")
    init["fc.weight"], init["fc.bias"] = arr(module.fc.weight), \
        arr(module.fc.bias)
    op("Gemm", [x, "fc.weight", "fc.bias"], "fc", transB=1)
    return P.encode_model(
        nodes, inputs=[P.encode_value_info("x", [batch, 3, img, img])],
        outputs=[P.encode_value_info("fc", [batch,
                                            module.fc.out_features])],
        initializers=init)


def resnet_keras(module, config, img):
    """``module`` as a functional Keras ``Model`` of the port, compiled on
    ``config``; each convolution's and the head's weights set from the
    module through ``Layer.set_weights`` (BatchNorm stays at its own 1
    and 0, as the module's)."""
    from flexflow_tpu_torch import keras

    L = keras.layers
    weights = []

    def conv(x, mod):
        layer = L.Conv2D(mod.out_channels, mod.kernel_size,
                         strides=mod.stride, padding=mod.padding,
                         use_bias=False)
        weights.append((layer, [mod.weight]))
        return layer(x)

    def bn(x, relu):
        x = L.BatchNormalization()(x)
        return L.Activation("relu")(x) if relu else x

    inp = L.Input(shape=(3, img, img))
    x = bn(conv(inp, module.conv1), True)
    x = L.MaxPooling2D(pool_size=3, strides=2, padding=(1, 1))(x)
    for _p, blk in resnet_blocks(module):
        h = bn(conv(x, blk.conv1), True)
        h = bn(conv(h, blk.conv2), True)
        h = bn(conv(h, blk.conv3), False)
        sc = x if blk.downsample is None else bn(
            conv(x, blk.downsample[0]), False)
        x = L.Activation("relu")(L.Add()([h, sc]))
    x = L.Flatten()(L.AveragePooling2D(pool_size=x.shape[2])(x))
    head = L.Dense(module.fc.out_features)
    weights.append((head, [module.fc.weight.T, module.fc.bias]))
    model = keras.models.Model(inputs=inp, outputs=head(x), ffconfig=config)
    model.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
    for layer, ws in weights:
        layer.set_weights([w.detach() for w in ws])
    return model


def train_mode_output(torch, m, x):
    """The FFModel's final output for ``x`` in training mode (BatchNorm on
    the batch's statistics, as the module in ``train()``): the forward of
    a train step, through the graph walk ``train_one_batch`` runs; the
    running statistics it computes are dropped."""
    with torch.no_grad():
        values, _ = m._run_graph(m.params, m._feeds_from_arrays([x]),
                                 m._ctx(True), m.op_state)
    return values[m._final_tensor.tensor_id]


def n_params(m) -> int:
    return sum(p.numel() for lp in m.params.values() for p in lp.values())


def max_rel(got, want) -> float:
    """Largest |got - want| over the largest |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def fx_model(pm, config, shape, softmax=False):
    """A module's ``PyTorchModel`` (traced once, in the main thread: fx
    tracing patches torch globally) onto an FFModel on ``config``; a
    softmax after the last layer for training."""
    import flexflow_tpu_torch as ff

    m = ff.FFModel(config)
    dt = ff.DataType.DT_INT32 if len(shape) == 2 else ff.DataType.DT_FLOAT
    (out,) = pm.torch_to_ff(m, [m.create_tensor(shape, dt)])
    if softmax:
        m.softmax(out)
    return m


def resnet_by_frontends(torch, card):
    """16a: ResNet-50 through fx, ONNX and Keras on the card; each model's
    parameter count and its training-mode logits against the module's.
    Returns (the fx model, the module's PyTorchModel, the report)."""
    import flexflow_tpu_torch as ff
    from flexflow_tpu_torch.onnx import ONNXModel
    from flexflow_tpu_torch.torch import PyTorchModel

    torch.manual_seed(16)
    module = resnet50_module(torch).to("cuda").train()
    pm = PyTorchModel(module)
    gen = torch.Generator(device="cuda").manual_seed(16)
    x = torch.randn(FRONT_BATCH, 3, RESNET_IMG, RESNET_IMG, generator=gen,
                    device="cuda")
    shape = [FRONT_BATCH, 3, RESNET_IMG, RESNET_IMG]

    def config():
        return ff.FFConfig(batch_size=FRONT_BATCH, device="cuda")

    report, models = {}, {}
    with tf32_off(torch):
        with torch.no_grad():
            want = module(x)
        t0 = time.perf_counter()
        m = fx_model(pm, config(), shape)
        m.compile()
        pm.copy_weights(m)
        models["fx"] = (m, time.perf_counter() - t0)
        t0 = time.perf_counter()
        blob = resnet_onnx_bytes(module, FRONT_BATCH, RESNET_IMG)
        m = ff.FFModel(config())
        om = ONNXModel(blob)
        om.apply(m, {"x": m.create_tensor(shape, ff.DataType.DT_FLOAT)})
        m.compile()
        om.import_initializers(m)
        models["onnx"] = (m, time.perf_counter() - t0)
        t0 = time.perf_counter()
        k = resnet_keras(module, config(), RESNET_IMG)
        models["keras"] = (k.ffmodel, time.perf_counter() - t0)
        for name, (m, secs) in models.items():
            got = train_mode_output(torch, m, x)
            report[name] = {"params": n_params(m), "layers": len(m.layers),
                            "rel_err": max_rel(got, want),
                            "build_s": secs}
            log(f"  16a {name}: {len(m.layers)} layers, "
                f"{report[name]['params']:,} parameters (want "
                f"{RESNET50_PARAMS:,}), training-mode logits [{FRONT_BATCH}"
                f", {got.shape[-1]}] against the module's: largest "
                f"difference {report[name]['rel_err']:.3e} of the largest "
                f"logit (limit {FRONT_TOL}); built in {secs:.1f} s"
                + (f" ({len(blob) / 2**20:.1f} MiB of ONNX)"
                   if name == "onnx" else "") + f"  [{card}]")
    bad = [f"{n}: {r}" for n, r in report.items()
           if r["params"] != RESNET50_PARAMS
           or not r["rel_err"] <= FRONT_TOL]
    if bad:
        raise AssertionError(f"phase 16a: {'; '.join(bad)}")
    return models["fx"][0], pm, report


def fx_training_pairs(torch, card, pm):
    """16b: the fx-built ResNet-50 and phase 11's direct-builder model at
    bench_train.py's size in bf16, trained in alternating blocks of
    RESNET_UNROLL steps in one process; step ms, MFU and peak memory of
    each (a finding: the frontend adds no launch, so no gate on speed);
    the losses finite."""
    import numpy as np

    import flexflow_tpu_torch as ff

    gc.collect()
    torch.cuda.empty_cache()
    direct, flops = resnet_model("cuda", "bfloat16", RESNET_BATCH,
                                 RESNET_IMG, 1000, RESNET_STAGES)
    fx = fx_model(pm, ff.FFConfig(batch_size=RESNET_BATCH,
                                      compute_dtype="bfloat16",
                                      device="cuda"),
                  [RESNET_BATCH, 3, RESNET_IMG, RESNET_IMG], softmax=True)
    models = {"direct": train_compile(direct, "sgd"),
              "fx": train_compile(fx, "sgd")}
    pm.copy_weights(fx)
    gen = torch.Generator(device="cuda").manual_seed(23)
    x = torch.randn(RESNET_BATCH, 3, RESNET_IMG, RESNET_IMG, generator=gen,
                    device="cuda")
    y = torch.randint(0, 1000, (RESNET_BATCH, 1), generator=gen,
                      device="cuda", dtype=torch.int32)
    for m in models.values():
        m.train_one_batch([x], y)              # warm: cuDNN's choices
    xs = [x.expand(RESNET_UNROLL, *x.shape)]
    ys = y.expand(RESNET_UNROLL, *y.shape)
    runs = {n: {"step_ms": [], "peak_gib": [], "losses": []} for n in models}
    for p in range(FRONT_PAIRS):
        for name in (("direct", "fx") if p % 2 == 0 else ("fx", "direct")):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            losses = models[name].train_batches(xs, ys)   # one read
            runs[name]["step_ms"].append(
                (time.perf_counter() - t0) * 1e3 / RESNET_UNROLL)
            runs[name]["peak_gib"].append(
                torch.cuda.max_memory_allocated() / 2**30)
            runs[name]["losses"].append(losses)
    report = {}
    for name, r in runs.items():
        med = statistics.median(r["step_ms"])
        report[name] = dict(step_ms=r["step_ms"], step_ms_median=med,
                            mfu=flops / (med / 1e3) / H100_BF16_PEAK,
                            peak_gib=max(r["peak_gib"]),
                            layers=len(models[name].layers),
                            losses=r["losses"])
        log(f"  16b {name}: {len(models[name].layers)} layers; step ms "
            f"{[round(v, 2) for v in r['step_ms']]} (median {med:.2f}) "
            f"over {FRONT_PAIRS} blocks of {RESNET_UNROLL}; MFU "
            f"{report[name]['mfu']:.4f} of {H100_BF16_PEAK / 1e12:.0f} "
            f"TFLOP/s ({flops / 1e12:.3f} model TFLOP a step); peak "
            f"{report[name]['peak_gib']:.2f} GiB (both models resident); "
            f"losses {[[round(v, 4) for v in b] for b in r['losses']]}  "
            f"[{card}]")
    del models, direct, fx
    gc.collect()
    torch.cuda.empty_cache()
    if not all(np.isfinite(v) for r in runs.values() for b in r["losses"]
               for v in b):
        raise AssertionError(f"phase 16b: a loss is not finite: {runs}")
    return report


def bert_encoder_module(torch, layers=ENC_LAYERS):
    """A BERT encoder at BERT-large widths in plain ``torch.nn``: token
    embedding, ``layers`` post-LN layers (``nn.MultiheadAttention(
    batch_first=True)``, LayerNorm, a GELU MLP of 4 x hidden), BERT's
    pooler (the first token through Linear and tanh) and a classifier."""
    nn = torch.nn

    class Layer(nn.Module):
        def __init__(self):
            super().__init__()
            self.mha = nn.MultiheadAttention(BERT_HIDDEN, BERT_HEADS,
                                             batch_first=True)
            self.ln1 = nn.LayerNorm(BERT_HIDDEN)
            self.fc1 = nn.Linear(BERT_HIDDEN, 4 * BERT_HIDDEN)
            self.act = nn.GELU()
            self.fc2 = nn.Linear(4 * BERT_HIDDEN, BERT_HIDDEN)
            self.ln2 = nn.LayerNorm(BERT_HIDDEN)

        def forward(self, x):
            a, _ = self.mha(x, x, x)
            x = self.ln1(x + a)
            return self.ln2(x + self.fc2(self.act(self.fc1(x))))

    class Encoder(nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(BERT_VOCAB, BERT_HIDDEN)
            self.layers = nn.ModuleList(Layer() for _ in range(layers))
            self.pooler = nn.Linear(BERT_HIDDEN, BERT_HIDDEN)
            self.classifier = nn.Linear(BERT_HIDDEN, ENC_CLASSES)

        def forward(self, ids):
            x = self.emb(ids)
            for layer in self.layers:
                x = layer(x)
            return self.classifier(torch.tanh(self.pooler(x[:, 0])))

    return Encoder()


def fit_losses(m, x, y):
    return [h["loss"] for h in m.fit(x, y, epochs=1)]


def native_block(gb):
    """``tests/test_native.py``'s C transformer block at BERT-large widths:
    embedding, MHA, residual LayerNorm, a GELU MLP, residual RMSNorm, a
    scalar, a mean over the sequence and a 4-way head."""
    toks = gb.input(0)
    h = gb.embedding(toks, BERT_VOCAB, BERT_HIDDEN, name="embed")
    a = gb.multihead_attention(h, h, h, BERT_HIDDEN, BERT_HEADS, name="attn")
    h = gb.layer_norm(gb.binary(h, a, "add"), [BERT_HIDDEN], name="ln1")
    f = gb.unary(gb.dense(h, 4 * BERT_HIDDEN, name="up"), "gelu")
    h = gb.rms_norm(gb.binary(h, gb.dense(f, BERT_HIDDEN, name="down"),
                              "add"), eps=1e-6, name="rn")
    h = gb.mean(gb.scalar(h, "multiply", 0.5, name="halve"), [1],
                name="pool")
    gb.output([gb.softmax(gb.dense(h, 4, name="head"))])
    return gb


def native_model(device):
    """(the FFModel the C builder's graph builds on ``device``, its IR
    text), compiled for SGD training."""
    import flexflow_tpu_torch as ff
    from flexflow_tpu_torch.native.graph_builder import NativeGraphBuilder

    gb = native_block(NativeGraphBuilder())
    m = ff.FFModel(ff.FFConfig(batch_size=ENC_BATCH, device=device))
    gb.build_on(m, [m.create_tensor([ENC_BATCH, BERT_SEQ],
                                    ff.DataType.DT_INT32)])
    return train_compile(m, "sgd"), gb.serialize()


def encoder_and_native(torch, card):
    """16c: the BERT-large-width encoder through fx: its fp32 forward
    against the module's on the card, and a fit of 2 steps on the card
    against the CPU's from the same weights. 16d: the C graph builder's
    block on the card and on the CPU: the IR text and layers equal, and
    GB_STEPS train steps' losses."""
    from concurrent.futures import ThreadPoolExecutor

    import flexflow_tpu_torch as ff
    from flexflow_tpu_torch.convert import load_params
    from flexflow_tpu_torch.torch import PyTorchModel

    torch.manual_seed(17)
    module = bert_encoder_module(torch).to("cuda").eval()
    pm = PyTorchModel(module)
    pm.to_ir()
    gen = torch.Generator().manual_seed(17)
    ids = torch.randint(0, BERT_VOCAB, (2 * ENC_BATCH, BERT_SEQ),
                        generator=gen, dtype=torch.int32)
    labels = torch.randint(0, ENC_CLASSES, (2 * ENC_BATCH, 1),
                           generator=gen, dtype=torch.int32)
    gb_ids = torch.randint(0, BERT_VOCAB, (GB_STEPS, ENC_BATCH, BERT_SEQ),
                           generator=gen, dtype=torch.int32)
    gb_labels = torch.randint(0, 4, (GB_STEPS, ENC_BATCH, 1), generator=gen,
                              dtype=torch.int32)
    shape = [ENC_BATCH, BERT_SEQ]

    def trained(device):
        m = fx_model(pm, ff.FFConfig(batch_size=ENC_BATCH, device=device),
                     shape, softmax=True)
        train_compile(m, "sgd")
        pm.copy_weights(m)
        return m

    def timed(fn, *a):
        t0 = time.perf_counter()
        return fn(*a), time.perf_counter() - t0

    def native_steps(m):
        return [m.train_one_batch([gb_ids[i]], gb_labels[i])
                for i in range(GB_STEPS)]

    report = {}
    # every model is built here; the worker thread only trains the CPU
    # ones (phase 11a's pattern)
    enc_cpu = trained("cpu")
    gm_cpu, ir_cpu = native_model("cpu")
    init = {ln: {w: p.detach().clone() for w, p in lp.items()}
            for ln, lp in gm_cpu.params.items()}
    with ThreadPoolExecutor(1) as pool, tf32_off(torch):
        enc_ref = pool.submit(timed, fit_losses, enc_cpu, ids, labels)
        gb_ref = pool.submit(timed, native_steps, gm_cpu)
        t0 = time.perf_counter()
        m = fx_model(pm, ff.FFConfig(batch_size=ENC_BATCH, device="cuda"),
                     shape)
        m.compile()
        pm.copy_weights(m)
        got = torch.as_tensor(m.predict(ids[:ENC_BATCH]))
        with torch.no_grad():
            want = module(ids[:ENC_BATCH].long().to("cuda")).cpu()
        fwd = max_rel(got, want)
        card_l = fit_losses(trained("cuda"), ids, labels)
        card_s = time.perf_counter() - t0
        ref_l, ref_s = enc_ref.result()
        rel = _rel(card_l, ref_l)
        report["16c"] = {"params": n_params(m), "forward_rel_err": fwd,
                         "fit_loss_card": card_l, "fit_loss_cpu": ref_l,
                         "loss_rel": rel}
        log(f"  16c encoder ({ENC_LAYERS} layers x {BERT_HIDDEN}, "
            f"{BERT_HEADS} heads, FFN {4 * BERT_HIDDEN}, vocab "
            f"{BERT_VOCAB}, batch {ENC_BATCH} x seq {BERT_SEQ}, fp32) "
            f"through fx: {len(m.layers)} layers, {n_params(m):,} "
            f"parameters; forward against the module's: largest difference "
            f"{fwd:.3e} of the largest logit; fit, 2 SGD steps: card loss "
            f"{card_l} CPU {ref_l}, relative difference {rel:.2e} (limit "
            f"{FRONT_TOL}); card {card_s:.1f} s, CPU {ref_s:.1f} s  "
            f"[{card}]")
        del m, enc_cpu
        t0 = time.perf_counter()
        gm, ir = native_model("cuda")
        load_params(gm, init)
        card_l = native_steps(gm)
        card_s = time.perf_counter() - t0
        ref_l, ref_s = gb_ref.result()
    rel = _rel(card_l, ref_l)
    same_layers = ([(l.name, l.op_type, l.outputs[0].dims)
                    for l in gm.layers]
                   == [(l.name, l.op_type, l.outputs[0].dims)
                       for l in gm_cpu.layers])
    report["16d"] = {"params": n_params(gm), "losses_card": card_l,
                     "losses_cpu": ref_l, "loss_rel": rel,
                     "ir_equal": ir == ir_cpu, "layers_equal": same_layers}
    log(f"  16d the C graph builder's block at BERT-large widths (batch "
        f"{ENC_BATCH} x seq {BERT_SEQ}): {len(ir.splitlines())} IR records, "
        f"IR text equal to the CPU model's: {ir == ir_cpu}, layers equal: "
        f"{same_layers}; {n_params(gm):,} parameters; {GB_STEPS} SGD steps: "
        f"card losses {card_l} CPU {ref_l}, relative difference {rel:.2e} "
        f"(limit {FRONT_TOL}); card {card_s:.1f} s, CPU {ref_s:.1f} s  "
        f"[{card}]")
    bad = [k for k, r in report.items()
           if not r.get("forward_rel_err", 0.0) <= FRONT_TOL
           or not r["loss_rel"] <= FRONT_TOL
           or not r.get("ir_equal", True) or not r.get("layers_equal", True)]
    del gm, gm_cpu
    gc.collect()
    if bad:
        raise AssertionError(f"phase 16 {bad}: {report}")
    return report


def dot_export(fx_resnet, card):
    """16e: ``export_dot`` of 16a's fx model: one node a layer, one an
    input, an edge from each input's producer."""
    import re
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = fx_resnet.export_dot(os.path.join(tmp, "resnet50.dot"))
        text = open(path).read()
    nodes = len(re.findall(r"\[label=", text))
    edges = text.count('" -> "')
    want = len(fx_resnet.layers) + len(fx_resnet.input_tensors)
    log(f"  16e export_dot of 16a's fx ResNet-50: {nodes} nodes ("
        f"{len(fx_resnet.layers)} layers + {len(fx_resnet.input_tensors)} "
        f"input), {edges} edges, {len(text)} bytes  [{card}]")
    if nodes != want or not edges >= len(fx_resnet.layers):
        raise AssertionError(f"phase 16e: {nodes} nodes, {edges} edges; "
                             f"want {want} nodes")
    return {"nodes": nodes, "edges": edges}


def frontends_phase(torch, card):
    """Phase 16: 16a-16e; K1-K3 and their plain versions launch no time.
    Returns (the phase's launch counts, the report)."""
    from flexflow_tpu_torch import kernels

    t_phase = time.perf_counter()
    kernels.reset_counts()
    report = {}
    fx_resnet, pm, report["16a"] = resnet_by_frontends(torch, card)
    log(f"  16a: {time.perf_counter() - t_phase:.1f} s")
    report["16b"] = fx_training_pairs(torch, card, pm)
    del pm
    report.update(encoder_and_native(torch, card))
    report["16e"] = dot_export(fx_resnet, card)
    counts = dict(kernels.counts)
    del fx_resnet
    gc.collect()
    torch.cuda.empty_cache()
    report["launches"] = counts
    report["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 16 launches: {counts}")
    log(f"  phase 16: {report['seconds']:.1f} s  [{card}]")
    if any(counts.values()):
        raise AssertionError(f"phase 16: K1-K3 or a plain version "
                             f"launched: {counts}")
    return counts, report


# ----------------------------------------------------------------------
# phase 18: the engines' compiled programs
# ----------------------------------------------------------------------
PROGRAM_PAIRS = 2        # 18: alternating (eager, program) timed pairs
PROGRAM_STEPS = 8        # 18: steps of a timed decode block
PROGRAM_ROUNDS = 6       # 18: rounds of a timed speculation block
PROGRAM_NEW = 8          # 18: new tokens of a profiled generate
PROGRAM_CHUNK = 64       # 18: prefill width (256 tokens a batch // 4 rows)
PROGRAM_OFFLOAD_LAYERS = 4          # 18: the offloaded model's depth
PROGRAM_OFFLOAD_RESERVE = 1 << 30   # 18: its ring (the paged bytes: 2.1 GB)


def cache_restorer(models):
    """A function that puts every KV-cache tensor of ``models`` back to
    what it holds now."""
    saved = {id(t): (t, t.clone()) for m in models
             for st in m.op_state.values() if isinstance(st, dict)
             for t in st.values()}

    def restore():
        for t, c in saved.values():
            t.copy_(c)
    return restore


def prefill_pending(models, prompts):
    """Each prompt but its last token prefilled into every model's cache
    (one step a model); returns (tok, pos, active) of the pending
    tokens."""
    import numpy as np

    from flexflow_tpu_torch.serve.batch_config import make_batch_meta
    from flexflow_tpu_torch.serve.request_manager import RequestManager

    R, L = len(prompts), len(prompts[0])
    meta = make_batch_meta(
        R, L - 1, tokens=np.array([p[:-1] for p in prompts], np.int32),
        positions=np.tile(np.arange(L - 1, dtype=np.int32), (R, 1)),
        start_pos=np.zeros(R, np.int32),
        num_tokens=np.full(R, L - 1, np.int32), active=np.ones(R, bool))
    for m in models:
        RequestManager._ifm(m).step(meta, want_output=False)
    return (np.array([p[-1] for p in prompts], np.int32),
            np.full(R, L - 1, np.int32), np.ones(R, bool))


def eager_vs_program(torch, card, what, run, restore, unit, after=None,
                     need=("flash_attend", "flash_attend_append")):
    """``run()`` -> (arrays, units of work) from the cache state that
    ``restore`` sets: once through the engine's eager body
    (``graphs.eager_bodies``), once through its program (the first
    program run builds it), then ``PROGRAM_PAIRS`` timed (eager,
    program) pairs. ``after()``, outside the timed region, gives more
    arrays to compare (KV-cache bytes). Gates: every array bit-equal,
    launch counts equal, one of the ``need`` kernels launched, no plain
    call. Returns the report."""
    import numpy as np

    from flexflow_tpu_torch import kernels
    from flexflow_tpu_torch.serve import graphs

    def once(eager):
        restore()
        kernels.reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with graphs.eager_bodies() if eager else contextlib.nullcontext():
            out, n = run()
        torch.cuda.synchronize()
        s = time.perf_counter() - t
        if after is not None:
            out = list(out) + list(after())
        return out, n, s, dict(kernels.counts)

    ref, n_ref, _, eager_counts = once(True)
    out, n, build_s, counts = once(False)
    ms = {"eager": [], "program": []}
    same = []
    for _ in range(PROGRAM_PAIRS):
        for mode in ms:
            o, k, s, _c = once(mode == "eager")
            same.append(k == n_ref and all(np.array_equal(a, b)
                                           for a, b in zip(o, ref)))
            ms[mode].append(s * 1e3 / k)
    equal = n == n_ref and all(np.array_equal(a, b) for a, b in zip(out, ref))
    log(f"  {what}: eager == program {equal} (and in every timed pass: "
        f"{all(same)}); launches {counts}; first program run (build + "
        f"{n} {unit}s) {build_s:.3f} s  [{card}]")
    log(f"    ms/{unit} eager {', '.join(f'{x:.3f}' for x in ms['eager'])}"
        f"; program {', '.join(f'{x:.3f}' for x in ms['program'])}; "
        f"eager/program {statistics.mean(ms['eager']) / statistics.mean(ms['program']):.2f}x  [{card}]")
    if not (equal and all(same)):
        raise AssertionError(f"{what}: the program's result differs from "
                             f"its eager body's")
    if counts != eager_counts or (need and not any(counts[k]
                                                   for k in need)):
        raise AssertionError(f"{what}: launches {counts} != eager "
                             f"{eager_counts}")
    if counts["plain_attend_cuda"] or counts["qmatmul_plain_cuda"]:
        raise AssertionError(f"{what}: a plain version ran on the card")
    return dict(equal=equal, counts=counts, units=n, build_s=build_s,
                eager_ms=ms["eager"], program_ms=ms["program"])


def program_pool_bytes(ifm):
    """(step programs', decode program's) graph-pool bytes of a manager:
    the device memory its captured programs hold beside the model's
    weights and caches."""
    from flexflow_tpu_torch.serve.graphs import pool_bytes

    steps = pool_bytes(ifm.graph_pool) if ifm.graph_pool is not None else 0
    dec = 0
    if ifm._decode_block is not None:
        dec = sum(pool_bytes(p.pool) for p in
                  ifm._decode_block.program._cache.programs.values()
                  if p.pool is not None)
    return steps, dec


def program_pools(torch, card, m):
    """Prints and returns ``m``'s program pools in GiB beside the bytes of
    its parameters and caches on the card."""
    from flexflow_tpu_torch.serve.request_manager import RequestManager

    steps, dec = program_pool_bytes(RequestManager._ifm(m))
    out = dict(step_pool_gib=steps / 2**30, decode_pool_gib=dec / 2**30,
               model_gib=_device_bytes(m) / 2**30)
    log(f"  graph pools: step programs {out['step_pool_gib']:.3f} GiB, "
        f"decode program {out['decode_pool_gib']:.3f} GiB; the model's "
        f"parameters and caches {out['model_gib']:.2f} GiB  [{card}]")
    return out


def kv_bytes(torch, models, cols):
    """A function giving the first ``cols`` columns of every KV cache of
    ``models`` as int16 arrays (every byte compared)."""
    def read():
        out = []
        for m in models:
            for st in m.op_state.values():
                if isinstance(st, dict):
                    for t in st.values():
                        out.append(t[..., :cols, :].contiguous()
                                   .view(torch.int16).cpu().numpy())
        return out
    return read


def prefill_row(torch, m):
    """(run, ) of one [REQUESTS, PROGRAM_CHUNK] prefill step on ``m``: every
    row a full chunk of seeded tokens from position 0, its token ids
    returned."""
    import numpy as np

    from flexflow_tpu_torch.serve.batch_config import BatchMeta
    from flexflow_tpu_torch.serve.request_manager import RequestManager

    rng = np.random.default_rng(18)
    R, Q = REQUESTS, PROGRAM_CHUNK
    meta = BatchMeta(
        tokens=rng.integers(0, VOCAB, (R, Q)).astype(np.int32),
        positions=np.tile(np.arange(Q, dtype=np.int32), (R, 1)),
        start_pos=np.zeros(R, np.int32), num_tokens=np.full(R, Q, np.int32),
        active=np.ones(R, bool))
    ifm = RequestManager._ifm(m)

    def run():
        return (ifm.step(meta),), 1
    return (run,)


def step_program_rows(torch, card, sm, beams, restore, pending):
    """Phase 18's serving steps against their eager bodies: the 7B [8, 64]
    prefill (tokens and every KV byte it wrote), one host tree round with
    two beam drafts and its commit, the cramped width-1 step, and the
    decode block of an offloaded model (7B widths, ``PROGRAM_OFFLOAD_
    LAYERS`` layers, its weights paged through a ring of
    ``PROGRAM_OFFLOAD_RESERVE`` bytes)."""
    import dataclasses as dc

    import numpy as np

    from flexflow_tpu_torch import DataType, FFModel
    from flexflow_tpu_torch.ffconst import InferenceMode
    from flexflow_tpu_torch.models.llama import (LLAMAConfig,
                                                 create_llama_model)
    from flexflow_tpu_torch.serve import graphs
    from flexflow_tpu_torch.serve.request_manager import (Request,
                                                          RequestManager)

    verifier, prompts = sm.verifier, sm.prompts
    tok, pos, act = pending
    ifm = RequestManager._ifm(verifier)
    R, L = REQUESTS, PROMPT_LEN
    report = {}
    report["prefill"] = eager_vs_program(
        torch, card, f"prefill step [{R}, {PROGRAM_CHUNK}], bf16",
        *prefill_row(torch, verifier), restore, "step",
        after=kv_bytes(torch, [verifier], PROGRAM_CHUNK))
    if not report["prefill"]["counts"]["flash_attend"]:
        raise AssertionError("the prefill launched no K1")
    # where the prefill program's time goes: its kernels, one replay
    run_prefill = prefill_row(torch, verifier)[0]
    report["prefill_busy"] = profile_window(
        torch, run_prefill, f"one [{R}, {PROGRAM_CHUNK}] prefill program",
        card, top=8, host_ops=False)

    rm = RequestManager()           # one commit program across the runs

    def host_round():
        rm.spec_stats = dict.fromkeys(("rounds", "request_rounds",
                                       "committed", "parked"), 0)
        live = [Request(guid=i, prompt_tokens=list(p), max_new_tokens=64,
                        slot=i, cache_depth=L - 1,
                        ssm_cache_depth={0: L - 1, 1: L - 1})
                for i, p in enumerate(prompts)]
        chains = []
        for j, b in enumerate(beams):
            chains += rm._draft_beams(RequestManager._ifm(b), j, live, R,
                                      BEAM_DEPTH, BEAM_WIDTH)
        trees = {r.slot: rm._merge_tree(r, chains, MAX_SEQ) for r in live}
        rm._verify_and_commit(verifier, ifm, live, trees, R,
                              1 + BEAM_DEPTH * len(beams) * BEAM_WIDTH,
                              MAX_SEQ)
        return [np.array(r.tokens) for r in live], 1

    cols = L + 1 + BEAM_DEPTH * len(beams) * BEAM_WIDTH
    report["host_round"] = eager_vs_program(
        torch, card, f"host tree round, two beam drafts (width "
        f"{BEAM_WIDTH}, depth {BEAM_DEPTH}), with its commit", host_round,
        restore, "round", after=kv_bytes(torch, [verifier, *beams], cols),
        need=("flash_attend_bias",))
    # the round commits where an accepted path is not the first chain;
    # the commit program alone, on paths that always move KV
    # (the host path's src_node width: one key with the round's commit)
    src = torch.zeros((R, rm.max_spec_depth + 1), dtype=torch.int32,
                      device="cuda")
    src[:, :BEAM_DEPTH] = torch.arange(BEAM_DEPTH) * 2 + 1
    ncommit = torch.tensor([BEAM_DEPTH - i % 2 for i in range(R)],
                           dtype=torch.int32, device="cuda")
    start = torch.full((R,), L, dtype=torch.int32, device="cuda")
    live_rows = torch.ones(R, dtype=torch.bool, device="cuda")

    def commit():
        verifier.op_state = rm._commit(verifier.op_state, src, ncommit,
                                       start, live_rows)
        return [], 1

    report["commit"] = eager_vs_program(
        torch, card, "the host tree path's commit", commit, restore,
        "commit", after=kv_bytes(torch, [verifier], L + 2 * BEAM_DEPTH + 1),
        need=())
    commits = rm._commit._cache.programs.values()
    log(f"  the commit: {rm._commit.builds} program(s) built (one key), "
        f"captured: {all(p.graphs for p in commits)}")
    if rm._commit.builds != 1 or not all(p.graphs for p in commits):
        raise AssertionError("the commit program was not built once and "
                             "captured")

    def cramped():
        rows = [(i, [int(tok[i])], int(pos[i])) for i in range(R)]
        return (ifm.step(RequestManager._meta_from_rows(R, 1, rows)),), 1

    report["cramped"] = eager_vs_program(
        torch, card, "cramped step, width 1", cramped, restore, "step",
        after=kv_bytes(torch, [verifier], L))
    steps = ifm._steps.programs
    if not steps or not all(p.graphs for p in steps.values()):
        raise AssertionError("a step program of the verifier was not "
                             "captured")
    log(f"  verifier: {ifm.step_builds} step programs built, every one "
        f"captured; keys (tree, R, width): "
        f"{sorted((k[0], k[1], k[2]) for k in steps)}")

    # an offloaded model's decode block: 7B widths, the verifier's first
    # layers' tensors paged to pinned host memory
    off = FFModel(dc.replace(verifier.config,
                             offload_reserve_space_size=PROGRAM_OFFLOAD_RESERVE))
    create_llama_model(off, LLAMAConfig.from_hf_config(
        dict(sm.hf, num_hidden_layers=PROGRAM_OFFLOAD_LAYERS)),
        mode=InferenceMode.TREE_VERIFY_MODE, data_type=DataType.DT_BFLOAT16)
    off.compile()
    share_params(off, verifier)
    moved = off.offload_weights()
    pf = off._prefetcher
    bound = max(pf.reserve, 2 * max(pf.sizes))
    log(f"  offloaded model: {PROGRAM_OFFLOAD_LAYERS} layers, "
        f"{moved / 2**30:.3f} GiB paged in {len(pf.order)} units (largest "
        f"{max(pf.sizes) / 2**20:.1f} MiB); ring {pf.ring_bytes / 2**30:.3f}"
        f" GiB (bound {bound / 2**30:.3f} GiB); captured: "
        f"{graphs.captures(off)}  [{card}]")
    if pf.ring_bytes > bound or not graphs.captures(off):
        raise AssertionError("offload: the ring passes its bound, or the "
                             "offloaded model does not capture")
    prefill_pending([off], prompts)
    off_ifm = RequestManager._ifm(off)

    def off_decode():
        return (off_ifm.decode_block(tok, pos, act, PROGRAM_STEPS),), \
            PROGRAM_STEPS

    report["offload_decode"] = eager_vs_program(
        torch, card, f"decode block, offloaded weights (ring "
        f"{pf.ring_bytes / 2**30:.3f} GiB)", off_decode,
        cache_restorer([off]), "step", after=kv_bytes(torch, [off], L + 8))
    report["offload_ring_gib"] = pf.ring_bytes / 2**30
    report["offload_pools"] = program_pools(torch, card, off)
    del off, off_ifm, pf
    gc.collect()
    torch.cuda.empty_cache()
    return report


def engine_programs_phase(torch, card, sm):
    """Phase 18: every engine's program against its eager body on phase
    6-7's models (LLaMA-2-7B geometry, bf16, 32 layers), then the
    decode program on the same verifier quantized to int8 (K3 inside the
    captures); one build per engine over an adaptive mixed batch; phase
    5's incremental generate profiled eager and program."""
    import dataclasses as dc

    import numpy as np

    from flexflow_tpu_torch import (DataType, FFModel, GenerationConfig,
                                    kernels)
    from flexflow_tpu_torch.ffconst import InferenceMode
    from flexflow_tpu_torch.models.llama import (LLAMAConfig,
                                                 create_llama_model)
    from flexflow_tpu_torch.serve import graphs
    from flexflow_tpu_torch.serve.engine import (BeamSpecEngine,
                                                 MultiSpecEngine,
                                                 SpecChainEngine)
    from flexflow_tpu_torch.serve.request_manager import RequestManager
    from flexflow_tpu_torch.telemetry import ServingTelemetry

    verifier, draft, prompts = sm.verifier, sm.ssm.ffmodel, sm.prompts
    t_part = [time.perf_counter()]
    seconds = {}

    def part(name):
        now = time.perf_counter()
        seconds[name] = round(now - t_part[0], 1)
        t_part[0] = now

    def model(layers, **cfg):
        m = FFModel(dc.replace(verifier.config, **cfg))
        create_llama_model(m, LLAMAConfig.from_hf_config(
            dict(sm.hf, num_hidden_layers=layers)),
            mode=InferenceMode.BEAM_SEARCH_MODE,
            data_type=DataType.DT_BFLOAT16)
        m.compile()
        share_params(m, verifier)
        return m

    draft3 = model(DRAFT_LAYERS + 1)
    beam = model(DRAFT_LAYERS, max_beam_width=BEAM_WIDTH)
    beam3 = model(DRAFT_LAYERS + 1, max_beam_width=BEAM_WIDTH)
    sampled = sampled_twin(verifier, GenerationConfig(
        do_sample=True, topp=0.6, temperature=0.8))
    models = [verifier, draft, draft3, beam, beam3]
    tok, pos, act = prefill_pending(models, prompts)
    restore = cache_restorer(models)
    report = {"seconds": seconds}
    ifm, ifm_s = RequestManager._ifm(verifier), RequestManager._ifm(sampled)
    part("models and prefill")

    def decode(m_ifm, seed=None):
        def run():
            if seed is not None:
                m_ifm.generator.manual_seed(seed)
            return (m_ifm.decode_block(tok, pos, act, PROGRAM_STEPS),), \
                PROGRAM_STEPS
        return run

    report["decode"] = eager_vs_program(
        torch, card, f"decode block, greedy, width {ifm.decode_width}",
        decode(ifm), restore, "step")
    report["decode_topp"] = eager_vs_program(
        torch, card, "decode block, top-p 0.6, temperature 0.8",
        decode(ifm_s, seed=11), restore, "step")
    part("decode blocks")
    # adaptive blocks: per-row first depths, the in-block rule on
    depth0 = np.array([SPEC_DEPTH, 3, 1, 5, SPEC_DEPTH, 2, 4, 6], np.int32)
    engines = {
        "chain": SpecChainEngine(verifier, draft, SPEC_DEPTH,
                                 max_rounds=PROGRAM_ROUNDS),
        "tree B=1": MultiSpecEngine(verifier, [draft], SPEC_DEPTH,
                                    max_rounds=PROGRAM_ROUNDS),
        "tree B=2": MultiSpecEngine(verifier, [draft, draft3], SPEC_DEPTH,
                                    max_rounds=PROGRAM_ROUNDS),
        "beam": BeamSpecEngine(verifier, beam, BEAM_DEPTH, BEAM_WIDTH,
                               max_rounds=PROGRAM_ROUNDS)}
    for name, eng in engines.items():
        def run(eng=eng):
            r0 = eng.rounds_run
            out = eng.run_block(tok, pos, act, PROGRAM_ROUNDS,
                                depth=depth0[:REQUESTS], min_depth=1)
            return out, eng.rounds_run - r0
        report[name] = eager_vs_program(
            torch, card, f"{type(eng).__name__} {name}, depth "
            f"{eng.depth}, tree width {eng.tree_width}", run, restore,
            "round")
        if eng._trace_count != 1 or (
                name != "chain"
                and not report[name]["counts"]["flash_attend_bias"]):
            raise AssertionError(f"{name}: {eng._trace_count} builds, "
                                 f"launches {report[name]['counts']}")

    part("spec engines")
    report.update(step_program_rows(torch, card, sm, (beam, beam3), restore,
                                    (tok, pos, act)))
    part("step programs")
    # an adaptive mixed batch builds each engine once
    tel = ServingTelemetry()
    gcfg = GenerationConfig(adaptive_spec=True, spec_fallback_margin=0.0,
                            spec_recover_margin=0.1)
    mixed = [p[:n] for p, n in zip(prompts, (32, 20, 12, 28, 16, 24, 8, 30))]
    verifier._chain_engine = verifier._multi_engine = None
    verifier._beam_engine = None
    for fn in (lambda rm: rm._generate_spec_chain(
                   verifier, draft, spec_depth=SPEC_DEPTH,
                   generation_config=gcfg),
               lambda rm: rm._generate_spec_tree_fused(
                   verifier, [draft], spec_depth=SPEC_DEPTH,
                   generation_config=gcfg),
               lambda rm: rm.generate_spec_infer(
                   verifier, [beam], spec_depth=BEAM_DEPTH,
                   beam_width=BEAM_WIDTH, generation_config=gcfg)):
        rm = RequestManager(telemetry=tel)
        for i, p in enumerate(mixed):
            rm.register_new_request(p, max_new_tokens=12 + 2 * i)
        fn(rm)
    traces = {k: getattr(verifier, f"_{k}_engine")._trace_count
              for k in ("chain", "multi", "beam")}
    retraces = tel.registry.get("ffsv_engine_retraces_total").value
    misses = tel.registry.get("ffsv_jit_cache_misses_total").value
    log(f"  adaptive mixed batch (prompt lengths 8-32, budgets 12-26): "
        f"builds {traces}, ffsv_jit_cache_misses_total {misses}, "
        f"ffsv_engine_retraces_total {retraces}")
    if set(traces.values()) != {1} or retraces != 0 or misses != 3:
        raise AssertionError("an engine built more than once")
    report["mixed_builds"] = traces
    part("mixed batch")

    # phase 5's incremental generate, device-busy share eager vs program
    def incr():
        rm = RequestManager()
        for p in prompts:
            rm.register_new_request(p, max_new_tokens=PROGRAM_NEW)
        rm.generate_incr_decoding(verifier)

    incr()                                  # builds the decode program
    busy = {"eager": [], "program": []}
    for _ in range(PROGRAM_PAIRS):
        for mode in busy:
            with graphs.eager_bodies() if mode == "eager" \
                    else contextlib.nullcontext():
                busy[mode].append(profile_window(
                    torch, incr, f"incremental generate ({PROGRAM_NEW} new "
                    f"tokens), {mode}", card, top=8, host_ops=False))
    report["busy"] = busy
    part("profiles")

    # the same verifier in int8: K3 inside the captured decode step
    verifier.quantize_weights("int8")
    report["decode_int8"] = eager_vs_program(
        torch, card, "decode block, int8 weights (the verifier quantized)",
        decode(ifm), restore, "step")
    if not report["decode_int8"]["counts"]["qmatmul"]:
        raise AssertionError("the int8 decode launched no K3")
    # the int8 verifier's [8, 64] prefill: K3 inside the step program
    report["prefill_int8"] = eager_vs_program(
        torch, card, f"prefill step [{REQUESTS}, {PROGRAM_CHUNK}], int8 "
        f"weights", *prefill_row(torch, verifier), restore, "step",
        after=kv_bytes(torch, [verifier], PROGRAM_CHUNK))
    if not report["prefill_int8"]["counts"]["qmatmul"]:
        raise AssertionError("the int8 prefill launched no K3")
    report["pools"] = program_pools(torch, card, verifier)
    part("int8 decode and prefill")
    return report["decode"]["counts"], report


# ----------------------------------------------------------------------
# phase 17: the Unity search
# ----------------------------------------------------------------------
SEARCH_CHIP = "h100-sxm"
SEARCH_GPUS = (1, 2, 8, 16)     # 17a: 16 GPUs are two HGX nodes over NDR
# each search bounded: 2 joint rewrite evaluations (and 2 MCMC moves), a
# 5 s deadline on each joint loop
SEARCH_KW = dict(search_budget=2, search_deadline_s=5.0)
LLAMA_TRAIN_SEQ = 4096          # 17a: LLaMA-2's context length
SEARCH_WORKERS = 6              # 17a: searches at once, a process each
AUTO_STEPS = 4                  # 17c: train steps on 2 ranks and on 1
AB_STEPS, AB_REPS = 2, 1        # 17c: searched_vs_dp_wallclock
INCEPTION_BATCH, INCEPTION_STEPS = 16, 3       # 17d
SEARCH_BOUND = 1e-5             # 17c, 17d: relative to one rank's


def llama_train_build(ff, config, layers=LAYERS):
    """LLaMA-2-7B's decoder as a training graph at ``config.batch_size``
    x ``LLAMA_TRAIN_SEQ`` tokens (17a's third PCG: the training MHA with
    a causal mask stands for the rotary serving attention)."""
    b = config.batch_size
    m = ff.FFModel(config)
    tokens = m.create_tensor([b, LLAMA_TRAIN_SEQ], ff.DataType.DT_INT32)
    h = m.embedding(tokens, VOCAB, HIDDEN, name="embed_tokens")
    for i in range(layers):
        x = m.rms_norm(h, dim=HIDDEN, name=f"layers.{i}.input_layernorm")
        a = m.multihead_attention(x, x, x, embed_dim=HIDDEN, num_heads=HEADS,
                                  bias=False, causal=True,
                                  name=f"layers.{i}.self_attn")
        h = m.add(h, a, name=f"layers.{i}.attn_residual")
        x = m.rms_norm(h, dim=HIDDEN,
                       name=f"layers.{i}.post_attention_layernorm")
        g = m.dense(x, INTER, use_bias=False, name=f"layers.{i}.mlp.gate_proj")
        u = m.dense(x, INTER, use_bias=False, name=f"layers.{i}.mlp.up_proj")
        d = m.dense(m.sigmoid_silu_multi(g, u, name=f"layers.{i}.mlp.act"),
                    HIDDEN, use_bias=False, name=f"layers.{i}.mlp.down_proj")
        h = m.add(h, d, name=f"layers.{i}.mlp_residual")
    logits = m.dense(m.rms_norm(h, dim=HIDDEN, name="norm"), VOCAB,
                     use_bias=False, name="lm_head")
    m.softmax(m.reshape(logits, [b * LLAMA_TRAIN_SEQ, VOCAB]))
    return m


def search_model(ff, name):
    """17a's model ``name`` as a graph on the host (nothing allocated),
    in phase 11's bf16 compute, with 17a's search settings."""
    batch, build = {
        "BERT-large": (BERT_BATCH, lambda c: bert_build(ff, c)),
        "ResNet-50": (RESNET_BATCH, lambda c: resnet_build(
            ff, c, RESNET_IMG, 1000, RESNET_STAGES)),
        "LLaMA-2-7B": (LARGE_BATCH, lambda c: llama_train_build(ff, c)),
    }[name]
    return build(ff.FFConfig(batch_size=batch, device="cpu",
                             compute_dtype="bfloat16", search_mesh=True,
                             search_chip=SEARCH_CHIP, search_profile=False,
                             **SEARCH_KW))


def search_one(name, n):
    """One of 17a's searches, in a worker process: ``optimize_model`` of
    ``name`` at ``n`` GPUs with ``search_mesh``, and data parallelism's
    analytic step beside it. Returns (report, the strategy's JSON)."""
    import collections

    import flexflow_tpu_torch as ff
    from flexflow_tpu_torch.search import (data_parallel_model_strategy,
                                           optimize_model)

    m = search_model(ff, name)
    t = time.perf_counter()
    st = optimize_model(m, chip=SEARCH_CHIP, num_devices=n, search_mesh=True)
    secs = time.perf_counter() - t
    dp = data_parallel_model_strategy(m, chip=SEARCH_CHIP, num_devices=n)
    if not st.ops or len(st.ops) != len(m.layers) or not st.cost > 0:
        raise AssertionError(f"17a {name} at {n}: the strategy does not "
                             f"cover the layers")
    dp_cost = dp.cost if dp is not None else None
    if dp_cost is not None and st.cost > dp_cost * 1.0001:
        raise AssertionError(f"17a {name} at {n}: the search lost to data "
                             f"parallelism")
    return dict(seconds=secs, layers=len(m.layers),
                mesh={a: d for a, d in (st.axis_degrees or {}).items()
                      if d > 1},
                cost_s=st.cost, dp_cost_s=dp_cost,
                peak_bytes=st.peak_memory,
                candidates=dict(collections.Counter(
                    op.name for op in st.ops.values()))), st.to_json()


def search_pcgs(card):
    """17a: ``optimize_model`` at full width and depth on the host, under
    the H100/NVLink machine model, at each of ``SEARCH_GPUS`` with
    ``search_mesh``; the searches run ``SEARCH_WORKERS`` at a time, each
    in a process of its own. Returns ({model: {gpus: report}}, {model:
    {gpus: strategy}})."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from flexflow_tpu_torch.search import Strategy

    names = ("BERT-large", "ResNet-50", "LLaMA-2-7B")
    t = time.perf_counter()
    with ProcessPoolExecutor(SEARCH_WORKERS, mp_context=multiprocessing
                             .get_context("spawn")) as pool:
        # the longest searches (most GPUs, LLaMA-2-7B) first
        jobs = {(name, n): pool.submit(search_one, name, n)
                for n in sorted(SEARCH_GPUS, reverse=True)
                for name in reversed(names)}
        done = {key: job.result() for key, job in jobs.items()}
    wall = time.perf_counter() - t
    report, kept = {}, {}
    for name in names:
        report[name], kept[name] = {}, {}
        for n in SEARCH_GPUS:
            r, js = done[name, n]
            dp = r["dp_cost_s"]
            log(f"  17a {name} ({r['layers']} layers), {n} "
                f"GPU{'s' if n > 1 else ''}: searched in "
                f"{r['seconds']:.2f} s; mesh {r['mesh'] or {'data': 1}}; "
                f"analytic step {r['cost_s'] * 1e3:.3f} ms vs data parallel "
                f"{'%.3f ms' % (dp * 1e3) if dp else 'none'}; peak "
                f"{r['peak_bytes'] / 1e9:.2f} GB a GPU; candidates "
                f"{r['candidates']}  [{card}]")
            report[name][n] = r
            kept[name][n] = Strategy.from_json(js)
    log(f"  17a: {len(done)} searches in {wall:.1f} s of wall time, "
        f"{SEARCH_WORKERS} at a time  [{card}]")
    report["wall_s"] = wall
    return report, kept


def measured_vs_analytic(torch, card, model, strategy, n=2,
                         device="cuda"):
    """17b: ``CostModel.measure_node`` on the card at every distinct (op,
    shapes, spec) key of the search at ``n`` GPUs over ``model``'s PCG:
    every node's candidates under every mesh factorization the search
    scored (``search_mesh``), and the adopted strategy's own. Measured
    ms beside the analytic roofline's by op type, the range of the
    ratio, and the count of analytic fallbacks."""
    from flexflow_tpu_torch.search import CostModel, MachineModel, PCG

    pcg = PCG.from_model(model)
    one = {"data": 1, "model": 1, "expert": 1, "seq": 1}
    factorizations = [one]
    for d in range(1, n + 1):
        for extra in ("seq", "model"):
            cand = dict(one, data=d, **{extra: n // d})
            if n % d == 0 and cand not in factorizations:
                factorizations.append(cand)
    machine = MachineModel.from_name(SEARCH_CHIP, n)
    adopted = dict(strategy.axis_degrees or one)
    t = time.perf_counter()
    records, fallbacks = [], 0
    for axes in factorizations:
        cm = CostModel(machine, axes, training=True, device=device,
                       compute_dtype=model.config.compute_dtype)
        for node in pcg.nodes:
            cands = list(node.candidates(axes))
            if axes == adopted and node.name in strategy.ops:
                cands.append(strategy.ops[node.name])
            for st in cands:
                cm.measure_node(node, st)
        records += list(cm.profile_records.values())
        fallbacks += cm.profile_fallbacks
    secs = time.perf_counter() - t
    by_op = {}
    lo, hi = (float("inf"), None), (0.0, None)
    for r in records:
        agg = by_op.setdefault(r["op"], {"keys": 0, "measured_ms": 0.0,
                                         "analytic_ms": 0.0, "fallbacks": 0})
        agg["keys"] += 1
        agg["analytic_ms"] += r["analytic_s"] * 1e3
        if r["measured_s"] is None:
            agg["fallbacks"] += 1
            continue
        agg["measured_ms"] += r["measured_s"] * 1e3
        ratio = r["measured_s"] / r["analytic_s"]
        at = f"{r['node']} ({r['op']}, {r['strategy']})"
        lo = min(lo, (ratio, at))
        hi = max(hi, (ratio, at))
    for op, agg in sorted(by_op.items()):
        log(f"  17b {op}: {agg['keys']} keys, measured "
            f"{agg['measured_ms']:.4f} ms vs analytic "
            f"{agg['analytic_ms']:.4f} ms (ratio "
            f"{agg['measured_ms'] / max(agg['analytic_ms'], 1e-12):.2f}); "
            f"fallbacks {agg['fallbacks']}  [{card}]")
    log(f"  17b: {len(records)} keys over {len(factorizations)} mesh "
        f"factorizations in {secs:.1f} s; measured/analytic from "
        f"{lo[0]:.4f} ({lo[1]}) to {hi[0]:.2f} ({hi[1]}); analytic "
        f"fallbacks {fallbacks}  [{card}]")
    if not records or fallbacks == len(records):
        raise AssertionError("17b measured no op on the card")
    return dict(keys=len(records), seconds=secs, by_op=by_op,
                ratio_min=lo[0], ratio_min_at=lo[1], ratio_max=hi[0],
                ratio_max_at=hi[1], fallbacks=fallbacks)


def _check_rest_shapes(model, result):
    """Each of a rank's weights is the slice its layer's weight_specs (or
    the op's own split) names on the rank's mesh."""
    from flexflow_tpu_torch.parallel.mesh import Mesh
    from flexflow_tpu_torch.parallel.placement import rest_dims
    from flexflow_tpu_torch.parallel.spec import ShardingPolicy
    from flexflow_tpu_torch.search.strategy import Strategy

    st = Strategy.from_json(result["strategy"])
    mesh = Mesh(tuple(result["mesh"].values()) or (1,),
                tuple(result["mesh"]) or ("data",))
    policy = ShardingPolicy(mesh)
    n = 0
    for layer in model.layers:
        for w in layer.weights:
            sh = policy.weight_sharding(
                w.shape, rest_dims(w, st.ops.get(layer.name)),
                w.shard_multiples)
            want = [d // mesh.axis_size(a) if a else d
                    for d, a in zip(w.shape, tuple(sh.spec) + (None,) * 8)]
            got = result["weight_shapes"][f"{layer.name}/{w.name}"]
            if got != want:
                raise AssertionError(f"{layer.name}/{w.name}: rank holds "
                                     f"{got}, its spec names {want}")
            n += 1
    return n


def searched_training(torch, card, work, device="cuda"):
    """17c: BERT-large widths cut to CUT_LAYERS, batch CUT_BATCH, fp32,
    compiled with ``auto_parallel`` and ``search_mesh`` on 2 ranks sharing
    the card (gloo), from one rank's weights: losses against one rank's,
    each rank's weight slices against its specs, and the measured A/B."""
    import numpy as np

    import flexflow_tpu_torch as ff
    from flexflow_tpu_torch.parallel import rank_jobs
    from flexflow_tpu_torch.parallel.launch import run_ranks

    me = os.path.abspath(__file__)
    rng = np.random.default_rng(17)
    data = os.path.join(work, "bert.npz")
    np.savez(data, x0=rng.integers(0, BERT_VOCAB, (AUTO_STEPS, CUT_BATCH,
                                                   BERT_SEQ), dtype=np.int32),
             y=rng.integers(0, BERT_VOCAB, (AUTO_STEPS, CUT_BATCH * BERT_SEQ,
                                            1), dtype=np.int32))
    init = bert_build(ff, ff.FFConfig(batch_size=CUT_BATCH, seed=7,
                                      device="cpu"), CUT_LAYERS)
    train_compile(init, "sgd")
    weights = os.path.join(work, "bert.pt")
    torch.save({ln: {w: p.detach().clone() for w, p in lp.items()}
                for ln, lp in init.params.items()}, weights)
    search = dict(auto_parallel=True, search_mesh=True,
                  search_chip=SEARCH_CHIP, **SEARCH_KW)
    base = dict(builder=f"{me}:bert_build",
                builder_kw={"layers": CUT_LAYERS},
                optimizer=["sgd", {"lr": TRAIN_LR}], data=data,
                weights=weights)
    auto = dict(base, name="auto", config=dict(batch_size=CUT_BATCH, seed=7,
                                               **search))
    ab = dict(builder=f"{me}:bert_build", builder_kw={"layers": CUT_LAYERS},
              config=dict(batch_size=CUT_BATCH, seed=7,
                          search_chip=SEARCH_CHIP, **SEARCH_KW),
              data=data, chip=SEARCH_CHIP, steps=AB_STEPS, reps=AB_REPS)
    t = time.perf_counter()
    res = run_ranks("flexflow_tpu_torch.parallel.rank_jobs:search_ab", 2,
                    {"device": device, "tf32": False, "runs": [auto],
                     "ab": ab}, workdir=os.path.join(work, "w2"),
                    timeout=PAR_TIMEOUT, device=device)
    secs = time.perf_counter() - t
    one = rank_jobs.train({"device": device, "tf32": False, "runs": [dict(
        base, name="one", config=dict(batch_size=CUT_BATCH, seed=7))]})[0]
    ranks = [r["runs"][0] for r in res]
    err = _rel(ranks[0]["losses"], one["losses"])
    shapes = sum(_check_rest_shapes(init, r) for r in ranks)
    st = json.loads(ranks[0]["strategy"])
    names = sorted({op["name"] for op in st["ops"].values()})
    log(f"  17c: 2 ranks in {secs:.1f} s; adopted mesh {ranks[0]['mesh']} "
        f"(axis_degrees {st.get('axis_degrees')}); candidates {names}; "
        f"losses {[round(x, 6) for x in ranks[0]['losses']]} vs one rank "
        f"{[round(x, 6) for x in one['losses']]}: worst relative "
        f"{err:.2e} (bound {SEARCH_BOUND}); {shapes} weight slices as "
        f"their specs name  [{card}]")
    ab_res = res[0]["ab"]
    log(f"  17c searched_vs_dp_wallclock (two ranks on ONE card, gloo "
        f"through the host: a structural check, not a parallel speed): "
        + "; ".join(f"{v}: analytic {d['analytic'] * 1e3:.3f} ms, wall "
                    f"{d['wallclock'] * 1e3:.1f} ms a step"
                    for v, d in ab_res.items()) + f"  [{card}]")
    if err > SEARCH_BOUND:
        raise AssertionError(f"17c losses {err:.2e} from one rank's")
    if any(r["losses"] != ranks[0]["losses"] for r in ranks[1:]):
        raise AssertionError("17c ranks read different losses")
    return dict(seconds=secs, mesh=ranks[0]["mesh"], candidates=names,
                losses=ranks[0]["losses"], one_rank=one["losses"],
                rel_err=err, weight_slices=shapes, ab=ab_res)


def branch_training(torch, card, work, device="cuda"):
    """17d: the four-branch inception block at data=4 on 4 ranks sharing
    the card (gloo), with the branch strategy that
    ``tests/test_measured_ab.py:86-124`` builds (on the H100 model):
    the plan has a region, the region runs on its ranks, and the losses
    and last-step gradients equal one rank's sequential walk."""
    import numpy as np

    import flexflow_tpu_torch as ff
    from flexflow_tpu_torch.parallel import rank_jobs
    from flexflow_tpu_torch.parallel.launch import load_target, run_ranks
    from flexflow_tpu_torch.search import (CostModel, MachineModel, PCG,
                                           UnitySearch)
    from flexflow_tpu_torch.search.graph_search import expand_strategy

    builder = os.path.join(HERE, "tests", "torch_rank_jobs.py:inception")
    cfg = dict(batch_size=INCEPTION_BATCH, seed=7)
    m = load_target(builder)(ff, ff.FFConfig(device="cpu", **cfg))
    pcg = PCG.from_model(m)
    axes = {"data": 4, "model": 1}
    cm = CostModel(MachineModel.from_name(SEARCH_CHIP, 4), axes,
                   training=True, branch_concurrency=True)
    s = UnitySearch(pcg, cm, axes,
                    enable_substitutions=False).optimize_graph(pcg)
    tagged = sum(1 for st in s.ops.values() if st.branch)
    strategy = expand_strategy(pcg, s)
    train_compile(m, "sgd")
    weights = os.path.join(work, "inception.pt")
    torch.save({ln: {w: p.detach().clone() for w, p in lp.items()}
                for ln, lp in m.params.items()}, weights)
    rng = np.random.default_rng(23)
    data = os.path.join(work, "inception.npz")
    np.savez(data, x0=rng.standard_normal(
        (INCEPTION_STEPS, INCEPTION_BATCH, 32, 8, 8), dtype=np.float32),
        y=rng.integers(0, 10, (INCEPTION_STEPS, INCEPTION_BATCH, 1),
                       dtype=np.int32))
    base = dict(builder=builder, optimizer=["sgd", {"lr": TRAIN_LR}],
                data=data, weights=weights)
    t = time.perf_counter()
    res = run_ranks("flexflow_tpu_torch.parallel.rank_jobs:train", 4,
                    {"device": device, "tf32": False, "runs": [dict(
                        base, name="branch", strategy=strategy.to_json(),
                        config=dict(cfg, data_parallelism_degree=4),
                        grads_out=os.path.join(work, "branch.npz"))]},
                    workdir=os.path.join(work, "w4"), timeout=PAR_TIMEOUT,
                    device=device)
    secs = time.perf_counter() - t
    one = rank_jobs.train({"device": device, "tf32": False, "runs": [dict(
        base, name="one", config=cfg,
        grads_out=os.path.join(work, "one.npz"))]})[0]
    ranks = [r[0] for r in res]
    err = _rel(ranks[0]["losses"], one["losses"])
    gb = dict(np.load(os.path.join(work, "branch.npz")))
    g1 = dict(np.load(os.path.join(work, "one.npz")))
    gerr = max(float(np.abs(gb[k] - g1[k]).max())
               / max(float(np.abs(g1[k]).max()), 1e-12) for k in g1)
    log(f"  17d: {tagged} ops tagged, {ranks[0]['branch_regions']} region "
        f"planned; 4 ranks in {secs:.1f} s; losses worst relative {err:.2e},"
        f" gradients worst (of each tensor's largest) {gerr:.2e} vs one "
        f"rank's sequential walk (bound {SEARCH_BOUND})  [{card}]")
    if not tagged or any(r["branch_regions"] != 1 for r in ranks):
        raise AssertionError("17d: no branch region planned")
    if err > SEARCH_BOUND or gerr > SEARCH_BOUND or set(gb) != set(g1):
        raise AssertionError(f"17d: the branch plan's losses ({err:.2e}) "
                             f"or gradients ({gerr:.2e}) differ")
    return dict(seconds=secs, tagged=tagged, rel_err=err, grad_err=gerr)


PHASE8_INCR = {}        # phase 8's incremental tokens, for 17e


def searched_serving(torch, card):
    """17e: phase 8's model compiled with ``auto_parallel`` on the one
    card: the incremental tokens against phase 8's, K1/K2/K3 launched and
    no plain call."""
    import numpy as np

    from flexflow_tpu_torch import kernels
    from flexflow_tpu_torch.serve.request_manager import RequestManager

    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, VOCAB, PROMPT_LEN).tolist()
               for _ in range(REQUESTS)]
    want = PHASE8_INCR.get("tokens")
    if want is None:            # phase 8 did not run: its model, plainly
        llm, _ssm, _ = headline_int8(torch)
        want = timed_pass(torch, card, prompts,
                          lambda rm: rm.generate_incr_decoding(llm.ffmodel),
                          NEW_TOKENS, "17e reference (phase 8's model)")[0]
        del llm, _ssm
        gc.collect()
    t = time.perf_counter()
    llm, _ssm, secs = headline_int8(
        torch, auto_parallel=True, search_chip=SEARCH_CHIP, **SEARCH_KW)
    search_s = time.perf_counter() - t
    m = llm.ffmodel
    names = sorted({op.name for op in m.strategy.ops.values()})
    got, _tps, counts, _ = timed_pass(
        torch, card, prompts, lambda rm: rm.generate_incr_decoding(m),
        NEW_TOKENS, "17e int8 incremental, auto_parallel")
    same = matches(got, want, NEW_TOKENS)
    log(f"  17e: compile with the search {search_s:.1f} s; strategy over "
        f"{len(m.strategy.ops)} layers, candidates {names}; tokens equal to "
        f"phase 8's {same}/{REQUESTS}; launches {counts}  [{card}]")
    if same != REQUESTS:
        raise AssertionError(f"17e: {same}/{REQUESTS} requests give phase "
                             f"8's tokens")
    if not (counts["flash_attend"] and counts["flash_attend_append"]
            and counts["qmatmul"]) or counts["plain_attend_cuda"] \
            or counts["qmatmul_plain_cuda"]:
        raise AssertionError(f"17e launch counts {counts}")
    del llm, _ssm, m
    gc.collect()
    return counts, dict(seconds=search_s, candidates=names, matches=same)


def costed_dot(torch, card, work, model, strategy, device="cuda"):
    """17f: BERT-large compiled (inference, on the card) with
    ``include_costs_dot_graph`` and ``export_strategy_file``, and
    ``pcg_to_dot`` of its PCG under 17a's 2-GPU strategy with those
    costs."""
    import flexflow_tpu_torch as ff
    from flexflow_tpu_torch.search import PCG
    from flexflow_tpu_torch.utils.dot import pcg_to_dot

    path = os.path.join(work, "bert_large.dot")
    m = bert_build(ff, ff.FFConfig(
        batch_size=BERT_BATCH, search_chip=SEARCH_CHIP, device=device,
        export_strategy_file=path, include_costs_dot_graph=True))
    m.compile()
    text = open(path).read()
    costs = m._estimate_layer_costs()
    pcg_text = pcg_to_dot(PCG.from_model(model), strategy=strategy,
                          costs=costs)
    with open(os.path.join(work, "bert_large_pcg.dot"), "w") as f:
        f.write(pcg_text)
    nodes = text.count("[label=") - len(m.input_tensors)
    costed = text.count("cost: ")
    pcg_nodes = pcg_text.count("[label=")
    log(f"  17f: compile's dot {nodes} layer nodes, {costed} with a cost; "
        f"pcg_to_dot {pcg_nodes} nodes, {pcg_text.count('cost: ')} with a "
        f"cost, {pcg_text.count('spec: ')} with a spec  [{card}]")
    if not nodes or costed != nodes or pcg_text.count("cost: ") != pcg_nodes:
        raise AssertionError("17f: a node without its cost")
    del m
    gc.collect()
    return dict(nodes=nodes, costed=costed, pcg_nodes=pcg_nodes)


def search_phase(torch, card, work):
    """Phase 17: the Unity search. 17a on the host, 17b-17f on the card;
    returns (17e's launch counts, the report). A failed gate raises."""
    import flexflow_tpu_torch as ff

    t_phase = time.perf_counter()
    report = {}
    log(f"phase 17a: the search at full width on the host, {SEARCH_CHIP} "
        f"machine model, {list(SEARCH_GPUS)} GPUs, search_mesh, budget "
        f"{SEARCH_KW['search_budget']}, deadline "
        f"{SEARCH_KW['search_deadline_s']} s  [{card}]")
    report["17a"], kept = search_pcgs(card)
    bert, bert_st = search_model(ff, "BERT-large"), kept["BERT-large"]
    log(f"phase 17b: the profiled re-rank's op timings on the card, 17a's "
        f"BERT-large at 2 GPUs (bf16 compute, fp32 weights, as phase 11 "
        f"trains it)  [{card}]")
    report["17b"] = measured_vs_analytic(torch, card, bert, bert_st[2])
    gc.collect()
    log(f"phase 17c: auto_parallel training, BERT-large widths, "
        f"{CUT_LAYERS} layers, batch {CUT_BATCH}, fp32, 2 ranks sharing the "
        f"card  [{card}]")
    report["17c"] = searched_training(torch, card, work)
    gc.collect()
    log(f"phase 17d: the branch plan, the inception block at data=4, batch "
        f"{INCEPTION_BATCH}, 4 ranks sharing the card  [{card}]")
    report["17d"] = branch_training(torch, card, work)
    gc.collect()
    log(f"phase 17e: phase 8's model (LLaMA-2-7B geometry, int8) compiled "
        f"with auto_parallel on one card  [{card}]")
    counts, report["17e"] = searched_serving(torch, card)
    log(f"phase 17f: the cost-annotated dot, BERT-large  [{card}]")
    report["17f"] = costed_dot(torch, card, work, bert, bert_st[2])
    report["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 17: {report['seconds']:.1f} s  [{card}]")
    return counts, report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18",
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--profile", action="store_true",
                    help="phases 5, 6 and 8 also trace a generate call, "
                         "and phase 11 one BERT-large train step, with "
                         "torch.profiler (device busy share, time by "
                         "kernel)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    t_script = time.perf_counter()
    # each phase's seconds, printed before the kernel table
    laps, running = {}, [None, t_script]

    def lap(name):
        now = time.perf_counter()
        if running[0] is not None:
            laps[running[0]] = round(now - running[1], 1)
        running[:] = [name, now]

    lap("1-2")

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
    lap("3")
    rows = kernel_phase(torch, timer) if 3 in phases else []
    del timer
    # the model <-> InferenceManager reference cycle keeps a phase's model
    # alive until a collection; free it before the next phase's peak
    gc.collect()
    by_path = {}
    if 4 in phases:
        lap('4')
        by_path["wide"] = e2e_parity_phase(torch)
        gc.collect()
    bf16_decode_ms = None
    if 5 in phases:
        lap('5')
        by_path["incr"], bf16 = full_size_phase(torch, card,
                                                profile=args.profile)
        bf16_decode_ms = bf16["decode_ms_per_step"]
        gc.collect()
    if phases & {6, 7, 18}:
        lap("6-7")
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
        if 18 in phases:
            lap("18")
            log(f"phase 18: the engines' programs (CUDA graphs) against "
                f"their eager bodies, phase 6-7's models (LLaMA-2-7B "
                f"geometry, bf16, {LAYERS} layers), then the verifier in "
                f"int8; {PROGRAM_PAIRS} alternating timed pairs  [{card}]")
            by_path["programs"], programs = engine_programs_phase(torch, card,
                                                                  sm)
            log(json.dumps({"engine_programs_phase": programs}))
        del sm
        gc.collect()
    if 8 in phases:
        lap('8')
        log(f"phase 8: LLaMA-2-7B geometry with int8 weights (bench.py's "
            f"headline), bf16 compute and cache, {REQUESTS} requests x "
            f"{PROMPT_LEN}-token prompts, {NEW_TOKENS} new tokens  [{card}]")
        by_path["int8"], int8 = int8_phase(torch, card, bf16_decode_ms,
                                           profile=args.profile)
        log(json.dumps({"int8_phase": int8}))
        gc.collect()
    if 9 in phases:
        lap('9')
        log(f"phase 9: online serving, LLaMA-2-7B geometry with int8 "
            f"weights (phase 8's models), {REQUESTS} slots, MAX_SEQ "
            f"{MAX_SEQ}  [{card}]")
        by_path["online"], online = online_phase(torch, card)
        log(json.dumps({"online_phase": online}))
        gc.collect()
    if 10 in phases:
        lap('10')
        by_path["families"], fams = families_phase(torch, card)
        log(json.dumps({"families_phase": fams}))
        gc.collect()
    if 11 in phases:
        lap('11')
        log(json.dumps({"training_phase": training_phase(
            torch, card, profile=args.profile)}))
        gc.collect()
    if 12 in phases:
        lap('12')
        import tempfile

        log(f"phase 12a: telemetry on the headline path (phase 8's models), "
            f"{TEL_PAIRS} alternating pairs off/on, incremental and "
            f"SpecInfer depth {SPEC_DEPTH}, {REQUESTS} requests x "
            f"{PROMPT_LEN}-token prompts, {NEW_TOKENS} new tokens  [{card}]")
        by_path["telemetry"], tel = telemetry_phase(torch, card)
        log(json.dumps({"telemetry_phase": tel}))
        gc.collect()
        log(f"phase 12b: the replica fleet at LLaMA-2-7B width, int8 on "
            f"load, {FLEET_SLOTS} slots a replica  [{card}]")
        with tempfile.TemporaryDirectory() as tmp:
            by_path["fleet"], fleet, ckpt = fleet_phase(torch, card, tmp)
            log("phase 12c: the serve CLI in a subprocess")
            fleet["cli"] = cli_phase(torch, card, ckpt)
        log(json.dumps({"fleet_phase": fleet}))
        gc.collect()
    # launch shapes that 14c holds against the plain versions, by run
    run_shapes = {}
    if 13 in phases:
        lap('13')
        counts13, run_shapes["inference_scripts"] = host_side_phase(torch,
                                                                    card)
        by_path.update(counts13)
        gc.collect()
        if 14 not in phases:
            log(f"13f's launch shapes against their plain versions  [{card}]")
            shard_shape_checks(torch, card, run_shapes)
    if 14 in phases:
        lap('14')
        log(f"phase 14a: CPU weight offload, phase 8's model (LLaMA-2-7B "
            f"geometry, int8, bf16), {OFFLOAD_PAIRS} alternating pairs "
            f"off/on, {REQUESTS} requests x {PROMPT_LEN}-token prompts, "
            f"{OFFLOAD_NEW} new tokens, prefetch reserve "
            f"{OFFLOAD_RESERVE >> 20} MiB  [{card}]")
        by_path["offload"], off, off_shapes = offload_phase(torch, card)
        log(json.dumps({"offload_phase": off}))
        gc.collect()
        log(f"phase 14b: sharded serving, LLaMA-2-7B widths, "
            f"{SHARD_LAYERS} layers, int8 weights, fp32 compute and cache, "
            f"{REQUESTS} requests x {PROMPT_LEN}-token prompts, {SHARD_NEW} "
            f"new tokens: 1 rank, then tp=2, pp=2 and sp=2 on 2 ranks "
            f"sharing the card; 14b-prefix at tp=2 and sp=2, 14b-strategy "
            f"at {LAYERS} layers and tp=2  [{card}]")
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            shard_counts, shard, shard_shapes = sharded_phase(torch, card,
                                                              tmp)
        by_path.update(shard_counts)
        log(json.dumps({"sharded_phase": shard}))
        gc.collect()
        log(f"phase 14c: the kernels at phase 14's and 13f's launch shapes "
            f"against their plain versions  [{card}]")
        t = time.perf_counter()
        checked = shard_shape_checks(
            torch, card, dict(shard_shapes, offload=off_shapes, **run_shapes))
        # the timed row of the partials mode: the sp2 decode shape
        rows.append(partials_row(
            torch, max(shard_shapes["sp2"]["flash_attend_append"]),
            by_path["sp2"]["flash_attend_partials"]))
        log(json.dumps({"shape_checks": dict(
            checked, seconds=time.perf_counter() - t)}))
        gc.collect()
    if 15 in phases:
        lap('15')
        import tempfile

        log(f"phase 15: parallel and resumable training, bench_train.py's "
            f"BERT-large (cut to {CUT_LAYERS} layers for parity) and the "
            f"ResNet-50 11a cut on 2 ranks sharing the card  [{card}]")
        with tempfile.TemporaryDirectory() as tmp:
            log(json.dumps({"parallel_training_phase":
                            parallel_training_phase(torch, card, tmp)}))
        gc.collect()
    if 16 in phases:
        lap('16')
        log(f"phase 16: the model frontends: ResNet-50 through fx, ONNX and "
            f"Keras, a BERT-large-width encoder through fx, the C graph "
            f"builder, the dot export  [{card}]")
        by_path["frontends"], front = frontends_phase(torch, card)
        log(json.dumps({"frontends_phase": front}))
        gc.collect()
    if 17 in phases:
        lap('17')
        import tempfile

        log(f"phase 17: the Unity search: PCGs at full width, the profiled "
            f"re-rank, searched strategies on ranks, the branch plan, "
            f"serving under auto_parallel, the costed dot  [{card}]")
        with tempfile.TemporaryDirectory() as tmp:
            by_path["auto_parallel"], searched = search_phase(torch, card,
                                                              tmp)
        log(json.dumps({"search_phase": searched}))
        gc.collect()
    for r in rows:
        # each kernel's launches on the path it serves: K1 (prefill) and
        # K2 (decode) on incremental decoding, K1's bias mode on spec, K3
        # on the int8 model's incremental decoding, K1/K2's partials mode
        # on sequence-parallel serving, the 16-bit wide kernel on phase
        # 4's bf16 head-dim-320 pass
        path = {"flash_attend_bias": "spec", "qmatmul": "int8",
                "flash_attend_partials": "sp2",
                "flash_attend_fp32": "fleet",
                "flash_attend_wide": "wide"}.get(r["name"], "incr")
        if path in by_path:
            r["launches"] = by_path[path][r["name"]]
        r["launches_by_path"] = {p: c[r["name"]] for p, c in by_path.items()}
    lap(None)
    log(json.dumps({"phase_seconds": laps}))
    log(f"chip_smoke.py: phases {sorted(phases)} in "
        f"{time.perf_counter() - t_script:.1f} s  [{card}]")
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
