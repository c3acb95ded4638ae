"""InferenceManager: dispatches serving steps for one model (counterpart
of ``flexflow_tpu/serve/inference_manager.py``).

The JAX manager jits its step, one program per meta shape. Here a step
is a program too (``serve/graphs.py``): one per key, the meta's kind
(a BatchMeta or a TreeBatchMeta) and shape, the compute dtype, the
sampler and the addresses of the parameters and caches it reads, every
key kept, all in one graph pool. On one CUDA device each is a CUDA graph
captured at the key's first step and replayed; on the CPU, under a mesh
and with the kernels off it is its stage, called directly. Either way a
step copies its host meta into the program's device tensors
(``batch_config.step_state``) with one copy, runs the program, and reads
back the output the program copied into its own buffer (none with
``want_output=False``). ``step_builds`` counts the builds, the JAX
step's traces. The KV caches are updated in place and
``model.op_state`` keeps naming the same tensors. A decode block is the
model's step program (``serve/engine.make_decode_block``), replayed a
step. The manager owns the model's random stream: one
``torch.Generator`` on the model's device, seeded from ``FFConfig.seed``
(a CPU generator cannot drive draws on the card), which every step and
decode block hands to the forward; a sampled graph advances it, and a
sampled step program registers it.

With ``FFConfig.inference_debugging`` on, every step dumps each op's
inputs, weights and outputs under ``debug_dir`` (default
``./inference_tensors``, as the JAX package writes;
``utils/debugging.py``) from an eager forward (the JAX dump runs outside
its jit too), and a decode block runs as single steps at the block's
width so that every decode token is dumped (the same tokens).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from flexflow_tpu_torch.ffconst import torch_dtype

# The port's verify-width quantum. The tree engine rounds its verify
# width (1 + B * depth nodes) up to a multiple of it, and incremental
# decode runs at it wherever the attention kernel serves the model: one
# draft model at depth 1-7 then verifies at exactly the decode width, so
# decode and verify run the same GEMM shapes and near-tie argmaxes
# resolve alike in both.
VERIFY_WIDTH = 8


def kernel_serves(model) -> bool:
    """Does the CUDA attention kernel serve every KV cache of ``model``?
    Asked of each cache tensor as allocated (its device, dtype, length and
    head dim, padded on the card: ``ops/inc_attention.py``
    ``cache_head_dim``) through ``kernels.attention.kernel_takes``, the
    predicate the kernel wrapper checks. Decides the incremental decode
    width and which engine a single draft model speculates through. False
    for a model whose config turns the kernels off (``use_kernels``), as
    the JAX package's ``use_pallas``."""
    from flexflow_tpu_torch.kernels.attention import kernel_takes

    if not getattr(getattr(model, "config", None), "use_kernels", True):
        return False

    caches = [st[n] for st in model.op_state.values() if isinstance(st, dict)
              for n in ("k", "k_cache") if n in st]
    return bool(caches) and all(
        kernel_takes(c.device, c.shape[-2], c.shape[-1], c.dtype)
        for c in caches)


class InferenceManager:
    """Owns the step functions for one FFModel serving graph."""

    def __init__(self, model):
        self.model = model
        model.finalize_gemm_fusion()   # serving gemm fusion (gemm_fusion.py)
        cfg = model.config
        self._compute_dtype = torch_dtype(cfg.compute_dtype)
        self.generator = torch.Generator(device=model.device)
        self.generator.manual_seed(cfg.seed)
        self._decode_block = None
        self.decode_width = self._resolve_decode_width(cfg)
        # the step programs, every key kept, and their graph pool
        from flexflow_tpu_torch.serve.graphs import ProgramCache

        self._steps = ProgramCache(model, keep=None)
        self.graph_pool = None
        # inference_debugging: where the dumps go, and the next step's
        # number
        self.debug_dir = "./inference_tensors"
        self._debug_step = 0

    def _resolve_decode_width(self, cfg) -> int:
        """Step width of incremental decode (config.decode_width; 0 = auto).

        Auto gives the verify width where the CUDA attention kernel
        serves the model (``kernel_serves``), and 1 elsewhere: the CPU
        path is the plain fp32 version, where wide queries would be pure
        waste. The JAX rule is the same with the Pallas kernel."""
        if cfg.decode_width:
            return int(cfg.decode_width)
        return VERIFY_WIDTH if kernel_serves(self.model) else 1

    @property
    def step_builds(self) -> int:
        """Step programs built (the JAX step's traces)."""
        return self._steps.builds

    def step(self, meta, want_output: bool = True):
        """Run one serving step over ``meta``, a BatchMeta or a
        TreeBatchMeta (numpy or tensor fields): the program of its key.
        Returns the op outputs as numpy (token ids [R, Q] for graphs
        ending in argmax or sampling; the packed [R, Q, 2W] top-W of a
        beam draft), or None with ``want_output=False`` (no host
        readback: prefill chunks whose outputs are discarded stay
        asynchronous)."""
        from flexflow_tpu_torch.serve.batch_config import load_step_meta

        m = self.model
        if m.config.inference_debugging:
            from flexflow_tpu_torch.utils.debugging import dump_serving_step

            out, m.op_state = dump_serving_step(
                m, meta.to(m.device), self.debug_dir, self._debug_step,
                generator=self.generator)
            self._debug_step += 1
            return out.cpu().numpy() if want_output else None
        progs = self._step_program(hasattr(meta, "ancestor"),
                                   *meta.tokens.shape)
        load_step_meta(progs.st, meta)
        progs.run("step")
        if not want_output:
            return None
        return progs.st["out"].to("cpu", copy=True).numpy()

    def _step_program(self, tree: bool, R: int, Q: int):
        """The step program of this key, built at its first use."""
        from flexflow_tpu_torch.serve.batch_config import step_state
        from flexflow_tpu_torch.serve.engine import _graph_samples
        from flexflow_tpu_torch.serve.graphs import (ProgramSet, captures,
                                                     tensor_key)

        m = self.model
        gen = self.generator if _graph_samples(m) else None
        key = (tree, R, Q, self._compute_dtype, gen is not None,
               tensor_key(m.params, m.op_state))
        capture = captures(m)
        if capture and self.graph_pool is None:
            self.graph_pool = torch.cuda.graph_pool_handle()

        def make(cap):
            return ProgramSet(
                {"step": functools.partial(self._step_stage, tree)},
                step_state(tree, R, Q, m.device), cap, generator=gen,
                state_of=lambda: m.op_state, pool=self.graph_pool)
        return self._steps.get(key, make, capture)

    def _step_stage(self, tree: bool, st, generator=None):
        """One serving forward over the program's meta tensors; its output
        copied into the program's ``out`` (made at the first run)."""
        from flexflow_tpu_torch.serve.batch_config import step_meta
        from flexflow_tpu_torch.serve.engine import forward_with_meta

        m = self.model
        out, m.op_state = forward_with_meta(
            m, m.params, m.op_state, step_meta(st, tree),
            self._compute_dtype, generator=generator)
        if "out" not in st:
            st["out"] = torch.empty_like(out)
        st["out"].copy_(out)

    def decode_block(self, tok: np.ndarray, pos: np.ndarray,
                     active: np.ndarray, n_steps: int) -> np.ndarray:
        """Run ``n_steps`` decode steps (the step program's replays) with
        one host readback. Returns int32 [R, n_steps]."""
        from flexflow_tpu_torch.serve.engine import make_decode_block

        m = self.model
        steps = m.config.decode_block_steps
        if m.config.inference_debugging:
            return self._decode_block_debug(tok, pos, active,
                                            min(int(n_steps), steps))
        if self._decode_block is None:
            self._decode_block = make_decode_block(
                m, self._compute_dtype, steps, width=self.decode_width)
        n_steps = min(int(n_steps), steps)
        dev = m.device
        toks, m.op_state, _last = self._decode_block(
            m.params, m.op_state,
            torch.as_tensor(tok, dtype=torch.int32, device=dev),
            torch.as_tensor(pos, dtype=torch.int32, device=dev),
            torch.as_tensor(active, dtype=torch.bool, device=dev), n_steps,
            self.generator)
        return toks[:, :n_steps].cpu().numpy()

    def _decode_block_debug(self, tok, pos, active, n_steps: int):
        """A decode block as ``n_steps`` dumped ``step`` calls at the fused
        block's width (one real token a row), so the dumped run gives the
        block's tokens."""
        from flexflow_tpu_torch.serve.batch_config import BatchMeta

        R = tok.shape[0]
        W = self.decode_width
        cur = np.asarray(tok, np.int32).copy()
        p = np.asarray(pos, np.int32).copy()
        act = np.asarray(active, bool)
        out = np.zeros((R, n_steps), np.int32)
        for j in range(n_steps):
            toks = np.zeros((R, W), np.int32)
            toks[:, 0] = cur
            qpos = p[:, None] + np.arange(W, dtype=np.int32)[None, :]
            meta = BatchMeta(tokens=toks, positions=qpos, start_pos=p.copy(),
                             num_tokens=act.astype(np.int32), active=act)
            nxt = np.asarray(self.step(meta)).reshape(R, -1)[:, 0]
            nxt = nxt.astype(np.int32)
            out[:, j] = np.where(act, nxt, 0)
            cur = np.where(act, nxt, cur)
            p = p + act.astype(np.int32)
        return out
