"""InferenceManager: dispatches serving steps for one model (counterpart
of ``flexflow_tpu/serve/inference_manager.py``).

PyTorch runs eagerly, so a step is a direct call of the serving forward;
the KV caches are updated in place and ``model.op_state`` keeps naming the
same tensors. A decode block is the model's step program
(``serve/engine.make_decode_block``): captured once as a CUDA graph on
the card and replayed a step (``serve/graphs.py``). The manager owns the model's random stream: one
``torch.Generator`` on the model's device, seeded from ``FFConfig.seed``
(a CPU generator cannot drive draws on the card), which every step and
decode block hands to the forward; a sampled graph advances it.

With ``FFConfig.inference_debugging`` on, every step dumps each op's
inputs, weights and outputs under ``debug_dir`` (default
``./inference_tensors``, as the JAX package writes;
``utils/debugging.py``), and a decode block runs as single steps at the
block's width so that every decode token is dumped (the same tokens).
"""

from __future__ import annotations

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

    def step(self, meta, want_output: bool = True):
        """Run one serving step over ``meta``, a BatchMeta or a
        TreeBatchMeta (numpy or tensor fields).
        Returns the op outputs as numpy (token ids [R, Q] for graphs
        ending in argmax or sampling; the packed [R, Q, 2W] top-W of a
        beam draft), or None with ``want_output=False`` (no host
        readback: prefill chunks whose outputs are discarded stay
        asynchronous)."""
        from flexflow_tpu_torch.serve.engine import forward_with_meta

        m = self.model
        if m.config.inference_debugging:
            from flexflow_tpu_torch.utils.debugging import dump_serving_step

            out, m.op_state = dump_serving_step(
                m, meta.to(m.device), self.debug_dir, self._debug_step,
                generator=self.generator)
            self._debug_step += 1
        else:
            out, m.op_state = forward_with_meta(
                m, m.params, m.op_state, meta.to(m.device),
                self._compute_dtype, generator=self.generator)
        if not want_output:
            return None
        return out.cpu().numpy()

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
