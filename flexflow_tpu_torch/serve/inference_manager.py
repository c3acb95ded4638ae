"""InferenceManager: dispatches serving steps for one model (counterpart
of ``flexflow_tpu/serve/inference_manager.py``).

PyTorch runs eagerly, so a step is a direct call of the serving forward;
the KV caches are updated in place and ``model.op_state`` keeps naming the
same tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from flexflow_tpu_torch.ffconst import torch_dtype

# Token width of the speculative verify pass for one draft model at the
# default depth 4 (1 + 4 nodes, padded to 8). Incremental decode runs at
# this width wherever the attention kernel serves the model, so decode and
# verify share shapes and near-tie argmaxes resolve alike in both.
VERIFY_WIDTH = 8


class InferenceManager:
    """Owns the step functions for one FFModel serving graph."""

    def __init__(self, model):
        self.model = model
        cfg = model.config
        self._compute_dtype = torch_dtype(cfg.compute_dtype)
        self._decode_block = None
        self.decode_width = self._resolve_decode_width(cfg)

    def _resolve_decode_width(self, cfg) -> int:
        """Step width of incremental decode (config.decode_width; 0 = auto).

        Auto gives the verify width when the CUDA attention kernel serves
        every serving-attention layer of the model (a CUDA device and a
        head dim and cache length the kernel takes), and 1 elsewhere: the
        CPU path is the plain fp32 version, where wide queries would be
        pure waste. The JAX rule is the same with the Pallas kernel."""
        if cfg.decode_width:
            return int(cfg.decode_width)
        from flexflow_tpu_torch.kernels.attention import supports_shapes

        if self.model.device.type != "cuda":
            return 1
        S = cfg.max_sequence_length
        dims = {layer.attrs["head_dim"] for layer in self.model.layers
                if "head_dim" in layer.attrs
                and "num_kv_heads" in layer.attrs}
        if dims and all(supports_shapes(S, d) for d in dims):
            return VERIFY_WIDTH
        return 1

    def step(self, meta, want_output: bool = True):
        """Run one serving step over ``meta`` (numpy or tensor fields).
        Returns the op outputs as numpy (token ids [R, Q] for graphs
        ending in argmax), or None with ``want_output=False`` (no host
        readback: prefill chunks whose outputs are discarded stay
        asynchronous)."""
        from flexflow_tpu_torch.serve.engine import forward_with_meta

        m = self.model
        out, m.op_state = forward_with_meta(
            m, m.params, m.op_state, meta.to(m.device), self._compute_dtype)
        if not want_output:
            return None
        return out.cpu().numpy()

    def decode_block(self, tok: np.ndarray, pos: np.ndarray,
                     active: np.ndarray, n_steps: int) -> np.ndarray:
        """Run ``n_steps`` decode steps with one host readback. Returns
        int32 [R, n_steps]."""
        from flexflow_tpu_torch.serve.engine import make_decode_block

        m = self.model
        steps = m.config.decode_block_steps
        if self._decode_block is None:
            self._decode_block = make_decode_block(
                m, self._compute_dtype, steps, width=self.decode_width)
        n_steps = min(int(n_steps), steps)
        dev = m.device
        toks, m.op_state, _last = self._decode_block(
            m.params, m.op_state,
            torch.as_tensor(tok, dtype=torch.int32, device=dev),
            torch.as_tensor(pos, dtype=torch.int32, device=dev),
            torch.as_tensor(active, dtype=torch.bool, device=dev), n_steps)
        return toks[:, :n_steps].cpu().numpy()
