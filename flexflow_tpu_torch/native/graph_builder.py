"""ctypes binding of the native C model-graph builder in the PyTorch/CUDA
port (counterpart of ``flexflow_tpu/native/graph_builder.py``).

The C ABI (``native/src/graph_builder.cpp``, the reference's
``src/c/flexflow_c.cc`` model-builder half) constructs a graph node by
node and serializes it as the frontend's JSON-lines IR; ``build_on``
hands it to :func:`flexflow_tpu_torch.torch.model.ir_to_ff`, so the
resulting FFModel compiles and trains like any other. The library is the
port's native one (``native/__init__.py``): a build that fails raises
``NativeBuildError``; there is no Python fallback.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence


class NativeGraphBuilder:
    def __init__(self):
        from flexflow_tpu_torch.native import load_native

        self._lib = load_native()       # raises NativeBuildError
        self._h = self._lib.ffgb_create()

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            try:
                self._lib.ffgb_destroy(h)
            except Exception:
                pass

    # -- builder surface ------------------------------------------------
    def _chk(self, node_id: int) -> int:
        if node_id < 0:
            raise ValueError(f"graph builder rejected op (code {node_id})")
        return node_id

    @staticmethod
    def _nm(name: Optional[str]) -> bytes:
        return (name or "").encode()

    def input(self, index: int, name: Optional[str] = None) -> int:
        return self._chk(self._lib.ffgb_input(self._h, index,
                                              self._nm(name)))

    def dense(self, in_id: int, out_dim: int, use_bias: bool = True,
              name: Optional[str] = None) -> int:
        return self._chk(self._lib.ffgb_dense(
            self._h, in_id, out_dim, int(use_bias), self._nm(name)))

    def conv2d(self, in_id: int, out_channels: int, kh: int, kw: int,
               sh: int, sw: int, ph: int, pw: int, groups: int = 1,
               use_bias: bool = True, name: Optional[str] = None) -> int:
        return self._chk(self._lib.ffgb_conv2d(
            self._h, in_id, out_channels, kh, kw, sh, sw, ph, pw, groups,
            int(use_bias), self._nm(name)))

    def pool2d(self, in_id: int, kh: int, kw: int, sh: int, sw: int,
               ph: int = 0, pw: int = 0, is_max: bool = True,
               name: Optional[str] = None) -> int:
        return self._chk(self._lib.ffgb_pool2d(
            self._h, in_id, kh, kw, sh, sw, ph, pw, int(is_max),
            self._nm(name)))

    def unary(self, in_id: int, op: str, name: Optional[str] = None) -> int:
        return self._chk(self._lib.ffgb_unary(self._h, in_id, op.encode(),
                                              self._nm(name)))

    def binary(self, a: int, b: int, op: str,
               name: Optional[str] = None) -> int:
        return self._chk(self._lib.ffgb_binary(self._h, a, b, op.encode(),
                                               self._nm(name)))

    def concat(self, ids: Sequence[int], axis: int,
               name: Optional[str] = None) -> int:
        arr = (ctypes.c_int * len(ids))(*ids)
        return self._chk(self._lib.ffgb_concat(self._h, arr, len(ids),
                                               axis, self._nm(name)))

    def softmax(self, in_id: int, axis: int = -1,
                name: Optional[str] = None) -> int:
        return self._chk(self._lib.ffgb_softmax(self._h, in_id, axis,
                                                self._nm(name)))

    def dropout(self, in_id: int, rate: float,
                name: Optional[str] = None) -> int:
        return self._chk(self._lib.ffgb_dropout(self._h, in_id,
                                                float(rate),
                                                self._nm(name)))

    def embedding(self, in_id: int, num_entries: int, out_dim: int,
                  name: Optional[str] = None) -> int:
        return self._chk(self._lib.ffgb_embedding(
            self._h, in_id, num_entries, out_dim, self._nm(name)))

    def reshape(self, in_id: int, shape: Sequence[int],
                name: Optional[str] = None) -> int:
        arr = (ctypes.c_int * len(shape))(*shape)
        return self._chk(self._lib.ffgb_reshape(self._h, in_id, arr,
                                                len(shape), self._nm(name)))

    def layer_norm(self, in_id: int, normalized_shape: Sequence[int],
                   affine: bool = True, eps: float = 1e-5,
                   name: Optional[str] = None) -> int:
        arr = (ctypes.c_int * len(normalized_shape))(*normalized_shape)
        return self._chk(self._lib.ffgb_layer_norm(
            self._h, in_id, arr, len(normalized_shape), int(affine),
            float(eps), self._nm(name)))

    def batch_norm(self, in_id: int, name: Optional[str] = None) -> int:
        return self._chk(self._lib.ffgb_batch_norm(self._h, in_id,
                                                   self._nm(name)))

    def rms_norm(self, in_id: int, eps: float = 1e-6, dim: int = 0,
                 name: Optional[str] = None) -> int:
        return self._chk(self._lib.ffgb_rms_norm(
            self._h, in_id, float(eps), dim, self._nm(name)))

    def multihead_attention(self, q: int, k: int, v: int, embed_dim: int,
                            num_heads: int, dropout: float = 0.0,
                            name: Optional[str] = None) -> int:
        return self._chk(self._lib.ffgb_multihead_attention(
            self._h, q, k, v, embed_dim, num_heads, float(dropout),
            self._nm(name)))

    def scalar(self, in_id: int, op: str, scalar: float,
               reverse: bool = False, name: Optional[str] = None) -> int:
        return self._chk(self._lib.ffgb_scalar(
            self._h, in_id, op.encode(), float(scalar), int(reverse),
            self._nm(name)))

    def transpose(self, in_id: int, perm: Sequence[int],
                  name: Optional[str] = None) -> int:
        arr = (ctypes.c_int * len(perm))(*perm)
        return self._chk(self._lib.ffgb_transpose(
            self._h, in_id, arr, len(perm), self._nm(name)))

    def mean(self, in_id: int, dims: Sequence[int], keepdims: bool = False,
             name: Optional[str] = None) -> int:
        arr = (ctypes.c_int * len(dims))(*dims)
        return self._chk(self._lib.ffgb_mean(
            self._h, in_id, arr, len(dims), int(keepdims), self._nm(name)))

    def cast(self, in_id: int, dtype: str,
             name: Optional[str] = None) -> int:
        return self._chk(self._lib.ffgb_cast(self._h, in_id, dtype.encode(),
                                             self._nm(name)))

    def output(self, ids: Sequence[int]):
        arr = (ctypes.c_int * len(ids))(*ids)
        if self._lib.ffgb_output(self._h, arr, len(ids)) != 0:
            raise ValueError("output() already called or bad node id")

    # -- hand-off to the runtime ----------------------------------------
    def serialize(self) -> str:
        n = self._lib.ffgb_serialize(self._h, None, 0)
        if n < 0:
            raise ValueError("graph has no output marked")
        buf = ctypes.create_string_buffer(n + 1)
        self._lib.ffgb_serialize(self._h, buf, n + 1)
        return buf.value.decode()

    def save(self, path: str):
        rc = self._lib.ffgb_save(self._h, path.encode())
        if rc != 0:
            raise ValueError(f"save failed (code {rc})")

    def build_on(self, ffmodel, input_tensors: Sequence) -> List:
        """Lower the C-built graph onto an FFModel (frontend IR path)."""
        from flexflow_tpu_torch.torch.model import IRNode, ir_to_ff

        ir = [IRNode.from_json(line)
              for line in self.serialize().splitlines() if line.strip()]
        return ir_to_ff(ir, ffmodel, input_tensors)
