"""Per-op tensor dumps of serving steps (counterpart of
``flexflow_tpu/utils/debugging.py``, the reference's
``inference_debugging`` mode: ``Op::save_inference_tensors_to_file``).

With ``FFConfig.inference_debugging`` on, every serving step's forward
runs through ``dump_forward``: the layers are walked in graph order, as
``FFModel._run_graph`` walks them, and each op's inputs, weights and
outputs are written to ``<out_dir>/step_<N>/<idx>_<layer>.npz`` with keys
``input_<i>``, ``weight_<name>`` and ``output_<i>``: the JAX package's
layout, so ``compare_dumps`` diffs a JAX dump directory against a port
one. Weights are dumped dequantized, in the compute dtype, as there.

numpy has no bfloat16 and the port does not depend on ``ml_dtypes``: a
bf16 tensor is stored widened to float32 (exact). ``compare_dumps``
compares in float32, reading the JAX package's ml_dtypes bf16 arrays
(stored as 2-byte records) the same way.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from flexflow_tpu_torch.ffconst import torch_dtype


def as_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        t = v.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(v)


def dump_forward(model, feeds: Dict[int, Any], out_dir: str, step: int = 0,
                 state: Optional[Dict[str, Any]] = None,
                 batch_config=None, generator=None):
    """Run ``model``'s serving forward over ``feeds`` layer by layer,
    dumping each op. The KV caches in ``state`` (default: the model's op
    state) are updated in place, as by a step. Returns (values by tensor
    id, new state)."""
    from flexflow_tpu_torch.kernels import use_kernels
    from flexflow_tpu_torch.ops.base import OpContext, get_op_impl
    from flexflow_tpu_torch.quant import dequantize_layer_params

    step_dir = os.path.join(out_dir, f"step_{step}")
    os.makedirs(step_dir, exist_ok=True)
    ctx = OpContext(compute_dtype=torch_dtype(model.config.compute_dtype),
                    batch_config=batch_config, generator=generator)
    ctx.state_in = state if state is not None else (model.op_state or {})
    ctx.state_out = {}
    values: Dict[int, Any] = dict(feeds)
    with use_kernels(model.config.use_kernels):
        for idx, layer in enumerate(model.layers):
            impl = get_op_impl(layer.op_type)
            ins = [values[t.tensor_id] for t in layer.inputs]
            blob = {f"input_{i}": as_numpy(v) for i, v in enumerate(ins)}
            ctx.layer_name = layer.name
            raw = model.params.get(layer.name, {})
            lp = dequantize_layer_params(raw, ctx.compute_dtype)
            for wname, w in (lp or {}).items():
                blob[f"weight_{wname}"] = as_numpy(w)
            outs = impl.forward(layer.attrs, raw if impl.quant_aware else lp,
                                ins, ctx)
            for t, v in zip(layer.outputs, outs):
                values[t.tensor_id] = v
            for i, v in enumerate(outs):
                blob[f"output_{i}"] = as_numpy(v)
            np.savez(os.path.join(step_dir, f"{idx:03d}_{layer.name}.npz"),
                     **blob)
    new_state = dict(ctx.state_in)
    new_state.update(ctx.state_out)
    return values, new_state


def dump_serving_step(model, meta, out_dir: str, step: int, generator=None):
    """One serving step over ``meta`` (device tensors) with its per-op
    dumps; called by ``InferenceManager.step`` when
    ``config.inference_debugging`` is on. Returns (final output, new
    state), as ``serve/engine.forward_with_meta``."""
    from flexflow_tpu_torch.serve.engine import build_feeds

    values, new_state = dump_forward(
        model, build_feeds(model, meta), out_dir, step=step,
        state=model.op_state, batch_config=meta, generator=generator)
    return values[model._final_tensor.tensor_id], new_state


def as_float32(x: np.ndarray) -> np.ndarray:
    """A dumped array in float32 (or its integers as they are); a
    2-byte record is an ml_dtypes bfloat16 saved without its dtype."""
    if x.dtype.kind == "V" and x.dtype.itemsize == 2:
        u = x.view(np.uint16).astype(np.uint32) << 16
        return u.view(np.float32)
    if x.dtype.kind == "f" or x.dtype.name == "bfloat16":
        return x.astype(np.float32)
    return x


def compare_dumps(dir_a: str, dir_b: str, rtol: float = 1e-4,
                  atol: float = 1e-5):
    """Diff two dump directories (one step's, or the whole ``out_dir``:
    ``step_<N>`` subdirectories are walked too); returns a list of
    (file, key, max_abs_err) mismatches, ``file`` relative to ``dir_a``.
    Files only in ``dir_a`` are skipped; a key missing from ``dir_b`` or
    a shape difference is an infinite error. Values are compared in
    float32."""
    mismatches = []
    for root, dirs, files in os.walk(dir_a):
        dirs.sort()
        rel = os.path.relpath(root, dir_a)
        for fname in sorted(files):
            pa = os.path.join(root, fname)
            pb = os.path.join(dir_b, rel, fname)
            name = fname if rel == "." else os.path.join(rel, fname)
            if not fname.endswith(".npz") or not os.path.exists(pb):
                continue
            with np.load(pa) as a, np.load(pb) as b:
                for key in a.files:
                    if key not in b.files:
                        mismatches.append((name, key, float("inf")))
                        continue
                    x, y = as_float32(a[key]), as_float32(b[key])
                    if x.shape != y.shape or not np.allclose(
                            x, y, rtol=rtol, atol=atol):
                        err = (float(np.abs(x.astype(np.float64)
                                            - y.astype(np.float64)).max())
                               if x.shape == y.shape else float("inf"))
                        mismatches.append((name, key, err))
    return mismatches


def worst_op(dir_a: str, dir_b: str):
    """(file, key, max_abs_err, max_rel_err) of the floating-point op
    output that differs most between two dump directories, relative to
    ``dir_a``'s largest magnitude in that tensor (token ids are left out:
    a near tie may flip one); None when no file pairs up."""
    worst = None
    for root, dirs, files in os.walk(dir_a):
        dirs.sort()
        rel = os.path.relpath(root, dir_a)
        for fname in sorted(files):
            pb = os.path.join(dir_b, rel, fname)
            if not fname.endswith(".npz") or not os.path.exists(pb):
                continue
            with np.load(os.path.join(root, fname)) as a, np.load(pb) as b:
                for key in a.files:
                    if not key.startswith("output_") or key not in b.files:
                        continue
                    x, y = as_float32(a[key]), as_float32(b[key])
                    if (x.shape != y.shape or x.size == 0
                            or x.dtype.kind != "f"):
                        continue
                    x, y = x.astype(np.float64), y.astype(np.float64)
                    err = float(np.abs(x - y).max())
                    rel_err = err / max(float(np.abs(x).max()), 1e-30)
                    if worst is None or rel_err > worst[3]:
                        worst = (os.path.join(rel, fname), key, err, rel_err)
    return worst
