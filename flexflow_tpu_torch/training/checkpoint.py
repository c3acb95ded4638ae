"""Flat weight export and import (counterpart of
``save_weights_npz``/``load_weights_npz`` in
``flexflow_tpu/training/checkpoint.py``, the reference's FileDataLoader
layout): one ``np.savez`` archive with a ``<layer>.<weight>`` entry per
parameter. Quantized leaves are exported dequantized, at full precision.
numpy has no bfloat16, so a bf16 parameter is written widened to float32
(exact); the JAX package loads such an entry in its parameter's dtype,
and the port reads the JAX package's ml_dtypes bf16 entries. Both
directions load in both packages. The orbax-style training resume is
not ported (ROADMAP.md Queue A).
"""

from __future__ import annotations

import os

import numpy as np


def save_weights_npz(path: str, model) -> None:
    """Every parameter of ``model`` to ``path``."""
    from flexflow_tpu_torch.quant import dequantize_array, is_quantized
    from flexflow_tpu_torch.utils.debugging import as_numpy

    flat = {}
    for lname, lp in model.params.items():
        for wname, w in lp.items():
            if is_quantized(w):
                w = dequantize_array(w)
            flat[f"{lname}.{wname}"] = as_numpy(w)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_weights_npz(path: str, model) -> None:
    """Copy every ``<layer>.<weight>`` of ``path`` into the compiled
    ``model``, in place and in each parameter's dtype (a quantized
    parameter is re-quantized). A missing entry raises ``KeyError``, a
    shape difference ``ValueError``."""
    from flexflow_tpu_torch.utils.debugging import as_float32

    with np.load(path) as data:
        for lname, lp in model.params.items():
            for wname in list(lp):
                key = f"{lname}.{wname}"
                if key not in data:
                    raise KeyError(f"checkpoint missing weight {key}")
                model.set_parameter_by_key((lname, wname),
                                           np.array(as_float32(data[key])))
