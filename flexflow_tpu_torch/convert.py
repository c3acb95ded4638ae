"""Parameters across the two packages.

``params_from_jax`` takes the JAX package's ``FFModel.params`` as nested
numpy arrays, ``{layer: {weight: np.ndarray}}``, and returns the port's
tensors. Layer and weight names and the ``[in, out]`` kernel layout are
the same in both packages, so the port then computes what the JAX model
computes. ``load_params`` copies such a dict into a compiled port model.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def params_from_jax(params_np: Mapping[str, Mapping[str, np.ndarray]],
                    device="cpu", dtype=None
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{layer: {weight: array}} -> {layer: {weight: tensor on device}},
    in ``dtype`` if given, else in each array's own dtype (numpy has no
    bfloat16: JAX's bf16 arrays arrive as ml_dtypes and become
    torch.bfloat16)."""
    return {layer: {w: _tensor(a, device, dtype) for w, a in lp.items()}
            for layer, lp in params_np.items()}


def _tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))     # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)


def load_params(model, params: Mapping[str, Mapping[str, object]]) -> int:
    """Copy every (layer, weight) of ``params`` (arrays or tensors) into the
    compiled ``model``, in the model's dtypes; returns the count."""
    n = 0
    for layer, lp in params.items():
        for w, a in lp.items():
            model.set_parameter_by_key((layer, w), a)
            n += 1
    return n
