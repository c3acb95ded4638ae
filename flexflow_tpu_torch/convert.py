"""Parameters across the two packages.

``params_from_jax`` takes the JAX package's ``FFModel.params`` as nested
numpy arrays, ``{layer: {weight: np.ndarray}}``, and returns the port's
tensors. Layer and weight names and the ``[in, out]`` kernel layout are
the same in both packages, so the port then computes what the JAX model
computes. A JAX ``QuantizedWeight`` crosses as the port's: the int8
payload, the fp32 scale, and its rows, dtype and qtype as they are.
``load_params`` copies such a dict into a compiled port model; a quantized
leaf goes into a quantized parameter as it is, not re-quantized.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from flexflow_tpu_torch.quant import QuantizedWeight, is_quantized


def params_from_jax(params_np: Mapping[str, Mapping[str, np.ndarray]],
                    device="cpu", dtype=None
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{layer: {weight: array}} -> {layer: {weight: tensor on device}},
    in ``dtype`` if given, else in each array's own dtype (numpy has no
    bfloat16: JAX's bf16 arrays arrive as ml_dtypes and become
    torch.bfloat16). A quantized leaf (any object with the JAX
    ``QuantizedWeight`` fields) becomes a port ``QuantizedWeight`` on
    ``device``; ``dtype`` does not apply to it."""
    return {layer: {w: _leaf(a, device, dtype) for w, a in lp.items()}
            for layer, lp in params_np.items()}


def _leaf(a, device, dtype):
    if all(hasattr(a, f) for f in ("qtype", "q", "scale", "rows", "dtype")):
        return QuantizedWeight(
            str(a.qtype), _tensor(a.q, device, torch.int8),
            _tensor(a.scale, device, torch.float32), int(a.rows),
            str(a.dtype))
    return _tensor(a, device, dtype)


def _tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))     # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)


def load_params(model, params: Mapping[str, Mapping[str, object]]) -> int:
    """Copy every (layer, weight) of ``params`` (arrays, tensors or
    QuantizedWeights) into the compiled ``model``, in the model's dtypes;
    returns the count. A QuantizedWeight's payload and scale are copied
    into the model's quantized parameter of the same qtype and shape."""
    n = 0
    for layer, lp in params.items():
        for w, a in lp.items():
            if is_quantized(a):
                old = model.params[layer][w]
                if not (is_quantized(old) and old.qtype == a.qtype
                        and old.shape == a.shape):
                    raise ValueError(f"({layer}, {w}): {a} does not fit the "
                                     f"model's {type(old).__name__} of shape "
                                     f"{tuple(old.shape)}")
                old.q.copy_(a.q)
                old.scale.copy_(a.scale)
            else:
                model.set_parameter_by_key((layer, w), a)
            n += 1
    return n
