"""HuggingFace state-dict loading (counterpart of
``flexflow_tpu/models/hf_utils.py``), and the pieces the family builders
share: HF tensors (torch or numpy) map straight into the model's
parameters through a name map; each value is copied into the existing
parameter in its dtype and on its device."""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from flexflow_tpu_torch.ffconst import InferenceMode


def _to_numpy(t) -> np.ndarray:
    """An HF tensor (torch, numpy or array-like) as numpy; a torch tensor
    comes to the CPU in fp32, as in the JAX package."""
    if isinstance(t, np.ndarray):
        return t
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu").float().numpy()
    return np.asarray(t)


def as_torch(t) -> torch.Tensor:
    """An HF tensor as a torch tensor: a torch tensor as it is (on its
    device, so a state dict on the card is split and copied there), an
    array on the CPU (numpy has no bfloat16: ml_dtypes' goes through
    fp32, exactly)."""
    if isinstance(t, torch.Tensor):
        return t
    a = np.asarray(t)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.as_tensor(a)


def hf_getter(hf):
    """``get(key, default)`` over an HF config given as a dict or as an
    object with the HF attribute names."""
    if isinstance(hf, dict):
        return hf.get
    return lambda k, d=None: getattr(hf, k, d)


def attention_builder(model, mode: InferenceMode, multiquery: bool):
    """The serving-attention builder of ``mode``: tree verify, draft, or
    incremental; the multi-query form takes ``num_kv_heads``."""
    kind = {InferenceMode.TREE_VERIFY_MODE: "tree_inc",
            InferenceMode.BEAM_SEARCH_MODE: "spec_inc"}.get(mode, "inc")
    form = "multiquery" if multiquery else "multihead"
    return getattr(model, f"{kind}_{form}_self_attention")


def serving_head(model, logits, mode: InferenceMode,
                 generation_config):
    """Top-p Sampling for a sampled incremental graph, argmax otherwise."""
    from flexflow_tpu_torch.serve.batch_config import GenerationConfig

    gen = generation_config or GenerationConfig()
    if gen.do_sample and mode == InferenceMode.INC_DECODING_MODE:
        return model.sampling(logits, top_p=gen.topp,
                              temperature=gen.temperature)
    return model.argmax(logits)


def tie_lm_head(state_dict: Dict[str, Any], wte_key: str,
                lm_head_key: str = "lm_head.weight") -> None:
    """Materialize a tied lm_head from the word-embedding table."""
    if lm_head_key not in state_dict and wte_key in state_dict:
        state_dict[lm_head_key] = state_dict[wte_key]


def load_hf_state_dict(model, state_dict: Mapping[str, Any],
                       weight_map: Dict[str, tuple], strict: bool = True,
                       preprocess=None) -> int:
    """Copy HF weights into a compiled FFModel's parameters.

    weight_map: hf_key -> (layer_name, weight_name, transpose). Returns
    the number of tensors loaded. ``preprocess(dict)`` mutates a shallow
    copy first (fused-qkv splits, tied embeddings)."""
    if preprocess is not None:
        state_dict = dict(state_dict)
        preprocess(state_dict)
    loaded = 0
    missing = []
    for hf_key, (layer, wname, transpose) in weight_map.items():
        if hf_key not in state_dict:
            missing.append(hf_key)
            continue
        arr = as_torch(state_dict[hf_key])
        model.set_parameter_by_key((layer, wname), arr.T if transpose else arr)
        loaded += 1
    if strict and missing:
        raise KeyError(f"missing {len(missing)} HF weights, e.g. {missing[:5]}")
    return loaded
