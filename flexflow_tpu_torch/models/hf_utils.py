"""HuggingFace state-dict loading (counterpart of
``flexflow_tpu/models/hf_utils.py``): HF tensors (torch or numpy) map
straight into the model's parameters through a name map; each value is
copied into the existing parameter in its dtype and on its device."""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch


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
    copy first (tied embeddings)."""
    if preprocess is not None:
        state_dict = dict(state_dict)
        preprocess(state_dict)
    loaded = 0
    missing = []
    for hf_key, (layer, wname, transpose) in weight_map.items():
        if hf_key not in state_dict:
            missing.append(hf_key)
            continue
        arr = torch.as_tensor(state_dict[hf_key])
        model.set_parameter_by_key((layer, wname), arr.T if transpose else arr)
        loaded += 1
    if strict and missing:
        raise KeyError(f"missing {len(missing)} HF weights, e.g. {missing[:5]}")
    return loaded
