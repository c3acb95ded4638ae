"""Serving model zoo of the PyTorch/CUDA port: LLaMA only in this slice.
``FAMILIES`` maps the HF ``model_type`` to the family."""

import dataclasses
from typing import Callable, Optional

from flexflow_tpu_torch.models import llama as _llama
from flexflow_tpu_torch.models.hf_utils import load_hf_state_dict
from flexflow_tpu_torch.models.llama import LLAMAConfig, create_llama_model


@dataclasses.dataclass(frozen=True)
class ModelFamily:
    name: str
    config_cls: type
    build: Callable          # (ffmodel, config, mode=..., ...) -> out tensor
    hf_weight_map: Callable  # (config) -> {hf_key: (layer, weight, transpose)}
    preprocess: Optional[Callable] = None  # (state_dict, config) -> None

    def load_hf(self, ffmodel, config, state_dict, strict: bool = True) -> int:
        pre = ((lambda sd: self.preprocess(sd, config))
               if self.preprocess else None)
        return load_hf_state_dict(ffmodel, state_dict,
                                  self.hf_weight_map(config),
                                  strict=strict, preprocess=pre)


FAMILIES = {
    "llama": ModelFamily("llama", LLAMAConfig, create_llama_model,
                         _llama.hf_weight_map,
                         _llama.preprocess_hf_state_dict),
}


def family_for_hf_config(hf_config) -> ModelFamily:
    """Resolve an HF config (dict or object) to its model family."""
    mt = (hf_config.get("model_type") if isinstance(hf_config, dict)
          else getattr(hf_config, "model_type", None))
    if mt not in FAMILIES:
        raise ValueError(f"unsupported model_type {mt!r}; the PyTorch port "
                         f"serves {sorted(FAMILIES)}")
    return FAMILIES[mt]


__all__ = ["FAMILIES", "LLAMAConfig", "ModelFamily", "create_llama_model",
           "family_for_hf_config", "load_hf_state_dict"]
