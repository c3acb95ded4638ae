"""Serving model zoo of the PyTorch/CUDA port (counterpart of
``flexflow_tpu/models/__init__.py``): LLaMA, OPT, Falcon, MPT and
StarCoder (GPT-BigCode). Each family is a builder that records the decoder
graph through the FFModel op-builder, an HF state-dict name map and a
preprocessor (fused-qkv splits, tied heads). ``FAMILIES`` maps the HF
``model_type`` to the family, the legacy names included; HF-layout
checkpoints on disk are ``checkpoint_store``'s."""

import dataclasses
from typing import Callable, Optional

from flexflow_tpu_torch.models import falcon as _falcon
from flexflow_tpu_torch.models import llama as _llama
from flexflow_tpu_torch.models import mpt as _mpt
from flexflow_tpu_torch.models import opt as _opt
from flexflow_tpu_torch.models import starcoder as _starcoder
from flexflow_tpu_torch.models.falcon import FalconConfig, create_falcon_model
from flexflow_tpu_torch.models.hf_utils import load_hf_state_dict
from flexflow_tpu_torch.models.llama import LLAMAConfig, create_llama_model
from flexflow_tpu_torch.models.mpt import MPTConfig, create_mpt_model
from flexflow_tpu_torch.models.opt import OPTConfig, create_opt_model
from flexflow_tpu_torch.models.starcoder import (STARCODERConfig,
                                                 create_starcoder_model)


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
    "opt": ModelFamily("opt", OPTConfig, create_opt_model,
                       _opt.hf_weight_map, _opt.preprocess_hf_state_dict),
    "falcon": ModelFamily("falcon", FalconConfig, create_falcon_model,
                          _falcon.hf_weight_map,
                          _falcon.preprocess_hf_state_dict),
    "mpt": ModelFamily("mpt", MPTConfig, create_mpt_model,
                       _mpt.hf_weight_map, _mpt.preprocess_hf_state_dict),
    "gpt_bigcode": ModelFamily("gpt_bigcode", STARCODERConfig,
                               create_starcoder_model,
                               _starcoder.hf_weight_map,
                               _starcoder.preprocess_hf_state_dict),
}
FAMILIES["starcoder"] = FAMILIES["gpt_bigcode"]
# legacy HF names of early Falcon checkpoints (tiiuae/falcon-7b pre-rename)
FAMILIES["RefinedWeb"] = FAMILIES["RefinedWebModel"] = FAMILIES["falcon"]


def family_for_hf_config(hf_config) -> ModelFamily:
    """Resolve an HF config (dict or object) to its model family."""
    mt = (hf_config.get("model_type") if isinstance(hf_config, dict)
          else getattr(hf_config, "model_type", None))
    if mt not in FAMILIES:
        raise ValueError(
            f"unsupported model_type {mt!r}; supported: "
            f"{sorted(set(f.name for f in FAMILIES.values()))}")
    return FAMILIES[mt]


__all__ = ["FAMILIES", "FalconConfig", "LLAMAConfig", "MPTConfig",
           "ModelFamily", "OPTConfig", "STARCODERConfig",
           "create_falcon_model", "create_llama_model", "create_mpt_model",
           "create_opt_model", "create_starcoder_model",
           "family_for_hf_config", "load_hf_state_dict"]
