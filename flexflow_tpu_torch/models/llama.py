"""LLaMA-family decoder for serving (counterpart of
``flexflow_tpu/models/llama.py``): embedding -> N x (RMSNorm -> rotary
GQA attention -> residual -> RMSNorm -> SwiGLU MLP -> residual) -> final
RMSNorm -> lm_head (fp32 logits) -> a head by mode: top-p Sampling,
a beam draft's packed top-W, or argmax.

Layer names follow the HF checkpoint layout (``layers.{i}.self_attn``
etc.), so ``hf_weight_map`` is a mechanical rename and both packages name
their parameters alike.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from flexflow_tpu_torch.ffconst import DataType, InferenceMode
from flexflow_tpu_torch.serve.batch_config import GenerationConfig


@dataclasses.dataclass
class LLAMAConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 2048

    @classmethod
    def from_hf_config(cls, hf) -> "LLAMAConfig":
        """Accepts a plain dict or an object with the HF attribute names."""
        if isinstance(hf, dict):
            get = hf.get
        else:
            def get(k, d=None):
                return getattr(hf, k, d)
        return cls(
            vocab_size=get("vocab_size", 32000),
            hidden_size=get("hidden_size", 4096),
            intermediate_size=get("intermediate_size", 11008),
            num_hidden_layers=get("num_hidden_layers", 32),
            num_attention_heads=get("num_attention_heads", 32),
            num_key_value_heads=get("num_key_value_heads")
            or get("num_attention_heads", 32),
            rms_norm_eps=get("rms_norm_eps", 1e-5),
            rope_theta=get("rope_theta", 10000.0),
            max_position_embeddings=get("max_position_embeddings", 2048),
        )


def create_llama_model(model, config: LLAMAConfig,
                       mode: InferenceMode = InferenceMode.INC_DECODING_MODE,
                       generation_config: Optional[GenerationConfig] = None,
                       data_type: DataType = DataType.DT_FLOAT):
    """Record the LLaMA decoder graph into ``model`` (an FFModel): tree
    attention in TREE_VERIFY_MODE (the speculative verifier), draft
    attention in BEAM_SEARCH_MODE, incremental attention otherwise.

    The head: top-p Sampling in INC_DECODING_MODE with ``do_sample``; in
    BEAM_SEARCH_MODE at ``max_beam_width`` W > 1 one fp32 tensor
    ``[..., 2W]`` = [top-W probabilities, top-W ids as floats] (ids are
    exact in fp32 below 2^24); argmax otherwise."""
    c = config
    R = model.config.max_requests_per_batch
    tokens = model.create_tensor([R, 1], DataType.DT_INT32)  # Q is dynamic

    h = model.embedding(tokens, c.vocab_size, c.hidden_size,
                        dtype=data_type, name="embed_tokens")
    if mode == InferenceMode.TREE_VERIFY_MODE:
        attn_builder = model.tree_inc_multiquery_self_attention
    elif mode == InferenceMode.BEAM_SEARCH_MODE:
        attn_builder = model.spec_inc_multiquery_self_attention
    else:
        attn_builder = model.inc_multiquery_self_attention
    for i in range(c.num_hidden_layers):
        x = model.rms_norm(h, eps=c.rms_norm_eps, dim=c.hidden_size,
                           name=f"layers.{i}.input_layernorm")
        attn = attn_builder(
            x, c.hidden_size, c.num_attention_heads, c.num_key_value_heads,
            data_type=data_type, apply_rotary_embedding=True,
            rope_theta=c.rope_theta, name=f"layers.{i}.self_attn")
        h = model.add(h, attn)
        x = model.rms_norm(h, eps=c.rms_norm_eps, dim=c.hidden_size,
                           name=f"layers.{i}.post_attention_layernorm")
        gate = model.dense(x, c.intermediate_size, use_bias=False,
                           datatype=data_type, name=f"layers.{i}.mlp.gate_proj")
        up = model.dense(x, c.intermediate_size, use_bias=False,
                         datatype=data_type, name=f"layers.{i}.mlp.up_proj")
        act = model.sigmoid_silu_multi(gate, up)
        down = model.dense(act, c.hidden_size, use_bias=False,
                           datatype=data_type, name=f"layers.{i}.mlp.down_proj")
        h = model.add(h, down)

    x = model.rms_norm(h, eps=c.rms_norm_eps, dim=c.hidden_size, name="norm")
    logits = model.dense(x, c.vocab_size, use_bias=False,
                         datatype=data_type, keep_f32_logits=True,
                         name="lm_head")
    gen = generation_config or GenerationConfig()
    width = model.config.max_beam_width
    if gen.do_sample and mode == InferenceMode.INC_DECODING_MODE:
        return model.sampling(logits, top_p=gen.topp,
                              temperature=gen.temperature)
    if mode == InferenceMode.BEAM_SEARCH_MODE and width > 1:
        probs, ids = model.arg_top_k(logits, k=width,
                                     speculative_decoding=True)
        return model.concat([probs, model.cast(ids, DataType.DT_FLOAT)],
                            axis=-1)
    return model.argmax(logits)


def preprocess_hf_state_dict(sd, config: "LLAMAConfig" = None):
    from flexflow_tpu_torch.models.hf_utils import tie_lm_head

    tie_lm_head(sd, "model.embed_tokens.weight")


def hf_weight_map(config: LLAMAConfig):
    """HF state-dict key -> (layer_name, weight_name, transpose?)."""
    m = {"model.embed_tokens.weight": ("embed_tokens", "weight", False),
         "model.norm.weight": ("norm", "weight", False),
         "lm_head.weight": ("lm_head", "kernel", True)}
    for i in range(config.num_hidden_layers):
        hf, ff = f"model.layers.{i}", f"layers.{i}"
        for p, w in (("q_proj", "wq"), ("k_proj", "wk"),
                     ("v_proj", "wv"), ("o_proj", "wo")):
            m[f"{hf}.self_attn.{p}.weight"] = (f"{ff}.self_attn", w, True)
        for p in ("gate_proj", "up_proj", "down_proj"):
            m[f"{hf}.mlp.{p}.weight"] = (f"{ff}.mlp.{p}", "kernel", True)
        m[f"{hf}.input_layernorm.weight"] = (
            f"{ff}.input_layernorm", "weight", False)
        m[f"{hf}.post_attention_layernorm.weight"] = (
            f"{ff}.post_attention_layernorm", "weight", False)
    return m
