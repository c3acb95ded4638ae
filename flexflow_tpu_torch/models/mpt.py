"""MPT decoder for serving (counterpart of ``flexflow_tpu/models/mpt.py``):
ALiBi position bias in place of rotary or learned positions
(``position_bias=True``), the query scaled by head_dim^-0.5
(``scaling_query``, no ``qk_prod_scaling``), bias-free LayerNorms and
projections (``no_bias``), a GELU FFN, and a head tied to the word
embedding.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from flexflow_tpu_torch.ffconst import DataType, InferenceMode
from flexflow_tpu_torch.models.hf_utils import (as_torch, attention_builder,
                                                hf_getter, serving_head,
                                                tie_lm_head)
from flexflow_tpu_torch.serve.batch_config import GenerationConfig


@dataclasses.dataclass
class MPTConfig:
    vocab_size: int = 50368
    hidden_size: int = 4096          # d_model
    n_heads: int = 32
    n_layers: int = 32
    expansion_ratio: int = 4
    max_seq_len: int = 2048
    no_bias: bool = True
    layer_norm_epsilon: float = 1e-5

    @classmethod
    def from_hf_config(cls, hf) -> "MPTConfig":
        get = hf_getter(hf)
        return cls(
            vocab_size=get("vocab_size", 50368),
            hidden_size=get("d_model") or get("hidden_size", 4096),
            n_heads=get("n_heads") or get("num_attention_heads", 32),
            n_layers=get("n_layers") or get("num_hidden_layers", 32),
            expansion_ratio=get("expansion_ratio", 4),
            max_seq_len=get("max_seq_len") or get(
                "max_position_embeddings", 2048),
            no_bias=get("no_bias", True),
            layer_norm_epsilon=get("layer_norm_epsilon", 1e-5),
        )


def create_mpt_model(model, config: MPTConfig,
                     mode: InferenceMode = InferenceMode.INC_DECODING_MODE,
                     generation_config: Optional[GenerationConfig] = None,
                     data_type: DataType = DataType.DT_FLOAT):
    """Record the MPT decoder graph into ``model`` (an FFModel)."""
    c = config
    R = model.config.max_requests_per_batch
    head_dim = c.hidden_size // c.n_heads
    tokens = model.create_tensor([R, 1], DataType.DT_INT32)
    h = model.embedding(tokens, c.vocab_size, c.hidden_size,
                        dtype=data_type, name="wte")
    attn_builder = attention_builder(model, mode, multiquery=False)
    use_bias = not c.no_bias

    def ln(x, name):
        return model.layer_norm(x, axes=[-1], eps=c.layer_norm_epsilon,
                                use_bias=use_bias, name=name)

    for i in range(c.n_layers):
        attn = attn_builder(
            ln(h, f"blocks.{i}.norm_1"), c.hidden_size, c.n_heads,
            data_type=data_type, bias=use_bias, apply_rotary_embedding=False,
            scaling_query=True, scaling_factor=head_dim ** -0.5,
            qk_prod_scaling=False, position_bias=True,
            name=f"blocks.{i}.attn")
        h = model.add(h, attn)
        up = model.dense(ln(h, f"blocks.{i}.norm_2"),
                         c.expansion_ratio * c.hidden_size,
                         use_bias=use_bias, datatype=data_type,
                         name=f"blocks.{i}.ffn.up_proj")
        down = model.dense(model.gelu(up), c.hidden_size, use_bias=use_bias,
                           datatype=data_type,
                           name=f"blocks.{i}.ffn.down_proj")
        h = model.add(h, down)

    h = ln(h, "norm_f")
    logits = model.dense(h, c.vocab_size, use_bias=False, datatype=data_type,
                         keep_f32_logits=True, name="lm_head")
    return serving_head(model, logits, mode, generation_config)


def preprocess_hf_state_dict(sd, config: MPTConfig):
    """Split the fused ``Wqkv`` into q/k/v pseudo-keys (on the tensors'
    own device) and tie the head."""
    d = config.hidden_size
    for i in range(config.n_layers):
        base = f"transformer.blocks.{i}.attn"
        for suffix in ("weight",) + (() if config.no_bias else ("bias",)):
            key = f"{base}.Wqkv.{suffix}"
            if key not in sd:
                continue
            fused = as_torch(sd.pop(key))
            sd[f"{base}.q_proj.{suffix}"] = fused[:d]
            sd[f"{base}.k_proj.{suffix}"] = fused[d: 2 * d]
            sd[f"{base}.v_proj.{suffix}"] = fused[2 * d:]
    tie_lm_head(sd, "transformer.wte.weight")


def hf_weight_map(config: MPTConfig):
    """HF state-dict key -> (layer_name, weight_name, transpose?), after
    ``preprocess_hf_state_dict``."""
    c = config
    m = {"transformer.wte.weight": ("wte", "weight", False),
         "transformer.norm_f.weight": ("norm_f", "gamma", False),
         "lm_head.weight": ("lm_head", "kernel", True)}
    if not c.no_bias:
        m["transformer.norm_f.bias"] = ("norm_f", "beta", False)
    for i in range(c.n_layers):
        hf, ff = f"transformer.blocks.{i}", f"blocks.{i}"
        for p, w, b in (("q_proj", "wq", "bq"), ("k_proj", "wk", "bk"),
                        ("v_proj", "wv", "bv"), ("out_proj", "wo", "bo")):
            m[f"{hf}.attn.{p}.weight"] = (f"{ff}.attn", w, True)
            if not c.no_bias:
                m[f"{hf}.attn.{p}.bias"] = (f"{ff}.attn", b, False)
        for p in ("up_proj", "down_proj"):
            m[f"{hf}.ffn.{p}.weight"] = (f"{ff}.ffn.{p}", "kernel", True)
            if not c.no_bias:
                m[f"{hf}.ffn.{p}.bias"] = (f"{ff}.ffn.{p}", "bias", False)
        for ln in ("norm_1", "norm_2"):
            m[f"{hf}.{ln}.weight"] = (f"{ff}.{ln}", "gamma", False)
            if not c.no_bias:
                m[f"{hf}.{ln}.bias"] = (f"{ff}.{ln}", "beta", False)
    return m
