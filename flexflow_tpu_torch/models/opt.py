"""OPT decoder for serving (counterpart of ``flexflow_tpu/models/opt.py``):
token + learned position embeddings (positions fed + 2), an optional
``project_in``/``project_out`` pair, pre- or post-LayerNorm blocks,
attention with qkv/out biases and the query scaled by head_dim^-0.5
(``scaling_query``, no ``qk_prod_scaling``), a ReLU FFN through
``dense(..., AC_MODE_RELU)``, and an fp32-logits head tied to the token
embedding. Layer names follow the HF checkpoint layout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from flexflow_tpu_torch.ffconst import ActiMode, DataType, InferenceMode
from flexflow_tpu_torch.models.hf_utils import (attention_builder, hf_getter,
                                                serving_head, tie_lm_head)
from flexflow_tpu_torch.serve.batch_config import GenerationConfig


@dataclasses.dataclass
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 768
    ffn_dim: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 2048
    word_embed_proj_dim: int = 768
    do_layer_norm_before: bool = True
    layer_norm_elementwise_affine: bool = True
    enable_bias: bool = True

    @classmethod
    def from_hf_config(cls, hf) -> "OPTConfig":
        get = hf_getter(hf)
        return cls(
            vocab_size=get("vocab_size", 50272),
            hidden_size=get("hidden_size", 768),
            ffn_dim=get("ffn_dim", 3072),
            num_hidden_layers=get("num_hidden_layers", 12),
            num_attention_heads=get("num_attention_heads", 12),
            max_position_embeddings=get("max_position_embeddings", 2048),
            word_embed_proj_dim=get("word_embed_proj_dim")
            or get("hidden_size", 768),
            do_layer_norm_before=get("do_layer_norm_before", True),
            layer_norm_elementwise_affine=get(
                "layer_norm_elementwise_affine", True),
            enable_bias=get("enable_bias", True),
        )


def create_opt_model(model, config: OPTConfig,
                     mode: InferenceMode = InferenceMode.INC_DECODING_MODE,
                     generation_config: Optional[GenerationConfig] = None,
                     data_type: DataType = DataType.DT_FLOAT):
    """Record the OPT decoder graph into ``model`` (an FFModel)."""
    c = config
    R = model.config.max_requests_per_batch
    head_dim = c.hidden_size // c.num_attention_heads
    tokens = model.create_tensor([R, 1], DataType.DT_INT32)
    positions = model.create_position_tensor([R, 1])
    model.set_position_offset(2)

    tok = model.embedding(tokens, c.vocab_size, c.word_embed_proj_dim,
                          dtype=data_type, name="embed_tokens")
    if c.word_embed_proj_dim != c.hidden_size:
        tok = model.dense(tok, c.hidden_size, use_bias=False,
                          datatype=data_type, name="project_in")
    pos = model.embedding(positions, c.max_position_embeddings + 2,
                          c.hidden_size, dtype=data_type,
                          name="embed_positions")
    h = model.add(tok, pos)
    attn_builder = attention_builder(model, mode, multiquery=False)

    def ln(x, name):
        return model.layer_norm(
            x, axes=[-1], use_bias=True,
            elementwise_affine=c.layer_norm_elementwise_affine, name=name)

    for i in range(c.num_hidden_layers):
        residual = h
        x = (ln(h, f"layers.{i}.self_attn_layer_norm")
             if c.do_layer_norm_before else h)
        attn = attn_builder(
            x, c.hidden_size, c.num_attention_heads, data_type=data_type,
            bias=c.enable_bias, apply_rotary_embedding=False,
            scaling_query=True, scaling_factor=head_dim ** -0.5,
            qk_prod_scaling=False, name=f"layers.{i}.self_attn")
        h = model.add(residual, attn)
        if not c.do_layer_norm_before:
            h = ln(h, f"layers.{i}.self_attn_layer_norm")
        residual = h
        x = (ln(h, f"layers.{i}.final_layer_norm")
             if c.do_layer_norm_before else h)
        fc1 = model.dense(x, c.ffn_dim, ActiMode.AC_MODE_RELU,
                          use_bias=c.enable_bias, datatype=data_type,
                          name=f"layers.{i}.fc1")
        fc2 = model.dense(fc1, c.hidden_size, use_bias=c.enable_bias,
                          datatype=data_type, name=f"layers.{i}.fc2")
        h = model.add(residual, fc2)
        if not c.do_layer_norm_before:
            h = ln(h, f"layers.{i}.final_layer_norm")

    if c.do_layer_norm_before:
        h = ln(h, "final_layer_norm")
    if c.word_embed_proj_dim != c.hidden_size:
        h = model.dense(h, c.word_embed_proj_dim, use_bias=False,
                        datatype=data_type, name="project_out")
    logits = model.dense(h, c.vocab_size, use_bias=False, datatype=data_type,
                         keep_f32_logits=True, name="lm_head")
    return serving_head(model, logits, mode, generation_config)


def preprocess_hf_state_dict(sd, config: Optional[OPTConfig] = None):
    tie_lm_head(sd, "model.decoder.embed_tokens.weight")


def hf_weight_map(config: OPTConfig):
    """HF state-dict key -> (layer_name, weight_name, transpose?)."""
    pre = "model.decoder"
    m = {f"{pre}.embed_tokens.weight": ("embed_tokens", "weight", False),
         f"{pre}.embed_positions.weight": ("embed_positions", "weight", False),
         "lm_head.weight": ("lm_head", "kernel", True)}
    if config.do_layer_norm_before:
        m[f"{pre}.final_layer_norm.weight"] = ("final_layer_norm", "gamma",
                                               False)
        m[f"{pre}.final_layer_norm.bias"] = ("final_layer_norm", "beta",
                                             False)
    if config.word_embed_proj_dim != config.hidden_size:
        m[f"{pre}.project_in.weight"] = ("project_in", "kernel", True)
        m[f"{pre}.project_out.weight"] = ("project_out", "kernel", True)
    for i in range(config.num_hidden_layers):
        hf, ff = f"{pre}.layers.{i}", f"layers.{i}"
        for p, w, b in (("q_proj", "wq", "bq"), ("k_proj", "wk", "bk"),
                        ("v_proj", "wv", "bv"), ("out_proj", "wo", "bo")):
            m[f"{hf}.self_attn.{p}.weight"] = (f"{ff}.self_attn", w, True)
            if config.enable_bias:
                m[f"{hf}.self_attn.{p}.bias"] = (f"{ff}.self_attn", b, False)
        for p in ("fc1", "fc2"):
            m[f"{hf}.{p}.weight"] = (f"{ff}.{p}", "kernel", True)
            if config.enable_bias:
                m[f"{hf}.{p}.bias"] = (f"{ff}.{p}", "bias", False)
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            m[f"{hf}.{ln}.weight"] = (f"{ff}.{ln}", "gamma", False)
            m[f"{hf}.{ln}.bias"] = (f"{ff}.{ln}", "beta", False)
    return m
