"""StarCoder (GPT-BigCode) decoder for serving (counterpart of
``flexflow_tpu/models/starcoder.py``): learned absolute position
embeddings (positions fed + 0), multi-query attention (one KV head),
biased projections and LayerNorms, a tanh-GELU MLP (HF
``gelu_pytorch_tanh``) and a head tied to ``wte``.
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
class STARCODERConfig:
    vocab_size: int = 49152
    hidden_size: int = 6144          # n_embd
    intermediate_size: int = 24576   # n_inner
    num_hidden_layers: int = 40      # n_layer
    num_attention_heads: int = 48    # n_head
    max_position_embeddings: int = 8192  # n_positions
    layer_norm_epsilon: float = 1e-5
    multi_query: bool = True

    @classmethod
    def from_hf_config(cls, hf) -> "STARCODERConfig":
        get = hf_getter(hf)
        n_embd = get("n_embd") or get("hidden_size", 6144)
        return cls(
            vocab_size=get("vocab_size", 49152),
            hidden_size=n_embd,
            intermediate_size=get("n_inner") or get("intermediate_size")
            or 4 * n_embd,
            num_hidden_layers=get("n_layer") or get("num_hidden_layers", 40),
            num_attention_heads=get("n_head") or get(
                "num_attention_heads", 48),
            max_position_embeddings=get("n_positions") or get(
                "max_position_embeddings", 8192),
            layer_norm_epsilon=get("layer_norm_epsilon", 1e-5),
            multi_query=get("multi_query", True),
        )


def create_starcoder_model(
        model, config: STARCODERConfig,
        mode: InferenceMode = InferenceMode.INC_DECODING_MODE,
        generation_config: Optional[GenerationConfig] = None,
        data_type: DataType = DataType.DT_FLOAT):
    """Record the StarCoder decoder graph into ``model`` (an FFModel)."""
    c = config
    R = model.config.max_requests_per_batch
    num_kv_heads = 1 if c.multi_query else c.num_attention_heads
    tokens = model.create_tensor([R, 1], DataType.DT_INT32)
    positions = model.create_position_tensor([R, 1])
    model.set_position_offset(0)

    tok = model.embedding(tokens, c.vocab_size, c.hidden_size,
                          dtype=data_type, name="wte")
    pos = model.embedding(positions, c.max_position_embeddings, c.hidden_size,
                          dtype=data_type, name="wpe")
    h = model.add(tok, pos)
    attn_builder = attention_builder(model, mode, multiquery=True)

    def ln(x, name):
        return model.layer_norm(x, axes=[-1], eps=c.layer_norm_epsilon,
                                use_bias=True, name=name)

    for i in range(c.num_hidden_layers):
        attn = attn_builder(
            ln(h, f"h.{i}.ln_1"), c.hidden_size, c.num_attention_heads,
            num_kv_heads, data_type=data_type, bias=True,
            apply_rotary_embedding=False, name=f"h.{i}.attn")
        h = model.add(h, attn)
        fc = model.dense(ln(h, f"h.{i}.ln_2"), c.intermediate_size,
                         use_bias=True, datatype=data_type,
                         name=f"h.{i}.mlp.c_fc")
        proj = model.dense(model.gelu(fc, approximate=True), c.hidden_size,
                           use_bias=True, datatype=data_type,
                           name=f"h.{i}.mlp.c_proj")
        h = model.add(h, proj)

    h = ln(h, "ln_f")
    logits = model.dense(h, c.vocab_size, use_bias=False, datatype=data_type,
                         keep_f32_logits=True, name="lm_head")
    return serving_head(model, logits, mode, generation_config)


def preprocess_hf_state_dict(sd, config: STARCODERConfig):
    """Split the fused ``c_attn`` into q/k/v pseudo-keys (on the tensors'
    own device) and tie the head. Multi-query fuses q (n_embd rows), k and
    v (head_dim rows each); multi-head interleaves [q_h | k_h | v_h] per
    head."""
    c = config
    hd = c.hidden_size // c.num_attention_heads
    H, d = c.num_attention_heads, c.hidden_size
    for i in range(c.num_hidden_layers):
        base = f"transformer.h.{i}.attn"
        for suffix in ("weight", "bias"):
            key = f"{base}.c_attn.{suffix}"
            if key not in sd:
                continue
            fused = as_torch(sd.pop(key))
            cols = tuple(fused.shape[1:])
            if c.multi_query:
                q, k, v = fused[:d], fused[d: d + hd], fused[d + hd:]
            else:
                f = fused.reshape((H, 3, hd) + cols)
                q = f[:, 0].reshape((H * hd,) + cols)
                k = f[:, 1].reshape((H * hd,) + cols)
                v = f[:, 2].reshape((H * hd,) + cols)
            sd[f"{base}.q_proj.{suffix}"] = q
            sd[f"{base}.k_proj.{suffix}"] = k
            sd[f"{base}.v_proj.{suffix}"] = v
    tie_lm_head(sd, "transformer.wte.weight")


def hf_weight_map(config: STARCODERConfig):
    """HF state-dict key -> (layer_name, weight_name, transpose?), after
    ``preprocess_hf_state_dict``."""
    c = config
    m = {"transformer.wte.weight": ("wte", "weight", False),
         "transformer.wpe.weight": ("wpe", "weight", False),
         "transformer.ln_f.weight": ("ln_f", "gamma", False),
         "transformer.ln_f.bias": ("ln_f", "beta", False),
         "lm_head.weight": ("lm_head", "kernel", True)}
    for i in range(c.num_hidden_layers):
        hf, ff = f"transformer.h.{i}", f"h.{i}"
        for p, w, b in (("q_proj", "wq", "bq"), ("k_proj", "wk", "bk"),
                        ("v_proj", "wv", "bv"), ("c_proj", "wo", "bo")):
            m[f"{hf}.attn.{p}.weight"] = (f"{ff}.attn", w, True)
            m[f"{hf}.attn.{p}.bias"] = (f"{ff}.attn", b, False)
        for p in ("c_fc", "c_proj"):
            m[f"{hf}.mlp.{p}.weight"] = (f"{ff}.mlp.{p}", "kernel", True)
            m[f"{hf}.mlp.{p}.bias"] = (f"{ff}.mlp.{p}", "bias", False)
        for ln in ("ln_1", "ln_2"):
            m[f"{hf}.{ln}.weight"] = (f"{ff}.{ln}", "gamma", False)
            m[f"{hf}.{ln}.bias"] = (f"{ff}.{ln}", "beta", False)
    return m
