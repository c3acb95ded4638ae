"""Falcon decoder for serving (counterpart of
``flexflow_tpu/models/falcon.py``): rotary multi-query or grouped-query
attention (``num_kv_heads``), GELU MLP, optional biases, a head tied to the
word embedding. Three block layouts: the parallel attention + MLP block
with one shared input LayerNorm (Falcon-7B), the new decoder architecture
with separate ``ln_attn``/``ln_mlp`` (40B-style), and the sequential block.
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
class FalconConfig:
    vocab_size: int = 65024
    hidden_size: int = 4544
    num_hidden_layers: int = 32
    num_attention_heads: int = 71
    num_kv_heads: int = 1
    layer_norm_epsilon: float = 1e-5
    rope_theta: float = 10000.0
    bias: bool = False
    parallel_attn: bool = True
    new_decoder_architecture: bool = False

    @classmethod
    def from_hf_config(cls, hf) -> "FalconConfig":
        get = hf_getter(hf)
        n_head = get("num_attention_heads") or get("n_head", 71)
        new_arch = get("new_decoder_architecture", False)
        multi_query = get("multi_query", True)
        if new_arch or not multi_query:
            n_kv = get("num_kv_heads") or get("n_head_kv") or n_head
        else:
            n_kv = 1
        return cls(
            vocab_size=get("vocab_size", 65024),
            hidden_size=get("hidden_size", 4544),
            num_hidden_layers=get("num_hidden_layers") or get("n_layer", 32),
            num_attention_heads=n_head,
            num_kv_heads=n_kv,
            layer_norm_epsilon=get("layer_norm_epsilon", 1e-5),
            rope_theta=get("rope_theta", 10000.0),
            bias=get("bias", False),
            parallel_attn=get("parallel_attn", True),
            new_decoder_architecture=new_arch,
        )


def create_falcon_model(model, config: FalconConfig,
                        mode: InferenceMode = InferenceMode.INC_DECODING_MODE,
                        generation_config: Optional[GenerationConfig] = None,
                        data_type: DataType = DataType.DT_FLOAT):
    """Record the Falcon decoder graph into ``model`` (an FFModel)."""
    c = config
    R = model.config.max_requests_per_batch
    tokens = model.create_tensor([R, 1], DataType.DT_INT32)
    h = model.embedding(tokens, c.vocab_size, c.hidden_size,
                        dtype=data_type, name="word_embeddings")
    attn_builder = attention_builder(model, mode, multiquery=True)

    def ln(x, name):
        return model.layer_norm(x, axes=[-1], eps=c.layer_norm_epsilon,
                                use_bias=True, name=name)

    def mlp(x, i):
        up = model.dense(x, 4 * c.hidden_size, use_bias=c.bias,
                         datatype=data_type, name=f"h.{i}.mlp.dense_h_to_4h")
        return model.dense(model.gelu(up), c.hidden_size, use_bias=c.bias,
                           datatype=data_type,
                           name=f"h.{i}.mlp.dense_4h_to_h")

    for i in range(c.num_hidden_layers):
        if c.new_decoder_architecture:
            attn_in = ln(h, f"h.{i}.ln_attn")
            mlp_in = ln(h, f"h.{i}.ln_mlp")
        else:
            attn_in = ln(h, f"h.{i}.input_layernorm")
            mlp_in = attn_in if c.parallel_attn else None
        attn = attn_builder(
            attn_in, c.hidden_size, c.num_attention_heads, c.num_kv_heads,
            data_type=data_type, bias=c.bias, apply_rotary_embedding=True,
            rope_theta=c.rope_theta, name=f"h.{i}.self_attention")
        if mlp_in is None:   # the sequential block
            h = model.add(h, attn)
            h = model.add(h, mlp(ln(h, f"h.{i}.post_attention_layernorm"), i))
        else:                # parallel attention + MLP: h + attn + mlp
            down = mlp(mlp_in, i)
            h = model.add(model.add(h, attn), down)

    h = ln(h, "ln_f")
    logits = model.dense(h, c.vocab_size, use_bias=False, datatype=data_type,
                         keep_f32_logits=True, name="lm_head")
    return serving_head(model, logits, mode, generation_config)


def preprocess_hf_state_dict(sd, config: FalconConfig):
    """Split each fused ``query_key_value`` into q/k/v pseudo-keys, in any
    of HF Falcon's three layouts (multi-query, classic multi-head, grouped
    new architecture), on the tensors' own device, and tie the head."""
    c = config
    hd = c.hidden_size // c.num_attention_heads
    H, KH = c.num_attention_heads, c.num_kv_heads
    for i in range(c.num_hidden_layers):
        base = f"transformer.h.{i}.self_attention"
        for suffix in ("weight",) + (("bias",) if c.bias else ()):
            key = f"{base}.query_key_value.{suffix}"
            if key not in sd:
                continue
            fused = as_torch(sd.pop(key))
            cols = tuple(fused.shape[1:])   # () for a bias
            if c.new_decoder_architecture:
                g = H // KH
                f = fused.reshape((KH, g + 2, hd) + cols)
                q = f[:, :-2].reshape((H * hd,) + cols)
                k = f[:, -2].reshape((KH * hd,) + cols)
                v = f[:, -1].reshape((KH * hd,) + cols)
            elif KH == 1:
                q = fused[: H * hd]
                k = fused[H * hd: (H + 1) * hd]
                v = fused[(H + 1) * hd:]
            else:   # classic MHA: [n_head, 3, head_dim, ...] interleaved
                f = fused.reshape((H, 3, hd) + cols)
                q = f[:, 0].reshape((H * hd,) + cols)
                k = f[:, 1].reshape((H * hd,) + cols)
                v = f[:, 2].reshape((H * hd,) + cols)
            sd[f"{base}.q_proj.{suffix}"] = q
            sd[f"{base}.k_proj.{suffix}"] = k
            sd[f"{base}.v_proj.{suffix}"] = v
    tie_lm_head(sd, "transformer.word_embeddings.weight")


def hf_weight_map(config: FalconConfig):
    """HF state-dict key -> (layer_name, weight_name, transpose?), after
    ``preprocess_hf_state_dict``."""
    c = config
    m = {"transformer.word_embeddings.weight": ("word_embeddings", "weight",
                                                False),
         "transformer.ln_f.weight": ("ln_f", "gamma", False),
         "transformer.ln_f.bias": ("ln_f", "beta", False),
         "lm_head.weight": ("lm_head", "kernel", True)}
    for i in range(c.num_hidden_layers):
        hf, ff = f"transformer.h.{i}", f"h.{i}"
        for p, w, b in (("q_proj", "wq", "bq"), ("k_proj", "wk", "bk"),
                        ("v_proj", "wv", "bv"), ("dense", "wo", "bo")):
            m[f"{hf}.self_attention.{p}.weight"] = (
                f"{ff}.self_attention", w, True)
            if c.bias:
                m[f"{hf}.self_attention.{p}.bias"] = (
                    f"{ff}.self_attention", b, False)
        for p in ("dense_h_to_4h", "dense_4h_to_h"):
            m[f"{hf}.mlp.{p}.weight"] = (f"{ff}.mlp.{p}", "kernel", True)
            if c.bias:
                m[f"{hf}.mlp.{p}.bias"] = (f"{ff}.mlp.{p}", "bias", False)
        if c.new_decoder_architecture:
            lns = ("ln_attn", "ln_mlp")
        elif c.parallel_attn:
            lns = ("input_layernorm",)
        else:
            lns = ("input_layernorm", "post_attention_layernorm")
        for lnname in lns:
            m[f"{hf}.{lnname}.weight"] = (f"{ff}.{lnname}", "gamma", False)
            m[f"{hf}.{lnname}.bias"] = (f"{ff}.{lnname}", "beta", False)
    return m
