"""HF-layout disk checkpoints for every serving family (counterpart of
``flexflow_tpu/models/checkpoint_store.py``, in the same on-disk format:
a checkpoint written by either package loads in the other).

A checkpoint directory holds ``config.json`` (HF attribute names) and the
weights in HF naming and orientation, as ``model.safetensors`` (a
hand-rolled writer and reader, no safetensors dependency) or
``pytorch_model.bin`` (``torch.save`` of CPU tensors), or sharded as
``transformers.save_pretrained`` writes a large model (published
LLaMA-2-7B directories are): ``model.safetensors.index.json`` (or
``pytorch_model.bin.index.json``) whose ``weight_map`` names each
tensor's shard file (``write_sharded_safetensors``). bf16 tensors read as
float32 (exact). The families' name
maps and fused-qkv preprocessors are therefore the loader, and a cold
start from disk gives the tokens of the in-memory build it was saved
from: the export inverts each family's qkv fusion exactly (falcon's three
``query_key_value`` layouts, MPT's ``Wqkv``, StarCoder's ``c_attn``), and
quantize-on-load runs the same ``FFModel.quantize_weights``.

    python -m flexflow_tpu_torch.models.checkpoint_store save \\
        --family falcon --out ckpt --format safetensors --device cpu
    python -m flexflow_tpu_torch.models.checkpoint_store info ckpt
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.models.hf_utils import _to_numpy

CONFIG_NAME = "config.json"
SAFETENSORS_NAME = "model.safetensors"
PYTORCH_NAME = "pytorch_model.bin"
SAFETENSORS_INDEX = "model.safetensors.index.json"
PYTORCH_INDEX = "pytorch_model.bin.index.json"

# numpy dtype name <-> safetensors header tag (the writer emits a subset;
# the reader takes all of them)
_ST_FROM_NP = {"float32": "F32", "float16": "F16", "float64": "F64",
               "int64": "I64", "int32": "I32", "int16": "I16",
               "int8": "I8", "uint8": "U8", "bool": "BOOL"}
_NP_FROM_ST = {v: k for k, v in _ST_FROM_NP.items()}

# Tiny per-family geometries (the JAX package's): the synthetic-checkpoint
# CLI and the tests share them.
TINY_CONFIGS: Dict[str, Dict[str, Any]] = {
    "llama": dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=128),
    "opt": dict(vocab_size=128, hidden_size=64, ffn_dim=128,
                num_hidden_layers=2, num_attention_heads=4,
                max_position_embeddings=64, word_embed_proj_dim=64),
    "falcon": dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, num_kv_heads=1),
    "mpt": dict(vocab_size=128, hidden_size=64, n_heads=4, n_layers=2,
                max_seq_len=64),
    "gpt_bigcode": dict(vocab_size=128, hidden_size=64,
                        intermediate_size=128, num_hidden_layers=2,
                        num_attention_heads=4, max_position_embeddings=64),
}


# ---------------------------------------------------------------- formats

def write_safetensors(path: str, tensors: Dict[str, np.ndarray],
                      metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``<u64 header length><JSON header><raw little-endian tensor
    bytes>``, tensors in name order, the header space-padded to 8 bytes.
    Returns the bytes written."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {k: str(v) for k, v in metadata.items()}
    blobs = []
    offset = 0
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        tag = _ST_FROM_NP.get(arr.dtype.name)
        if tag is None:   # e.g. ml_dtypes' bfloat16: stored as F32
            arr = np.ascontiguousarray(arr.astype(np.float32))
            tag = "F32"
        if arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        raw = arr.tobytes()
        header[name] = {"dtype": tag, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    hjson = json.dumps(header, separators=(",", ":")).encode("utf-8")
    hjson += b" " * ((-len(hjson)) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for raw in blobs:
            f.write(raw)
    return 8 + len(hjson) + offset


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a safetensors file as a numpy array (writable views
    of one buffer)."""
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen).decode("utf-8"))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        tag = info["dtype"]
        if tag == "BF16":   # numpy has no bfloat16: widen to float32
            lo, hi = info["data_offsets"]
            u = np.frombuffer(memoryview(data)[lo:hi], dtype="<u2")
            out[name] = (u.astype(np.uint32) << 16).view(
                np.float32).reshape(info["shape"])
            continue
        if tag not in _NP_FROM_ST:
            raise ValueError(f"{path}: unsupported safetensors dtype {tag} "
                             f"for tensor {name!r}")
        lo, hi = info["data_offsets"]
        out[name] = np.frombuffer(
            memoryview(data)[lo:hi], dtype=np.dtype(_NP_FROM_ST[tag])
        ).reshape(info["shape"])
    return out


def write_sharded_safetensors(checkpoint_dir: str,
                              tensors: Dict[str, np.ndarray], n_shards: int,
                              metadata: Optional[Dict[str, str]] = None
                              ) -> int:
    """``tensors`` as ``n_shards`` safetensors files named as
    ``transformers.save_pretrained`` names them
    (``model-00001-of-00002.safetensors``, ...; tensors in name order,
    split by count) plus ``model.safetensors.index.json``. Returns the
    bytes of the shards."""
    names = sorted(tensors)
    per = -(-len(names) // max(1, n_shards))
    weight_map: Dict[str, str] = {}
    total = nbytes = 0
    for i in range(n_shards):
        part = names[i * per:(i + 1) * per]
        fname = f"model-{i + 1:05d}-of-{n_shards:05d}.safetensors"
        nbytes += write_safetensors(os.path.join(checkpoint_dir, fname),
                                    {k: tensors[k] for k in part}, metadata)
        for k in part:
            weight_map[k] = fname
            total += int(np.asarray(tensors[k]).nbytes)
    with open(os.path.join(checkpoint_dir, SAFETENSORS_INDEX), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=2, sort_keys=True)
    return nbytes


def _read_sharded(checkpoint_dir: str, index_path: str,
                  reader) -> Dict[str, np.ndarray]:
    """Every tensor of an index's shards; a tensor the index names but no
    shard holds raises."""
    with open(index_path) as f:
        weight_map = json.load(f)["weight_map"]
    out: Dict[str, np.ndarray] = {}
    for fname in sorted(set(weight_map.values())):
        out.update(reader(os.path.join(checkpoint_dir, fname)))
    missing = sorted(set(weight_map) - set(out))
    if missing:
        raise ValueError(f"{index_path}: tensors missing from the shards: "
                         f"{missing[:4]}")
    return out


def _write_pytorch_bin(path: str, tensors: Dict[str, np.ndarray]) -> int:
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in tensors.items()}, path)
    return os.path.getsize(path)


def _read_pytorch_bin(path: str) -> Dict[str, np.ndarray]:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: _to_numpy(v) for k, v in sd.items()}


# ----------------------------------------------------- HF config roundtrip

def hf_config_dict(family_name: str, config) -> Dict[str, Any]:
    """A family config dataclass as an HF ``config.json`` dict whose
    attribute names ``from_hf_config`` reads back to the same config."""
    c = config
    if family_name in ("llama", "opt"):
        d = dataclasses.asdict(c)
    elif family_name == "falcon":
        d = dict(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                 num_hidden_layers=c.num_hidden_layers,
                 num_attention_heads=c.num_attention_heads,
                 num_kv_heads=c.num_kv_heads,
                 # multi_query only matters where it forces one KV head:
                 # grouped and multi-head checkpoints must say False
                 multi_query=(c.num_kv_heads == 1
                              and not c.new_decoder_architecture),
                 layer_norm_epsilon=c.layer_norm_epsilon,
                 rope_theta=c.rope_theta, bias=c.bias,
                 parallel_attn=c.parallel_attn,
                 new_decoder_architecture=c.new_decoder_architecture)
    elif family_name == "mpt":
        d = dict(vocab_size=c.vocab_size, d_model=c.hidden_size,
                 n_heads=c.n_heads, n_layers=c.n_layers,
                 expansion_ratio=c.expansion_ratio,
                 max_seq_len=c.max_seq_len, no_bias=c.no_bias,
                 layer_norm_epsilon=c.layer_norm_epsilon)
    elif family_name in ("gpt_bigcode", "starcoder"):
        d = dict(vocab_size=c.vocab_size, n_embd=c.hidden_size,
                 n_inner=c.intermediate_size,
                 n_layer=c.num_hidden_layers, n_head=c.num_attention_heads,
                 n_positions=c.max_position_embeddings,
                 layer_norm_epsilon=c.layer_norm_epsilon,
                 multi_query=c.multi_query)
        family_name = "gpt_bigcode"
    else:
        raise ValueError(f"unknown family {family_name!r}")
    d["model_type"] = family_name
    return d


# ------------------------------------------------------------ qkv re-fuse

def _stack_heads(q, k, v, H, hd, cols):
    """Per-head interleaved [q_h | k_h | v_h] rows (HF's multi-head
    fusion)."""
    return np.stack([q.reshape((H, hd) + cols), k.reshape((H, hd) + cols),
                     v.reshape((H, hd) + cols)],
                    axis=1).reshape((H * 3 * hd,) + cols)


def _pop_qkv(sd, base, suffix):
    keys = [f"{base}.{p}.{suffix}" for p in ("q_proj", "k_proj", "v_proj")]
    if not all(k in sd for k in keys):
        return None
    return tuple(sd.pop(k) for k in keys)


def _refuse_falcon(sd: Dict[str, np.ndarray], c) -> None:
    hd = c.hidden_size // c.num_attention_heads
    H, KH = c.num_attention_heads, c.num_kv_heads
    for i in range(c.num_hidden_layers):
        base = f"transformer.h.{i}.self_attention"
        for suffix in ("weight",) + (("bias",) if c.bias else ()):
            qkv = _pop_qkv(sd, base, suffix)
            if qkv is None:
                continue
            q, k, v = qkv
            cols = q.shape[1:]
            if c.new_decoder_architecture:
                g = H // KH   # grouped [q * g | k | v] per kv head
                fused = np.concatenate(
                    [q.reshape((KH, g, hd) + cols),
                     k.reshape((KH, 1, hd) + cols),
                     v.reshape((KH, 1, hd) + cols)],
                    axis=1).reshape((KH * (g + 2) * hd,) + cols)
            elif KH == 1:     # multi-query: rows concatenated
                fused = np.concatenate([q, k, v], axis=0)
            else:
                fused = _stack_heads(q, k, v, H, hd, cols)
            sd[f"{base}.query_key_value.{suffix}"] = \
                np.ascontiguousarray(fused)


def _refuse_mpt(sd: Dict[str, np.ndarray], c) -> None:
    for i in range(c.n_layers):
        base = f"transformer.blocks.{i}.attn"
        for suffix in ("weight",) + (() if c.no_bias else ("bias",)):
            qkv = _pop_qkv(sd, base, suffix)
            if qkv is not None:
                sd[f"{base}.Wqkv.{suffix}"] = np.ascontiguousarray(
                    np.concatenate(qkv, axis=0))


def _refuse_starcoder(sd: Dict[str, np.ndarray], c) -> None:
    hd = c.hidden_size // c.num_attention_heads
    H = c.num_attention_heads
    for i in range(c.num_hidden_layers):
        base = f"transformer.h.{i}.attn"
        for suffix in ("weight", "bias"):
            qkv = _pop_qkv(sd, base, suffix)
            if qkv is None:
                continue
            q, k, v = qkv
            fused = (np.concatenate([q, k, v], axis=0) if c.multi_query
                     else _stack_heads(q, k, v, H, hd, q.shape[1:]))
            sd[f"{base}.c_attn.{suffix}"] = np.ascontiguousarray(fused)


_REFUSE = {"falcon": _refuse_falcon, "mpt": _refuse_mpt,
           "gpt_bigcode": _refuse_starcoder, "starcoder": _refuse_starcoder}


# --------------------------------------------------------------- save/load

def export_hf_state_dict(model, family_name: str,
                         config) -> Dict[str, np.ndarray]:
    """Every mapped parameter of a compiled FFModel in HF naming and
    orientation, fp32 (the exact inverse of ``ModelFamily.load_hf``:
    dequantized, un-fused, un-transposed, then qkv re-fused)."""
    from flexflow_tpu_torch.models import FAMILIES

    fam = FAMILIES[family_name]
    sd: Dict[str, np.ndarray] = {}
    for hf_key, (layer, wname, transpose) in fam.hf_weight_map(config).items():
        arr = model.get_parameter_by_key((layer, wname))
        sd[hf_key] = np.ascontiguousarray(arr.T if transpose else arr)
    refuse = _REFUSE.get(fam.name)
    if refuse is not None:
        refuse(sd, config)
    return sd


def save_checkpoint(model, family_name: str, config, checkpoint_dir: str,
                    fmt: str = "safetensors") -> Dict[str, Any]:
    """Write ``config.json`` and the weights in HF layout; ``fmt`` is
    ``safetensors`` (default) or ``pytorch-bin``. Returns a manifest
    (weights_file, n_tensors, bytes, model_type)."""
    if fmt not in ("safetensors", "pytorch-bin"):
        raise ValueError(f"unknown checkpoint format {fmt!r}")
    os.makedirs(checkpoint_dir, exist_ok=True)
    sd = export_hf_state_dict(model, family_name, config)
    cfg = hf_config_dict(family_name, config)
    with open(os.path.join(checkpoint_dir, CONFIG_NAME), "w") as f:
        json.dump(cfg, f, indent=2, sort_keys=True)
    if fmt == "safetensors":
        fname = SAFETENSORS_NAME
        nbytes = write_safetensors(
            os.path.join(checkpoint_dir, fname), sd,
            metadata={"format": "pt", "model_type": cfg["model_type"]})
    else:
        fname = PYTORCH_NAME
        nbytes = _write_pytorch_bin(os.path.join(checkpoint_dir, fname), sd)
    return {"weights_file": fname, "n_tensors": len(sd), "bytes": nbytes,
            "model_type": cfg["model_type"]}


def read_checkpoint_config(checkpoint_dir: str) -> Dict[str, Any]:
    path = os.path.join(checkpoint_dir, CONFIG_NAME)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"{checkpoint_dir}: not a checkpoint (missing {CONFIG_NAME})")
    with open(path) as f:
        return json.load(f)


def load_checkpoint(checkpoint_dir: str
                    ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """``(config_dict, hf_state_dict)`` of a checkpoint directory:
    safetensors where present (one file, else the sharded index), else
    ``pytorch_model.bin`` (one file, else its index)."""
    cfg = read_checkpoint_config(checkpoint_dir)
    for single, index, reader in (
            (SAFETENSORS_NAME, SAFETENSORS_INDEX, read_safetensors),
            (PYTORCH_NAME, PYTORCH_INDEX, _read_pytorch_bin)):
        path = os.path.join(checkpoint_dir, single)
        if os.path.isfile(path):
            return cfg, reader(path)
        path = os.path.join(checkpoint_dir, index)
        if os.path.isfile(path):
            return cfg, _read_sharded(checkpoint_dir, path, reader)
    raise FileNotFoundError(
        f"{checkpoint_dir}: no weights file ({SAFETENSORS_NAME}, "
        f"{SAFETENSORS_INDEX}, {PYTORCH_NAME} or {PYTORCH_INDEX})")


def load_checkpoint_into(model, checkpoint_dir: str,
                         quantize: Optional[str] = None) -> int:
    """Load a checkpoint into an already compiled model of its
    architecture, then, with ``quantize``, quantize on load (the
    in-memory build's ``quantize_weights``). Returns the tensors loaded."""
    from flexflow_tpu_torch.models import family_for_hf_config
    from flexflow_tpu_torch.quant import normalize_qtype

    cfg_dict, sd = load_checkpoint(checkpoint_dir)
    fam = family_for_hf_config(cfg_dict)
    n = fam.load_hf(model, fam.config_cls.from_hf_config(cfg_dict), sd)
    qtype = normalize_qtype(quantize)
    if qtype is not None:
        model.quantize_weights(qtype)
    return n


def build_tiny(family_name: str, seed: int = 0, max_seq: int = 64,
               device: str = "cuda"):
    """(model, config): a compiled TINY incremental-decoding model of
    ``family_name`` on ``device`` (2 request slots, an fp32 cache), its
    weights drawn from ``seed`` (the same for every call)."""
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.core.model import FFModel
    from flexflow_tpu_torch.ffconst import InferenceMode
    from flexflow_tpu_torch.models import FAMILIES

    fam = FAMILIES[family_name]
    mcfg = fam.config_cls(**TINY_CONFIGS[fam.name])
    model = FFModel(FFConfig(device=device, max_requests_per_batch=2,
                             max_sequence_length=max_seq,
                             max_tokens_per_batch=16, seed=seed,
                             kv_cache_dtype="float32"))
    fam.build(model, mcfg, mode=InferenceMode.INC_DECODING_MODE)
    return model.compile(), mcfg


def save_tiny_checkpoint(family_name: str, checkpoint_dir: str,
                         fmt: str = "safetensors", seed: int = 0,
                         max_seq: int = 64,
                         device: str = "cuda") -> Dict[str, Any]:
    """Write ``build_tiny``'s model as a checkpoint."""
    from flexflow_tpu_torch.models import FAMILIES

    model, mcfg = build_tiny(family_name, seed, max_seq, device)
    return save_checkpoint(model, FAMILIES[family_name].name, mcfg,
                           checkpoint_dir, fmt=fmt)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="HF-layout serving checkpoints of the PyTorch port")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("save", help="write a tiny synthetic checkpoint")
    sp.add_argument("--family", choices=sorted(TINY_CONFIGS), default="llama")
    sp.add_argument("--out", required=True)
    sp.add_argument("--format", choices=("safetensors", "pytorch-bin"),
                    default="safetensors")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--device", default="cuda",
                    help="where the model is built (default: cuda)")
    ip = sub.add_parser("info", help="describe a checkpoint directory")
    ip.add_argument("dir")
    args = ap.parse_args(argv)
    if args.cmd == "save":
        man = save_tiny_checkpoint(args.family, args.out, fmt=args.format,
                                   seed=args.seed, device=args.device)
        print(json.dumps({"dir": args.out, **man}))
        return 0
    cfg, sd = load_checkpoint(args.dir)
    print(json.dumps({
        "model_type": cfg.get("model_type"),
        "n_tensors": len(sd),
        "bytes": int(sum(v.nbytes for v in sd.values())),
        "keys_sample": sorted(sd)[:4]}))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
