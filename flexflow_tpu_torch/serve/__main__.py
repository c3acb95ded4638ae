"""CLI serving entry: ``python -m flexflow_tpu_torch.serve`` (counterpart
of ``python -m flexflow_tpu.serve``, with its flags plus ``--device`` and
``--inference-debugging``).

Examples:
  python -m flexflow_tpu_torch.serve --model <hf-dir> --prompt "Hello" \
      --max-new-tokens 64
  python -m flexflow_tpu_torch.serve --model <hf-dir> --ssm-model <draft-dir> \
      --prompt "Hello"                       # speculative decoding
  python -m flexflow_tpu_torch.serve --ssm-model builtin --device cpu

``--model`` is a local HF model directory (config.json and the weights,
one file or shards with their index), read through ``LLM(dir)``. A
``--prompt`` is a comma-separated list of token ids or, where the
directory has a tokenizer (``tokenizer.model``, or another local one
where ``transformers`` imports), text; with a tokenizer the outputs are
printed as text too.
With no ``--model`` it serves a LLaMA-class model of the JAX CLI's
default geometry (vocab 1024, hidden 256, 4 layers; a 2-layer draft on
the same weights for ``--ssm-model builtin``) with weights drawn from a
seeded generator and no tokenizer, so the whole stack runs anywhere.
``--inference-debugging`` dumps every op of every step to
``./inference_tensors``. The device is the card unless ``--device cpu``
is given.

Parallel serving: ``-tp``/``-pp``/``-sp`` set the tensor, pipeline and
sequence parallelism degrees; their product is the number of ranks, one
process each, started by torchrun (which sets ``RANK``, ``WORLD_SIZE``
and the rendezvous):

  torchrun --nproc-per-node 2 -m flexflow_tpu_torch.serve -tp 2 \
      --model <hf-dir> --prompt 1,5,9

Every rank serves the same prompts in lockstep; rank 0 prints.
``--offload`` pages the serving weights to pinned host memory.
"""

from __future__ import annotations

import argparse
import time

# the JAX CLI's built-in model (flexflow_tpu/serve/__main__.py)
DEFAULT_GEOMETRY = dict(vocab_size=1024, hidden_size=256,
                        intermediate_size=688, num_attention_heads=8,
                        num_key_value_heads=4, max_position_embeddings=512,
                        tie_word_embeddings=False)


def default_state_dict(n_layers: int, seed: int = 0):
    """(hf config, state dict) of the built-in LLaMA at ``n_layers``: every
    matrix drawn from N(0, 0.02) by one seeded CPU generator, norms at 1.
    The embedding, head and first layers' tensors do not depend on
    ``n_layers``, so a shallower draft holds the verifier's own."""
    import torch

    from flexflow_tpu_torch.models.llama import LLAMAConfig, hf_weight_map

    g = DEFAULT_GEOMETRY
    hf = dict(model_type="llama", num_hidden_layers=n_layers, **g)
    E, V, I = g["hidden_size"], g["vocab_size"], g["intermediate_size"]
    hd = E // g["num_attention_heads"]
    kv = g["num_key_value_heads"] * hd
    shapes = {"embed_tokens": (V, E), "lm_head": (V, E),
              "q_proj": (E, E), "k_proj": (kv, E), "v_proj": (kv, E),
              "o_proj": (E, E), "gate_proj": (I, E), "up_proj": (I, E),
              "down_proj": (E, I)}
    gen = torch.Generator().manual_seed(seed)
    keys = list(hf_weight_map(LLAMAConfig.from_hf_config(hf)))
    # the tensors outside the layers first, then each layer's in layer
    # order: no draw depends on the depth
    order = sorted(keys, key=lambda k: (
        (1, int(k.split(".")[2]), k) if k.startswith("model.layers.")
        else (0, 0, k)))
    return hf, {key: _draw(torch, key, shapes, E, gen) for key in order}


def _draw(torch, key, shapes, E, gen):
    if key.endswith("norm.weight"):
        return torch.ones(E)
    return torch.empty(shapes[key.split(".")[-2]]).normal_(
        0.0, 0.02, generator=gen)


def _prompts(args, p, has_tokenizer: bool):
    """Each ``--prompt``: comma-separated token ids, else text (which
    needs the model's tokenizer)."""
    if not args.prompt:
        return [[1, 5, 9, 23], [1, 44, 17]]
    out = []
    for s in args.prompt:
        try:
            out.append([int(t) for t in s.split(",") if t.strip()])
        except ValueError:
            if not has_tokenizer:
                p.error(f"--prompt {s!r}: the model has no tokenizer, so "
                        "a prompt is comma-separated token ids")
            out.append(s)
    return out


def main(argv=None):
    from flexflow_tpu_torch.serve.api import LLM, SSM

    p = argparse.ArgumentParser(prog="python -m flexflow_tpu_torch.serve")
    p.add_argument("--model", default="", help="HF checkpoint dir")
    p.add_argument("--ssm-model", default="",
                   help="draft model dir (enables speculative decoding); "
                        "'builtin' for the built-in pair")
    p.add_argument("--prompt", action="append", default=None,
                   help="comma-separated token ids, or text with a "
                        "tokenizer (repeatable)")
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--max-requests-per-batch", type=int, default=4)
    p.add_argument("--max-seq-length", type=int, default=256)
    p.add_argument("--max-tokens-per-batch", type=int, default=64)
    p.add_argument("-tp", "--tensor-parallelism-degree", type=int,
                   default=1)
    p.add_argument("-pp", "--pipeline-parallelism-degree", type=int,
                   default=1)
    p.add_argument("-sp", "--sequence-parallelism-degree", type=int,
                   default=1)
    p.add_argument("--8bit-quantization", dest="q8", action="store_true")
    p.add_argument("--4bit-quantization", dest="q4", action="store_true")
    p.add_argument("--offload", action="store_true")
    p.add_argument("--output-file", default="")
    p.add_argument("--inference-debugging", action="store_true",
                   help="dump every op of every step to "
                        "./inference_tensors")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.model:
        llm = LLM(args.model, output_file=args.output_file)
        ssms = [SSM(args.ssm_model)] if args.ssm_model else []
    else:
        if args.ssm_model and args.ssm_model != "builtin":
            p.error("--ssm-model <dir> requires --model (a real draft "
                    "cannot speculate for the built-in random verifier); "
                    "use '--ssm-model builtin' for the built-in pair")
        llm = LLM(default_state_dict(4), output_file=args.output_file)
        ssms = [SSM(default_state_dict(2))] if args.ssm_model else []
    quant = "int4" if args.q4 else ("int8" if args.q8 else None)
    llm.compile(max_requests_per_batch=args.max_requests_per_batch,
                max_seq_length=args.max_seq_length,
                max_tokens_per_batch=args.max_tokens_per_batch,
                ssms=ssms, device=args.device,
                inference_debugging=args.inference_debugging,
                tensor_parallelism_degree=args.tensor_parallelism_degree,
                pipeline_parallelism_degree=(
                    args.pipeline_parallelism_degree),
                sequence_parallelism_degree=(
                    args.sequence_parallelism_degree),
                cpu_offload=args.offload,
                **({"quantization_type": quant} if quant else {}))

    prompts = _prompts(args, p, llm.tokenizer is not None)
    t0 = time.time()
    results = llm.generate(prompts, max_new_tokens=args.max_new_tokens)
    dt = time.time() - t0
    mesh = llm.ffmodel.mesh
    if mesh is not None and mesh.rank != 0:
        return 0            # every rank served the same tokens
    total = sum(len(r.output_tokens) for r in results)
    for r in results:
        print(f"guid={r.guid} output={r.output_tokens}")
        if llm.tokenizer is not None:
            print(f"  text: {r.output_text!r}")
    print(f"{total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s)"
          + (" [speculative]" if ssms else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
