"""The serving job of ``parallel/launch.run_ranks``: ``serve`` runs on
every rank of a process group. It builds a LLaMA-family serving model (or
a verifier and its draft) at the payload's degrees, carries whole weights
in from a file (``shard_params``) or draws them from the seed, and
generates; it returns the tokens, the kernels' launch counts and launch
shapes (``kernels.record_shapes``), peak device memory and the wall
time. ``python -m flexflow_tpu_torch.serve`` under torchrun is the
user's entry to the same path.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import torch


def _dev(payload):
    d = payload.get("device", "cpu")
    if d.startswith("cuda"):
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(d)


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------
def _build(run, model_kw, weights, mode, dev):
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.convert import load_params
    from flexflow_tpu_torch.core.model import FFModel
    from flexflow_tpu_torch.models.llama import (LLAMAConfig,
                                                 create_llama_model)
    from flexflow_tpu_torch.parallel.spec import shard_params

    m = FFModel(FFConfig(device=str(dev), **run["config"]))
    create_llama_model(m, LLAMAConfig(**model_kw), mode=mode)
    m.compile()
    if weights:
        full = torch.load(weights, weights_only=False)
        if m.mesh is not None:
            full = shard_params(full, m, m.policy, m.mesh.coord)
        load_params(m, _on(full, dev))
    m.finalize_pipeline()
    return m


def _on(params, dev):
    from flexflow_tpu_torch.quant import QuantizedWeight, is_quantized

    def move(a):
        if is_quantized(a):
            return QuantizedWeight(a.qtype, a.q.to(dev), a.scale.to(dev),
                                   a.rows, a.dtype)
        return a.to(dev)

    return {layer: {w: move(a) for w, a in lp.items()}
            for layer, lp in params.items()}


def _shapes(m) -> Dict[str, List[int]]:
    """The local shapes the kernels run at: the KV cache stack and one
    held layer's projections."""
    from flexflow_tpu_torch.ffconst import OpType

    out = {}
    kv = m.op_state.get("kv_cache")
    if kv is not None:
        out["kv_cache"] = list(kv["k"].shape)
    for layer in m.layers:
        if not m._holds(layer.name):
            continue
        names = {OpType.INC_MULTIHEAD_SELF_ATTENTION: ("wq", "wk", "wo"),
                 OpType.TREE_INC_MULTIHEAD_SELF_ATTENTION: ("wq", "wk",
                                                            "wo"),
                 OpType.LINEAR: ("kernel",)}.get(layer.op_type, ())
        for w in names:
            key = w if w != "kernel" else layer.name.split(".")[-1]
            if key in out:
                continue
            leaf = m._stacked_leaf(layer.name, w)
            if leaf is None:
                leaf = m.params.get(layer.name, {}).get(w)
            if leaf is not None:
                out[key] = list(leaf.shape)
    return out


def _decode_timer(model):
    """Wrap the model's InferenceManager ``decode_block`` (each block ends
    in a host readback) to add up its wall time and steps."""
    from flexflow_tpu_torch.serve.request_manager import RequestManager

    ifm = RequestManager._ifm(model)
    stats = {"s": 0.0, "steps": 0}
    block = ifm.decode_block

    def timed_block(tok, pos, act, n):
        t = time.perf_counter()
        out = block(tok, pos, act, n)
        stats["s"] += time.perf_counter() - t
        stats["steps"] += min(int(n), model.config.decode_block_steps)
        return out

    ifm.decode_block = timed_block
    return stats


def _generate(llm, ssm, run):
    from flexflow_tpu_torch.serve.request_manager import RequestManager

    rm = RequestManager()
    for p in run["prompts"]:
        rm.register_new_request(p, max_new_tokens=run["max_new"])
    if ssm is None:
        res = rm.generate_incr_decoding(llm)
    else:
        res = rm.generate_spec_infer(llm, [ssm],
                                     spec_depth=run.get("spec_depth"))
    by_prompt = {tuple(r.input_tokens): list(r.output_tokens) for r in res}
    return [by_prompt[tuple(p)] for p in run["prompts"]]


def serve(payload) -> List[Dict[str, Any]]:
    """Each run of ``payload["runs"]``: build, generate (``repeat``
    times, the wall time of each kept) and report."""
    from flexflow_tpu_torch import kernels
    from flexflow_tpu_torch.ffconst import InferenceMode

    dev = _dev(payload)
    on_card = dev.type == "cuda"
    results = []
    for run in payload["runs"]:
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        spec = run.get("draft") is not None
        mode = (InferenceMode.TREE_VERIFY_MODE if spec
                else InferenceMode.INC_DECODING_MODE)
        llm = _build(run, run["model"], run.get("weights"), mode, dev)
        ssm = None
        if spec:
            d = run["draft"]
            ssm = _build(run, d["model"], d.get("weights"),
                         InferenceMode.BEAM_SEARCH_MODE, dev)
        moved = 0
        if run.get("offload"):
            moved = llm.offload_weights(min_bytes=run.get("offload_min", 1))
            if ssm is not None:
                moved += ssm.offload_weights(
                    min_bytes=run.get("offload_min", 1))
        dec = _decode_timer(llm) if ssm is None else None
        seconds, decode_ms, tokens, counts = [], [], None, None
        with kernels.record_shapes() as shapes:
            for _ in range(int(run.get("repeat", 1))):
                kernels.reset_counts()
                if dec is not None:
                    dec.update(s=0.0, steps=0)
                if on_card:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                tokens = _generate(llm, ssm, run)
                if on_card:
                    torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                counts = dict(kernels.counts)
                if dec is not None:
                    decode_ms.append(dec["s"] * 1e3 / max(1, dec["steps"]))
            shapes = {k: sorted(v) for k, v in shapes.items()}
        results.append({
            "name": run.get("name", ""), "rank": llm.mesh.rank
            if llm.mesh is not None else 0,
            "tokens": tokens, "counts": counts, "seconds": seconds,
            "decode_ms_per_step": decode_ms,
            "moved": moved, "shapes": _shapes(llm),
            "fetched": (llm._prefetcher.bytes_fetched
                        if llm._prefetcher is not None else 0),
            "offloaded": sorted(llm._offloaded),
            "launch_shapes": shapes,
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if on_card else 0),
            "mesh": dict(llm.mesh.shape) if llm.mesh is not None else {},
        })
        del llm, ssm
    return results
