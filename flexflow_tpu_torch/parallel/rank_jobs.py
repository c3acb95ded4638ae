"""The serving and training jobs of ``parallel/launch.run_ranks``: each
runs on every rank of a process group.

``serve`` builds a LLaMA-family serving model (or a verifier and its
draft) at the payload's degrees, under a run's strategy (a Strategy's
JSON, set before compile) or the search's (``auto_parallel``), carries
whole weights in from a file (``shard_params``) or draws them from the
seed, and generates, with the shared-prefix pool when a run asks
(``prefix_cache``); it returns the tokens, the pool's hit tokens, the
kernels' launch counts and launch shapes (``kernels.record_shapes``),
the weight bytes the rank holds, peak device memory and the wall time,
and can save the parameters as the rank holds them (``save_params``).
``python -m flexflow_tpu_torch.serve`` under torchrun is the user's
entry to the same path.

``train`` builds a model with a caller's builder at the payload's
degrees, compiles it with an optimizer and a loss, carries whole weights
in from a file (each rank keeps its slice) or draws them from the seed,
and takes train steps on the batches of an ``.npz``; it returns each
step's loss and wall time, the bytes the gradient sums all-reduced and
peak device memory, and can save or restore a checkpoint and write the
whole parameters after the steps. A run may carry a strategy (set before
compile) or ask for the search (``auto_parallel`` in its config); it then
also returns the strategy executed, each parameter's local shape and the
count of branch regions planned; rank 0 can write the last step's whole
gradients.

``search_ab`` runs ``train``'s runs, then the measured searched-vs-DP A/B
of ``search/measure.py`` on the same ranks.
"""

from __future__ import annotations

import gc
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
    if run.get("strategy"):
        from flexflow_tpu_torch.search.strategy import Strategy

        m.strategy = Strategy.from_json(run["strategy"])
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
    """The run's prompts' output tokens, in prompt order, and the prompt
    tokens the prefix pool installed instead of prefilling."""
    from flexflow_tpu_torch.serve.batch_config import GenerationConfig
    from flexflow_tpu_torch.serve.request_manager import RequestManager

    rm = RequestManager()
    gc = GenerationConfig(prefix_cache=bool(run.get("prefix_cache")))
    for p in run["prompts"]:
        rm.register_new_request(p, max_new_tokens=run["max_new"])
    if ssm is None:
        res = rm.generate_incr_decoding(llm, generation_config=gc)
    else:
        res = rm.generate_spec_infer(llm, [ssm],
                                     spec_depth=run.get("spec_depth"),
                                     generation_config=gc)
    by_prompt = {tuple(r.input_tokens): list(r.output_tokens) for r in res}
    return ([by_prompt[tuple(p)] for p in run["prompts"]],
            sum(r.prefix_hit_tokens for r in res))


def serve(payload) -> List[Dict[str, Any]]:
    """Each run of ``payload["runs"]``: build, generate (``repeat``
    times, the wall time of each kept) and report."""
    from flexflow_tpu_torch import kernels
    from flexflow_tpu_torch.ffconst import InferenceMode
    from flexflow_tpu_torch.quant import quantized_nbytes

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
        seconds, decode_ms, tokens, counts, hits = [], [], None, None, []
        with kernels.record_shapes() as shapes:
            for _ in range(int(run.get("repeat", 1))):
                kernels.reset_counts()
                if dec is not None:
                    dec.update(s=0.0, steps=0)
                if on_card:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                tokens, hit = _generate(llm, ssm, run)
                hits.append(hit)
                if on_card:
                    torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                counts = dict(kernels.counts)
                if dec is not None:
                    decode_ms.append(dec["s"] * 1e3 / max(1, dec["steps"]))
            shapes = {k: sorted(v) for k, v in shapes.items()}
        if run.get("save_params"):
            # the rank's parameters as it holds them, on the host
            torch.save(_on(llm.params, torch.device("cpu")),
                       run["save_params"].format(rank=llm.mesh.rank
                                                 if llm.mesh else 0))
        results.append({
            "name": run.get("name", ""), "rank": llm.mesh.rank
            if llm.mesh is not None else 0,
            "tokens": tokens, "counts": counts, "seconds": seconds,
            "prefix_hit_tokens": hits,
            # payload and scale of a quantized leaf, a stage's stacked
            # blocks included
            "weight_bytes": quantized_nbytes(llm.params),
            "strategy": (llm.strategy.to_json()
                         if llm.strategy is not None else None),
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


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------
def build_trainer(run, dev):
    """``run["builder"]`` ("file.py:fn" or "module:fn", called as
    ``fn(ff, config, **builder_kw)`` and returning the uncompiled
    FFModel) compiled with ``run``'s optimizer, loss and metrics; a
    ``run["strategy"]`` (a Strategy's JSON) is set on the model before
    compile."""
    import flexflow_tpu_torch as ff
    from flexflow_tpu_torch.parallel.launch import load_target

    cfg = ff.FFConfig(device=str(dev), **run.get("config", {}))
    m = load_target(run["builder"])(ff, cfg, **run.get("builder_kw", {}))
    if run.get("strategy"):
        from flexflow_tpu_torch.search.strategy import Strategy

        m.strategy = Strategy.from_json(run["strategy"])
    kind, kw = run.get("optimizer", ("sgd", {"lr": 0.01}))
    opt = (ff.SGDOptimizer(m, **kw) if kind == "sgd"
           else ff.AdamOptimizer(m, **kw))
    m.compile(optimizer=opt,
              loss_type=ff.LossType[run.get(
                  "loss", "LOSS_SPARSE_CATEGORICAL_CROSSENTROPY")],
              metrics=[ff.MetricsType[k] for k in run.get("metrics", ())])
    return m


def train(payload) -> List[Dict[str, Any]]:
    """Each run of ``payload["runs"]``: build (``build_trainer``), load
    ``weights`` (whole tensors, ``torch.save``) or
    ``restore`` a checkpoint directory, then take ``steps`` train steps
    from ``first_step`` on the ``.npz`` batches ``data`` (``x0``, ``x1``,
    ... and ``y``, each [steps, batch, ...]), saving a checkpoint after
    ``save["step"]`` steps when asked; rank 0 writes the whole parameters
    to ``out`` and the last step's whole gradients to ``grads_out``.
    ``deterministic`` runs under
    ``torch.use_deterministic_algorithms``; the payload's ``tf32`` sets
    the card's TF32 switches."""
    import numpy as np

    from flexflow_tpu_torch.convert import load_params
    from flexflow_tpu_torch.training.checkpoint import (CheckpointManager,
                                                        training_state)

    dev = _dev(payload)
    on_card = dev.type == "cuda"
    if on_card and "tf32" in payload:
        torch.backends.cuda.matmul.allow_tf32 = payload["tf32"]
        torch.backends.cudnn.allow_tf32 = payload["tf32"]
    results = []
    for run in payload["runs"]:
        # the last run's model is a reference cycle (model <-> optimizer):
        # free it before this run's peak
        gc.collect()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        # the card's atomics-free kernels (the embedding's backward);
        # cuBLAS needs CUBLAS_WORKSPACE_CONFIG set before it starts
        torch.use_deterministic_algorithms(bool(run.get("deterministic")))
        m = build_trainer(run, dev)
        if run.get("weights"):
            load_params(m, torch.load(run["weights"], weights_only=False))
        restore_s = None
        if run.get("restore"):
            t0 = time.perf_counter()
            CheckpointManager(run["restore"]).restore(m)
            restore_s = time.perf_counter() - t0
        data = np.load(run["data"])
        xs = [data[f"x{i}"] for i in range(len(m.input_tensors))]
        y = data["y"]
        first = int(run.get("first_step", 0))
        steps = int(run.get("steps", len(y) - first))
        save = run.get("save") or {}
        losses, step_ms = [], []
        for i in range(first, first + steps):
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(m.train_one_batch([x[i] for x in xs], y[i]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if save and i + 1 == save["step"]:
                t0 = time.perf_counter()
                CheckpointManager(save["dir"]).save(i + 1, m, force=True)
                save["seconds"] = time.perf_counter() - t0
        if run.get("grads_out"):
            # the last step's gradients, whole (before its update)
            from flexflow_tpu_torch.training.checkpoint import _whole

            grads = {f"{ln}/{w}": _whole(m, ln, w, p.grad).float().numpy()
                     for ln, lp in m.params.items() for w, p in lp.items()
                     if p.grad is not None}
            if m.mesh is None or m.mesh.rank == 0:
                np.savez(run["grads_out"], **grads)
        if run.get("out"):
            state = training_state(m)
            if m.mesh is None or m.mesh.rank == 0:
                np.savez(run["out"], **{
                    f"{ln}/{w}": t.float().numpy()
                    for ln, lp in state["params"].items()
                    for w, t in lp.items()})
        results.append({
            "name": run.get("name", ""),
            "rank": m.mesh.rank if m.mesh is not None else 0,
            "mesh": dict(m.mesh.shape) if m.mesh is not None else {},
            "losses": losses, "step_ms": step_ms,
            "allreduce_bytes": m.grad_allreduce_bytes,
            "save_seconds": save.get("seconds"),
            "restore_seconds": restore_s,
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if on_card else 0),
            "strategy": (m.strategy.to_json() if m.strategy is not None
                         else None),
            "weight_shapes": {f"{ln}/{w}": list(p.shape)
                              for ln, lp in m.params.items()
                              for w, p in lp.items()},
            "branch_regions": (len(m._branch_plan.regions)
                               if m._branch_plan is not None else 0)})
        del m
    torch.use_deterministic_algorithms(False)
    return results


# ----------------------------------------------------------------------
# the searched-vs-DP A/B
# ----------------------------------------------------------------------
def search_ab(payload) -> Dict[str, Any]:
    """``train(payload)``, then, with ``payload["ab"]``, the measured
    searched-vs-DP A/B (``search/measure.searched_vs_dp_wallclock``) of
    ``ab["builder"]`` (called as ``fn(ff, config, **ab["builder_kw"])``,
    config ``ab["config"]``) on the first batch of ``ab["data"]``, over
    this job's ranks; returns {"runs": ..., "ab": {variant: {"analytic",
    "wallclock"}}}."""
    import numpy as np

    import flexflow_tpu_torch as ff
    from flexflow_tpu_torch.parallel.launch import load_target
    from flexflow_tpu_torch.search.measure import searched_vs_dp_wallclock

    out: Dict[str, Any] = {"runs": train(payload)}
    ab = payload.get("ab")
    if ab:
        dev = _dev(payload)
        build = load_target(ab["builder"])
        data = np.load(ab["data"])

        def build_model():
            return build(ff, ff.FFConfig(device=str(dev), **ab["config"]),
                         **ab.get("builder_kw", {}))

        n_in = sum(1 for k in data.files if k.startswith("x"))
        out["ab"] = searched_vs_dp_wallclock(
            build_model, [data[f"x{i}"][0] for i in range(n_in)],
            data["y"][0], chip=ab.get("chip", "h100-sxm"),
            steps=ab.get("steps", 2), reps=ab.get("reps", 2),
            variants=tuple(ab.get("variants", ("searched", "dp"))))
    return out
