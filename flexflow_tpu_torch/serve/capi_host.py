"""Python host of the native C serving ABI (``ffsv_*``): the counterpart
of ``flexflow_tpu/serve/capi_host.py`` for the PyTorch port.

``flexflow_tpu_torch/native/csrc/serve_c.cpp`` (built into
``native/_build/libflexflow_tpu_torch_serve.so`` by
``flexflow_tpu_torch.native.build_serve_library``) embeds CPython and
calls the flat functions of this module, so that a C host drives config
creation and flag parsing, model build and weight load, request
registration and generation, speculative decoding, text prompts and the
metrics snapshot. It exports the JAX package's ``ffsv_*`` symbols from
``native/include/flexflow_tpu_c.h``, so the C mains of ``examples/c``
link against it unchanged.

Every function takes and returns simple types (str, int, lists, opaque
objects), so the C side needs no Python type knowledge beyond calling a
function.

The device: an embedding C host sets ``FFSV_DEVICE`` (``cuda``, the
default, or ``cpu``) before ``ffsv_init``; ``host_init`` reads it once
and every config made through the ABI afterwards runs there. An unknown
value raises.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

# the device of the configs made through the ABI (host_init sets it)
_DEVICE = "cuda"


def host_init() -> int:
    """Embedded-host initialization, called by ``ffsv_init`` after the
    module import: reads ``FFSV_DEVICE`` (only here, so that importing
    this module from an ordinary Python process changes nothing)."""
    global _DEVICE
    want = os.environ.get("FFSV_DEVICE", "cuda")
    if want not in ("cuda", "cpu"):
        raise ValueError(f"FFSV_DEVICE={want!r}: use 'cuda' or 'cpu'")
    _DEVICE = want
    return 0


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def config_create():
    from flexflow_tpu_torch.config import FFConfig

    return FFConfig(device=_DEVICE)


def config_parse_args(args: Sequence[str]):
    """Reference flexflow_config_parse_args: build an FFConfig from the
    reference's command-line flag set (``FFConfig.from_args``)."""
    from flexflow_tpu_torch.config import FFConfig

    return FFConfig.from_args(list(args), device=_DEVICE)


def config_set(cfg, key: str, value: str) -> int:
    """Set one config field from its string form, coerced to the field's
    current type. A field currently holding ``None`` (Optional) infers
    the type from the literal instead: true/false -> bool,
    none/null/"" -> None, numeric -> int/float, else str — so e.g.
    setting ``search_profile`` to "false" stores False, not the truthy
    string. Returns 0 on success, -1 on unknown key/bad value."""
    if not hasattr(cfg, key):
        return -1
    cur = getattr(cfg, key)
    try:
        if isinstance(cur, bool):
            low = value.lower()
            if low in ("1", "true", "yes", "on"):
                val = True
            elif low in ("0", "false", "no", "off"):
                val = False
            else:
                return -1    # a typo must not silently disable a flag
        elif isinstance(cur, int):
            val = int(value)
        elif isinstance(cur, float):
            val = float(value)
        elif isinstance(cur, str):
            val = value
        elif cur is None:
            low = value.lower()
            if low in ("true", "false", "yes", "no", "on", "off"):
                val = low in ("true", "yes", "on")
            elif low in ("", "none", "null"):
                val = None
            else:
                try:
                    val = int(value)
                except ValueError:
                    try:
                        val = float(value)
                    except ValueError:
                        val = value
        else:
            return -1
        setattr(cfg, key, val)
        return 0
    except ValueError:
        return -1


def config_get(cfg, key: str) -> str:
    return "" if not hasattr(cfg, key) else str(getattr(cfg, key))


# ---------------------------------------------------------------------------
# model build + weights (reference flexflow_model_create + file loader)
# ---------------------------------------------------------------------------

# the wire names of the families (gpt_bigcode is "starcoder" on the wire)
_WIRE_FAMILIES = ("llama", "opt", "falcon", "mpt", "starcoder")


def _families() -> Dict[str, tuple]:
    from flexflow_tpu_torch.models import FAMILIES

    return {name: (FAMILIES[name].config_cls, FAMILIES[name].build)
            for name in _WIRE_FAMILIES}


class _ServingHost:
    """One compiled serving model + its RequestManager."""

    def __init__(self, model, gen_cfg=None):
        from flexflow_tpu_torch.serve.request_manager import RequestManager

        self.model = model
        self.rm = RequestManager()
        self.results: Dict[int, List[int]] = {}
        # adaptive-speculation / sampling policy parsed from the spec
        # JSON's "generation_config" (None -> library defaults)
        self.gen_cfg = gen_cfg
        # attach the shared-prefix pool EAGERLY (not lazily at the first
        # generate) so ffsv_register_request calls made before the loop
        # starts still get admission-time prefix matching
        self.rm._resolve_prefix_cache(gen_cfg)


# spec-JSON "generation_config" keys -> GenerationConfig fields. Short C
# -friendly spellings on the wire; the Python dataclass keeps the long
# names (serve/batch_config.py documents semantics).
_GEN_CFG_KEYS = {
    "adaptive": "adaptive_spec",
    "adaptive_spec": "adaptive_spec",
    "timeout_s": "timeout_s",
    "spec_depth": "spec_depth",
    "min_spec_depth": "min_spec_depth",
    "fallback_margin": "spec_fallback_margin",
    "recover_margin": "spec_recover_margin",
    "probe_every": "spec_probe_every",
    "ewma_alpha": "spec_ewma_alpha",
    "draft_cost_ratio": "spec_draft_cost_ratio",
    "do_sample": "do_sample",
    "temperature": "temperature",
    "topp": "topp",
    "prefix_cache": "prefix_cache",
    "prefix_cache_tokens": "prefix_cache_tokens",
}


def _parse_generation_config(spec: dict):
    """Optional ``generation_config`` object -> GenerationConfig (None
    when absent). Unknown keys AND out-of-range values raise so a C
    host's typo'd or nonsensical knob cannot silently run a degenerate
    policy (surfaces via ffsv_last_error)."""
    raw = spec.get("generation_config")
    if raw is None:
        return None
    from flexflow_tpu_torch.serve.batch_config import GenerationConfig

    unknown = sorted(set(raw) - set(_GEN_CFG_KEYS))
    if unknown:
        raise ValueError(f"unknown generation_config keys {unknown}; "
                         f"have {sorted(_GEN_CFG_KEYS)}")
    gc = GenerationConfig(**{_GEN_CFG_KEYS[k]: v for k, v in raw.items()})
    checks = (
        ("adaptive", isinstance(gc.adaptive_spec, bool), "a boolean"),
        ("spec_depth", isinstance(gc.spec_depth, int)
         and gc.spec_depth >= 0, "an int >= 0 (0 = caller's depth)"),
        ("min_spec_depth", isinstance(gc.min_spec_depth, int)
         and gc.min_spec_depth >= 1, "an int >= 1"),
        ("probe_every", isinstance(gc.spec_probe_every, int)
         and gc.spec_probe_every >= 1, "an int >= 1"),
        ("ewma_alpha", isinstance(gc.spec_ewma_alpha, (int, float))
         and 0 < gc.spec_ewma_alpha <= 1, "in (0, 1]"),
        ("fallback_margin",
         isinstance(gc.spec_fallback_margin, (int, float))
         and gc.spec_fallback_margin > 0, "> 0"),
        ("recover_margin",
         isinstance(gc.spec_recover_margin, (int, float))
         and gc.spec_recover_margin >= gc.spec_fallback_margin,
         ">= fallback_margin (hysteresis)"),
        ("draft_cost_ratio",
         isinstance(gc.spec_draft_cost_ratio, (int, float))
         and gc.spec_draft_cost_ratio >= 0, ">= 0 (0 = estimate)"),
        ("timeout_s", isinstance(gc.timeout_s, (int, float))
         and gc.timeout_s >= 0, ">= 0 (0 = no timeout)"),
        ("prefix_cache", isinstance(gc.prefix_cache, bool), "a boolean"),
        ("prefix_cache_tokens", isinstance(gc.prefix_cache_tokens, int)
         and gc.prefix_cache_tokens >= 0,
         "an int >= 0 (pool tokens; 0 = default)"),
    )
    for key, ok, want in checks:
        if not ok:
            raise ValueError(
                f"generation_config.{key} must be {want}")
    return gc


def llm_create(cfg, spec_json: str) -> _ServingHost:
    """Build + compile a serving model from a JSON spec:

    ``{"family": "llama", "model_config": {<family Config kwargs>},
       "mode": "inc" | "spec" | "tree",
       "weights_npz": "<path>" (optional — default is seeded init),
       "checkpoint_dir": "<dir>" (optional — cold-start from an
       HF-layout disk checkpoint written by models/checkpoint_store.py:
       config.json decides family AND model_config, so neither may be
       given alongside it; mutually exclusive with weights_npz),
       "quantize": "int8" | "int4" | "none" (optional — weight-only
       compression applied after the weights land, the
       quantize-on-load cold-start path),
       "generation_config": {<adaptive speculation / sampling /
       prefix-cache knobs>} (optional — see _GEN_CFG_KEYS; e.g.
       {"adaptive": true, "spec_depth": 6, "min_spec_depth": 1,
       "fallback_margin": 0.95, "prefix_cache": true,
       "prefix_cache_tokens": 65536})}``

    The reference counterpart chains flexflow_model_create, the per-op
    builder calls, FileDataLoader weight load and init_operators_inference
    (flexflow_c.cc); here one call owns build->compile->weight load, on
    the config's device.
    """
    from flexflow_tpu_torch.core.model import FFModel
    from flexflow_tpu_torch.ffconst import InferenceMode
    from flexflow_tpu_torch.quant import normalize_qtype

    spec = json.loads(spec_json)
    gen_cfg = _parse_generation_config(spec)
    qtype = normalize_qtype(spec.get("quantize"))   # typos fail loudly
    ckpt_dir = spec.get("checkpoint_dir")
    if ckpt_dir:
        # the checkpoint's config.json IS the model spec: deriving family
        # + model_config from anywhere else could silently build a graph
        # the weights don't fit
        from flexflow_tpu_torch.models import family_for_hf_config
        from flexflow_tpu_torch.models.checkpoint_store import \
            read_checkpoint_config

        if spec.get("model_config"):
            raise ValueError("checkpoint_dir and model_config are mutually "
                             "exclusive: the checkpoint's config.json is "
                             "the model config")
        if spec.get("weights_npz"):
            raise ValueError(
                "checkpoint_dir and weights_npz are mutually exclusive")
        cfg_dict = read_checkpoint_config(ckpt_dir)
        fam = family_for_hf_config(cfg_dict)
        # the C-ABI wire name for gpt_bigcode is "starcoder"
        wire = "starcoder" if fam.name == "gpt_bigcode" else fam.name
        if "family" in spec and spec["family"] not in (fam.name, wire):
            raise ValueError(
                f"spec family {spec['family']!r} does not match checkpoint "
                f"model_type {cfg_dict.get('model_type')!r} ({wire})")
        family = wire
        cfg_cls, create = _families()[family]
        mcfg = cfg_cls.from_hf_config(cfg_dict)
    else:
        family = spec.get("family", "llama")
        if family not in _families():
            raise ValueError(f"unknown model family {family!r}; "
                             f"have {sorted(_families())}")
        cfg_cls, create = _families()[family]
        mcfg = cfg_cls(**spec.get("model_config", {}))
    mode = {"inc": InferenceMode.INC_DECODING_MODE,
            "spec": InferenceMode.BEAM_SEARCH_MODE,
            "tree": InferenceMode.TREE_VERIFY_MODE}[spec.get("mode", "inc")]
    if getattr(cfg, "telemetry", False):
        # C hosts opt in via ffsv_config_set(cfg, "telemetry", "true")
        # (+ optional telemetry_trace_path) and read snapshots back
        # through ffsv_metrics_dump
        from flexflow_tpu_torch.telemetry import ensure_telemetry

        ensure_telemetry(getattr(cfg, "telemetry_trace_path", "") or None)
    model = FFModel(cfg)
    create(model, mcfg, mode=mode)
    model.compile()
    if ckpt_dir:
        from flexflow_tpu_torch.models.checkpoint_store import \
            load_checkpoint_into

        load_checkpoint_into(model, ckpt_dir, quantize=qtype)
    else:
        weights = spec.get("weights_npz")
        if weights:
            from flexflow_tpu_torch.training.checkpoint import \
                load_weights_npz

            load_weights_npz(weights, model)
        if qtype:
            model.quantize_weights(qtype)
    return _ServingHost(model, gen_cfg=gen_cfg)


# ---------------------------------------------------------------------------
# requests + generation (reference RequestManager + flexflow_model_generate)
# ---------------------------------------------------------------------------

def _default_timeout(host: _ServingHost) -> Optional[float]:
    """The spec JSON's generation_config.timeout_s (0/absent = None)."""
    gc = host.gen_cfg
    t = getattr(gc, "timeout_s", 0.0) if gc is not None else 0.0
    return float(t) if t and t > 0 else None


def register_request(host: _ServingHost, tokens: Sequence[int],
                     max_new_tokens: int) -> int:
    return host.rm.register_new_request(
        [int(t) for t in tokens], max_new_tokens=int(max_new_tokens),
        timeout_s=_default_timeout(host))


def register_request_timeout(host: _ServingHost, tokens: Sequence[int],
                             max_new_tokens: int, timeout_s: float) -> int:
    """``ffsv_register_request_timeout``: per-request wall-clock bound
    (seconds; <= 0 = none, overriding any spec-JSON default)."""
    return host.rm.register_new_request(
        [int(t) for t in tokens], max_new_tokens=int(max_new_tokens),
        timeout_s=float(timeout_s) if timeout_s > 0 else None)


_STATUS_CODES = {"ok": 0, "timed_out": 1, "cancelled": 2, "error": 3,
                 "rejected": 5}


def request_cancel(host: _ServingHost, request_id: int) -> int:
    """``ffsv_request_cancel``: flag a request for cancellation; the
    next generate/generate_spec round reaps it (partial output kept).
    1 = cancelled, 0 = unknown or already finished."""
    return 1 if host.rm.cancel(int(request_id)) else 0


def request_status(host: _ServingHost, request_id: int) -> int:
    """``ffsv_request_status``: -1 unknown, 0 ok, 1 timed_out,
    2 cancelled, 3 error, 4 registered-but-unfinished, 5 rejected
    (prompt can never fit max_sequence_length)."""
    rid = int(request_id)
    res = host.rm.results.get(rid)
    if res is not None:
        return _STATUS_CODES.get(res.status, 3)
    req = host.rm.inflight.get(rid)
    return 4 if req is not None else -1


def generate(host: _ServingHost) -> int:
    """Run incremental decoding for every pending request (reference
    flexflow_model_generate, flexflow_c.cc:1584). Returns the number of
    finished requests; outputs are fetched per-request afterwards."""
    results = host.rm.generate_incr_decoding(
        host.model, generation_config=host.gen_cfg)
    for r in results:
        host.results[r.guid] = [int(t) for t in r.output_tokens]
    return len(results)


def get_output(host: _ServingHost, request_id: int) -> List[int]:
    return host.results.get(int(request_id), [])


class _SpecHost(_ServingHost):
    """Verifier + draft SSMs (reference spec_infer main: one LLM, one or
    more SSMs driven through RequestManager)."""

    def __init__(self, model, ssms, gen_cfg=None):
        super().__init__(model, gen_cfg=gen_cfg)
        self.ssms = ssms


def spec_create(cfg, verifier_json: str, draft_json: str) -> _SpecHost:
    """Build + compile a speculative-decoding pair (reference
    inference/spec_infer/spec_infer.cc:201 builds the LLM in
    TREE_VERIFY mode and its SSMs in BEAM_SEARCH mode). Both specs use
    the llm_create JSON schema; a draft whose family/dims truncate the
    verifier's shares its shallow weights automatically (per-layer-name
    seeded init), matching the bench's truncation-draft construction.

    Multi-SSM: ``draft_json`` may instead be ``{"ssms": [<spec>, ...]}``
    — one draft model per entry, all proposing into one merged token
    tree per round (the reference's multi-SSM SpecInfer configuration).
    The verifier spec's ``generation_config`` (llm_create schema) carries
    the pair-level adaptive-speculation policy; its ``spec_depth``
    overrides the ffsv_generate_spec argument when set."""
    v = dict(json.loads(verifier_json))
    v["mode"] = "tree"
    d = json.loads(draft_json)
    draft_specs = d["ssms"] if isinstance(d, dict) and "ssms" in d else [d]
    if not draft_specs:
        raise ValueError('draft spec "ssms" must name at least one model')
    verifier = llm_create(cfg, json.dumps(v))
    drafts = []
    for ds in draft_specs:
        ds = dict(ds)
        ds["mode"] = "spec"
        drafts.append(llm_create(cfg, json.dumps(ds)).model)
    return _SpecHost(verifier.model, drafts, gen_cfg=verifier.gen_cfg)


def generate_spec(host: _SpecHost, spec_depth: int) -> int:
    """Speculative decoding for every pending request (reference
    flexflow_model_generate on a spec-configured model). Returns the
    number of finished requests. ``spec_depth`` must be >= 1 — the
    RequestManager treats falsy depths as "use the maximum", which would
    silently invert a C caller's 0-means-off intent. The spec JSON's
    ``generation_config`` (held on the host) supplies the adaptive
    depth-controller policy; its ``spec_depth`` field, when set,
    overrides this argument."""
    if int(spec_depth) < 1:
        raise ValueError(f"spec_depth must be >= 1, got {spec_depth}")
    results = host.rm.generate_spec_infer(host.model, host.ssms,
                                          spec_depth=int(spec_depth),
                                          generation_config=host.gen_cfg)
    for r in results:
        host.results[r.guid] = [int(t) for t in r.output_tokens]
    return len(results)


# ---------------------------------------------------------------------------
# text prompts (reference flexflow_model_generate takes TEXT; the C++
# tokenizer encodes/decodes around the token-level engine)
# ---------------------------------------------------------------------------

def register_bpe_tokenizer(host: _ServingHost, vocab_path: str,
                           merges_path: str) -> int:
    """Attach the GPT-2 BPE tokenizer (on the native library) so the host
    can take text prompts. Returns the vocab size."""
    from flexflow_tpu_torch.native.tokenizer import BPETokenizer

    tok = BPETokenizer(vocab_path=vocab_path, merges_path=merges_path)
    host.rm.register_tokenizer(tok)
    return tok.vocab_size()


def register_request_text(host: _ServingHost, text: str,
                          max_new_tokens: int) -> int:
    return host.rm.register_new_request(text,
                                        max_new_tokens=int(max_new_tokens))


def metrics_dump(fmt: str = "json") -> str:
    """Process-wide aggregated metrics snapshot (``ffsv_metrics_dump``).

    Merges the global telemetry registry with every live replica pool's
    per-replica registries (``telemetry.aggregate_registry`` — exact by
    MetricsRegistry.merge's contract), so a C host sees fleet totals
    without knowing about pools. ``fmt``: "json" (structured snapshot
    incl. exact p50/p90/p99 per histogram) or "prometheus" (text
    exposition format). Returns an EMPTY snapshot ("{}" / "") when
    telemetry is disabled and no fleet is live — a C host can
    distinguish "off" from "on with no traffic" by the presence of the
    ffsv_requests_total key. Unknown formats raise (surfaces as NULL +
    ffsv_last_error)."""
    from flexflow_tpu_torch.telemetry import aggregate_registry, \
        get_telemetry

    if fmt not in ("json", "prometheus"):
        raise ValueError(f"unknown metrics format {fmt!r}; "
                         "use 'json' or 'prometheus'")
    reg = aggregate_registry()
    if get_telemetry() is None and not reg.snapshot():
        return "{}" if fmt == "json" else ""
    return reg.to_json() if fmt == "json" else reg.to_prometheus()


def get_output_text(host: _ServingHost, request_id: int) -> str:
    """Decoded output of a FINISHED request. Unknown/unfinished guids
    raise (the C side surfaces NULL + ffsv_last_error) so an empty
    decode is distinguishable from a wrong guid. Reuses the
    RequestManager's own collected GenerationResult.output_text — one
    decode path, not two."""
    rid = int(request_id)
    res = host.rm.results.get(rid)
    if res is None:
        raise KeyError(f"no finished request with guid {rid}")
    if host.rm.tokenizer is None:
        raise ValueError("no tokenizer registered")
    return res.output_text or host.rm.tokenizer.decode(res.output_tokens)
