"""User-facing serving API: ``LLM`` and its draft model ``SSM``
(counterpart of ``flexflow_tpu/serve/api.py``).

An LLM is built from one of three sources, as in the JAX package:

* a ``(hf_config, state_dict)`` pair (the config a dict or an object
  with the HF attribute names);
* an in-memory ``transformers`` model (anything with ``config`` and
  ``state_dict()``);
* a local HF model directory: ``config.json`` and the weights (one
  safetensors or ``pytorch_model.bin`` file, or shards with their index)
  are read by ``models/checkpoint_store.py``, with no ``transformers``
  import. Its tokenizer is the directory's ``tokenizer.model`` on the
  native SentencePiece tokenizer, else ``transformers.AutoTokenizer``
  with ``local_files_only`` where ``transformers`` imports, else none
  (token-id prompts only). A string that is not a directory raises: the
  port never downloads (the JAX package fetches a hub name through
  ``transformers``).

The config picks the model family, ``compile`` records the serving graph
on ``device``, initializes it and copies the HF weights in, and
``generate`` runs the continuous-batching incremental decoder or, with
SSMs attached at ``compile``, speculative inference; with a tokenizer,
prompts may be text and results carry ``output_text``.
``LLM(..., output_file=path)`` logs every finished request to ``path``::

    ssm = SSM((draft_hf_config, draft_state_dict))
    llm = LLM((hf_config, state_dict)).compile(ssms=[ssm])
    results = llm.generate(prompts, max_new_tokens=64)

``compile(..., quantization_type="int8")`` (or ``"int4"``) serves
weight-only quantized weights through the dequant-GEMM K3, and
``compile(..., gemm_fusion=True)`` fuses the qkv and SwiGLU GEMMs; the
drafts compile with the same fields. ``compile(..., max_beam_width=2)``
builds the drafts as beam drafts of
width 2 (the FFConfig field reaches every model; the verifier ignores
it), and ``generate`` then drafts beams through the fused beam engine
(one draft) or the host tree path (several). ``compile(generation_config=
GenerationConfig(do_sample=True))`` without SSMs makes incremental
decoding sample (top-p at ``topp``, ``temperature``); speculation stays
greedy.

Online serving: ``start_server`` starts a background thread that owns
the device and runs the continuous batch; concurrent ``generate`` calls
from any thread join it, each blocking until its own requests resolve::

    llm.start_server(admission=AdmissionPolicy(max_queue_depth=16))
    res = llm.generate(prompt, max_new_tokens=64, timeout_s=2.0,
                       tenant="premium", priority=1)   # any thread
    llm.cancel(guid)                                   # any thread
    llm.stop_server(flush_timeout_s=30.0)

``generate(..., timeout_s=...)`` bounds a request's wall clock (past it
the result comes back ``timed_out`` with its partial tokens); ``priority``
orders slot grants and lets an at-risk request preempt a lower-priority
one; ``GenerationConfig(prefix_cache=True)`` pools finished prompts' KV
and installs shared prefixes instead of prefilling them. In server mode
an ``admission`` policy (serve/admission.py) rejects over-limit
submissions with ``RejectedError``.

Telemetry: ``compile(..., telemetry=True)`` (an FFConfig field, with
``telemetry_trace_path`` for the JSONL span trace) enables the
process-global ``ServingTelemetry`` (flexflow_tpu_torch/telemetry), and
``llm.start_metrics_server(port)`` serves its registry over HTTP
(``GET /metrics``, ``GET /metrics.json``).

``LLM.from_checkpoint(dir, quantize="int8")`` (and ``SSM``'s) cold-starts
from an HF-layout checkpoint on disk (``models/checkpoint_store.py``),
quantizing on load when asked. Every family of ``models.FAMILIES`` serves
this way: LLaMA, OPT, Falcon, MPT and StarCoder.
"""

from __future__ import annotations

import os
import threading
from typing import Any, List, Optional, Sequence, Tuple, Union

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.ffconst import CompMode, DataType, InferenceMode
from flexflow_tpu_torch.serve.admission import RejectedError
from flexflow_tpu_torch.serve.batch_config import GenerationConfig
from flexflow_tpu_torch.serve.request_manager import (GenerationResult,
                                                      RequestManager)


_global_init_kwargs: dict = {}

# the reference's serve.init keys that are not FFConfig fields: an FFConfig
# field to set (the value passed on, or the tuple's value when the key is
# true), or None for a Legion resource knob, which has no meaning here
_INIT_ALIASES = {
    "num_gpus": "num_devices",
    "num_cpus": None,
    "memory_per_gpu": None,
    "zero_copy_memory_per_node": None,
    "legion_utility_processors": None,
    "use_4bit_quantization": ("quantization_type", "int4"),
    "use_8bit_quantization": ("quantization_type", "int8"),
    "offload": ("cpu_offload", True),
    "fusion": "enable_fusion",
}


def init(configs_dict: Optional[dict] = None, **kwargs) -> dict:
    """Serving defaults for every later ``LLM.compile`` (reference
    serve/__init__.py init() :94, the JAX package's ``serve.init``): the
    keys that name FFConfig fields are stored, the reference's aliases
    mapped (``_INIT_ALIASES``), Legion resource keys and unknown keys
    dropped. ``compile``'s own keyword arguments win over them. Returns
    the stored fields; each call replaces the last call's."""
    global _global_init_kwargs
    merged = dict(configs_dict or {})
    merged.update(kwargs)
    known = set(FFConfig.__dataclass_fields__)
    out = {}
    for k, v in merged.items():
        if k in known:
            out[k] = v
        elif _INIT_ALIASES.get(k) is not None:
            a = _INIT_ALIASES[k]
            if isinstance(a, tuple):
                if v:
                    out[a[0]] = a[1]
            else:
                out[a] = v
    _global_init_kwargs = out
    return out


def _is_hf_model(obj) -> bool:
    return hasattr(obj, "state_dict") and hasattr(obj, "config")


# the files a transformers tokenizer is loaded from
_HF_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json",
                       "vocab.json")


def _local_tokenizer(model_dir: str):
    """The tokenizer of a local model directory: ``tokenizer.model`` on
    the native SentencePiece tokenizer, else ``transformers.AutoTokenizer``
    (``local_files_only``) where ``transformers`` imports and the
    directory holds a tokenizer file of its own, else None. A
    ``tokenizer.model`` the parser rejects counts as absent, as in the
    JAX package; a native library that cannot build raises. (Some
    ``transformers`` versions build a tokenizer for a directory with no
    tokenizer file; the JAX package takes it, the port does not.)"""
    sp_path = os.path.join(model_dir, "tokenizer.model")
    if os.path.exists(sp_path):
        from flexflow_tpu_torch.native.sp_tokenizer import \
            SentencePieceTokenizer

        try:
            return SentencePieceTokenizer(sp_path)
        except ValueError:
            pass
    if not any(os.path.exists(os.path.join(model_dir, f))
               for f in _HF_TOKENIZER_FILES):
        return None
    try:
        import transformers

        return transformers.AutoTokenizer.from_pretrained(
            model_dir, local_files_only=True)
    except Exception:
        return None


class LLM:
    """A large language model to serve: ``model`` is a ``(hf_config,
    state_dict)`` pair, an in-memory ``transformers`` model, or a local
    HF model directory."""

    inference_mode = InferenceMode.INC_DECODING_MODE

    def __init__(self, model: Any, data_type: DataType = DataType.DT_FLOAT,
                 tokenizer: Any = None, output_file: str = ""):
        from flexflow_tpu_torch.models import family_for_hf_config

        self.checkpoint_dir: Optional[str] = None
        if isinstance(model, (tuple, list)) and len(model) == 2:
            self.hf_config, self._state_dict = model
        elif _is_hf_model(model):
            self.hf_config = model.config
            self._state_dict = model.state_dict()
        elif isinstance(model, str):
            if not os.path.isdir(model):
                raise ValueError(
                    f"{model!r} is not a local model directory; the "
                    "PyTorch port reads local directories only and never "
                    "downloads a hub model")
            from flexflow_tpu_torch.models.checkpoint_store import \
                load_checkpoint

            self.hf_config, self._state_dict = load_checkpoint(model)
            self.checkpoint_dir = model
            if tokenizer is None:
                tokenizer = _local_tokenizer(model)
        else:
            raise TypeError(f"unsupported model source: {type(model)}")
        self.data_type = data_type
        self.tokenizer = tokenizer
        self.output_file = output_file
        self.ffmodel = None
        self.ssms: List["SSM"] = []
        self.rm: Optional[RequestManager] = None
        self._server: Optional[_BackgroundServer] = None
        self._quantize_on_load: Optional[str] = None
        self.family = family_for_hf_config(self.hf_config)
        self.model_config = self.family.config_cls.from_hf_config(
            self.hf_config)

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str,
                        quantize: Optional[str] = None, **kwargs) -> "LLM":
        """Cold-start from an HF-layout checkpoint directory (config.json
        + model.safetensors or pytorch_model.bin): read the config, build
        the family's graph and load the weights at ``compile()``, then
        with ``quantize`` ("int8" or "int4") quantize right after the
        weights land. Gives the tokens of the in-memory build it was
        saved from."""
        from flexflow_tpu_torch.models.checkpoint_store import \
            load_checkpoint
        from flexflow_tpu_torch.quant import normalize_qtype

        cfg_dict, state_dict = load_checkpoint(checkpoint_dir)
        llm = cls((cfg_dict, state_dict), **kwargs)
        llm.checkpoint_dir = checkpoint_dir
        llm._quantize_on_load = normalize_qtype(quantize)
        return llm

    def compile(self, generation_config: Optional[GenerationConfig] = None,
                max_requests_per_batch: int = 1, max_seq_length: int = 256,
                max_tokens_per_batch: int = 64,
                ssms: Sequence["SSM"] = (), **ffconfig_kwargs):
        """Build the serving graph, initialize it on ``device`` (an
        FFConfig field, "cuda" by default) and load the weights. With
        ``ssms`` the graph is the tree verifier (TREE_VERIFY_MODE) and
        each draft model compiles with the same batch geometry and
        FFConfig fields, so that request slots line up across caches."""
        from flexflow_tpu_torch.core.model import FFModel

        self.generation_config = generation_config or GenerationConfig()
        self.ssms = list(ssms)
        mode = (InferenceMode.TREE_VERIFY_MODE if self.ssms
                else self.inference_mode)
        kw = dict(_global_init_kwargs)       # serve.init's defaults
        kw.update(ffconfig_kwargs)
        config = FFConfig(max_requests_per_batch=max_requests_per_batch,
                          max_sequence_length=max_seq_length,
                          max_tokens_per_batch=max_tokens_per_batch, **kw)
        if config.telemetry:
            # enable-or-keep the process-global telemetry (a live
            # instance's registry survives; the drafts compile with the
            # same fields, so this runs once per model) and attach the
            # requested trace path to its tracer
            from flexflow_tpu_torch.telemetry import ensure_telemetry

            ensure_telemetry(config.telemetry_trace_path or None)
        self.ffmodel = FFModel(config)
        self.family.build(self.ffmodel, self.model_config, mode=mode,
                          generation_config=self.generation_config,
                          data_type=self.data_type)
        self.ffmodel.compile(comp_mode=CompMode.COMP_MODE_INFERENCE)
        self.family.load_hf(self.ffmodel, self.model_config,
                            self._state_dict)
        self._state_dict = None     # the weights now live in the model
        if config.quantization_type:
            # post-load quantization (the reference's --8bit/--4bit flags);
            # the leaves compile already quantized stay as they are
            self.ffmodel.quantize_weights(config.quantization_type)
        elif self._quantize_on_load:
            # from_checkpoint(quantize=...): the same post-load step,
            # asked for at the checkpoint door
            self.ffmodel.quantize_weights(self._quantize_on_load)
        # the JAX order: stack the pipeline stage's blocks now that the
        # weights are loaded, then page weights out (offload pages the
        # stacked leaves), then fuse (off under a plan or offload)
        self.ffmodel.finalize_pipeline()
        if config.cpu_offload:
            self.ffmodel.offload_weights()
        self.ffmodel.finalize_gemm_fusion()
        self.rm = RequestManager()
        if self.tokenizer is not None:
            self.rm.register_tokenizer(self.tokenizer)
        else:
            get = (self.hf_config.get if isinstance(self.hf_config, dict)
                   else lambda k, d=None: getattr(self.hf_config, k, d))
            self.rm.eos_token_id = get("eos_token_id", None)
        if self.output_file:
            self.rm.register_output_filepath(self.output_file)
        for ssm in self.ssms:
            ssm.compile(generation_config=self.generation_config,
                        max_requests_per_batch=max_requests_per_batch,
                        max_seq_length=max_seq_length,
                        max_tokens_per_batch=max_tokens_per_batch,
                        **ffconfig_kwargs)
        return self

    def generate(self, requests_or_prompts: Union[str, Sequence],
                 max_new_tokens: int = 128, max_length: int = 0,
                 timeout_s: Optional[float] = None,
                 tenant: str = "default", priority: int = 0
                 ) -> Union[GenerationResult, List[GenerationResult]]:
        """Generate for one prompt (a string or a list of token ids) or a
        list of prompts; results come back in prompt order. Speculative
        inference when SSMs were attached at ``compile``.

        ``timeout_s`` (default: ``GenerationConfig.timeout_s``, 0 = none)
        bounds each request's wall clock: past it the request is resolved
        between decode rounds with ``timed_out=True`` and its partial
        output. ``tenant`` and ``priority`` feed admission control and
        slot scheduling. With a server running, the requests join its
        continuous batch and the call blocks until they resolve; an
        over-limit submission raises ``RejectedError``."""
        if self.ffmodel is None:
            raise RuntimeError("call LLM.compile() before generate()")
        single = isinstance(requests_or_prompts, str) or (
            requests_or_prompts and isinstance(requests_or_prompts[0], int))
        prompts = ([requests_or_prompts] if single
                   else list(requests_or_prompts))
        if not prompts:
            # an empty submission would leave a waiter nothing releases
            return []
        if timeout_s is None and self.generation_config.timeout_s > 0:
            timeout_s = self.generation_config.timeout_s
        if self._server is not None:
            srv = self._server
            guids, ev = srv.submit(prompts, max_new_tokens, max_length,
                                   timeout_s=timeout_s, tenant=tenant,
                                   priority=priority)
            ev.wait()
            if srv._error is not None:
                raise RuntimeError("serving loop died") from srv._error
            missing = [g for g in guids if g not in self.rm.results]
            if missing:
                # stop_server()'s flush window closed before these
                # finished: an explicit error, never a silent drop
                raise RuntimeError(
                    f"server stopped before request(s) {missing} resolved")
        else:
            guids = [self.rm.register_new_request(
                p, max_new_tokens=max_new_tokens,
                max_sequence_length=max_length, timeout_s=timeout_s,
                tenant=tenant, priority=priority) for p in prompts]
            _run_loop(self, self.rm)
        results = [self.rm.results[g] for g in guids]
        return results[0] if single else results

    def cancel(self, request_id: int) -> bool:
        """Cancel a registered request by guid, from any thread. The
        serving loop reaps the flag at its next between-rounds seam; the
        result resolves with ``cancelled=True`` and the tokens generated
        so far. False when the guid is unknown or already finished."""
        if self.rm is None:
            return False
        return self.rm.cancel(request_id)

    def start_server(self, admission=None):
        """Start the background server: a thread owns the generation loop
        and the device, and concurrent ``generate`` calls join its
        continuous batch. ``admission`` (an ``AdmissionPolicy`` or an
        ``AdmissionController``, serve/admission.py) bounds the front
        door."""
        if self.ffmodel is None:
            raise RuntimeError("call LLM.compile() before start_server()")
        return _start_server(self, admission)

    def stop_server(self, flush_timeout_s: Optional[float] = 30.0):
        """Drain outstanding requests and stop the server: wait up to
        ``flush_timeout_s`` (None = forever); past it every outstanding
        request is cancelled (reaped within one decode block), the call
        waits for the server thread to end that block (at most
        ``STRAGGLER_JOIN_S``), and every waiter is resolved rather than
        dropped. A server whose thread outlives that wait stays attached,
        refusing submissions, until its thread ends."""
        return _stop_server(self, flush_timeout_s)

    def start_metrics_server(self, port: int = 9600,
                             host: str = "127.0.0.1"):
        """Serve the telemetry registry over HTTP: ``GET /metrics``
        (Prometheus text) and ``GET /metrics.json``. Enables telemetry if
        it is not on yet (an endpoint over no registry is useless).
        ``port=0`` binds an ephemeral port; the bound port is on the
        returned server (``.port``). A port that cannot be bound raises."""
        from flexflow_tpu_torch.telemetry import (MetricsHTTPServer,
                                                  ensure_telemetry,
                                                  get_telemetry)

        ensure_telemetry()
        if getattr(self, "_metrics_server", None) is None:
            self._metrics_server = MetricsHTTPServer(
                lambda: getattr(get_telemetry(), "registry", None),
                host=host, port=port)
        return self._metrics_server

    def stop_metrics_server(self):
        srv = getattr(self, "_metrics_server", None)
        if srv is not None:
            srv.stop()
            self._metrics_server = None
        return self


def _run_loop(llm, rm: RequestManager) -> List[GenerationResult]:
    """One generation loop over everything ``rm`` has queued, through the
    speculative loops when ``llm`` has draft models (``llm`` is an LLM or
    a ``loadgen.EngineHandle``)."""
    gen_cfg = getattr(llm, "generation_config", None)
    if llm.ssms:
        return rm.generate_spec_infer(
            llm.ffmodel, [s.ffmodel for s in llm.ssms],
            generation_config=gen_cfg)
    return rm.generate_incr_decoding(llm.ffmodel, generation_config=gen_cfg)


# how long stop_server waits, after cancelling the stragglers, for the
# server thread to end its block (on the card a block takes well under a
# second; past this the device is taken to be hung)
STRAGGLER_JOIN_S = 120.0


def _start_server(llm, admission=None):
    srv = llm._server
    if srv is not None and (srv._stopping or not srv._thread.is_alive()):
        # a stopped server is replaced only once its thread has ended: two
        # loops must never share the manager and its in-place caches
        srv._thread.join(STRAGGLER_JOIN_S)
        if srv._thread.is_alive():
            raise RuntimeError("the stopped server's thread is still "
                               "running its block; cannot start another")
        llm._server = None
    if llm._server is None:
        ctrl = admission
        if ctrl is not None:
            from flexflow_tpu_torch.serve.admission import (
                AdmissionController, AdmissionPolicy)

            if isinstance(ctrl, AdmissionPolicy):
                ctrl = AdmissionController(ctrl)
        llm._server = _BackgroundServer(llm, admission=ctrl)
        llm._server.start()
    return llm


def _stop_server(llm, flush_timeout_s: Optional[float] = 30.0):
    """Stop the server; it is forgotten only once its thread has ended
    (until then ``start_server`` refuses and submissions raise)."""
    if llm._server is not None and llm._server.stop(flush_timeout_s):
        llm._server = None
    return llm


class _BackgroundServer:
    """The background serving loop (counterpart of the JAX package's).
    Submitter threads register requests under the
    condition lock and wait on a per-submission event; the server thread
    runs generation loops whenever work is queued, and requests that
    arrive while a loop runs join its continuous batch at the next slot
    fill. Every device call is made on the server thread.

    With an ``admission`` controller, a submission is admitted or rejected
    under the same lock that registers it, so the queue-depth check and
    the registration are atomic; the realized queue waits of each loop
    feed the controller's windowed p99, which its retry-after hints use.
    A rejection is noted in the manager's telemetry when it is on.

    Torch state that belongs to a thread (grad mode, the current device)
    is set on the server thread itself: grad off, and the model's device
    current. Kernels launch on that thread's current stream, the default
    stream, as on a thread that entered no stream context."""

    def __init__(self, llm, admission=None):
        import torch

        self.llm = llm
        self.admission = admission
        # the model's device, its index resolved here: the server thread's
        # current device is its own, and "cuda" means the caller's
        dev = torch.device(llm.ffmodel.device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self._device = dev
        self._work = threading.Condition()
        self._stopping = False
        # (remaining-guid-set, event) per submission
        self._waiters: List[Tuple[set, threading.Event]] = []
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="flexflow-torch-serve")
        self._error: Optional[BaseException] = None

    def start(self):
        self._thread.start()

    def submit(self, prompts, max_new_tokens: int, max_length: int,
               timeout_s: Optional[float] = None, tenant: str = "default",
               priority: int = 0, trace_id: Optional[str] = None,
               failovers: int = 0, preemptions: int = 0
               ) -> Tuple[List[int], threading.Event]:
        """Register ``prompts`` and return (guids, an event set once all
        resolve). ``trace_id``, ``failovers`` and ``preemptions`` carry a
        replica pool's fleet-wide id and earlier lives' counts
        (RequestManager.register_new_request)."""
        ev = threading.Event()
        with self._work:
            if self._error is not None:
                raise RuntimeError("serving loop died") from self._error
            if self._stopping or not self._thread.is_alive():
                raise RuntimeError(
                    "server is stopping/stopped; submit raced stop_server()")
            if self.admission is not None:
                depth = len(self.llm.rm.pending)
                try:
                    self.admission.admit(tenant, depth, n=len(prompts))
                except RejectedError as e:
                    tel = self.llm.rm._tel()
                    if tel is not None:
                        tel.note_rejected(tenant, e.reason, depth)
                    raise
            guids = [self.llm.rm.register_new_request(
                p, max_new_tokens=max_new_tokens,
                max_sequence_length=max_length, timeout_s=timeout_s,
                tenant=tenant, priority=priority, trace_id=trace_id,
                failovers=failovers, preemptions=preemptions)
                for p in prompts]
            self._waiters.append((set(guids), ev))
            self._work.notify_all()
        return guids, ev

    def stop(self, flush_timeout_s: Optional[float] = 30.0) -> bool:
        """Flush, then cancel the stragglers and wait for the thread to
        end its block; every waiter resolves. True when the thread has
        ended."""
        with self._work:
            self._stopping = True
            self._work.notify_all()
        self._thread.join(flush_timeout_s)
        if self._thread.is_alive():
            # the flush window closed mid-batch: cancel everything still
            # outstanding; the loops reap cancellations between decode
            # rounds, so the thread ends with its current block
            rm = self.llm.rm
            for guid in list(rm.inflight):
                rm.cancel(guid)
            self._thread.join(STRAGGLER_JOIN_S)
        # every waiter resolves, even if its guids never produced results
        # (LLM.generate turns a missing result into an explicit error)
        with self._work:
            for _, ev in self._waiters:
                ev.set()
            self._waiters.clear()
        return not self._thread.is_alive()

    def _run(self):
        import torch

        try:
            if self._device.type == "cuda":
                torch.cuda.set_device(self._device)
            with torch.no_grad():
                self._serve()
        except BaseException as e:       # surface to submitters
            # fail every in-flight and queued request with this error (each
            # gets a status="error" result), then release every waiter:
            # submitters raise instead of hanging, and the manager is clean
            # for a restarted server
            with self._work:
                self.llm.rm.abort_outstanding(e)
                self._error = e
                for _, ev in self._waiters:
                    ev.set()
                self._waiters.clear()
            raise

    def _serve(self):
        rm = self.llm.rm
        while True:
            with self._work:
                while not rm.pending and not self._stopping:
                    self._work.wait(timeout=0.05)
                if self._stopping and not rm.pending:
                    # release any waiters for already-finished guids
                    for _, ev in self._waiters:
                        ev.set()
                    return
            done = _run_loop(self.llm, rm)
            with self._work:
                if self.admission is not None:
                    for res in done or ():
                        if res.queue_wait_s > 0.0:
                            self.admission.observe_queue_wait(
                                res.queue_wait_s)
                done_guids = set(rm.results)
                fire, keep = [], []
                for guids, ev in self._waiters:
                    guids -= done_guids
                    (keep if guids else fire).append((guids, ev))
                self._waiters = keep
            for _, ev in fire:
                ev.set()


class SSM(LLM):
    """Small speculative model: a draft model (reference
    serve/serve.py SSM), built in BEAM_SEARCH_MODE."""

    inference_mode = InferenceMode.BEAM_SEARCH_MODE
