"""User-facing serving API: ``LLM`` and its draft model ``SSM``
(counterpart of ``flexflow_tpu/serve/api.py``).

An LLM is built from a ``(hf_config, state_dict)`` pair: the config (a
dict or an object with the HF attribute names) picks the model family,
``compile`` records the serving graph on ``device``, initializes it and
copies the HF weights in, and ``generate`` runs the continuous-batching
incremental decoder or, with SSMs attached at ``compile``, speculative
inference::

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

No server, checkpoint loading or transformers import in this slice.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Union

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.ffconst import CompMode, DataType, InferenceMode
from flexflow_tpu_torch.serve.batch_config import GenerationConfig
from flexflow_tpu_torch.serve.request_manager import (GenerationResult,
                                                      RequestManager)


class LLM:
    """A large language model to serve, from ``(hf_config, state_dict)``."""

    inference_mode = InferenceMode.INC_DECODING_MODE

    def __init__(self, model: Any, data_type: DataType = DataType.DT_FLOAT,
                 tokenizer: Any = None):
        from flexflow_tpu_torch.models import family_for_hf_config

        if not (isinstance(model, (tuple, list)) and len(model) == 2):
            raise TypeError("the PyTorch port builds an LLM from a "
                            "(hf_config, state_dict) pair")
        self.hf_config, self._state_dict = model
        self.data_type = data_type
        self.tokenizer = tokenizer
        self.ffmodel = None
        self.ssms: List["SSM"] = []
        self.rm: Optional[RequestManager] = None
        self.family = family_for_hf_config(self.hf_config)
        self.model_config = self.family.config_cls.from_hf_config(
            self.hf_config)

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
        config = FFConfig(max_requests_per_batch=max_requests_per_batch,
                          max_sequence_length=max_seq_length,
                          max_tokens_per_batch=max_tokens_per_batch,
                          **ffconfig_kwargs)
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
        self.ffmodel.finalize_gemm_fusion()
        self.rm = RequestManager()
        if self.tokenizer is not None:
            self.rm.register_tokenizer(self.tokenizer)
        else:
            get = (self.hf_config.get if isinstance(self.hf_config, dict)
                   else lambda k, d=None: getattr(self.hf_config, k, d))
            self.rm.eos_token_id = get("eos_token_id", None)
        for ssm in self.ssms:
            ssm.compile(generation_config=self.generation_config,
                        max_requests_per_batch=max_requests_per_batch,
                        max_seq_length=max_seq_length,
                        max_tokens_per_batch=max_tokens_per_batch,
                        **ffconfig_kwargs)
        return self

    def generate(self, requests_or_prompts: Union[str, Sequence],
                 max_new_tokens: int = 128, max_length: int = 0
                 ) -> Union[GenerationResult, List[GenerationResult]]:
        """Generate for one prompt (a string or a list of token ids) or a
        list of prompts; results come back in prompt order. Speculative
        inference when SSMs were attached at ``compile``."""
        if self.ffmodel is None:
            raise RuntimeError("call LLM.compile() before generate()")
        single = isinstance(requests_or_prompts, str) or (
            requests_or_prompts and isinstance(requests_or_prompts[0], int))
        prompts = ([requests_or_prompts] if single
                   else list(requests_or_prompts))
        if not prompts:
            return []
        guids = [self.rm.register_new_request(
            p, max_new_tokens=max_new_tokens, max_sequence_length=max_length)
            for p in prompts]
        if self.ssms:
            self.rm.generate_spec_infer(
                self.ffmodel, [s.ffmodel for s in self.ssms],
                generation_config=self.generation_config)
        else:
            self.rm.generate_incr_decoding(
                self.ffmodel, generation_config=self.generation_config)
        results = [self.rm.results[g] for g in guids]
        return results[0] if single else results


class SSM(LLM):
    """Small speculative model: a draft model (reference
    serve/serve.py SSM), built in BEAM_SEARCH_MODE."""

    inference_mode = InferenceMode.BEAM_SEARCH_MODE
