"""FFConfig of the PyTorch/CUDA port: the serving, quantization and
fusion fields of ``flexflow_tpu.config.FFConfig`` plus ``device``.

The device alone decides the attention path: CUDA tensors go to the
hand-written kernels, CPU tensors to their plain PyTorch versions. There
is no switch that puts the plain version on the card, and no silent CPU
fallback — asking for ``cuda`` where CUDA is missing raises
(``resolve_device``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from flexflow_tpu_torch.quant import normalize_qtype


@dataclasses.dataclass
class FFConfig:
    # where the model's parameters, KV caches and activations live
    device: str = "cuda"
    seed: int = 0
    # activations compute in compute_dtype; params keep their WeightSpec dtype
    compute_dtype: str = "float32"

    # --- serving shapes (reference BatchConfig::max_requests_per_batch /
    # max_tokens_per_batch / max_sequence_length) ---
    max_requests_per_batch: int = 8
    max_tokens_per_batch: int = 128
    max_sequence_length: int = 256
    kv_cache_dtype: str = "bfloat16"
    # decode steps / speculation rounds per host readback (serve/engine.py
    # decode block and speculative engines)
    decode_block_steps: int = 8
    spec_rounds_per_call: int = 4
    # draft beam width (reference BeamSearchBatchConfig::MAX_BEAM_WIDTH):
    # a BEAM_SEARCH_MODE graph built at a width above 1 ends in the packed
    # [top-W probs, top-W ids] head that beam drafting reads
    max_beam_width: int = 1
    # incremental-decode step width; 0 = auto: the padded verify width (8)
    # where the CUDA kernel serves the config, 1 elsewhere
    # (InferenceManager._resolve_decode_width)
    decode_width: int = 0

    # --- weights ---
    # weight-only quantization of the serving matmul weights: None | "int8"
    # | "int4" (normalized from the aliases quant.normalize_qtype takes);
    # each layer is quantized as it is initialized, and LLM.compile
    # quantizes again after loading (quant.py)
    quantization_type: Optional[str] = None
    # runtime fusion switch (the reference's --fusion); gemm_fusion needs it
    enable_fusion: bool = True
    # serving gemm fusion: wq|wk|wv -> one wqkv, SwiGLU gate|up -> one
    # [E, 2I] Linear (serve/gemm_fusion.py). Off by default, as in the JAX
    # package, where it measured slower end to end
    gemm_fusion: bool = False

    def __post_init__(self):
        self.quantization_type = normalize_qtype(self.quantization_type)


def resolve_device(name) -> torch.device:
    """The config's device, checked: a CUDA device that this process
    cannot reach raises instead of falling back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"FFConfig.device={str(name)!r} but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    return dev
