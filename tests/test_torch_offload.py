"""CPU weight offload of the port (``offload.py``) against the JAX
package and against itself with offload off, on the CPU.

Mirrors ``tests/test_offload.py`` and ``tests/test_serving_pp.py``'s
PP x offload case. On a CPU model the host is the device: offload runs
the same bookkeeping and per-layer fetch path without pinning (the card's
pinned pages and side-stream prefetch are checked by the ``cuda`` case
and ``chip_smoke.py`` phase 14a). Offload on and off must give identical
results, alone, after int8/int4 quantization, through ``LLM.compile``
and under pipeline parallelism (spawned gloo ranks).
"""

import numpy as np
import pytest
import torch

import flexflow_tpu as ff
import flexflow_tpu_torch as fft
from flexflow_tpu_torch.convert import load_params, params_from_jax
from flexflow_tpu_torch.offload import (Prefetcher, fetch_layer_params,
                                        host_memory_supported)
from flexflow_tpu_torch.parallel.launch import run_ranks
from flexflow_tpu_torch.quant import is_quantized

TINY4 = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=4, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=128)
SERVE = dict(max_requests_per_batch=2, max_sequence_length=64,
             max_tokens_per_batch=16, seed=0, kv_cache_dtype="float32")
PROMPTS = [[5, 9, 23, 44], [7, 3]]


def _graph(pkg, model, batch):
    t = model.create_tensor([batch, 256], pkg.DataType.DT_FLOAT)
    x = model.dense(t, 256, pkg.ActiMode.AC_MODE_RELU)
    x = model.dense(x, 64)
    model.softmax(x)


_jax = {}


def _jax_model():
    if "m" not in _jax:
        jm = ff.FFModel(ff.FFConfig(batch_size=16))
        _graph(ff, jm, 16)
        jm.compile()
        _jax["m"] = jm
    return _jax["m"]


def _model(batch=16):
    """The JAX test's model in the port, with the JAX model's weights."""
    m = fft.FFModel(fft.FFConfig(batch_size=batch, device="cpu"))
    _graph(fft, m, batch)
    m.compile()
    load_params(m, params_from_jax({k: {w: np.asarray(a)
                                        for w, a in lp.items()}
                                    for k, lp in _jax_model().params.items()}))
    return m


def test_offload_predict_identical():
    model = _model()
    x = np.random.RandomState(0).randn(16, 256).astype(np.float32)
    full = model.predict(x)
    np.testing.assert_allclose(full, _jax_model().predict(x), rtol=1e-5,
                               atol=1e-6)
    moved = model.offload_weights(min_bytes=1024)
    assert moved == sum(lp["kernel"].nbytes
                        for lp in model.params.values())
    assert set(model._offloaded) == {"linear", "linear_1"}
    assert set(model._offloaded["linear"]) == {"kernel"}   # bias stays
    got = model.predict(x)
    np.testing.assert_array_equal(got, full)
    assert model._prefetcher.bytes_fetched == moved


@pytest.mark.parametrize("qtype,tol", [("int8", 0.02), ("int4", 0.3)])
def test_offload_composes_with_quantization(qtype, tol):
    model = _model()
    x = np.random.RandomState(1).randn(16, 256).astype(np.float32)
    full = model.predict(x)
    model.quantize_weights(qtype)
    quant = model.predict(x)
    moved = model.offload_weights(min_bytes=1024)
    assert moved > 0
    qw = model.params["linear"]["kernel"]
    assert is_quantized(qw)                   # the payload pages, compressed
    assert moved == sum(lp["kernel"].nbytes for lp in model.params.values())
    got = model.predict(x)
    np.testing.assert_array_equal(got, quant)
    rel = np.abs(got - full).max() / max(1e-6, np.abs(full).max())
    assert rel < tol


def test_offload_idempotent():
    model = _model()
    moved1 = model.offload_weights(min_bytes=1024)
    assert moved1 > 0
    before = {k: dict(v) for k, v in model._offloaded.items()}
    assert model.offload_weights(min_bytes=1024) == 0
    assert model._offloaded == before
    # every record points back at the model's device
    assert {d for ws in before.values() for d in ws.values()} == \
        {model.device}


def test_fetch_moves_the_compressed_leaf():
    model = _model()
    model.quantize_weights("int8")
    model.offload_weights(min_bytes=1024)
    lp = fetch_layer_params(model, "linear", model.params["linear"])
    assert is_quantized(lp["kernel"]) and lp["kernel"].q.dtype == torch.int8
    assert lp["bias"] is model.params["linear"]["bias"]


def test_prefetcher_follows_graph_order():
    model = _model()
    model.offload_weights(min_bytes=1024)
    pf = model._prefetcher
    assert isinstance(pf, Prefetcher)
    assert pf.order == ["linear", "linear_1"]
    assert pf.reserve == model.config.offload_reserve_space_size
    assert host_memory_supported("cpu")


_serving = {}


def _llm(offload, quant=None):
    """LLM of the serve CLI's built-in geometry (its 1 MiB embedding and
    head reach offload's default threshold), offload on or off."""
    from flexflow_tpu_torch.serve.__main__ import default_state_dict

    key = (offload, quant)
    if key not in _serving:
        llm = fft.LLM(default_state_dict(2))
        llm.compile(max_requests_per_batch=2, max_seq_length=64,
                    max_tokens_per_batch=16, device="cpu",
                    kv_cache_dtype="float32", cpu_offload=offload,
                    **({"quantization_type": quant} if quant else {}))
        res = llm.generate([[5, 9, 23, 44], [7, 3]], max_new_tokens=8)
        _serving[key] = (llm, [r.output_tokens for r in res])
    return _serving[key]


@pytest.mark.parametrize("quant", [None, "int8"])
def test_llm_compile_offload_tokens_identical(quant):
    """LLM.compile(cpu_offload=True) pages the weights at compile (after
    quantization, before fusion) and serves the tokens of offload off."""
    from flexflow_tpu_torch.offload import _OFFLOAD_NAMES

    llm, on = _llm(True, quant)
    off_llm, off = _llm(False, quant)
    assert on == off
    # exactly the serving weights of at least offload's default 1 MiB
    # (fp32: the embedding and the head; int8 leaves all fall below it)
    want = {layer for layer, lp in off_llm.ffmodel.params.items()
            if any(w in _OFFLOAD_NAMES and a.nbytes >= 1 << 20
                   for w, a in lp.items())}
    assert set(llm.ffmodel._offloaded) == want
    assert ("lm_head" in want) == (quant is None)
    assert not llm.ffmodel._gemm_fusion_done or \
        "wqkv" not in llm.ffmodel.params.get("layers.0.self_attn", {})


def test_offload_serving_matches_jax():
    """Tiny LLaMA with the JAX model's weights: the port's tokens with
    every weight paged equal the JAX package's."""
    from flexflow_tpu.models.llama import LLAMAConfig as JCfg
    from flexflow_tpu.models.llama import create_llama_model as jax_llama
    from flexflow_tpu.serve.request_manager import RequestManager as JRM
    from flexflow_tpu_torch.models.llama import (LLAMAConfig,
                                                 create_llama_model)
    from flexflow_tpu_torch.serve.request_manager import RequestManager

    jm = ff.FFModel(ff.FFConfig(use_native_scheduler=False, **SERVE))
    jax_llama(jm, JCfg(**TINY4))
    jm.compile(comp_mode=ff.CompMode.COMP_MODE_INFERENCE)
    pm = fft.FFModel(fft.FFConfig(device="cpu", **SERVE))
    create_llama_model(pm, LLAMAConfig(**TINY4))
    pm.compile()
    load_params(pm, params_from_jax({k: {w: np.asarray(a)
                                         for w, a in lp.items()}
                                     for k, lp in jm.params.items()}))
    assert pm.offload_weights(min_bytes=1) > 0

    def gen(rm, m):
        for p in PROMPTS:
            rm.register_new_request(p, max_new_tokens=8)
        return {tuple(r.input_tokens): r.output_tokens
                for r in rm.generate_incr_decoding(m)}

    assert gen(RequestManager(), pm) == gen(JRM(), jm)


@pytest.fixture(scope="module")
def pp_offload_runs(tmp_path_factory):
    runs = []
    for quant in (None, "int8"):
        cfg = dict(SERVE, pipeline_parallelism_degree=2,
                   **({"quantization_type": quant} if quant else {}))
        for off in (False, True):
            runs.append(dict(name=f"{quant}-{off}", model=TINY4, config=cfg,
                             prompts=PROMPTS, max_new=8, offload=off))
    # a reserve below one block's bytes: each microbatch fetches again
    runs.append(dict(name="int8-True-small", model=TINY4,
                     config=dict(cfg, offload_reserve_space_size=1),
                     prompts=PROMPTS, max_new=8, offload=True))
    return run_ranks("flexflow_tpu_torch.parallel.rank_jobs:serve", 2,
                     {"device": "cpu", "runs": runs},
                     workdir=tmp_path_factory.mktemp("ppoff"), timeout=240)


@pytest.mark.parametrize("quant", ["None", "int8"])
def test_pp_offload_matches(pp_offload_runs, quant):
    """PP x offload: each stage pages its stage-stacked leaves and
    streams each block's slices back; tokens equal the in-memory pp run
    on both stages."""
    for rank in pp_offload_runs:
        by = {r["name"]: r for r in rank}
        on, off = by[f"{quant}-True"], by[f"{quant}-False"]
        assert on["tokens"] == off["tokens"]
        assert on["moved"] > 0 and off["moved"] == 0
        assert "__pp_blocks__" in on["offloaded"]


def test_pp_offload_fetches_a_block_once_a_forward(pp_offload_runs):
    """The 2 microbatches of a pp=2 forward share each block's fetch when
    the stage's paged bytes fit the reserve; with a reserve below a
    block's bytes each microbatch fetches it again: the same forwards
    stream more bytes (twice in a forward of 2 microbatches, the same in
    one of 1), for the same tokens."""
    for rank in pp_offload_runs:
        by = {r["name"]: r for r in rank}
        once, again = by["int8-True"], by["int8-True-small"]
        assert again["tokens"] == once["tokens"]
        assert 0 < once["fetched"] < again["fetched"] <= 2 * once["fetched"]


@pytest.mark.cuda
def test_offload_pages_pinned_memory_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (pinned pages and the side-stream "
                    "prefetch exist only on the card)")
    m = fft.FFModel(fft.FFConfig(batch_size=16, device="cuda"))
    _graph(fft, m, 16)
    m.compile()
    x = np.random.RandomState(0).randn(16, 256).astype(np.float32)
    full = m.predict(x)
    assert m.offload_weights(min_bytes=1024) > 0
    k = m.params["linear"]["kernel"]
    assert k.device.type == "cpu" and k.is_pinned()
    np.testing.assert_array_equal(m.predict(x), full)
