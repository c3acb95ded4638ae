"""The serving step as a program (``InferenceManager.step``), the host
tree path's commit program, the capturable ``append_kv`` and the offload
ring, against the JAX package on the CPU.

On the CPU a program is its stage called directly; what the card
captures as a CUDA graph is the same function over the same device
tensors, so these tests pin what both share:

* (a) build accounting against the JAX jit: an incremental generate
  over prompts of mixed lengths and the host tree path with two beam
  drafts, through both packages on the same weights: the same tokens,
  and each model's ``step_builds`` equal to its JAX manager's traces of
  ``_step_impl``; a second identical run builds nothing in either;
* (b) no step body reads the host: a prefill chunk, a width-1 step, a
  tree verify, a beam level, the commit, the same on an offloaded
  model, and the other families' steps (``test_torch_engine_programs``'s
  dispatch mode);
* (c) ``append_kv`` bit for bit against the JAX cache update in fp32:
  ragged counts, an inactive row, a row with no token, a row whose
  tokens end at the last column with padding past it, and a write past
  the cache end that is dropped;
* (d) the offload ring: its schedule never puts two live units in one
  byte, its size stays within the bound, and an offloaded model's
  tokens equal those of the model without offload.
"""

import collections
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu.ffconst import InferenceMode as JMode
from flexflow_tpu.models.llama import LLAMAConfig as JLlamaConfig
from flexflow_tpu.models.llama import create_llama_model as jax_create_llama
from flexflow_tpu.ops.inc_attention import append_kv as jax_append_kv
from flexflow_tpu.ops.inc_attention import \
    append_kv_stacked as jax_append_kv_stacked
from flexflow_tpu.serve import inference_manager as jax_im
from flexflow_tpu.serve.request_manager import RequestManager as JRM
import flexflow_tpu_torch as fft
from flexflow_tpu_torch import kernels
from flexflow_tpu_torch.convert import load_params, params_from_jax
from flexflow_tpu_torch.ffconst import InferenceMode
from flexflow_tpu_torch.models.checkpoint_store import build_tiny
from flexflow_tpu_torch.models.llama import LLAMAConfig, create_llama_model
from flexflow_tpu_torch.offload import ring_schedule, ring_waits
from flexflow_tpu_torch.ops.inc_attention import append_kv, append_kv_stacked
from flexflow_tpu_torch.serve import graphs
from flexflow_tpu_torch.serve.batch_config import (BatchMeta, TreeBatchMeta,
                                                   ancestor_mask_from_parents)
from flexflow_tpu_torch.serve.inference_manager import InferenceManager
from flexflow_tpu_torch.serve.request_manager import (CommitProgram,
                                                      RequestManager)
from test_torch_engine_programs import (_FakeGraph, _FakeStream,  # noqa: F401
                                        _NoHostRead, no_host_read)

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
SERVE = dict(max_requests_per_batch=2, max_sequence_length=64,
             max_tokens_per_batch=16, seed=0, kv_cache_dtype="float32")
# mixed lengths: one prompt takes two prefill chunks of 8
PROMPTS = [([5, 9, 23, 44, 17, 3, 8, 61, 2, 30, 7], 6), ([7, 3, 11], 8),
           ([2, 4], 5)]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port_model(mode, weights, beam_width=1, **kw):
    """A tiny port LLaMA on the CPU carrying a JAX model's weights."""
    pm = fft.FFModel(fft.FFConfig(device="cpu", **dict(SERVE, **kw),
                                  max_beam_width=beam_width))
    create_llama_model(pm, LLAMAConfig(**TINY), mode=mode)
    pm.compile()
    load_params(pm, params_from_jax(
        {layer: {w: np.asarray(a) for w, a in lp.items()}
         for layer, lp in weights.items()}))
    return pm


def _jax_draft(seed):
    jm = ff.FFModel(ff.FFConfig(**dict(SERVE, seed=seed), max_beam_width=2))
    jax_create_llama(jm, JLlamaConfig(**TINY), mode=JMode.BEAM_SEARCH_MODE)
    jm.compile(comp_mode=ff.CompMode.COMP_MODE_INFERENCE)
    return jm


@pytest.fixture(scope="module")
def family(tiny_spec_pair):
    """(JAX verifier, port verifier, [(JAX draft, port draft)] x 2): the
    tiny spec pair's verifier and two beam drafts of width 2 (seeds 3
    and 5), each port model on its JAX twin's weights."""
    jllm = tiny_spec_pair[0]
    drafts = [_jax_draft(s) for s in (3, 5)]
    return (jllm, _port_model(InferenceMode.TREE_VERIFY_MODE, jllm.params),
            [(jd, _port_model(InferenceMode.BEAM_SEARCH_MODE, jd.params,
                              beam_width=2)) for jd in drafts])


def _gen(rm, run):
    guids = [rm.register_new_request(p, max_new_tokens=n) for p, n in PROMPTS]
    run(rm)
    return [rm.results[g].output_tokens for g in guids]


# ----------------------------------------------------------------------
# (a) step programs built as the JAX step traces
# ----------------------------------------------------------------------
def test_step_builds_equal_jax_traces(family, monkeypatch):
    jllm, pllm, drafts = family
    jmodels = [jllm] + [jd for jd, _ in drafts]
    pmodels = [pllm] + [pd for _, pd in drafts]
    traces = collections.Counter()
    impl = jax_im.InferenceManager._step_impl

    def counted(self, params, op_state, meta, rng):
        traces[id(self.model)] += 1
        return impl(self, params, op_state, meta, rng)

    monkeypatch.setattr(jax_im.InferenceManager, "_step_impl", counted)
    for m in jmodels:                 # managers made after the wrap
        monkeypatch.setattr(m, "_inference_manager", None, raising=False)

    def runs(rm_cls, llm, ssms):
        return [_gen(rm_cls(), lambda rm: rm.generate_incr_decoding(llm)),
                _gen(rm_cls(), lambda rm: rm._generate_spec_tree_host(
                    llm, ssms, spec_depth=2, beam_width=2))]

    jout = runs(JRM, jllm, jmodels[1:])
    tout = runs(RequestManager, pllm, pmodels[1:])
    assert tout == jout
    builds = [m._inference_manager.step_builds for m in pmodels]
    assert builds == [traces[id(m)] for m in jmodels]
    # the llm's prefill chunk and at least one verify width; each draft's
    # prefill chunk and its beam levels
    assert builds[0] >= 2 and min(builds[1:]) >= 2
    assert pllm._inference_manager._steps.programs      # every key kept
    # the same runs again: nothing new to build in either package
    assert runs(RequestManager, pllm, pmodels[1:]) == tout
    assert runs(JRM, jllm, jmodels[1:]) == jout
    assert [m._inference_manager.step_builds for m in pmodels] == builds
    assert [traces[id(m)] for m in jmodels] == builds


# ----------------------------------------------------------------------
# (b) no step body reads the host
# ----------------------------------------------------------------------
def _batch(Q, num):
    R = len(num)
    tokens = np.arange(R * Q, dtype=np.int32).reshape(R, Q) % 100 + 1
    start = np.array([4, 9], np.int32)[:R]
    return BatchMeta(tokens=tokens,
                     positions=start[:, None] + np.arange(Q, dtype=np.int32),
                     start_pos=start, num_tokens=np.asarray(num, np.int32),
                     active=np.asarray(num) > 0)


def _tree(T, n):
    R = len(n)
    parent = np.full((R, T), -1, np.int32)
    parent[:, 1:] = np.arange(T - 1)[None, :] // 2
    depth = np.zeros((R, T), np.int32)
    for j in range(1, T):
        depth[:, j] = depth[:, parent[0, j]] + 1
    start = np.array([6, 11], np.int32)[:R]
    return TreeBatchMeta(
        tokens=(np.arange(R * T, dtype=np.int32).reshape(R, T) % 90 + 3),
        positions=start[:, None] + depth, parent=parent,
        ancestor=ancestor_mask_from_parents(parent), start_pos=start,
        num_nodes=np.asarray(n, np.int32), active=np.ones(R, bool))


STEPS = {"prefill chunk": (InferenceMode.TREE_VERIFY_MODE, 1,
                           lambda: _batch(8, [8, 5])),
         "width 1": (InferenceMode.TREE_VERIFY_MODE, 1,
                     lambda: _batch(1, [1, 0])),
         "tree verify": (InferenceMode.TREE_VERIFY_MODE, 1,
                         lambda: _tree(8, [7, 3])),
         "beam level": (InferenceMode.BEAM_SEARCH_MODE, 2,
                        lambda: _tree(8, [5, 3]))}


@pytest.mark.parametrize("offload", [False, True])
@pytest.mark.parametrize("name", list(STEPS))
def test_step_bodies_read_no_host(no_host_read, tiny_spec_pair, name,
                                  offload):
    mode, width, meta = STEPS[name]
    m = _port_model(mode, tiny_spec_pair[0].params, beam_width=width)
    if offload:
        assert m.offload_weights(min_bytes=1024) > 0
    ifm = InferenceManager(m)
    out = ifm.step(meta())
    assert no_host_read == ["step"] and ifm.step_builds == 1
    R, Q = meta().tokens.shape
    assert out.shape[:2] == (R, Q)
    # the step's output is a copy: the next step (other tokens) leaves it
    again, other = out.copy(), meta()
    other.tokens = other.tokens + 1
    ifm.step(other)
    np.testing.assert_array_equal(out, again)
    assert ifm.step_builds == 1


@pytest.mark.parametrize("family", ["opt", "falcon", "mpt", "gpt_bigcode"])
def test_family_step_bodies_read_no_host(no_host_read, family):
    """The other families' prefill, width-1 and tree steps (learned
    positions, ALiBi, multi-query) read no host either."""
    m, _ = build_tiny(family, device="cpu")
    ifm = InferenceManager(m)
    metas = [_batch(8, [8, 5]), _batch(1, [1, 0]), _tree(8, [7, 3])]
    for meta in metas:
        assert ifm.step(meta).shape[:2] == meta.tokens.shape
    assert no_host_read == ["step"] * 3 and ifm.step_builds == 3


def test_commit_body_reads_no_host(no_host_read, tiny_spec_pair):
    m = _port_model(InferenceMode.TREE_VERIFY_MODE, tiny_spec_pair[0].params)
    k = m.op_state["kv_cache"]["k"]
    k.copy_(torch.randn(k.shape, generator=torch.Generator().manual_seed(1)))
    before = k.clone()
    commit = CommitProgram()
    src = torch.tensor([[1, 3, 4], [0, 0, 0]], dtype=torch.int32)
    m.op_state = commit(m.op_state, src, torch.tensor([3, 0]),
                        torch.tensor([5, 9]), torch.tensor([True, True]))
    assert no_host_read == ["commit"] and commit.builds == 1
    np.testing.assert_array_equal(k[:, 0, :, 5:8].numpy(),
                                  before[:, 0][:, :, [6, 8, 9]].numpy())
    np.testing.assert_array_equal(k[:, 1].numpy(), before[:, 1].numpy())
    commit(m.op_state, src, torch.tensor([1, 0]), torch.tensor([5, 9]),
           torch.tensor([True, False]))
    assert commit.builds == 1


# ----------------------------------------------------------------------
# (c) append_kv against the JAX cache update
# ----------------------------------------------------------------------
R_, KH_, S_, D_ = 6, 2, 16, 4
# rows: a full chunk; ragged; inactive; tokens ending at S - 1 with their
# padding past S; tokens past the cache end (dropped); no token
START = np.array([0, 3, 4, S_ - 4, S_ - 2, 5], np.int32)
NUM = np.array([6, 2, 6, 4, 6, 0], np.int32)
ACTIVE = np.array([True, True, False, True, True, True])


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("Q", [1, 6])
def test_append_kv_matches_jax(stacked, Q):
    rng = np.random.RandomState(3)
    L = 3
    cache = rng.randn(L, R_, KH_, S_, D_).astype(np.float32)
    new = rng.randn(R_, Q, KH_, D_).astype(np.float32)
    num = np.minimum(NUM, Q)
    args = [START, num, ACTIVE]
    tc = torch.from_numpy(cache.copy())
    with _NoHostRead():
        if stacked:
            append_kv_stacked(tc, 1, torch.from_numpy(new),
                              *map(torch.from_numpy, args))
        else:
            append_kv(tc[1], torch.from_numpy(new),
                      *map(torch.from_numpy, args))
    if stacked:
        want = np.asarray(jax_append_kv_stacked(
            jnp.asarray(cache), 1, jnp.asarray(new), *map(jnp.asarray, args)))
    else:
        want = cache.copy()
        want[1] = np.asarray(jax_append_kv(jnp.asarray(cache[1]),
                                           jnp.asarray(new),
                                           *map(jnp.asarray, args)))
    np.testing.assert_array_equal(tc.numpy(), want)
    # the writes happened where they should, and only there
    np.testing.assert_array_equal(tc[1, 0, :, :Q].numpy(),
                                  new[0].transpose(1, 0, 2))
    if Q == 6:
        np.testing.assert_array_equal(tc[1, 3, :, S_ - 4:].numpy(),
                                      new[3, :4].transpose(1, 0, 2))
    np.testing.assert_array_equal(tc[1, 2].numpy(), cache[1, 2])
    np.testing.assert_array_equal(tc[1, 5].numpy(), cache[1, 5])
    np.testing.assert_array_equal(tc[[0, 2]].numpy(), cache[[0, 2]])


# ----------------------------------------------------------------------
# (d) the offload ring
# ----------------------------------------------------------------------
def test_ring_schedule_keeps_live_units_apart():
    sizes = [5, 3, 8, 2, 8, 1, 7, 4]
    for ring in (8, 10, 16, 38):
        offs = ring_schedule(sizes, ring)
        waits = ring_waits(sizes, offs)
        assert all(0 <= o and o + b <= ring for o, b in zip(offs, sizes))
        for i in range(len(sizes)):
            for j in range(i):
                apart = (offs[j] + sizes[j] <= offs[i]
                         or offs[i] + sizes[i] <= offs[j])
                # an overlapping earlier unit is at or before the wait
                assert apart or j <= waits[i] < i
        if ring >= sum(sizes):
            assert waits == [-1] * len(sizes)


@pytest.mark.parametrize("reserve", [1, 250000, 1 << 30])
def test_offload_ring_on_the_cpu(tiny_spec_pair, reserve, capsys):
    weights = tiny_spec_pair[0].params
    ref = _port_model(InferenceMode.TREE_VERIFY_MODE, weights)
    m = _port_model(InferenceMode.TREE_VERIFY_MODE, weights,
                    offload_reserve_space_size=reserve)
    assert m.offload_weights(min_bytes=1024) > 0
    pf = m._prefetcher
    largest = max(pf.sizes)
    assert pf.ring.numel() == pf.ring_bytes <= max(reserve, 2 * largest)
    assert pf.ring_bytes <= sum(pf.sizes)
    assert ("the ring is" in capsys.readouterr().out) == (
        pf.ring_bytes > reserve)
    # record, at each fetch, which units' copies went out
    issued, at = [], [None]
    copy, fetch = pf._copy, pf.fetch

    def logged_copy(i):
        issued.append((i, at[0]))
        copy(i)

    def logged_fetch(unit):
        at[0] = pf._index[unit]
        return fetch(unit)

    pf._copy, pf.fetch = logged_copy, logged_fetch
    out = [_gen(RequestManager(), lambda rm: rm.generate_incr_decoding(mm))
           for mm in (ref, m)]
    assert out[0] == out[1]
    assert pf.bytes_fetched > 0 and issued
    # a unit is live from its copy (issued during the fetch of unit
    # ``a``) through its own compute, which ends before the fetch of the
    # next unit; two units live at once never share a byte of the ring
    n = len(pf.order)
    passes, cur = [], []
    for i, a in issued:
        if i == 0 and a == 0 and cur:
            passes.append(cur)
            cur = []
        cur.append((i, a))
    passes.append(cur)
    assert len(passes) > 1
    for p in passes:
        assert [i for i, _ in p] == list(range(n))
        for i, a_i in p:
            assert a_i <= i
            for j, a_j in p:
                if j != i and a_i <= j and a_j <= i:
                    assert (pf.offsets[j] + pf.sizes[j] <= pf.offsets[i]
                            or pf.offsets[i] + pf.sizes[i] <= pf.offsets[j])
    # the ring holds every unit: a pass's copies all go out at its start
    assert all(a == 0 for p in passes for _i, a in p) == pf.holds_all


def test_fetched_bytes_count_at_each_replay(monkeypatch):
    """A host counter of a program's work (the prefetcher's bytes) goes
    through ``kernels.each_run``: nothing at the warm-up or the capture,
    once at each replay (faked CUDA graphs, as in
    ``test_torch_engine_programs``)."""
    for name, value in (
            ("CUDAGraph", _FakeGraph), ("Stream", lambda dev: _FakeStream()),
            ("current_stream", lambda dev: _FakeStream()),
            ("stream", lambda s: contextlib.nullcontext()),
            ("graph", lambda g, **kw: contextlib.nullcontext()),
            ("synchronize", lambda dev=None: None),
            ("graph_pool_handle", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, value)
    fetched = []

    def stage(st, gen):
        kernels.each_run(lambda: fetched.append(100))

    progs = graphs.ProgramSet({"step": stage},
                              {"active": torch.ones(2, dtype=torch.bool)},
                              capture=True)
    assert fetched == []
    progs.run("step")
    progs.run("step")
    assert fetched == [100, 100]
    # outside a capture the counter moves at once
    stage(None, None)
    assert fetched == [100, 100, 100]
