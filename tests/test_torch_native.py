"""The port's native host side against the JAX package, on the CPU.

The GPT-2 BPE and SentencePiece tokenizers run on the port's native
library (``flexflow_tpu_torch/native``, built with g++ from
``native/src``) and are held against the port's pure-Python oracles and
the JAX package's tokenizers on fuzzed text. The native batch scheduler
is driven through its lifecycle, and the native loop of
``RequestManager.generate_incr_decoding`` against the port's Python loop
and the JAX package's, on a deterministic fake model and on a tiny LLaMA
(vocab 128, hidden 64, 2 layers, 2 request slots, a 64-position fp32
cache) whose weights come from the JAX model. Cancellation, deadlines,
a mid-run handover to the Python loop and a failed library build close
it.
"""

import random
import string
import time

import numpy as np
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu.ffconst import InferenceMode as JMode
from flexflow_tpu.models.llama import LLAMAConfig as JLlamaConfig
from flexflow_tpu.models.llama import create_llama_model as jax_create_llama
from flexflow_tpu.native.sp_tokenizer import \
    SentencePieceTokenizer as JSPTokenizer
from flexflow_tpu.native.tokenizer import BPETokenizer as JBPETokenizer
from flexflow_tpu.serve.request_manager import RequestManager as JRM
import flexflow_tpu_torch as fft
from flexflow_tpu_torch import native
from flexflow_tpu_torch.convert import load_params, params_from_jax
from flexflow_tpu_torch.ffconst import InferenceMode
from flexflow_tpu_torch.models.llama import LLAMAConfig, create_llama_model
from flexflow_tpu_torch.native.scheduler import NativeBatchScheduler
from flexflow_tpu_torch.native.sp_tokenizer import (BYTE, CONTROL, NORMAL,
                                                    UNKNOWN,
                                                    SentencePieceTokenizer,
                                                    build_model_proto)
from flexflow_tpu_torch.native.tokenizer import (BPETokenizer,
                                                 PyBPETokenizer,
                                                 _bytes_to_unicode,
                                                 pretokenize)
from flexflow_tpu_torch.serve.request_manager import RequestManager

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
SERVE = dict(max_requests_per_batch=2, max_sequence_length=64,
             max_tokens_per_batch=16, seed=0, kv_cache_dtype="float32")
PROMPTS = [[5, 9, 23, 7], [11, 3, 19], [1, 2, 3, 4, 5, 6, 7, 8, 9], [42]]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# 1. tokenizers
# ----------------------------------------------------------------------
def _toy_vocab():
    """The JAX native test's toy GPT-2 vocab and merges."""
    bu = _bytes_to_unicode()
    vocab = {ch: i for i, ch in enumerate(bu.values())}
    merges = []

    def add(a, b):
        merges.append((a, b))
        if a + b not in vocab:
            vocab[a + b] = len(vocab)

    sp = bu[ord(" ")]
    for a, b in (("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o"),
                 ("w", "o"), ("r", "l"), ("wo", "rl"), ("worl", "d"),
                 (sp, "w"), (sp + "w", "orld"), ("t", "h"), ("th", "e"),
                 (sp, "the")):
        add(a, b)
    vocab["<|endoftext|>"] = len(vocab)
    return vocab, merges


def _fuzz_texts(seed=42, n=200):
    rng = random.Random(seed)
    cases = ["hello world", "it's the world's 'test'", "tab\tnewline\n",
             "unicode: café 日本語 emoji \U0001F600", "  x  ", "'''",
             "123abc", "hello" * 50, "", "a  b"]
    for _ in range(n):
        k = rng.randint(0, 60)
        cases.append("".join(rng.choice(string.printable) for _ in range(k)))
    return cases


def test_pretokenize_rules():
    assert pretokenize("hello world") == ["hello", " world"]
    assert pretokenize("it's fine") == ["it", "'s", " fine"]
    assert pretokenize("a  b") == ["a", " ", " b"]
    assert pretokenize("x!?y") == ["x", "!?", "y"]
    assert pretokenize("") == []


def test_bpe_native_matches_oracle_and_jax():
    """The native BPE gives the port's oracle's ids and the JAX
    package's tokenizer's on fuzzed text, and decodes back to it."""
    vocab, merges = _toy_vocab()
    tok = BPETokenizer(vocab=vocab, merges=merges)
    py = PyBPETokenizer(vocab, merges)
    jax_tok = JBPETokenizer(vocab=vocab, merges=merges)
    assert tok.vocab_size() == len(vocab) == jax_tok.vocab_size()
    assert tok.eos_token_id == vocab["<|endoftext|>"]
    for text in _fuzz_texts():
        ids = tok.encode(text)
        assert ids == py.encode(text) == jax_tok.encode(text), text
        assert tok.decode(ids) == py.decode(ids) == text


def test_bpe_from_files(tmp_path):
    import json

    vocab, merges = _toy_vocab()
    (tmp_path / "vocab.json").write_text(json.dumps(vocab),
                                         encoding="utf-8")
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges),
        encoding="utf-8")
    tok = BPETokenizer(vocab_path=str(tmp_path / "vocab.json"),
                       merges_path=str(tmp_path / "merges.txt"))
    text = "héllo wörld 你好, the world"
    assert tok.decode(tok.encode(text)) == text
    assert tok.encode(text) == PyBPETokenizer(vocab, merges).encode(text)


def make_sp_model(model_type: int, byte_fallback: bool = True,
                  seed: int = 0, n_words: int = 0) -> bytes:
    """A synthetic SentencePiece model (the JAX native test's): control
    pieces, ▁-prefixed words and subwords with seeded scores, the 256
    byte pieces; ``n_words`` extra numbered pieces pad the vocabulary."""
    rng = np.random.RandomState(seed)
    pieces = [("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL),
              ("</s>", 0.0, CONTROL)]
    words = ["the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog",
             "hello", "world", "token", "model", "serve", "très", "bien",
             "日本", "語"]
    subs = ["qu", "ick", "th", "e", "br", "own", "fo", "x", "ju", "mp", "s",
            "o", "ver", "la", "zy", "do", "g", "he", "llo", "wor", "ld",
            "to", "ken", "mo", "del", "ser", "ve", "a", "b", "c", "d", "t",
            "h", "i", "n", "r", "u", "w", "l", "▁"]
    vocab = []
    for w in words:
        vocab += ["▁" + w, w]
    vocab += subs + [f"w{i}" for i in range(n_words)]
    seen = set()
    for v in vocab:
        if v not in seen:
            seen.add(v)
            pieces.append((v, -float(rng.uniform(0.5, 12.0)), NORMAL))
    for b in range(256):
        pieces.append((f"<0x{b:02X}>", -100.0, BYTE))
    return build_model_proto(pieces, model_type=model_type,
                             byte_fallback=byte_fallback)


def _sp_corpus():
    rng = np.random.RandomState(42)
    corpus = ["the quick brown fox jumps over the lazy dog", "hello world",
              "  spaced   out  text ", "", " ", "très bien",
              "日本語 model", "emoji 🦙 fallback", "a\nb\tc",
              "serve the token model"]
    glyphs = list("abcdefgh xyz…éß中πλ🙂")
    for _ in range(40):
        parts = []
        for _ in range(rng.randint(1, 14)):
            if rng.rand() < 0.6:
                parts.append(str(rng.choice(
                    ["the", "quick", "fox", "model", "très", "日本"])))
            else:
                parts.append("".join(rng.choice(glyphs)
                                     for _ in range(rng.randint(1, 6))))
        corpus.append(" ".join(parts))
    return corpus


@pytest.mark.parametrize("model_type", [1, 2])   # unigram, BPE
def test_sp_native_matches_oracle_and_jax(model_type):
    """The native SentencePiece tokenizer gives the port's ``SpModel``
    oracle's ids and the JAX package's tokenizer's, with the BOS, and the
    same decoded text."""
    data = make_sp_model(model_type)
    tok = SentencePieceTokenizer(data)
    jtok = JSPTokenizer(data)
    assert (tok.eos_token_id, tok.bos_token_id, tok.vocab_size) == \
        (jtok.eos_token_id, jtok.bos_token_id, jtok.vocab_size)
    for text in _sp_corpus():
        ids = tok.encode_raw(text)
        assert ids == tok.model.encode_ids(text), text
        assert tok.encode(text) == jtok.encode(text) == \
            [tok.bos_token_id] + ids
        assert tok.decode(ids) == tok.model.decode_ids(ids) == \
            jtok.decode(ids)


def test_sp_roundtrip_and_llama_conventions(tmp_path):
    path = tmp_path / "tokenizer.model"
    path.write_bytes(make_sp_model(1))
    tok = SentencePieceTokenizer(str(path))
    text = "the quick fox 🦙 says ωmega"
    ids = tok.encode(text)
    assert ids[0] == tok.bos_token_id
    assert tok.decode(ids[1:]) == text
    assert tok.decode(tok.encode("  the   fox ")[1:]) == "the fox"
    with pytest.raises(ValueError):
        SentencePieceTokenizer(b"\x0a\x05abc")       # truncated field


# ----------------------------------------------------------------------
# 2. the scheduler
# ----------------------------------------------------------------------
def test_scheduler_lifecycle():
    s = NativeBatchScheduler(max_requests=2, max_seq=32, eos_id=99)
    assert s.supports_cancel
    s.add_request(1, [5, 6, 7], max_new=4)
    s.add_request(2, [8], max_new=2)
    s.add_request(3, [9, 10], max_new=3)
    assert s.fill_slots() == 2
    rows, tokens, positions, start, num, act = s.assemble_prefill(8, 64, 8)
    assert rows == 1 and act[0] and not act[1]
    assert list(tokens[0][:2]) == [5, 6] and num[0] == 2
    live, tok, pos, act = s.assemble_decode()
    assert live == 2 and (tok[0], pos[0], tok[1], pos[1]) == (7, 2, 8, 0)
    block = s.decode_block(8)
    assert block == 4
    toks = np.array([[20, 21, 22, 23], [30, 99, 0, 0]], np.int32)
    assert s.append_block(toks) == 2
    done = {}
    while (p := s.pop_done()) is not None:
        done[p[0]] = p
    assert done[1][1:] == ([5, 6, 7, 20, 21, 22, 23], 3)
    assert done[2][1] == [8, 30, 99]
    assert s.fill_slots() == 1
    assert s.cancel(3) and not s.cancel(3) and not s.cancel(77)
    assert s.pop_done()[0] == 3 and not s.has_work()


def test_scheduler_rejects_overlong_prompt():
    s = NativeBatchScheduler(max_requests=1, max_seq=8)
    s.add_request(7, list(range(8)), max_new=4)
    assert s.fill_slots() == 0
    assert s.pop_done()[0] == 7 and not s.has_work()


class _FakeIFM:
    """Deterministic model: next token = (last + position) % 50 + 1."""

    def __init__(self):
        self.calls = []

    def step(self, meta, want_output=True):
        self.calls.append(("prefill", int(np.asarray(meta.num_tokens).sum())))

    def decode_block(self, tok, pos, act, block):
        self.calls.append(("decode", int(block), int(act.sum())))
        out = np.zeros((tok.shape[0], block), np.int32)
        cur, p = tok.copy(), pos.copy()
        for j in range(block):
            cur = (cur + p) % 50 + 1
            p = p + 1
            out[:, j] = np.where(act, cur, 0)
        return out


class _Cfg:
    max_requests_per_batch = 3
    max_sequence_length = 24
    max_tokens_per_batch = 16      # a prefill chunk of 16 // 3 = 5
    decode_block_steps = 8         # longer than a chunk
    use_native_scheduler = True


@pytest.mark.parametrize("loop", ["native", "python", "jax-native",
                                  "jax-python"])
def test_fake_model_parity(loop):
    """One synthetic workload (an over-long prompt, EOS 13, staggered
    budgets) through every loop on the fake model: token-identical, the
    rejected request resolved as such. The port's two loops also run the
    same prefill steps and decode blocks (a cancel or an arrival meets
    the same seams on both)."""
    def run(rm_cls, native_on):
        rm = rm_cls(eos_token_id=13)
        prompts = [[3, 4, 5], [10], [7, 8], [1, 2, 3, 4, 5, 6], [9, 9],
                   list(range(30))]
        for i, pr in enumerate(prompts):
            rm.register_new_request(pr, max_new_tokens=6 + i)
        cfg = _Cfg()
        cfg.use_native_scheduler = native_on

        class Model:
            config = cfg
            _inference_manager = _FakeIFM()

        res = rm.generate_incr_decoding(Model())
        return (sorted((tuple(r.input_tokens), tuple(r.output_tokens))
                       for r in res), Model._inference_manager.calls)

    want, calls = run(RequestManager, False)
    assert len(want) == 6 and {c[0] for c in calls} == {"prefill", "decode"}
    got, got_calls = {"native": lambda: run(RequestManager, True),
                      "python": lambda: (want, calls),
                      "jax-native": lambda: run(JRM, True),
                      "jax-python": lambda: run(JRM, False)}[loop]()
    assert got == want
    if loop == "native":
        assert got_calls == calls


# ----------------------------------------------------------------------
# 3. the tiny LLaMA on every loop
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    jm = ff.FFModel(ff.FFConfig(use_native_scheduler=False, **SERVE))
    jax_create_llama(jm, JLlamaConfig(**TINY), mode=JMode.INC_DECODING_MODE)
    jm.compile(comp_mode=ff.CompMode.COMP_MODE_INFERENCE)
    ports = {}
    for native_on in (True, False):
        m = fft.FFModel(fft.FFConfig(device="cpu",
                                     use_native_scheduler=native_on,
                                     **SERVE))
        create_llama_model(m, LLAMAConfig(**TINY),
                           mode=InferenceMode.INC_DECODING_MODE)
        m.compile()
        load_params(m, params_from_jax(jm.params))
        ports[native_on] = m
    return jm, ports


def _tokens(rm, model, prompts, n):
    guids = [rm.register_new_request(p, max_new_tokens=n) for p in prompts]
    rm.generate_incr_decoding(model)
    return [rm.results[g].output_tokens for g in guids]


class _SpyRM(RequestManager):
    """Counts the turns of each loop."""

    def __init__(self, hook=None, **kw):
        super().__init__(**kw)
        self.turns = {"native": 0, "python": 0}
        self.hook = hook

    def _generate_incr_native(self, *a):
        self.turns["native"] += 1
        return super()._generate_incr_native(*a)

    def _generate_incr_python(self, *a):
        self.turns["python"] += 1
        return super()._generate_incr_python(*a)

    def _reap_expired(self, active, max_seq, done, ctrl=None):
        if self.hook is not None:
            self.hook(self, active)
        return super()._reap_expired(active, max_seq, done, ctrl)


def test_default_is_native_and_tiny_llama_matches_jax(models):
    """``use_native_scheduler`` is on by default; the native loop, the
    Python loop and the JAX package's loops give the same tokens (more
    requests than slots, so slots are refilled mid-run)."""
    jm, ports = models
    assert fft.FFConfig().use_native_scheduler
    jax_py = _tokens(JRM(), jm, PROMPTS, 10)
    jm.config.use_native_scheduler = True
    try:
        jax_native = _tokens(JRM(), jm, PROMPTS, 10)
    finally:
        jm.config.use_native_scheduler = False
    rm = _SpyRM()
    native_toks = _tokens(rm, ports[True], PROMPTS, 10)
    assert rm.turns == {"native": 1, "python": 0}
    rm = _SpyRM()
    python_toks = _tokens(rm, ports[False], PROMPTS, 10)
    assert rm.turns == {"native": 0, "python": 1}
    assert native_toks == python_toks == jax_py == jax_native
    assert all(len(t) == 10 for t in native_toks)


def test_native_cancel_and_deadline(models):
    """On the native loop: a request cancelled before the loop and one
    expired on arrival resolve with no tokens; one whose deadline passes
    mid-run and one cancelled mid-run resolve with a prefix of their
    tokens; the others' tokens do not change."""
    jm, ports = models
    want = _tokens(JRM(), jm, PROMPTS, 24)

    def midrun(rm_, active):
        for req in active:
            if req is not None and req.num_generated >= 8:
                if req.prompt_tokens == PROMPTS[0]:
                    req.deadline_s = time.perf_counter() - 1e-3
                elif req.prompt_tokens == PROMPTS[1]:
                    rm_.cancel(req.guid)

    rm = _SpyRM(midrun)
    g = [rm.register_new_request(p, max_new_tokens=24) for p in PROMPTS]
    g_cx = rm.register_new_request([7, 7, 7], max_new_tokens=24)
    g_to = rm.register_new_request([8, 8], max_new_tokens=24,
                                   timeout_s=-1.0)
    assert rm.cancel(g_cx)
    rm.generate_incr_decoding(ports[True])
    assert rm.turns == {"native": 1, "python": 0}
    res = [rm.results[x] for x in g]
    assert res[0].status == "timed_out" and res[1].status == "cancelled"
    for r, w in zip(res[:2], want[:2]):
        assert 8 <= len(r.output_tokens) < 24
        assert r.output_tokens == w[:len(r.output_tokens)]
    assert [r.output_tokens for r in res[2:]] == want[2:]
    assert rm.results[g_cx].status == "cancelled"
    assert rm.results[g_to].status == "timed_out"
    assert rm.results[g_cx].output_tokens == rm.results[g_to].output_tokens \
        == []
    assert not rm.pending and not rm.inflight


def test_native_hands_over_to_python_for_a_priority_arrival(models):
    """A priority request registered while the native loop runs hands the
    slot table to the Python loop, which finishes every request with the
    JAX package's tokens."""
    jm, ports = models
    want = _tokens(JRM(), jm, PROMPTS + [[3, 1, 4]], 12)

    def arrive(rm_, active):
        if not rm_.extra and any(r is not None and r.num_generated
                                 for r in active):
            rm_.extra.append(rm_.register_new_request(
                [3, 1, 4], max_new_tokens=12, priority=1))

    rm = _SpyRM(arrive)
    rm.extra = []
    g = [rm.register_new_request(p, max_new_tokens=12) for p in PROMPTS]
    rm.generate_incr_decoding(ports[True])
    assert rm.turns == {"native": 1, "python": 1}
    assert [rm.results[x].output_tokens for x in g + rm.extra] == want


def test_failed_build_raises_and_runs_no_loop(models, tmp_path,
                                              monkeypatch):
    """A native scheduler that is asked for and cannot build raises with
    the compiler's complaint; no request leaves the queue and no loop
    runs."""
    _, ports = models
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeBuildError, match="no-such-g"):
        native.load_native()
    rm = _SpyRM()
    g = rm.register_new_request(PROMPTS[0], max_new_tokens=4)
    with pytest.raises(native.NativeBuildError):
        rm.generate_incr_decoding(ports[True])
    assert rm.turns == {"native": 0, "python": 0}
    assert [r.guid for r in rm.pending] == [g] and not rm.results
