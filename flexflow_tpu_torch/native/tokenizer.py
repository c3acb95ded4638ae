"""GPT-2 byte-level BPE tokenizer (counterpart of
``flexflow_tpu/native/tokenizer.py``).

``BPETokenizer`` runs on the native library (``native/src/
bpe_tokenizer.cpp``). ``pretokenize`` and ``PyBPETokenizer`` are a copy of
the JAX package's pure-Python version, kept as the oracle the tests hold
the native one against: both give identical ids.
"""

from __future__ import annotations

import ctypes
import functools
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from flexflow_tpu_torch.native import load_native


@functools.lru_cache(maxsize=1)
def _bytes_to_unicode() -> Dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _cp_is_letter(cp: int) -> bool:
    if (ord("a") <= cp <= ord("z")) or (ord("A") <= cp <= ord("Z")):
        return True
    if 0xC0 <= cp < 0x2000 and cp not in (0xD7, 0xF7):
        return True
    if 0x2C00 <= cp < 0xE000:
        return True
    return cp >= 0x10000


def _cp_is_digit(cp: int) -> bool:
    return ord("0") <= cp <= ord("9")


def _cp_is_space(cp: int) -> bool:
    return cp in (0x20, 0x09, 0x0A, 0x0D, 0x0B, 0x0C, 0xA0)


def pretokenize(text: str) -> List[str]:
    """GPT-2-style splitter — an exact port of the C++ ``pretokenize`` in
    native/src/bpe_tokenizer.cpp so both backends always agree."""
    pieces: List[str] = []
    n = len(text)
    p = 0
    while p < n:
        if text[p] == "'":
            matched = False
            for c in _CONTRACTIONS:
                if text.startswith(c, p):
                    pieces.append(c)
                    p += len(c)
                    matched = True
                    break
            if matched:
                continue
        start = p
        leading_space = False
        cp = ord(text[p])
        if (cp == 0x20 and p + 1 < n and not _cp_is_space(ord(text[p + 1]))):
            leading_space = True
            p += 1
        if p < n and _cp_is_letter(ord(text[p])):
            while p < n and _cp_is_letter(ord(text[p])):
                p += 1
            pieces.append(text[start:p])
            continue
        if p < n and _cp_is_digit(ord(text[p])):
            while p < n and _cp_is_digit(ord(text[p])):
                p += 1
            pieces.append(text[start:p])
            continue
        if p < n and not _cp_is_space(ord(text[p])):
            while (p < n and not _cp_is_space(ord(text[p]))
                   and not _cp_is_letter(ord(text[p]))
                   and not _cp_is_digit(ord(text[p]))):
                p += 1
            pieces.append(text[start:p])
            continue
        if leading_space:
            p = start
        q = p
        while q < n and _cp_is_space(ord(text[q])):
            q += 1
        if q < n and q - p > 1:
            pieces.append(text[p:q - 1])
            p = q - 1
        else:
            pieces.append(text[p:q])
            p = q
    return pieces


class PyBPETokenizer:
    """Pure-Python GPT-2 BPE (the test oracle)."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]]):
        self.vocab = vocab
        self.id_to_token = {v: k for k, v in vocab.items()}
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: Dict[str, List[int]] = {}
        self.eos_token_id = vocab.get("<|endoftext|>")

    def _bpe(self, piece: str) -> List[int]:
        if piece in self._cache:
            return self._cache[piece]
        word = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
        parts = list(word)
        while len(parts) > 1:
            pairs = [(self.ranks.get((parts[i], parts[i + 1]), None), i)
                     for i in range(len(parts) - 1)]
            pairs = [(r, i) for r, i in pairs if r is not None]
            if not pairs:
                break
            _, i = min(pairs)
            parts = parts[:i] + [parts[i] + parts[i + 1]] + parts[i + 2:]
        ids = []
        for p in parts:
            if p in self.vocab:
                ids.append(self.vocab[p])
            else:
                ids.extend(self.vocab[c] for c in p if c in self.vocab)
        self._cache[piece] = ids
        return ids

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        for piece in pretokenize(text):
            out.extend(self._bpe(piece))
        return out

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.id_to_token.get(int(i), "") for i in ids)
        data = bytes(self.byte_decoder[c] for c in text
                     if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace")


class BPETokenizer:
    """The GPT-2 BPE on the native library, from file paths (vocab.json
    and merges.txt) or a vocab dict and a merges list. Raises
    ``NativeBuildError`` when the library cannot be built."""

    def __init__(self, vocab=None, merges=None,
                 vocab_path: Optional[str] = None,
                 merges_path: Optional[str] = None):
        if vocab_path is not None:
            with open(vocab_path, encoding="utf-8") as f:
                vocab = json.load(f)
        if merges_path is not None:
            merges = []
            with open(merges_path, encoding="utf-8") as f:
                for line in f:
                    line = line.rstrip("\n")
                    if not line or line.startswith("#"):
                        continue
                    a, _, b = line.partition(" ")
                    merges.append((a, b))
        assert vocab is not None
        merges = [tuple(m) for m in (merges or [])]
        self.eos_token_id = vocab.get("<|endoftext|>")
        self._lib = load_native()
        vocab_json = json.dumps(vocab, ensure_ascii=False)
        merges_txt = "\n".join(f"{a} {b}" for a, b in merges)
        self._h = self._lib.ffbpe_create_from_buffers(
            vocab_json.encode("utf-8"), merges_txt.encode("utf-8"))
        if not self._h:
            raise ValueError("the native BPE tokenizer rejected the vocab "
                             "or merges")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.ffbpe_destroy(h)
            self._h = None

    def vocab_size(self) -> int:
        return self._lib.ffbpe_vocab_size(self._h)

    def encode(self, text: str) -> List[int]:
        data = text.encode("utf-8")
        cap = max(64, 2 * len(data))
        while True:
            buf = (ctypes.c_int32 * cap)()
            n = self._lib.ffbpe_encode(self._h, data, len(data), buf, cap)
            if n >= 0:
                return list(buf[:n])
            cap = -n

    def decode(self, ids: Sequence[int]) -> str:
        arr = np.asarray(list(ids), dtype=np.int32)
        n = len(arr)
        cap = max(64, 8 * n)
        ptr = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        while True:
            out = ctypes.create_string_buffer(cap)
            w = self._lib.ffbpe_decode(self._h, ptr, n, out, cap)
            if w >= 0:
                return out.raw[:w].decode("utf-8", errors="replace")
            cap = -w
