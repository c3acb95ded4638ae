"""SentencePiece tokenizer of the LLaMA family (counterpart of
``flexflow_tpu/native/sp_tokenizer.py``).

``SentencePieceTokenizer`` runs on the native library
(``native/src/sp_tokenizer.cpp``: a dependency-free ModelProto parser,
unigram Viterbi, greedy BPE and byte fallback). ``build_model_proto``
(which writes synthetic ``tokenizer.model`` files) and ``SpModel`` (the
same algorithms in pure Python: the oracle the tests hold the native
version against) are a copy of the JAX package's.
"""

from __future__ import annotations

import ctypes
import struct
from typing import List, Optional, Sequence, Tuple

from flexflow_tpu_torch.native import load_native

WS = "▁"  # SentencePiece whitespace escape
# SentencePiece::Type
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
_UNK_PENALTY = 10.0
_UNK_SURFACE = " ⁇ "


# ----------------------------------------------------------------------
# ModelProto wire codec (fields per sentencepiece_model.proto)
# ----------------------------------------------------------------------
def _varint(v: int) -> bytes:
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        out += bytes([b | (0x80 if v else 0)])
        if not v:
            return out


def _ld(fnum: int, payload: bytes) -> bytes:
    return _varint((fnum << 3) | 2) + _varint(len(payload)) + payload


def _vi(fnum: int, value: int) -> bytes:
    return _varint(fnum << 3) + _varint(value)


def _f32(fnum: int, value: float) -> bytes:
    return _varint((fnum << 3) | 5) + struct.pack("<f", value)


def build_model_proto(pieces: Sequence[Tuple[str, float, int]],
                      model_type: int = 1, byte_fallback: bool = False,
                      unk_id: int = 0, bos_id: int = 1, eos_id: int = 2,
                      add_dummy_prefix: bool = True,
                      remove_extra_whitespaces: bool = True,
                      escape_whitespaces: bool = True) -> bytes:
    """Serialize a minimal but valid SentencePiece ModelProto."""
    out = b""
    for piece, score, ptype in pieces:
        body = (_ld(1, piece.encode("utf-8")) + _f32(2, score)
                + _vi(3, ptype))
        out += _ld(1, body)
    trainer = (_vi(3, model_type) + _vi(35, 1 if byte_fallback else 0)
               + _vi(40, unk_id) + _vi(41, bos_id) + _vi(42, eos_id))
    out += _ld(2, trainer)
    norm = (_vi(3, 1 if add_dummy_prefix else 0)
            + _vi(4, 1 if remove_extra_whitespaces else 0)
            + _vi(5, 1 if escape_whitespaces else 0))
    out += _ld(3, norm)
    return out


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    v = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not (b & 0x80):
            return v, pos
        shift += 7


def _iter_fields(buf: bytes):
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:
            v, pos = _read_varint(buf, pos)
            yield fnum, wtype, v
        elif wtype == 1:
            if pos + 8 > n:
                raise ValueError("truncated 64-bit field")
            yield fnum, wtype, buf[pos:pos + 8]
            pos += 8
        elif wtype == 2:
            ln, pos = _read_varint(buf, pos)
            if pos + ln > n:
                # match the C++ parser's strictness (Reader::sub sets
                # ok=false): a silently clamped slice would let the Python
                # twin "parse" a corrupt .model the native path rejects
                raise ValueError("truncated length-delimited field")
            yield fnum, wtype, buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:
            if pos + 4 > n:
                raise ValueError("truncated 32-bit field")
            yield fnum, wtype, buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"bad wire type {wtype}")


class SpModel:
    """Parsed ModelProto + the shared algorithmic core (the oracle)."""

    def __init__(self, data: bytes):
        self.pieces: List[str] = []
        self.scores: List[float] = []
        self.types: List[int] = []
        self.model_type = 1
        self.byte_fallback = False
        self.unk_id, self.bos_id, self.eos_id = 0, 1, 2
        self.add_dummy_prefix = True
        self.remove_extra_ws = True
        self.escape_ws = True
        for fnum, wtype, val in _iter_fields(data):
            if fnum == 1 and wtype == 2:
                piece, score, ptype = "", 0.0, NORMAL
                for pf, pw, pv in _iter_fields(val):
                    if pf == 1 and pw == 2:
                        piece = pv.decode("utf-8")
                    elif pf == 2 and pw == 5:
                        score = struct.unpack("<f", pv)[0]
                    elif pf == 3 and pw == 0:
                        ptype = pv
                self.pieces.append(piece)
                self.scores.append(score)
                self.types.append(ptype)
            elif fnum == 2 and wtype == 2:
                for tf, tw, tv in _iter_fields(val):
                    if tw != 0:
                        continue
                    if tf == 3:
                        self.model_type = tv
                    elif tf == 35:
                        self.byte_fallback = bool(tv)
                    elif tf == 40:
                        self.unk_id = tv
                    elif tf == 41:
                        self.bos_id = tv
                    elif tf == 42:
                        self.eos_id = tv
            elif fnum == 3 and wtype == 2:
                for nf, nw, nv in _iter_fields(val):
                    if nw != 0:
                        continue
                    if nf == 3:
                        self.add_dummy_prefix = bool(nv)
                    elif nf == 4:
                        self.remove_extra_ws = bool(nv)
                    elif nf == 5:
                        self.escape_ws = bool(nv)
        if not self.pieces:
            raise ValueError("empty SentencePiece model")
        self.piece_to_id = {p: i for i, p in enumerate(self.pieces)}
        self.byte_id = {}
        for i, (p, t) in enumerate(zip(self.pieces, self.types)):
            if t == BYTE and len(p) == 6 and p.startswith("<0x"):
                self.byte_id[int(p[3:5], 16)] = i
        normal_scores = [s for s, t in zip(self.scores, self.types)
                        if t == NORMAL]
        self.min_score = min([0.0] + normal_scores)
        self.max_piece_len = max(len(p.encode("utf-8"))
                                 for p in self.pieces)

    # ---- shared algorithm (mirrors native/src/sp_tokenizer.cpp) ----
    def normalize(self, text: str) -> str:
        s = text
        if self.remove_extra_ws:
            parts = [p for p in s.split(" ") if p != ""]
            s = " ".join(parts)
        if self.add_dummy_prefix:
            s = " " + s
        if self.escape_ws:
            s = s.replace(" ", WS)
        return s

    def _emit_fallback(self, seg: bytes, out: List[int]):
        if self.byte_fallback and all(b in self.byte_id for b in seg):
            out.extend(self.byte_id[b] for b in seg)
        else:
            out.append(self.unk_id)

    def encode_ids(self, text: str) -> List[int]:
        s = self.normalize(text).encode("utf-8")
        if self.model_type == 2:
            return self._encode_bpe(s)
        return self._encode_unigram(s)

    @staticmethod
    def _utf8_len(b: int) -> int:
        if b < 0x80:
            return 1
        if b & 0xE0 == 0xC0:
            return 2
        if b & 0xF0 == 0xE0:
            return 3
        if b & 0xF8 == 0xF0:
            return 4
        return 1

    def _char_starts(self, s: bytes):
        starts = set()
        i = 0
        while i < len(s):
            starts.add(i)
            i += self._utf8_len(s[i])
        starts.add(len(s))
        return starts

    def _encode_unigram(self, s: bytes) -> List[int]:
        n = len(s)
        if n == 0:
            return []
        starts = self._char_starts(s)
        NEG = -1e30
        best = [NEG] * (n + 1)
        prev = [-1] * (n + 1)
        piece = [-1] * (n + 1)
        best[0] = 0.0
        unk_score = self.min_score - _UNK_PENALTY
        for i in range(n):
            if i not in starts or best[i] <= NEG:
                continue
            cl = self._utf8_len(s[i])
            ce = min(i + cl, n)
            if best[i] + unk_score > best[ce]:
                best[ce] = best[i] + unk_score
                prev[ce], piece[ce] = i, -2
            for e in range(i + 1, min(n, i + self.max_piece_len) + 1):
                if e not in starts:
                    continue
                pid = self.piece_to_id.get(s[i:e].decode("utf-8", "ignore"))
                if pid is None or self.types[pid] not in (NORMAL,
                                                          USER_DEFINED):
                    continue
                sc = best[i] + self.scores[pid]
                if sc > best[e]:
                    best[e] = sc
                    prev[e], piece[e] = i, pid
        segs = []
        cur = n
        while cur > 0:
            if prev[cur] < 0:
                return []
            segs.append((prev[cur], piece[cur]))
            cur = prev[cur]
        out: List[int] = []
        for st, pid in reversed(segs):
            if pid >= 0:
                out.append(pid)
            else:
                cl = self._utf8_len(s[st])
                self._emit_fallback(s[st:st + cl], out)
        return out

    def _encode_bpe(self, s: bytes) -> List[int]:
        sym = []
        i = 0
        while i < len(s):
            ln = min(self._utf8_len(s[i]), len(s) - i)
            sym.append((i, i + ln))
            i += ln
        while len(sym) > 1:
            best_score, best_i = -1e30, -1
            for k in range(len(sym) - 1):
                pid = self.piece_to_id.get(
                    s[sym[k][0]:sym[k + 1][1]].decode("utf-8", "ignore"))
                if pid is None or self.types[pid] not in (NORMAL,
                                                          USER_DEFINED):
                    continue
                if self.scores[pid] > best_score:
                    best_score, best_i = self.scores[pid], k
            if best_i < 0:
                break
            sym[best_i] = (sym[best_i][0], sym[best_i + 1][1])
            del sym[best_i + 1]
        out: List[int] = []
        for a, b in sym:
            pid = self.piece_to_id.get(s[a:b].decode("utf-8", "ignore"))
            if pid is not None and self.types[pid] in (NORMAL, USER_DEFINED):
                out.append(pid)
            else:
                self._emit_fallback(s[a:b], out)
        return out

    def decode_ids(self, ids: Sequence[int]) -> str:
        out = b""
        pending = b""
        for i in ids:
            if not (0 <= i < len(self.pieces)):
                continue
            t = self.types[i]
            if t == BYTE:
                pending += bytes([int(self.pieces[i][3:5], 16)])
                continue
            out += pending
            pending = b""
            if t in (CONTROL, UNUSED):
                continue
            if t == UNKNOWN:
                out += _UNK_SURFACE.encode("utf-8")
                continue
            out += self.pieces[i].encode("utf-8")
        out += pending
        s = out.decode("utf-8", "replace")
        if self.escape_ws:
            s = s.replace(WS, " ")
        if self.add_dummy_prefix and s.startswith(" "):
            s = s[1:]
        return s


class SentencePieceTokenizer:
    """LLaMA-family tokenizer over a ``tokenizer.model`` (a path or its
    bytes), with no ``transformers`` import: ``encode`` (with a leading
    BOS, HF LlamaTokenizer's default), ``decode`` and ``eos_token_id``,
    what ``RequestManager.register_tokenizer`` needs. The ids come from
    the native library; ``self.model`` is the parsed oracle. Raises
    ``NativeBuildError`` when the library cannot be built and
    ``ValueError`` when the native parser rejects the model."""

    def __init__(self, model_path_or_bytes, add_bos: bool = True):
        if isinstance(model_path_or_bytes, bytes):
            data = model_path_or_bytes
        else:
            with open(model_path_or_bytes, "rb") as f:
                data = f.read()
        self.model = SpModel(data)
        self.add_bos = add_bos
        self.eos_token_id = self.model.eos_id
        self.bos_token_id = self.model.bos_id
        self._lib = load_native()
        self._h = self._lib.ffsp_create_from_buffer(data, len(data))
        if not self._h:
            raise ValueError("the native SentencePiece parser rejected the "
                             "model")

    @property
    def vocab_size(self) -> int:
        return len(self.model.pieces)

    def encode(self, text: str) -> List[int]:
        ids = self.encode_raw(text)
        if self.add_bos:
            return [self.model.bos_id] + ids
        return ids

    def encode_raw(self, text: str) -> List[int]:
        """The ids of ``text`` without the BOS."""
        raw = text.encode("utf-8")
        cap = 4 * max(16, len(raw))
        while True:
            buf = (ctypes.c_int32 * cap)()
            n = self._lib.ffsp_encode(self._h, raw, len(raw), buf, cap)
            if n <= cap:
                return list(buf[:n])
            cap = n

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        ids = [int(i) for i in ids]
        arr = (ctypes.c_int32 * max(1, len(ids)))(*ids)
        cap = 16 * max(16, len(ids))
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.ffsp_decode(self._h, arr, len(ids), buf, cap)
            if n <= cap:
                return buf.raw[:n].decode("utf-8", "replace")
            cap = n

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.ffsp_destroy(h)
            self._h = None
