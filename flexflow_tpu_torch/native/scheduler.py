"""ctypes binding of the native continuous-batching scheduler
(counterpart of ``flexflow_tpu/native/scheduler.py``).

The C++ scheduler (``native/src/batch_scheduler.cpp``) owns slot fill,
batch assembly and the EOS/length bookkeeping of incremental decoding;
``RequestManager._generate_incr_native`` drives it. The port's library is
always built from the repository's current sources, so ``ffs_cancel`` is
always there (``supports_cancel`` is true).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from flexflow_tpu_torch.native import load_native


def _i32p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class NativeBatchScheduler:
    """Owns request slot state during a generation loop. Construction
    builds the library if needed and raises ``NativeBuildError`` when it
    cannot."""

    supports_cancel = True

    def __init__(self, max_requests: int, max_seq: int,
                 eos_id: Optional[int] = None):
        self._lib = load_native()
        self.R = max_requests
        self.max_seq = max_seq
        self._h = self._lib.ffs_create(max_requests, max_seq,
                                       -1 if eos_id is None else int(eos_id))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.ffs_destroy(h)
            self._h = None

    def add_request(self, guid: int, prompt_tokens, max_new: int,
                    max_seq_len: int = 0):
        toks = np.asarray(list(prompt_tokens), dtype=np.int32)
        self._lib.ffs_add_request(self._h, guid, _i32p(toks), len(toks),
                                  max_new, max_seq_len)

    def has_work(self) -> bool:
        return bool(self._lib.ffs_has_work(self._h))

    def fill_slots(self) -> int:
        """Pending requests into free slots, lowest slot first, in add
        order; a prompt with no room for one token goes straight to the
        done queue. Returns the requests placed."""
        return self._lib.ffs_fill_slots(self._h)

    def assemble_prefill(self, chunk: int, budget: int, Q: int):
        R = self.R
        tokens = np.zeros((R, Q), np.int32)
        positions = np.zeros((R, Q), np.int32)
        start = np.zeros((R,), np.int32)
        num = np.zeros((R,), np.int32)
        act = np.zeros((R,), np.uint8)
        rows = self._lib.ffs_assemble_prefill(
            self._h, chunk, budget, Q, _i32p(tokens), _i32p(positions),
            _i32p(start), _i32p(num), _u8p(act))
        return rows, tokens, positions, start, num, act.astype(bool)

    def assemble_decode(self):
        R = self.R
        tok = np.zeros((R,), np.int32)
        pos = np.zeros((R,), np.int32)
        act = np.zeros((R,), np.uint8)
        live = self._lib.ffs_assemble_decode(self._h, _i32p(tok), _i32p(pos),
                                             _u8p(act))
        return live, tok, pos, act.astype(bool)

    def decode_block(self, max_block: int) -> int:
        return self._lib.ffs_decode_block(self._h, max_block)

    def append_block(self, toks: np.ndarray) -> int:
        toks = np.ascontiguousarray(toks, dtype=np.int32)
        assert toks.shape[0] == self.R
        return self._lib.ffs_append_block(self._h, _i32p(toks),
                                          toks.shape[1])

    def cancel(self, guid: int) -> bool:
        """Cancel a pending or active request; its partial tokens drain
        through ``pop_done``. False if unknown or already finished."""
        return bool(self._lib.ffs_cancel(self._h, guid))

    def pop_done(self) -> Optional[Tuple[int, List[int], int]]:
        """(guid, all_tokens, prompt_len) of the next finished request,
        or None."""
        guid = ctypes.c_int64()
        n = ctypes.c_int32()
        if not self._lib.ffs_pop_done(self._h, ctypes.byref(guid),
                                      ctypes.byref(n)):
            return None
        out = np.zeros((n.value,), np.int32)
        got = self._lib.ffs_done_tokens(self._h, guid.value, _i32p(out),
                                        n.value)
        plen = self._lib.ffs_prompt_len(self._h, guid.value)
        return guid.value, [int(t) for t in out[:got]], plen
