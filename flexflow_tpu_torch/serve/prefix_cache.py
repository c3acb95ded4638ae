"""Shared-prefix KV cache: radix trie over token ids + pooled KV segments
(counterpart of ``flexflow_tpu/serve/prefix_cache.py``).

Most serving traffic shares system prompts and few-shot prefixes. This
module gives the RequestManager a process-level pool of finished prompts'
KV:

* ``PrefixCache`` — a trie over token ids, copied from the JAX package.
  ``match(tokens)`` walks the trie for the longest stored path agreeing
  with ``tokens`` (capped at ``len(tokens) - 1``: the last prompt token
  must still be fed to emit the first output logits) and returns
  ``(shared_len, entry)``, taking a reference on the entry. Entries are
  inserted on request finish (``insert``) with their slot's KV; eviction
  is LRU by a token-count budget on an injectable clock, and an entry with
  live references is never evicted.

* KV segment helpers — ``extract_prefix_kv`` / ``install_prefix_kv`` copy
  the first N cache positions of a slot out and back into another slot,
  for both of the port's layouts: per-layer ``{"k_cache","v_cache"}`` of
  ``[R, KH, S, Dc]``, and the stacked ``op_state["kv_cache"] = {"k","v"}``
  of ``[L, R, KH, S, Dc]`` (``core/model.py _consolidate_kv_caches``).
  ``Dc`` is the cache's own head dim, padded on the card
  (``ops/inc_attention.cache_head_dim``), so ``prefix_compatible``
  compares the cache's shape, never the model's head dim.

Where the port differs from the JAX package: segments are torch tensors
on the model's device, cloned at store (bf16 has no numpy type, and a
host round trip would cost a copy each way), and an install writes them
into the slot's region of the cache in place (``copy_``); no op_state
entry is ever replaced, so the cache tensors keep their addresses.
Segments are padded to ``_PAD`` positions, as in the JAX package; the pad
positions hold stale KV past the slot's valid extent, which the attention
kernels mask (positions at or past ``length``), and the suffix prefill
and the decode appends overwrite them before the extent reaches them.

Token identity: KV at position p depends only on tokens[0..p], so a
pooled segment holds what re-prefilling the same prefix writes, provided
the projections give each row the same bits whatever the batch (the
port's kernels K1/K2/K3 are row-invariant by design; a library GEMM
promises no such thing). Reuse then changes wall clock, never tokens.

One pooled token costs ``layers x 2 x kv_heads x Dc x itemsize`` bytes of
device memory: 512 KiB at LLaMA-2-7B geometry in bf16 (32 layers, K and
V, 32 heads of 128). So the pool has a byte budget beside the JAX
package's token budget: ``DEFAULT_POOL_MEMORY_FRACTION`` of the device
memory free at its first insert (``PrefixCache(max_bytes=...)`` sets
another; segments on the host keep the token budget alone, as in the
JAX package). Eviction holds both.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

# position-count granularity for stored/installed segments (as in the JAX
# package)
_PAD = 8

# default pool budget in TOKENS (sum of entry lengths); a few hundred chat
# system prompts. GenerationConfig.prefix_cache_tokens overrides.
DEFAULT_POOL_TOKENS = 65536
# byte budget of a pool on the card: this share of the device memory
# free at its first insert (the caches and weights are allocated by
# then)
DEFAULT_POOL_MEMORY_FRACTION = 0.25


def _round_up(n: int, m: int = _PAD) -> int:
    return -(-n // m) * m


# ----------------------------------------------------------------------
# KV segment extract/install (both op_state layouts)
# ----------------------------------------------------------------------
def _kv_slots(op_state) -> List[Tuple[str, str, str, bool]]:
    """KV-cache entries of an op_state: (name, k_key, v_key, stacked)."""
    out = []
    for name, st in op_state.items():
        if not isinstance(st, dict):
            continue
        if "k_cache" in st and "v_cache" in st:
            out.append((name, "k_cache", "v_cache", False))
        elif name == "kv_cache" and "k" in st and "v" in st:
            out.append((name, "k", "v", True))
    return out


def extract_prefix_kv(op_state, slot: int, length: int) -> Optional[Dict]:
    """Clone the first ``length`` positions of ``slot``'s KV (padded up to
    a ``_PAD`` multiple of positions) on the cache's device. Returns None
    when the cache is too short to hold the padded segment."""
    P = _round_up(length)
    segs: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, kk, vk, stacked in _kv_slots(op_state):
        k, v = op_state[name][kk], op_state[name][vk]
        if P > k.shape[-2]:
            return None
        if stacked:      # [L, R, KH, S, Dc] -> [L, KH, P, Dc]
            segs[name] = {"k": k[:, slot, :, :P].clone(),
                          "v": v[:, slot, :, :P].clone()}
        else:            # [R, KH, S, Dc] -> [KH, P, Dc]
            segs[name] = {"k": k[slot, :, :P].clone(),
                          "v": v[slot, :, :P].clone()}
    return segs or None


def segment_nbytes(segs: Dict) -> int:
    """Device bytes one model's stored segments hold."""
    return sum(t.numel() * t.element_size()
               for s in segs.values() for t in s.values())


def entry_nbytes(segments: Dict[str, Any]) -> int:
    """Bytes a pool entry's segments hold, over every model."""
    return sum(segment_nbytes(s) for s in segments.values()
               if isinstance(s, dict))


def default_byte_budget(device: torch.device) -> int:
    """The pool's byte budget when none is given: a share of the memory
    free on ``device`` now; 0 (no byte budget) off the card."""
    if device.type != "cuda":
        return 0
    free, _ = torch.cuda.mem_get_info(device)
    return int(free * DEFAULT_POOL_MEMORY_FRACTION)


def _segment_device(segments: Dict[str, Any]) -> Optional[torch.device]:
    for s in segments.values():
        if isinstance(s, dict):
            for seg in s.values():
                for t in seg.values():
                    return t.device
    return None


def prefix_compatible(op_state, segs: Dict, length: int) -> bool:
    """True when ``segs`` (one model's stored segment dict) can be
    installed into ``op_state`` for ``length`` shared tokens: every KV
    cache present, in the same layout, geometry (the cache's own head dim
    included), dtype and device, the padded length within the cache."""
    slots = _kv_slots(op_state)
    if not slots:
        return False
    P = _round_up(length)
    for name, kk, vk, stacked in slots:
        seg = segs.get(name)
        if seg is None:
            return False
        cache, k = op_state[name][kk], seg["k"]
        if P > cache.shape[-2] or k.shape[-2] < P:
            return False
        want = ((cache.shape[0], cache.shape[2], cache.shape[4])
                if stacked else (cache.shape[1], cache.shape[3]))
        got = ((k.shape[0], k.shape[1], k.shape[3]) if k.dim() == 4
               else (k.shape[0], k.shape[2]))
        if (k.dim() != (4 if stacked else 3) or want != got
                or k.dtype != cache.dtype or k.device != cache.device):
            return False
    return True


def install_prefix_kv(op_state, slot: int, segs: Dict, length: int):
    """Write the first ``length`` shared positions of a stored segment
    (rounded up to ``_PAD``) into ``slot``'s region of every cache, in
    place. The tail of the last ``_PAD`` bucket is stale KV past the
    slot's valid extent until the suffix prefill overwrites it."""
    P = _round_up(length)
    for name, kk, vk, stacked in _kv_slots(op_state):
        seg = segs.get(name)
        if seg is None:
            continue
        k_cache, v_cache = op_state[name][kk], op_state[name][vk]
        if stacked:
            k_cache[:, slot, :, :P].copy_(seg["k"][:, :, :P])
            v_cache[:, slot, :, :P].copy_(seg["v"][:, :, :P])
        else:
            k_cache[slot, :, :P].copy_(seg["k"][:, :P])
            v_cache[slot, :, :P].copy_(seg["v"][:, :P])
    return op_state


# ----------------------------------------------------------------------
# Radix trie + refcounted pool (as in the JAX package)
# ----------------------------------------------------------------------
class _Node:
    __slots__ = ("children", "entry", "parent", "token")

    def __init__(self, parent=None, token=None):
        self.children: Dict[int, "_Node"] = {}
        self.entry: Optional["PrefixEntry"] = None
        self.parent = parent
        self.token = token


class PrefixEntry:
    """One pooled prefix: its token ids, per-model KV segments (keyed
    "llm", "ssm0", ...; a model absent at insert time simply prefills cold
    on reuse), a refcount, and an LRU stamp."""

    __slots__ = ("tokens", "length", "segments", "nbytes", "refs",
                 "last_used", "_node")

    def __init__(self, tokens: Tuple[int, ...], segments: Dict[str, Any],
                 now: float):
        self.tokens = tokens
        self.length = len(tokens)
        self.segments = segments
        self.nbytes = entry_nbytes(segments)
        self.refs = 0
        self.last_used = now
        self._node: Optional[_Node] = None


class PrefixCache:
    """Refcounted shared-prefix KV pool (see module docstring).

    Thread-safe for the serving split of duties: ``match`` runs on
    submitter threads (register_new_request) while ``insert``/eviction
    run on the engine loop thread."""

    def __init__(self, max_tokens: int = 0, min_tokens: int = 2,
                 clock=None, max_bytes: int = 0):
        self.max_tokens = max_tokens or DEFAULT_POOL_TOKENS
        # None until the first insert fixes it (default_byte_budget);
        # 0 = no byte budget
        self.max_bytes: Optional[int] = max_bytes or None
        self.min_tokens = max(1, min_tokens)
        self._clock = clock or time.monotonic
        self._root = _Node()
        self._entries: List[PrefixEntry] = []
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.shared_tokens_total = 0
        self.pool_tokens = 0
        self._pool_bytes = 0

    def __len__(self):
        return len(self._entries)

    def pool_bytes(self) -> int:
        """Device bytes the pooled segments hold."""
        with self._lock:
            return self._pool_bytes

    def _over_budget(self) -> bool:
        return (self.pool_tokens > self.max_tokens
                or (bool(self.max_bytes)
                    and self._pool_bytes > self.max_bytes))

    # -- lookup --------------------------------------------------------
    def match(self, tokens: Sequence[int]
              ) -> Tuple[int, Optional[PrefixEntry]]:
        """Longest-prefix lookup, capped at ``len(tokens) - 1``. On a hit
        the entry's refcount is taken (caller MUST ``release``). The
        returned ``shared_len`` may be shorter than the entry (radix
        partial match: the entry's first ``shared_len`` positions are
        what the caller installs)."""
        with self._lock:
            node, depth = self._root, 0
            for t in tokens[:max(0, len(tokens) - 1)]:
                child = node.children.get(int(t))
                if child is None:
                    break
                node, depth = child, depth + 1
            if depth < self.min_tokens:
                self.misses += 1
                return 0, None
            entry = self._subtree_entry(node)
            if entry is None:       # pruning keeps this unreachable in
                self.misses += 1    # steady state
                return 0, None
            entry.refs += 1
            entry.last_used = self._clock()
            self.hits += 1
            self.shared_tokens_total += depth
            return depth, entry

    @staticmethod
    def _subtree_entry(node: _Node) -> Optional[PrefixEntry]:
        """Any entry at or below ``node``: every path in the trie was
        written by an insert, and eviction prunes entry-less leaves, so
        the first descent finds one."""
        seen = 0
        while node is not None and seen < 4096:
            if node.entry is not None:
                return node.entry
            node = next(iter(node.children.values()), None)
            seen += 1
        return None

    def release(self, entry: PrefixEntry):
        with self._lock:
            entry.refs = max(0, entry.refs - 1)

    # -- insert / evict ------------------------------------------------
    def would_store(self, tokens: Sequence[int]) -> bool:
        """True when ``insert(tokens, ...)`` would add a new entry: the
        cheap pre-check before paying for the KV copy."""
        n = len(tokens)
        if n < self.min_tokens or n > self.max_tokens:
            return False
        with self._lock:
            node = self._root
            for t in tokens:
                node = node.children.get(int(t))
                if node is None:
                    return True
            return node.entry is None

    def insert(self, tokens: Sequence[int], segments: Dict[str, Any]
               ) -> Tuple[Optional[PrefixEntry], int]:
        """Pool a finished prompt's KV. Returns (entry, n_evicted);
        entry is None when the prompt is out of bounds or already
        stored (the existing entry just gets an LRU touch)."""
        toks = tuple(int(t) for t in tokens)
        n = len(toks)
        if n < self.min_tokens or n > self.max_tokens:
            return None, 0
        if self.max_bytes is None:
            dev = _segment_device(segments)
            self.max_bytes = 0 if dev is None else default_byte_budget(dev)
        if self.max_bytes and entry_nbytes(segments) > self.max_bytes:
            return None, 0
        with self._lock:
            node = self._root
            for t in toks:
                child = node.children.get(t)
                if child is None:
                    child = node.children[t] = _Node(node, t)
                node = child
            now = self._clock()
            if node.entry is not None:
                node.entry.last_used = now
                return None, 0
            entry = PrefixEntry(toks, segments, now)
            entry._node = node
            node.entry = entry
            self._entries.append(entry)
            self.pool_tokens += n
            self._pool_bytes += entry.nbytes
            return entry, self._evict_to_budget(keep=entry)

    def _evict_to_budget(self, keep: Optional[PrefixEntry] = None) -> int:
        """LRU-evict unreferenced entries until the pool fits the token
        and byte budgets (lock held). Entries with live refs (a request
        between match and finish) are never evicted, so the pool may run
        over budget transiently under pressure."""
        n_evicted = 0
        while self._over_budget():
            victims = [e for e in self._entries
                       if e.refs == 0 and e is not keep]
            if not victims:
                break
            victim = min(victims, key=lambda e: e.last_used)
            self._remove(victim)
            n_evicted += 1
        self.evictions += n_evicted
        return n_evicted

    def _remove(self, entry: PrefixEntry):
        self._entries.remove(entry)
        self.pool_tokens -= entry.length
        self._pool_bytes -= entry.nbytes
        node = entry._node
        entry._node = None
        if node is None:
            return
        node.entry = None
        # prune the now entry-less tail so _subtree_entry never descends
        # into a dead branch
        while (node.parent is not None and not node.children
               and node.entry is None):
            parent = node.parent
            parent.children.pop(node.token, None)
            node.parent = None
            node = parent
