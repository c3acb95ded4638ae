"""CPU (host-memory) weight offload for serving (counterpart of
``flexflow_tpu/offload.py``; the reference's ``-offload`` mode,
config.h:144-146 and linear_kernels.cu:30-40, pages weights from pinned
CPU memory into a GPU scratch region per use).

``offload_model_weights`` moves the big serving weights (the names
quantization covers, ``_OFFLOAD_NAMES``) of a CUDA model to **pinned**
host memory; a quantized weight moves its int8/int4 payload and its
scale, never a dequantized copy. ``FFModel._apply_layer`` then fetches a
layer's weights before it runs (and before lazy dequantization), through
the model's ``Prefetcher``:

* the copies run on a side CUDA stream, ordered by events: while layer i
  computes, the copies of the next offloaded layers are in flight,
  wrapping from the last layer to the first for the next forward;
* the compute stream waits on a layer's event before reading its copies,
  and ``record_stream`` tells the caching allocator that the buffers are
  used there, so it reuses them only once that work is done;
* ``FFConfig.offload_reserve_space_size`` bounds the weight bytes on the
  card: the copies in flight plus the fetched layers whose compute the
  card has not finished (the host runs ahead of the card). Before a
  copy would pass the bound, the host waits for the oldest such layer's
  compute; the next layer's copy always goes out.

Under a pipeline plan the stage-stacked leaves are paged
(``params[PP_PARAMS_KEY]``); a pending plan is finalized first, and
``fetch_block_params`` streams one block's slices back. The microbatches
of a forward share a block's fetch when the stage's paged bytes fit the
reserve (``pipeline_plan.run_pp_graph``); else each fetches it again.

On a CPU model the host is the device: the same bookkeeping and fetch
path run without pinning or copies (what the CPU tests exercise). On the
card, a weight that cannot be pinned raises.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional

import torch

from flexflow_tpu_torch.quant import (QuantizedWeight, _QUANT_NAMES,
                                      is_quantized)

# the big serving matmuls: one shared set with quantization, so the two
# features always cover the same weights
_OFFLOAD_NAMES = _QUANT_NAMES


def host_memory_supported(device="cuda") -> bool:
    """Can weights of a ``device`` model live in pinned host memory?"""
    dev = torch.device(device)
    if dev.type == "cpu":
        return True
    if not torch.cuda.is_available():
        return False
    try:
        return torch.empty(1, pin_memory=True).is_pinned()
    except RuntimeError:
        return False


def _pin(t: torch.Tensor) -> torch.Tensor:
    h = t.detach().to("cpu").pin_memory()
    if not h.is_pinned():
        raise RuntimeError("offload: pinning host memory failed")
    return h


def _leaf_tensors(w) -> List[torch.Tensor]:
    return [w.q, w.scale] if is_quantized(w) else [w]


def _page_out(container: Dict[str, Any], wname: str, w, min_bytes: int,
              on_card: bool) -> int:
    """Page one eligible weight out, in place; bytes moved (0 when
    ineligible or already paged)."""
    if wname not in _OFFLOAD_NAMES:
        return 0
    nbytes = int(getattr(w, "nbytes", 0))
    if nbytes < min_bytes:
        return 0
    if not is_quantized(w) and w.dim() < 2:
        return 0
    if on_card:
        if not _leaf_tensors(w)[0].is_cuda:
            return 0                      # already on the host
        if is_quantized(w):
            container[wname] = QuantizedWeight(w.qtype, _pin(w.q),
                                               _pin(w.scale), w.rows,
                                               w.dtype)
        else:
            container[wname] = _pin(w)
    return nbytes


def offload_model_weights(model, min_bytes: int = 1 << 20) -> int:
    """Page the eligible weights of ``model`` to pinned host memory.

    Records each paged weight in ``model._offloaded`` ({layer: {weight:
    device}}, or ``{PP_PARAMS_KEY: {pos: {weight: device}}}`` for the
    stage-stacked leaves) and returns the bytes moved off the device. A
    second call moves nothing (idempotent)."""
    from flexflow_tpu_torch.serve.pipeline_plan import PP_PARAMS_KEY

    dev = model.device
    on_card = dev.type == "cuda"
    if on_card and not host_memory_supported(dev):
        raise RuntimeError("offload needs pinned host memory, which this "
                           "process cannot allocate")
    if (getattr(model, "_pp_plan", None) is not None
            and PP_PARAMS_KEY not in (model.params or {})):
        # the stacked leaves are what is paged: stack first, whatever the
        # call order
        model.finalize_pipeline()
    offloaded: Dict[str, Dict[str, Any]] = dict(
        getattr(model, "_offloaded", None) or {})
    moved = 0
    for lname, ws in (model.params or {}).items():
        if lname == PP_PARAMS_KEY:
            for pos, per_w in ws.items():
                for wname, w in list(per_w.items()):
                    done = offloaded.get(PP_PARAMS_KEY, {}).get(pos, {})
                    if wname in done:
                        continue
                    n = _page_out(per_w, wname, w, min_bytes, on_card)
                    if n:
                        moved += n
                        offloaded.setdefault(PP_PARAMS_KEY, {}).setdefault(
                            pos, {})[wname] = dev
            continue
        for wname, w in list(ws.items()):
            if wname in offloaded.get(lname, {}):
                continue
            n = _page_out(ws, wname, w, min_bytes, on_card)
            if n:
                moved += n
                offloaded.setdefault(lname, {})[wname] = dev
    model._offloaded = offloaded
    model._prefetcher = Prefetcher(model) if offloaded else None
    return moved


def _to_device(w, device, non_blocking: bool):
    if is_quantized(w):
        return QuantizedWeight(
            w.qtype, w.q.to(device, non_blocking=non_blocking),
            w.scale.to(device, non_blocking=non_blocking), w.rows, w.dtype)
    return w.to(device, non_blocking=non_blocking)


class Prefetcher:
    """Streams offloaded weights back to the card ahead of use.

    A unit is a layer name, or ``("block", j)`` for this stage's stacked
    block j under a pipeline plan; units are fetched in graph order."""

    def __init__(self, model):
        from flexflow_tpu_torch.serve.pipeline_plan import PP_PARAMS_KEY

        self.model = model
        self.device = model.device
        off = model._offloaded
        if PP_PARAMS_KEY in off:
            n = model._pp_plan.blocks_per_stage
            self.order: List[Any] = [("block", j) for j in range(n)]
        else:
            self.order = [layer.name for layer in model.layers
                          if layer.name in off]
        self.reserve = int(model.config.offload_reserve_space_size)
        # unit -> (copy event, device leaves, bytes): copies issued, not
        # yet handed out
        self._inflight: "collections.OrderedDict" = collections.OrderedDict()
        # (event on the compute stream past the unit's use, bytes) of the
        # units handed out, oldest first; the last one's compute is still
        # being enqueued, so it has no event yet
        self._in_use: "collections.deque" = collections.deque()
        self._last_bytes = 0
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        # bytes streamed back since the counter was last reset
        self.bytes_fetched = 0

    def _host_leaves(self, unit) -> Dict[Any, Any]:
        from flexflow_tpu_torch.parallel.pipeline import block_slice
        from flexflow_tpu_torch.serve.pipeline_plan import PP_PARAMS_KEY

        m = self.model
        if isinstance(unit, tuple):
            stacked = m.params[PP_PARAMS_KEY]
            out = {}
            for pos, names in m._offloaded[PP_PARAMS_KEY].items():
                sl = block_slice({w: stacked[pos][w] for w in names}, unit[1])
                for w, leaf in sl.items():
                    out[(pos, w)] = leaf
            return out
        lp = m.params[unit]
        return {w: lp[w] for w in m._offloaded[unit] if w in lp}

    def _unit_bytes(self, unit) -> int:
        return sum(int(getattr(w, "nbytes", 0))
                   for w in self._host_leaves(unit).values())

    def total_bytes(self) -> int:
        """The paged bytes of every unit: what one forward streams back."""
        return sum(self._unit_bytes(u) for u in self.order)

    def _issue(self, unit):
        leaves = self._host_leaves(unit)
        nbytes = sum(int(getattr(w, "nbytes", 0)) for w in leaves.values())
        if self._stream is None:
            self._inflight[unit] = (None, leaves, nbytes)
            return
        with torch.cuda.stream(self._stream):
            dev_leaves = {k: _to_device(w, self.device, True)
                          for k, w in leaves.items()}
            ev = torch.cuda.Event()
            ev.record(self._stream)
        self._inflight[unit] = (ev, dev_leaves, nbytes)

    def fetch(self, unit) -> Dict[Any, Any]:
        """The unit's weights on the device, ready for the current stream;
        then the next units are put in flight within the reserve."""
        if self._stream is not None and self._last_bytes:
            # everything enqueued so far includes the last unit's compute
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            self._in_use.append((done, self._last_bytes))
        if unit not in self._inflight:
            self._issue(unit)
        ev, leaves, nbytes = self._inflight.pop(unit)
        self.bytes_fetched += nbytes
        if ev is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ev)
            for w in leaves.values():
                for t in _leaf_tensors(w):
                    t.record_stream(cur)
            self._last_bytes = nbytes
        self._prefetch_after(unit)
        return leaves

    def _resident(self) -> int:
        """Weight bytes of this model on the card: in flight, handed out
        and not yet past on the compute stream, and the last unit."""
        while self._in_use and self._in_use[0][0].query():
            self._in_use.popleft()
        return (sum(n for _e, _l, n in self._inflight.values())
                + sum(n for _e, n in self._in_use) + self._last_bytes)

    def _prefetch_after(self, unit):
        if self._stream is None or len(self.order) < 2:
            return
        i = self.order.index(unit)
        for k in range(1, len(self.order)):
            nxt = self.order[(i + k) % len(self.order)]
            if nxt in self._inflight:
                continue
            need = self._unit_bytes(nxt)
            if k > 1 and self._resident() + need > self.reserve:
                break
            while self._in_use and self._resident() + need > self.reserve:
                # the host waits for the card to finish the oldest layer
                # still holding its weights
                self._in_use.popleft()[0].synchronize()
            self._issue(nxt)


def fetch_layer_params(model, layer_name: str,
                       lp: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """``lp`` with the layer's offloaded weights on the device (before
    dequantization: the copy moves the compressed form)."""
    if not lp:
        return lp
    out = dict(lp)
    out.update(model._prefetcher.fetch(layer_name))
    return out


def fetch_block_params(model, j: int) -> Dict[str, Dict[str, Any]]:
    """{pos: {weight: leaf on the device}} of this stage's block j's
    offloaded stacked slices."""
    out: Dict[str, Dict[str, Any]] = {}
    for (pos, w), leaf in model._prefetcher.fetch(("block", j)).items():
        out.setdefault(pos, {})[w] = leaf
    return out
