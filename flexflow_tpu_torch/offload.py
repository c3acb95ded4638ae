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

* the copies land in one device scratch ring of
  ``FFConfig.offload_reserve_space_size`` bytes (sized up to twice the
  largest unit where the reserve does not hold it twice; the size is
  printed), allocated once, each unit at a fixed slot: the weight bytes
  on the card are the ring's, by construction;
* they run on a side CUDA stream forked from the compute stream,
  ordered by events, never by a host wait: while layer i computes, the
  copies of the next layers whose slots are free are in flight, and a
  slot's next copy waits on the compute of the layer that last read it.
  A captured program (``serve/graphs.py``) takes a forward's copies as
  memcpy nodes, forked and joined by those events; nothing crosses a
  forward.

Under a pipeline plan the stage-stacked leaves are paged
(``params[PP_PARAMS_KEY]``); a pending plan is finalized first, and
``fetch_block_params`` streams one block's slices back. The microbatches
of a forward share a block's fetch when the stage's paged bytes fit the
reserve and the ring holds them all (``pipeline_plan.run_pp_graph``);
else each fetches it again.

On a CPU model the host is the device: nothing is pinned, and the ring
is host memory that the same schedule fills by synchronous copies (what
the CPU tests exercise). On the card, a weight that cannot be pinned
raises.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import torch

from flexflow_tpu_torch import kernels
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
    if moved:
        model._prefetcher = Prefetcher(model)
        # programs built over the resident weights read them by address:
        # drop them, and the next block builds again (the JAX jit retraces
        # on the new shardings)
        from flexflow_tpu_torch.serve.graphs import drop_programs

        drop_programs(model)
    return moved


# every leaf's slot in the ring starts at a multiple of this (K3's tensor
# maps and the kernels' vector loads want 16-byte addresses)
_ALIGN = 256


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def ring_schedule(sizes: List[int], ring: int) -> List[int]:
    """The ring offset of each unit (``sizes``: its aligned bytes, in
    fetch order): one after the other, back to 0 where a unit would pass
    the ring's end."""
    offs, o = [], 0
    for b in sizes:
        if o + b > ring:
            o = 0
        offs.append(o)
        o += b
    return offs


def ring_waits(sizes: List[int], offs: List[int]) -> List[int]:
    """For each unit, the last earlier unit of the order whose slot its
    slot overlaps (-1: none): the unit's copy waits until that unit's
    compute is done."""
    need = []
    for i, (o, b) in enumerate(zip(offs, sizes)):
        need.append(max((j for j in range(i)
                         if offs[j] < o + b and o < offs[j] + sizes[j]),
                        default=-1))
    return need


class Prefetcher:
    """Streams offloaded weights back to the device ahead of use, through
    one scratch ring (the reference's reserved GPU region).

    A unit is a layer name, or ``("block", j)`` for this stage's stacked
    block j under a pipeline plan; units are fetched in graph order, and
    a fetch of the first unit (or of another than the next) starts a
    pass. The ring, ``offload_reserve_space_size`` bytes (sized up to
    twice the largest unit where that does not fit, and printed; no more
    than every unit at once), is allocated once, here, outside any graph
    pool. Each unit has a fixed slot in it (``ring_schedule``), and each
    of its leaves a fixed view, so a program that reads them reads the
    same addresses at every replay. A pass orders everything by events,
    never by a host wait, so a CUDA graph captures it whole:

    * the copy stream forks from the current stream where the pass
      starts (it waits on everything the last pass enqueued);
    * a unit's copy waits on the compute-done event of the last earlier
      unit of the pass whose slot it overwrites (``ring_waits``), and is
      issued as soon as that event exists: while a layer computes, the
      copies of the next units that fit are in flight;
    * the compute stream waits on a unit's copy event before it reads
      the unit; its done event is recorded at the next fetch, once the
      unit's compute is enqueued.

    Every copy rejoins the compute stream within its pass, so no prefetch
    crosses a pass (nor a program's replay). On a CPU model the ring is
    host memory and the copies are synchronous: the same schedule, the
    same views."""

    def __init__(self, model):
        from flexflow_tpu_torch.serve.pipeline_plan import PP_PARAMS_KEY

        self.model = model
        self.device = model.device
        off = model._offloaded
        plan = model._pp_plan
        if PP_PARAMS_KEY in off:
            # the segments before and after the blocks keep their layers
            self.order: List[Any] = (
                [ly.name for ly in plan.pre if ly.name in off]
                + [("block", j) for j in range(plan.blocks_per_stage)]
                + [ly.name for ly in plan.post if ly.name in off])
        else:
            self.order = [layer.name for layer in model.layers
                          if layer.name in off]
        self._index = {u: i for i, u in enumerate(self.order)}
        self.reserve = int(model.config.offload_reserve_space_size)
        self.sizes = [sum(_aligned(int(t.nbytes)) for w in
                          self._host_leaves(u).values()
                          for t in _leaf_tensors(w)) for u in self.order]
        largest, total = max(self.sizes), sum(self.sizes)
        self.ring_bytes = min(total, max(self.reserve, 2 * largest))
        if self.ring_bytes > self.reserve:
            print(f"offload: the reserve ({self.reserve} bytes) does not "
                  f"hold the largest unit ({largest} bytes) twice; the "
                  f"ring is {self.ring_bytes} bytes")
        self.ring = torch.empty(self.ring_bytes, dtype=torch.uint8,
                                device=self.device)
        self.offsets = ring_schedule(self.sizes, self.ring_bytes)
        self.waits = ring_waits(self.sizes, self.offsets)
        self._views = [self._ring_views(i) for i in range(len(self.order))]
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        # the pass: its first unit, the unit it expects next, the copies
        # issued ({unit index: copy event or None}) and the units whose
        # compute-done events later copies wait on
        self._start = self._next = 0
        self._copied: Dict[int, Any] = {}
        self._done: Dict[int, Any] = {}
        # bytes streamed back since the counter was last reset
        self.bytes_fetched = 0

    @property
    def holds_all(self) -> bool:
        """Does the ring hold every unit at once (no slot reused within a
        pass)?"""
        return self.ring_bytes >= sum(self.sizes)

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

    def _ring_views(self, i) -> Dict[Any, Any]:
        """Unit i's leaves as views of its ring slot (a quantized leaf: its
        payload and scale, each a view)."""
        o = self.offsets[i]

        def view(t):
            nonlocal o
            v = self.ring[o:o + t.nbytes].view(t.dtype).view(t.shape)
            o += _aligned(int(t.nbytes))
            return v

        out = {}
        for k, w in self._host_leaves(self.order[i]).items():
            if is_quantized(w):
                out[k] = QuantizedWeight(w.qtype, view(w.q), view(w.scale),
                                         w.rows, w.dtype)
            else:
                out[k] = view(w)
        return out

    def _unit_bytes(self, unit) -> int:
        return sum(int(getattr(w, "nbytes", 0))
                   for w in self._host_leaves(unit).values())

    def total_bytes(self) -> int:
        """The paged bytes of every unit: what one forward streams back."""
        return sum(self._unit_bytes(u) for u in self.order)

    def _copy(self, i):
        """Unit i's host leaves into its ring views, on the copy stream
        after the compute that last read the slot."""
        pairs = [(d, h) for k, w in self._host_leaves(self.order[i]).items()
                 for d, h in zip(_leaf_tensors(self._views[i][k]),
                                 _leaf_tensors(w))]
        if self._stream is None:
            for d, h in pairs:
                d.copy_(h)
            self._copied[i] = None
            return
        with torch.cuda.stream(self._stream):
            j = self.waits[i]
            if j >= self._start:
                self._stream.wait_event(self._done[j])
            for d, h in pairs:
                d.copy_(h, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        self._copied[i] = ev

    def fetch(self, unit) -> Dict[Any, Any]:
        """The unit's weights on the device (views of the ring), ready for
        the current stream; then the next units' copies go out as far as
        their slots are free."""
        i = self._index[unit]
        cur = (torch.cuda.current_stream(self.device)
               if self._stream is not None else None)
        if i == 0 or i != self._next:
            # a new pass: its copies follow everything enqueued so far
            self._start, self._copied, self._done = i, {}, {}
            if cur is not None:
                self._stream.wait_stream(cur)
        elif cur is not None and (i - 1) in self.waits:
            # unit i - 1's compute is enqueued: a later copy waits on it
            ev = torch.cuda.Event()
            ev.record(cur)
            self._done[i - 1] = ev
        if i not in self._copied:
            self._copy(i)
        self._next = i + 1
        # the copies whose slots are free once unit i - 1 is done, in order
        for k in range(i + 1, len(self.order)):
            if k in self._copied:
                continue
            if self.waits[k] >= i:
                break
            self._copy(k)
        if cur is not None:
            cur.wait_event(self._copied[i])
        # counted where the copy runs: now, or at each replay of a program
        kernels.each_run(functools.partial(self._fetched,
                                           self._unit_bytes(unit)))
        return self._views[i]

    def _fetched(self, nbytes: int):
        self.bytes_fetched += nbytes


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
