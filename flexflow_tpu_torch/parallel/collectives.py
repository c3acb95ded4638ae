"""Collectives over one mesh axis (counterpart of
``flexflow_tpu/parallel/collectives.py``).

Each function takes the tensor, the ``Mesh`` and an axis name, and runs
over the process group of this rank's peers along that axis; on an axis
of size 1 it returns its input (a copy where the JAX function would
produce a new array). The results are new tensors on the input's device.

Transport. NCCL takes CUDA tensors directly. Gloo's support for CUDA
tensors depends on the collective and the build (point-to-point has
none), so under gloo a CUDA tensor is staged through a pinned host
buffer explicitly: device -> pinned host, the collective on the host
copy, host -> device. That is how two ranks sharing one card talk (NCCL
refuses two ranks on one device); it moves the same bytes and computes
the same values, it is not a fallback of the compute. Gloo also has no
reduce-scatter: ``reduce_scatter`` is an all-reduce and a slice there.

Autograd. ``psum``, ``all_gather``, ``reduce_scatter`` and
``ppermute_shift`` are differentiable, with the transposes JAX's
autodiff gives them inside a parallel train step, where a value is
either replicated over an axis (every peer holds the same value, and its
gradient is the whole derivative, the same on every peer) or split over
it (each peer holds its part and the derivative of its part):

  psum           partials -> replicated;  backward: the identity
  all_gather     split -> replicated;     backward: this peer's slice
  reduce_scatter partials -> split;       backward: an all-gather
  ppermute_shift                          backward: the inverse shift
  sum_grads      replicated value entering a computation each peer does
                 on its own part (identity); backward: a psum of the
                 peers' partial gradients (Megatron's ``f``)
  split          replicated -> split (this peer's chunk); backward: an
                 all-gather
  psum_parts     partials -> replicated, each peer then computing on its
                 own part (a split LayerNorm's statistics); backward: a
                 psum
  gather_product split on the contracted dim -> each peer's columns of
                 the products; saves the shard, not the gathered input;
                 backward: the weight gradients and a reduce-scatter

A backward runs the same collectives in the same order on every peer,
since every peer records the same graph. On CUDA, autograd runs the
backward on its own thread: each staged copy is made on the current
stream and waited for before gloo reads the host buffer.

Traffic. Inside ``count_moved()`` (off otherwise, as
``kernels.record_shapes`` is), ``calls[(collective, axis)]`` counts the
collectives this rank runs and ``moved[(collective, axis)]`` adds up
their input bytes (a reduce-scatter's whole input, as gloo all-reduces
it; an all-gather's shard; a send's or broadcast's tensor; ``"world"``
where no axis is named).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

# dtype codes of the point-to-point header (send_tensor / recv_tensor)
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int32,
           torch.int64, torch.int8, torch.bool, torch.uint8, torch.float64)
_HEADER = 8     # [ndim, dtype code, dims...], int64, zero-padded


moved: Dict[Tuple[str, str], int] = {}
calls: Dict[Tuple[str, str], int] = {}
_counting = [False]


@contextlib.contextmanager
def count_moved():
    """Count the block's collectives into ``calls`` and ``moved`` (both
    emptied first)."""
    moved.clear()
    calls.clear()
    _counting[0] = True
    try:
        yield
    finally:
        _counting[0] = False


def _count(kind: str, axis: Optional[str], x: torch.Tensor):
    if not _counting[0]:
        return
    key = (kind, axis or "world")
    calls[key] = calls.get(key, 0) + 1
    moved[key] = moved.get(key, 0) + x.numel() * x.element_size()


def _staged(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of CUDA ``x`` (``x`` itself on the CPU)."""
    if not x.is_cuda:
        return x.contiguous()
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def _run(x: torch.Tensor, group, fn) -> torch.Tensor:
    """Apply the in-place collective ``fn`` to a contiguous copy of ``x``,
    staged through host memory under gloo; returns the copy on x's
    device."""
    if x.is_cuda and _staged(group):
        h = _to_host(x)
        fn(h)
        return h.to(x.device)
    y = x.clone(memory_format=torch.contiguous_format)
    fn(y)
    return y


def axis_size(mesh, axis_name: str) -> int:
    return 1 if mesh is None else mesh.axis_size(axis_name)


def _group(mesh, axis_name):
    if mesh is None or mesh.axis_size(axis_name) <= 1:
        return None
    return mesh.group(axis_name)


def _reduce(x, mesh, axis_name, op, kind="all_reduce"):
    group = _group(mesh, axis_name)
    if group is None:
        return x.clone()
    _count(kind, axis_name, x)
    return _run(x, group, lambda t: dist.all_reduce(t, op=op, group=group))


def _differentiable(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis_name):
        return _reduce(x, mesh, axis_name, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis_name):
        ctx.mesh, ctx.axis_name = mesh, axis_name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.mesh, ctx.axis_name,
                       dist.ReduceOp.SUM), None, None


def psum(x: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    """The sum over the peers along ``axis_name`` (backward: the
    identity)."""
    if _differentiable(x):
        return _PSum.apply(x, mesh, axis_name)
    return _reduce(x, mesh, axis_name, dist.ReduceOp.SUM)


def sum_grads(x: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    """``x`` itself; its backward sums the peers' gradients along
    ``axis_name``. A replicated value goes through it where each peer
    computes on its own part of the work, so that every peer's gradient
    of the value is the whole one."""
    if axis_size(mesh, axis_name) <= 1 or not _differentiable(x):
        return x
    return _SumGrads.apply(x, mesh, axis_name)


def psum_parts(x: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    """The sum over the peers of their partials (a statistic of a value
    split over ``axis_name``), which each peer then reads for its own
    part: its gradient there is a partial too, so the backward sums the
    peers' gradients (``sum_grads`` of a ``psum``)."""
    return sum_grads(psum(x, mesh, axis_name), mesh, axis_name)


def pmax(x: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    """The elementwise max over the peers (not differentiable: take it of
    a detached value)."""
    return _reduce(x, mesh, axis_name, dist.ReduceOp.MAX)


def pmean(x: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    return psum(x, mesh, axis_name) / axis_size(mesh, axis_name)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis_name, axis, tiled):
        ctx.args = (mesh, axis_name, axis, tiled)
        return _all_gather(x, mesh, axis_name, axis, tiled)

    @staticmethod
    def backward(ctx, g):
        mesh, axis_name, axis, tiled = ctx.args
        i = mesh.index(axis_name)
        if tiled:
            part = g.chunk(mesh.axis_size(axis_name), dim=axis)[i]
        else:
            part = g.select(axis, i)
        return part.contiguous(), None, None, None, None


def all_gather(x: torch.Tensor, mesh, axis_name: str, *, axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Every peer's ``x`` in axis order: concatenated along ``axis``
    (``tiled``), else stacked on a new ``axis`` (backward: this peer's
    slice of the gradient)."""
    if _differentiable(x) and axis_size(mesh, axis_name) > 1:
        return _AllGather.apply(x, mesh, axis_name, axis, tiled)
    return _all_gather(x, mesh, axis_name, axis, tiled)


class _GatherProduct(torch.autograd.Function):
    """``all_gather(x)`` on its last dim, then ``x @ w`` for each ``w`` in
    ``dtype``. Only ``x``'s shard is saved; the backward gathers it again
    for the weights' gradients, and the input's gradient (each peer's
    product a partial sum) is summed over the peers and cut to this
    peer's part (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, mesh, axis_name, dtype, *ws):
        ctx.args = (mesh, axis_name, dtype)
        ctx.save_for_backward(x, *ws)
        xw = _all_gather(x, mesh, axis_name, x.dim() - 1, True).to(dtype)
        return tuple(xw @ w.to(dtype) for w in ws)

    @staticmethod
    def backward(ctx, *gs):
        mesh, axis_name, dtype = ctx.args
        x, *ws = ctx.saved_tensors
        xw = _all_gather(x, mesh, axis_name, x.dim() - 1, True).to(dtype)
        rows = xw.reshape(-1, xw.shape[-1])
        dx, dws = None, []
        for j, (w, g) in enumerate(zip(ws, gs)):
            g = g.to(dtype)
            wd = w.to(dtype)
            dws.append((rows.t() @ g.reshape(-1, g.shape[-1])).to(w.dtype)
                       if ctx.needs_input_grad[4 + j] else None)
            if ctx.needs_input_grad[0]:
                part = g @ wd.t()
                dx = part if dx is None else dx + part
        if dx is not None:
            dx = _reduce_scatter(dx.to(x.dtype), mesh, axis_name,
                                 x.dim() - 1)
        return (dx, None, None, None, *dws)


def gather_product(x: torch.Tensor, mesh, axis_name: str, ws,
                   dtype=None) -> List[torch.Tensor]:
    """``[all_gather(x, axis=-1) @ w for w in ws]`` (in ``dtype``, default
    the promotion of ``x``'s and the weights' dtypes) for ``x`` split over
    ``axis_name`` on the dim the products contract, each ``w`` this
    peer's columns: the peers compute different columns of the outputs.
    Saves ``x``'s shard, not the gathered ``x``, for the backward;
    backward: the weights' gradients, and the input's as a
    reduce-scatter of the peers' partial sums."""
    if dtype is None:
        dtype = x.dtype
        for w in ws:
            dtype = torch.promote_types(dtype, w.dtype)
    if _differentiable(x) or any(_differentiable(w) for w in ws):
        return list(_GatherProduct.apply(x, mesh, axis_name, dtype, *ws))
    xw = _all_gather(x, mesh, axis_name, x.dim() - 1, True).to(dtype)
    return [xw @ w.to(dtype) for w in ws]


def _all_gather(x, mesh, axis_name, axis, tiled):
    group = _group(mesh, axis_name)
    if group is None:
        return x.clone() if tiled else x.unsqueeze(axis)
    n = mesh.axis_size(axis_name)
    _count("all_gather", axis_name, x)
    src = _to_host(x) if (x.is_cuda and _staged(group)) else x.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=axis) if tiled else torch.stack(parts, axis)
    return out.to(x.device)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis_name, dim):
        ctx.args = (mesh, axis_name, dim)
        return _reduce_scatter(x, mesh, axis_name, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis_name, dim = ctx.args
        return _all_gather(g, mesh, axis_name, dim, True), None, None, None


def reduce_scatter(x: torch.Tensor, mesh, axis_name: str, *,
                   scatter_dimension: int = 0) -> torch.Tensor:
    """The sum over peers, split along ``scatter_dimension``: this rank's
    chunk (backward: an all-gather of the chunks' gradients)."""
    if _differentiable(x) and axis_size(mesh, axis_name) > 1:
        return _ReduceScatter.apply(x, mesh, axis_name, scatter_dimension)
    return _reduce_scatter(x, mesh, axis_name, scatter_dimension)


def _reduce_scatter(x, mesh, axis_name, dim):
    n = axis_size(mesh, axis_name)
    total = _reduce(x, mesh, axis_name, dist.ReduceOp.SUM,
                    kind="reduce_scatter")
    if n == 1:
        return total
    return total.chunk(n, dim=dim)[mesh.index(axis_name)].contiguous()


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis_name, dim):
        ctx.args = (mesh, axis_name, dim)
        return _chunk(x, mesh, axis_name, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis_name, dim = ctx.args
        return _all_gather(g, mesh, axis_name, dim, True), None, None, None


def _chunk(x, mesh, axis_name, dim):
    n = axis_size(mesh, axis_name)
    return x.chunk(n, dim=dim)[mesh.index(axis_name)].contiguous()


def split(x: torch.Tensor, mesh, axis_name: str, dim: int) -> torch.Tensor:
    """This peer's chunk of ``x`` along ``dim`` (``x`` replicated over
    ``axis_name``); backward: an all-gather of the chunks' gradients."""
    if axis_size(mesh, axis_name) <= 1:
        return x
    if _differentiable(x):
        return _Split.apply(x, mesh, axis_name, dim)
    return _chunk(x, mesh, axis_name, dim)


def broadcast(x: Optional[torch.Tensor], src: int, group=None, *,
              device=None) -> torch.Tensor:
    """``x`` from global rank ``src`` to every rank of ``group`` (the
    world when None). Ranks other than ``src`` may pass None: the shape
    and dtype travel first."""
    me = dist.get_rank()
    dev = torch.device(device) if device is not None else x.device
    if me == src:
        _count("broadcast", None, x)
        head = _header(x)
    else:
        head = torch.zeros(_HEADER, dtype=torch.int64)
    staged = _staged(group)
    hd = head if staged else head.to(dev)
    dist.broadcast(hd, src=src, group=group)
    shape, dtype = _parse_header(hd.cpu())
    if me == src:
        buf = x.contiguous()
    else:
        buf = torch.empty(shape, dtype=dtype, device=dev)
    if buf.is_cuda and staged:
        h = _to_host(buf)
        dist.broadcast(h, src=src, group=group)
        return buf if me == src else h.to(dev)
    dist.broadcast(buf, src=src, group=group)
    return buf


def _header(x: torch.Tensor) -> torch.Tensor:
    if x.dim() > _HEADER - 2:
        raise ValueError(f"a {x.dim()}-d tensor does not fit the header")
    head = torch.zeros(_HEADER, dtype=torch.int64)
    head[0] = x.dim()
    head[1] = _DTYPES.index(x.dtype)
    head[2:2 + x.dim()] = torch.tensor(x.shape, dtype=torch.int64)
    return head


def _parse_header(head: torch.Tensor):
    nd = int(head[0])
    return tuple(int(d) for d in head[2:2 + nd]), _DTYPES[int(head[1])]


def send_tensor(x: torch.Tensor, dst: int, group=None,
                axis_name: Optional[str] = None):
    """Point-to-point send of ``x`` (its shape and dtype first) to global
    rank ``dst`` (a peer along ``axis_name``, for ``moved``); staged
    through pinned host memory under gloo."""
    _count("send", axis_name, x)
    staged = _staged(group)
    head = _header(x)
    dist.send(head if staged else head.to(x.device), dst=dst, group=group)
    dist.send(_to_host(x) if (x.is_cuda and staged) else x.contiguous(),
              dst=dst, group=group)


def recv_tensor(src: int, device, group=None) -> torch.Tensor:
    """Receive what ``send_tensor`` sent from global rank ``src``, on
    ``device``."""
    dev = torch.device(device)
    staged = _staged(group)
    head = torch.zeros(_HEADER, dtype=torch.int64,
                       device="cpu" if staged else dev)
    dist.recv(head, src=src, group=group)
    shape, dtype = _parse_header(head.cpu())
    if dev.type == "cuda" and staged:
        h = torch.empty(shape, dtype=dtype, pin_memory=True)
        dist.recv(h, src=src, group=group)
        return h.to(dev)
    buf = torch.empty(shape, dtype=dtype, device=dev)
    dist.recv(buf, src=src, group=group)
    return buf


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis_name, shift):
        ctx.args = (mesh, axis_name, shift)
        return _shift(x, mesh, axis_name, shift)

    @staticmethod
    def backward(ctx, g):
        mesh, axis_name, shift = ctx.args
        return _shift(g, mesh, axis_name, -shift), None, None, None


def ppermute_shift(x: torch.Tensor, mesh, axis_name: str,
                   shift: int = 1) -> torch.Tensor:
    """Ring shift: the peer at index i sends to (i + shift) mod n, so each
    rank returns the ``x`` of peer (i - shift) mod n. The send and the
    receive are posted together (``batch_isend_irecv``), so the ring
    never waits in a cycle. Backward: the inverse shift."""
    if _differentiable(x):
        return _Shift.apply(x, mesh, axis_name, shift)
    return _shift(x, mesh, axis_name, shift)


def _shift(x, mesh, axis_name, shift):
    n = axis_size(mesh, axis_name)
    if n == 1 or shift % n == 0:
        return x.clone()
    group = _group(mesh, axis_name)
    _count("ppermute", axis_name, x)
    i = mesh.index(axis_name)
    dst = mesh.rank_at(**{axis_name: (i + shift) % n})
    src = mesh.rank_at(**{axis_name: (i - shift) % n})
    if x.is_cuda and _staged(group):
        send_buf = _to_host(x)
        recv_buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    else:
        send_buf = x.contiguous()
        recv_buf = torch.empty_like(send_buf)
    ops = [dist.P2POp(dist.isend, send_buf, dst, group),
           dist.P2POp(dist.irecv, recv_buf, src, group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return recv_buf.to(x.device)


def all_to_all(x: torch.Tensor, mesh, axis_name: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Split ``x`` into n chunks along ``split_axis``, send chunk j to peer
    j, and concatenate what arrives along ``concat_axis`` (tiled, the JAX
    ``all_to_all``). Built from an all-gather, which every backend has:
    peer j's chunk i is slice i of what peer j gathered."""
    n = axis_size(mesh, axis_name)
    if n == 1:
        return x.clone()
    i = mesh.index(axis_name)
    every = all_gather(x, mesh, axis_name, axis=0, tiled=False)  # [n, ...]
    mine = [every[j].chunk(n, dim=split_axis)[i] for j in range(n)]
    return torch.cat(mine, dim=concat_axis).contiguous()
