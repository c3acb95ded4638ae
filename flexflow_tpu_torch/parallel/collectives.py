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
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

# dtype codes of the point-to-point header (send_tensor / recv_tensor)
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int32,
           torch.int64, torch.int8, torch.bool, torch.uint8, torch.float64)
_HEADER = 8     # [ndim, dtype code, dims...], int64, zero-padded


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


def _reduce(x, mesh, axis_name, op):
    group = _group(mesh, axis_name)
    if group is None:
        return x.clone()
    return _run(x, group, lambda t: dist.all_reduce(t, op=op, group=group))


def psum(x: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    return _reduce(x, mesh, axis_name, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    return _reduce(x, mesh, axis_name, dist.ReduceOp.MAX)


def pmean(x: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    return psum(x, mesh, axis_name) / axis_size(mesh, axis_name)


def all_gather(x: torch.Tensor, mesh, axis_name: str, *, axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Every peer's ``x`` in axis order: concatenated along ``axis``
    (``tiled``), else stacked on a new ``axis``."""
    group = _group(mesh, axis_name)
    if group is None:
        return x.clone() if tiled else x.unsqueeze(axis)
    n = mesh.axis_size(axis_name)
    src = _to_host(x) if (x.is_cuda and _staged(group)) else x.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=axis) if tiled else torch.stack(parts, axis)
    return out.to(x.device)


def reduce_scatter(x: torch.Tensor, mesh, axis_name: str, *,
                   scatter_dimension: int = 0) -> torch.Tensor:
    """The sum over peers, split along ``scatter_dimension``: this rank's
    chunk."""
    n = axis_size(mesh, axis_name)
    total = psum(x, mesh, axis_name)
    if n == 1:
        return total
    return total.chunk(n, dim=scatter_dimension)[
        mesh.index(axis_name)].contiguous()


def broadcast(x: Optional[torch.Tensor], src: int, group=None, *,
              device=None) -> torch.Tensor:
    """``x`` from global rank ``src`` to every rank of ``group`` (the
    world when None). Ranks other than ``src`` may pass None: the shape
    and dtype travel first."""
    me = dist.get_rank()
    dev = torch.device(device) if device is not None else x.device
    if me == src:
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


def send_tensor(x: torch.Tensor, dst: int, group=None):
    """Point-to-point send of ``x`` (its shape and dtype first) to global
    rank ``dst``; staged through pinned host memory under gloo."""
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


def ppermute_shift(x: torch.Tensor, mesh, axis_name: str,
                   shift: int = 1) -> torch.Tensor:
    """Ring shift: the peer at index i sends to (i + shift) mod n, so each
    rank returns the ``x`` of peer (i - shift) mod n. The send and the
    receive are posted together (``batch_isend_irecv``), so the ring
    never waits in a cycle."""
    n = axis_size(mesh, axis_name)
    if n == 1 or shift % n == 0:
        return x.clone()
    group = _group(mesh, axis_name)
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
