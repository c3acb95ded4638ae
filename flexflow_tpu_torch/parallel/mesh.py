"""Device mesh over the ranks of the process group (counterpart of
``flexflow_tpu/parallel/mesh.py``).

The JAX package builds one ``jax.sharding.Mesh`` whose named axes carry
the parallelism degrees. Here each rank is one process with one device,
and the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks with the same named dims, in the same order (``AXIS_ORDER``: the
innermost, fastest-varying axis is ``model``, so tensor-parallel peers
are neighbouring ranks). ``Mesh`` wraps it with what the ops ask: the
size of an axis, this rank's index along it, the process group of its
peers on it and the global rank at a coordinate.

A process without a process group (a single-process run, or the tests
that compare layouts) gets a ``Mesh`` whose ``device_mesh`` is None: its
shape and names are computed as the JAX package computes them, and it
has no peers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

AXIS_ORDER = ("pipe", "data", "expert", "seq", "model")


@dataclasses.dataclass
class MachineResource:
    """Cluster inventory (reference machine_view.h:102 MachineResource)."""

    num_nodes: int
    num_devices_per_node: int

    @property
    def num_devices(self) -> int:
        return self.num_nodes * self.num_devices_per_node


def mesh_layout(config, num_devices: int
                ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the mesh that ``config`` lays over
    ``num_devices`` devices: ``mesh_shape`` when given, else the degrees
    above 1 in ``AXIS_ORDER`` with the leftover devices absorbed into
    ``data`` (the reference's default is data-parallel over all workers,
    model.h:303) — the JAX ``make_mesh`` rules."""
    n = int(num_devices)
    if config.mesh_shape is not None:
        shape = tuple(int(d) for d in config.mesh_shape)
        names = tuple(config.mesh_axis_names)[: len(shape)]
        need = math.prod(shape)
        if need > n:
            raise ValueError(f"mesh_shape {shape} needs {need} devices, "
                             f"have {n}")
        return shape, names
    degrees = {
        "pipe": config.pipeline_parallelism_degree,
        "data": config.data_parallelism_degree,
        "expert": config.expert_parallelism_degree,
        "seq": config.sequence_parallelism_degree,
        "model": config.tensor_parallelism_degree,
    }
    explicit = math.prod(degrees.values())
    if explicit > n:
        raise ValueError(
            f"parallelism degrees {degrees} need {explicit} devices, have {n}")
    n = (n // explicit) * explicit
    degrees["data"] *= n // explicit
    names = tuple(a for a in AXIS_ORDER if degrees[a] > 1)
    shape = tuple(degrees[a] for a in names)
    if not names:
        return (1,), ("data",)
    return shape, names


class Mesh:
    """Named mesh axes over the ranks ``0 .. prod(shape) - 1``, row-major
    (the last axis varies fastest). ``shape`` is a dict axis -> size, as
    the JAX mesh's."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 rank: int = 0, device_mesh=None):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))
        self.rank = int(rank)
        self.device_mesh = device_mesh
        self.coord: Dict[str, int] = {}
        rest = self.rank
        for name in reversed(self.axis_names):
            self.coord[name] = rest % self.shape[name]
            rest //= self.shape[name]

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_size(self, name: str) -> int:
        """Size of axis ``name`` (1 when the mesh has no such axis)."""
        return self.shape.get(name, 1)

    def index(self, name: str) -> int:
        """This rank's index along ``name`` (0 when absent)."""
        return self.coord.get(name, 0)

    def rank_at(self, **coord) -> int:
        """Global rank at this rank's coordinate with ``coord`` replaced
        (axes not named keep this rank's index)."""
        full = dict(self.coord)
        full.update(coord)
        r = 0
        for name in self.axis_names:
            r = r * self.shape[name] + full[name]
        return r

    def group(self, name: str):
        """The process group of this rank's peers along ``name``; None
        when the axis has size 1 or there is no process group."""
        if self.axis_size(name) <= 1 or self.device_mesh is None:
            return None
        return self.device_mesh.get_group(name)

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


def make_mesh(config, world_size: Optional[int] = None) -> Mesh:
    """The mesh ``config`` implies over the process group's ranks.

    With a process group up, ``world_size`` defaults to its size, every
    rank must sit in the mesh, and the result carries a ``DeviceMesh``
    (device type ``cuda`` or ``cpu``, after ``config.device``) whose
    named dims give each axis its process group. Without one, the mesh
    is a layout only (``device_mesh`` None), for ``world_size`` devices
    (default 1)."""
    import torch.distributed as dist

    active = dist.is_available() and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if active else 1
    shape, names = mesh_layout(config, world_size)
    if not active:
        return Mesh(shape, names)
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(
            f"mesh {dict(zip(names, shape))} covers {math.prod(shape)} "
            f"ranks but the process group has {dist.get_world_size()}: "
            "every rank must sit in the mesh")
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    dev_type = "cuda" if str(config.device).startswith("cuda") else "cpu"
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    dm = DeviceMesh(dev_type, ranks, mesh_dim_names=names)
    return Mesh(shape, names, rank=dist.get_rank(), device_mesh=dm)


def single_device_mesh() -> Mesh:
    return Mesh((1,), ("data",))
