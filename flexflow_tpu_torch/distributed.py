"""Multi-process runtime initialization (counterpart of
``flexflow_tpu/distributed.py``).

The reference launches one process per GPU with mpirun over GASNet/UCX
and NCCL communicators; the JAX package joins the jax distributed
runtime. The port joins a ``torch.distributed`` process group: every rank
calls :func:`initialize` (directly, or through the serving entry points
when a parallelism degree is above 1), after which ``parallel/mesh.py``
lays the parallelism axes over the ranks.

Ranks come from arguments or from torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``).
``init_method`` takes any torch rendezvous URL: ``tcp://host:port`` or
``file:///path`` (what the tests and ``parallel/launch.py`` use, so that
concurrent jobs on one host never race for a port).

Backend: NCCL when every rank has a GPU of its own, gloo on the CPU and
when several ranks share one card (NCCL refuses two ranks on one
device). ``timeout`` bounds every collective, so a rank whose peer died
raises instead of hanging.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

_initialized = False

DEFAULT_TIMEOUT_S = 300.0


def choose_backend(device: str, world_size: int) -> str:
    """``nccl`` when every rank of ``world_size`` has a GPU of its own,
    else ``gloo``."""
    import torch

    if (str(device).startswith("cuda") and torch.cuda.is_available()
            and torch.cuda.device_count() >= world_size):
        return "nccl"
    return "gloo"


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None,
               device: str = "cuda",
               timeout: float = DEFAULT_TIMEOUT_S) -> bool:
    """Start (or join) the process group. Idempotent; returns True when a
    process group is active, False for a single-process run (nothing
    configured).

    ``init_method``/``world_size``/``rank`` default to torchrun's
    environment. A rank that has a world size or a rank but no rendezvous
    raises, instead of running single-process while its peers block.
    ``FF_DISABLE_DISTRIBUTED=1`` wins over everything."""
    global _initialized
    import torch
    import torch.distributed as dist

    if _initialized or dist.is_initialized():
        _initialized = True
        return True
    if os.environ.get("FF_DISABLE_DISTRIBUTED") == "1":
        return False
    if world_size is None and os.environ.get("WORLD_SIZE"):
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and os.environ.get("RANK"):
        rank = int(os.environ["RANK"])
    if init_method is None and os.environ.get("MASTER_ADDR"):
        init_method = (f"tcp://{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if init_method is None:
        if world_size is not None or rank is not None:
            raise ValueError(
                "WORLD_SIZE/RANK are set but there is no rendezvous: set "
                "MASTER_ADDR/MASTER_PORT (or pass init_method) so this "
                "rank joins the job instead of silently running "
                "single-process while its peers block")
        return False
    if world_size is None or rank is None:
        raise ValueError(f"init_method={init_method!r} needs world_size "
                         "and rank (arguments or WORLD_SIZE/RANK)")
    backend = backend or choose_backend(device, world_size)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    _initialized = True
    return True


def shutdown():
    """Destroy the process group (a no-op without one)."""
    global _initialized
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def process_info():
    """(rank, world_size, local_device_count, world_size): the JAX
    tuple's shape, one device a rank."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return rank, world, local, world


def host_local_batch(global_batch: int) -> int:
    """Per-rank batch of a globally sharded input pipeline (the
    reference's per-node dataloader split)."""
    _rank, n, _local, _world = process_info()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    return global_batch // n
