"""Parallel serving of the port: the mesh over the process group's ranks,
the collectives, the sharding policy, the parallel ops, sequence-sharded
attention and the pipeline schedule (counterpart of
``flexflow_tpu/parallel``)."""

from flexflow_tpu_torch.parallel.mesh import (MachineResource, Mesh,
                                              make_mesh)
from flexflow_tpu_torch.parallel.pipeline import (pipeline_spmd,
                                                  shard_stacked_params,
                                                  stack_stage_params)
from flexflow_tpu_torch.parallel.spec import ShardingPolicy, shard_params

__all__ = ["MachineResource", "Mesh", "ShardingPolicy", "make_mesh",
           "pipeline_spmd", "shard_params", "shard_stacked_params",
           "stack_stage_params"]
