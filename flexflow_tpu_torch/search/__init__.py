"""Auto-parallelization search: the Unity capability in the port
(counterpart of ``flexflow_tpu/search``).

The reference's Unity stack (reference src/runtime/graph.cc, substitution.cc,
simulator.cc, machine_model.cc — SURVEY §2.1 L6) jointly searches algebraic
graph substitutions and per-op MachineViews, costing candidates with an
on-device microbenchmark simulator. The port keeps the JAX package's search
line for line and changes what surrounds it:

* the decision space per op is a **sharding assignment** (which named mesh
  axes shard which dims of its output/weights); ``FFModel.compile``
  executes it over the ranks of the process group (weights sliced at rest,
  outputs moved to their specs: ``parallel/placement.py``);
* the cost model is an analytic roofline over an H100/NVLink machine model
  (``"h100-sxm"``; ``"cpu-sim"`` for tests), with a profiled re-rank that
  times the port's ops on the model's device (``CostModel.measure_node``);
* the DP search splits the PCG at post-dominator bottlenecks exactly like
  ``SearchHelper::find_optimal_sequence_graph_time`` and memoizes subgraph
  costs; an MCMC pass (MLSys'19 ``FFModel::mcmc_optimize``) refines;
* substitutions (``GraphXfer``) rewrite the PCG before/inside the search and
  load from the same JSON rule format as ``substitutions/graph_subst_3_v2.json``.
"""

from flexflow_tpu_torch.search.machine_model import (
    GPU_CHIPS, ChipSpec, MachineModel,
)
from flexflow_tpu_torch.search.strategy import OpStrategy, Strategy
from flexflow_tpu_torch.search.cost_model import CostModel, CostMetrics
from flexflow_tpu_torch.search.pcg import PCG, PCGNode
from flexflow_tpu_torch.search.graph_search import (
    UnitySearch, data_parallel_model_strategy, mcmc_optimize, optimize_model,
)
from flexflow_tpu_torch.search.measure import (
    format_ab, searched_vs_dp_wallclock, wallclock_train,
)

__all__ = [
    "GPU_CHIPS", "ChipSpec", "MachineModel", "OpStrategy", "Strategy",
    "CostModel", "CostMetrics", "PCG", "PCGNode", "UnitySearch",
    "mcmc_optimize", "optimize_model", "data_parallel_model_strategy",
    "searched_vs_dp_wallclock", "wallclock_train", "format_ab",
]
