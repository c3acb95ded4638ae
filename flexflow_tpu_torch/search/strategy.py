"""Parallelization strategies: what the search produces (counterpart of
``flexflow_tpu/search/strategy.py``; the JSON is the JAX package's, so a
file saved by either package loads in the other).

The reference's search output is a MachineView per PCG node (reference
src/runtime/graph.cc:2219 serializes (graph, optimal views); the FFMapper then
routes each op's point tasks to its view's devices). Here the output is a
**sharding assignment** per op: a mesh-axis name per tensor dim for the op's
output and each weight, plus the set of axes the output is partial over
(pending psum). ``FFModel.compile`` executes it over the process group's
ranks: weights at rest follow ``weight_specs`` and each layer's output is
moved to its ``output_spec`` (``parallel/placement.py``).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Tuple

Spec = Tuple[Optional[str], ...]        # per-dim mesh axis name or None


def spec_degree(spec: Spec, axis_degrees: Dict[str, int]) -> int:
    """Total shards implied by a spec."""
    d = 1
    for a in spec:
        if a is not None:
            d *= axis_degrees.get(a, 1)
    return d


def shard_bytes(shape: Tuple[int, ...], dtype_bytes: int, spec: Spec,
                axis_degrees: Dict[str, int]) -> float:
    """Per-device bytes of a tensor laid out with `spec`."""
    total = float(math.prod(shape)) * dtype_bytes if shape else dtype_bytes
    return total / spec_degree(spec, axis_degrees)


@dataclasses.dataclass
class OpStrategy:
    """One op's parallelization decision.

    input_specs  — the layout this config consumes (edge resharding is costed
                   against the producer's output_spec).
    output_spec  — layout of the primary output.
    weight_specs — per weight-name layout (axis names per dim), fed to
                   ShardingPolicy.weight_sharding at compile.
    partial_axes — mesh axes the output is partial over; the cost model
                   charges a psum and the resulting spec is replicated over
                   that axis after reduction (row-parallel linear etc.).
    """

    input_specs: Tuple[Spec, ...]
    output_spec: Spec
    weight_specs: Dict[str, Spec] = dataclasses.field(default_factory=dict)
    partial_axes: Tuple[str, ...] = ()
    name: str = ""                       # human tag, e.g. "tp-col", "dp"
    # Nonsequence (branch-parallel) placement: (branch_idx, n_branches)
    # pins this op to slice branch_idx of the data axis split n_branches
    # ways — the reference's NonsequenceSplit device-subset assignment
    # (include/flexflow/graph.h:156). None = the op spans all devices.
    branch: Optional[Tuple[int, int]] = None
    # Unequal-resource split (the reference's VERTICAL(i)/HORIZONTAL(i)
    # params, graph.cc:220-244 — both are i-vs-rest device partitions,
    # vertical in node units, horizontal in per-node device units):
    # (devices_for_this_branch, total_devices). None = equal slices.
    branch_alloc: Optional[Tuple[int, int]] = None
    # Mesh axis the branch slices live on; the search can also pin
    # branches over the model/expert axes, not just data.
    branch_axis: str = "data"

    def key(self) -> str:
        return json.dumps([self.input_specs, self.output_spec,
                           sorted(self.weight_specs.items()),
                           self.partial_axes, self.branch,
                           self.branch_alloc, self.branch_axis],
                          default=list)


@dataclasses.dataclass
class Strategy:
    """Whole-model assignment: layer name → OpStrategy."""

    ops: Dict[str, OpStrategy] = dataclasses.field(default_factory=dict)
    cost: float = float("inf")           # simulated step time (s)
    peak_memory: float = 0.0             # per-device bytes
    # mesh factorization this strategy was searched under (set when the
    # search explored factorizations — the reference searches MachineView
    # degrees too, graph.cc:2107); compile applies it to the config
    axis_degrees: Optional[Dict[str, int]] = None

    def to_json(self) -> str:
        def enc(s: OpStrategy):
            return {
                "inputs": [list(x) for x in s.input_specs],
                "output": list(s.output_spec),
                "weights": {k: list(v) for k, v in s.weight_specs.items()},
                "partial": list(s.partial_axes),
                "name": s.name,
                **({"branch": list(s.branch)} if s.branch else {}),
                **({"branch_alloc": list(s.branch_alloc)}
                   if s.branch_alloc else {}),
                **({"branch_axis": s.branch_axis}
                   if s.branch_axis != "data" else {}),
            }

        return json.dumps({"cost": self.cost, "peak_memory": self.peak_memory,
                           **({"axis_degrees": self.axis_degrees}
                              if self.axis_degrees else {}),
                           "ops": {k: enc(v) for k, v in self.ops.items()}},
                          indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Strategy":
        raw = json.loads(text)

        def dec(d) -> OpStrategy:
            return OpStrategy(
                input_specs=tuple(tuple(x) for x in d["inputs"]),
                output_spec=tuple(d["output"]),
                weight_specs={k: tuple(v) for k, v in d["weights"].items()},
                partial_axes=tuple(d["partial"]),
                name=d.get("name", ""),
                branch=tuple(d["branch"]) if d.get("branch") else None,
                branch_alloc=(tuple(d["branch_alloc"])
                              if d.get("branch_alloc") else None),
                branch_axis=d.get("branch_axis", "data"),
            )

        return cls(ops={k: dec(v) for k, v in raw["ops"].items()},
                   cost=raw.get("cost", float("inf")),
                   peak_memory=raw.get("peak_memory", 0.0),
                   axis_degrees=raw.get("axis_degrees"))

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Strategy":
        with open(path) as f:
            return cls.from_json(f.read())


def replicated(ndims: int) -> Spec:
    return (None,) * ndims


def data_parallel_strategy(layer_specs: List[Tuple[str, int, Dict[str, int]]]
                           ) -> Strategy:
    """Baseline: batch dim on 'data' everywhere, weights replicated
    (the reference's get_basic_data_parallel_config, model.h:303).
    layer_specs: [(name, out_ndims, {weight_name: ndims})]."""
    st = Strategy()
    for name, out_nd, weights in layer_specs:
        spec = tuple(["data"] + [None] * (out_nd - 1)) if out_nd else ()
        st.ops[name] = OpStrategy(
            input_specs=(), output_spec=spec,
            weight_specs={w: (None,) * nd for w, nd in weights.items()},
            name="dp")
    return st
