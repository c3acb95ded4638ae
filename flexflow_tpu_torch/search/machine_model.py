"""The machine model: the cost model's view of the hardware (counterpart
of ``flexflow_tpu/search/machine_model.py``).

Role-equivalent of the reference's SimpleMachineModel/EnhancedMachineModel
(reference src/runtime/machine_model.cc, include/flexflow/simulator.h:213-560),
which models GPU nodes, NVLink/PCIe/NIC bandwidths and routes comm paths.
The port's machine is GPUs in nodes: within a node every GPU reaches every
other through NVSwitch at the full NVLink rate (an HGX H100 node holds 8),
and nodes talk over InfiniBand, one NIC a GPU. So the model is a chip spec
(dense bf16 flop/s, HBM bytes/s and capacity, the NVLink rate a GPU has
into the switch, the NIC rate) plus the node geometry. The field names are
the JAX package's, which costs the same shapes on a TPU slice: ``ici_*`` is
the fabric inside a node (NVLink/NVSwitch here) and ``dcn_*`` the network
between nodes (InfiniBand here); ``devices_per_slice`` is the GPUs of one
node. Under a switch one peer gets the whole per-GPU rate, so
``ici_link_bandwidth`` equals ``ici_bandwidth``.

Collective costs use the standard ring lower bounds: for N participants
moving B bytes with a per-GPU bandwidth W,
  all-gather / reduce-scatter:  B * (N-1)/N / W
  all-reduce:                   2 * B * (N-1)/N / W   (RS + AG)
  all-to-all:                   B * (N-1)/N / W
  ppermute (ring shift):        B / W_link  (one peer)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Per-chip peak numbers."""

    name: str
    bf16_flops: float           # peak dense flop/s (bf16)
    hbm_bandwidth: float        # bytes/s
    hbm_capacity: float         # bytes
    ici_bandwidth: float        # bytes/s a chip has inside its node, one way
    ici_link_bandwidth: float   # bytes/s to one peer inside the node
    dcn_bandwidth: float        # bytes/s a chip has across nodes
    # fraction of peak the roofline assumes achievable on big GEMMs
    flops_efficiency: float = 0.55
    mem_efficiency: float = 0.8
    # fixed per-op cost (launch + pipeline fill): the sublinear-scaling
    # term that makes over-sharding SMALL ops lose, and branch-parallel
    # (nonsequence-split) placement win by running fewer, bigger
    # per-device ops concurrently. The reference captures this by
    # MEASURING per-op costs (Op::measure_operator_cost); a pure roofline
    # is scale-linear and would never see it.
    op_overhead: float = 2e-6
    # devices one node holds on its intra-node fabric (None: a whole
    # configuration is one node unless FFConfig.num_nodes says otherwise)
    devices_per_node: Optional[int] = None


# HGX H100: 8 GPUs a node on one NVSwitch fabric
H100_GPUS_PER_NODE = 8

GPU_CHIPS: Dict[str, ChipSpec] = {
    # NVIDIA H100 SXM5, public spec-sheet values: 989 TFLOP/s dense bf16,
    # 3.35 TB/s HBM3, 80 GB; NVLink 4 through NVSwitch at 450 GB/s each
    # way a GPU (any peer gets all of it); one 400 Gb/s NDR InfiniBand NIC
    # a GPU (50 GB/s) between nodes. The efficiencies and op_overhead are
    # the JAX package's defaults, not fitted to this card.
    "h100-sxm": ChipSpec("h100-sxm", bf16_flops=989e12,
                         hbm_bandwidth=3.35e12, hbm_capacity=80e9,
                         ici_bandwidth=450e9, ici_link_bandwidth=450e9,
                         dcn_bandwidth=50e9,
                         devices_per_node=H100_GPUS_PER_NODE),
    # Virtual chip for tests: tiny numbers so costs are nonzero and
    # ratios still favor parallelism the way real chips do (the JAX
    # package's "cpu-sim", unchanged, so the two searches can be held
    # against each other).
    "cpu-sim": ChipSpec("cpu-sim", bf16_flops=1e11, hbm_bandwidth=2e10,
                        hbm_capacity=8e9, ici_bandwidth=5e9,
                        ici_link_bandwidth=2.5e9, dcn_bandwidth=1e9),
}


@dataclasses.dataclass
class MachineModel:
    """Node geometry + chip spec -> collective/time/memory primitives.

    ``dcn_model`` (optional, a network.NetworkedMachineModel over the
    NODES) replaces the flat ``chip.dcn_bandwidth`` for cross-node
    collectives with the routed inter-node ring's bottleneck link: the
    reference's NetworkedMachineModel exists exactly to let topology
    change search outcomes (machine_model.cc / network.cc). A thin
    inter-node fabric makes the search keep allreduce-heavy axes inside a
    node."""

    chip: ChipSpec
    num_devices: int
    devices_per_slice: Optional[int] = None   # GPUs a node; None: one node
    dcn_model: Optional[object] = None        # network.NetworkedMachineModel

    @classmethod
    def from_name(cls, chip_name: str, num_devices: int,
                  devices_per_slice: Optional[int] = None,
                  dcn_model=None) -> "MachineModel":
        return cls(GPU_CHIPS[chip_name], num_devices, devices_per_slice,
                   dcn_model)

    @property
    def num_slices(self) -> int:
        per = self.devices_per_slice or self.num_devices
        return max(1, -(-self.num_devices // per))

    def _dcn_ring_bw(self) -> float:
        """Per-GPU effective bandwidth of a cross-node ring collective:
        the slowest routed node-to-node path's bottleneck link
        (network.NetworkedMachineModel.ring_bottleneck_bandwidth; a
        disconnected fabric returns ~0, i.e. effectively infinite cost)."""
        bw = self.dcn_model.ring_bottleneck_bandwidth(
            list(range(self.num_slices)))
        return max(bw, 1e-9)         # keep downstream divisions finite

    # ---- compute / memory primitives -------------------------------------
    def gemm_time(self, flops: float) -> float:
        return flops / (self.chip.bf16_flops * self.chip.flops_efficiency)

    def mem_time(self, bytes_moved: float) -> float:
        return bytes_moved / (self.chip.hbm_bandwidth * self.chip.mem_efficiency)

    def op_time(self, flops: float, bytes_moved: float) -> float:
        """Roofline: an op is flop-bound or HBM-bound, the rest overlaps;
        plus the fixed per-op overhead (see ChipSpec.op_overhead)."""
        return (max(self.gemm_time(flops), self.mem_time(bytes_moved))
                + self.chip.op_overhead)

    # ---- collective primitives ------------------------------------------
    def _group_bw(self, group_size: int) -> float:
        """Bandwidth available to a collective over a mesh-axis group.
        Groups that fit a node ride NVLink; larger groups are bound by the
        inter-node network (through the routed topology's bottleneck when
        one is modeled)."""
        per_slice = self.devices_per_slice or self.num_devices
        if group_size <= per_slice:
            return self.chip.ici_bandwidth
        if self.dcn_model is not None:
            return self._dcn_ring_bw()
        return self.chip.dcn_bandwidth

    def all_reduce_time(self, bytes_per_chip: float, group: int) -> float:
        if group <= 1:
            return 0.0
        return 2.0 * bytes_per_chip * (group - 1) / group / self._group_bw(group)

    def all_gather_time(self, bytes_per_chip: float, group: int) -> float:
        if group <= 1:
            return 0.0
        return bytes_per_chip * (group - 1) / group / self._group_bw(group)

    def reduce_scatter_time(self, bytes_per_chip: float, group: int) -> float:
        return self.all_gather_time(bytes_per_chip, group)

    def all_to_all_time(self, bytes_per_chip: float, group: int) -> float:
        if group <= 1:
            return 0.0
        return bytes_per_chip * (group - 1) / group / self._group_bw(group)

    def ppermute_time(self, bytes_per_chip: float) -> float:
        return bytes_per_chip / self.chip.ici_link_bandwidth

    def memory_per_device(self) -> float:
        return self.chip.hbm_capacity
