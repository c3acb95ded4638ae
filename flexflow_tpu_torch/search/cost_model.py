"""Cost model: simulated step time + memory for a (PCG, strategy) candidate
(counterpart of ``flexflow_tpu/search/cost_model.py``; the analytic part is
the JAX package's line for line).

Role-equivalent of the reference's ``Simulator`` (reference
src/runtime/simulator.cc:797 simulate_runtime; ``CostMetrics`` simulator.h:55),
which microbenchmarks each op on-device and simulates the task graph over a
machine model. Here the simulation is:

  step_time = Σ_ops roofline(op, sharding) + Σ_ops psum(partial outputs)
            + Σ_edges reshard(producer_spec → consumer_spec)
            [+ gradient allreduce per weight for training]

The profiled re-rank (``measure_node``) times each distinct (op, sharding)
leaf's port forward on the model's device with caching by params-hash, the
moral equivalent of ``Op::measure_operator_cost``.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Optional, Tuple

from flexflow_tpu_torch.ffconst import OpType
from flexflow_tpu_torch.search.machine_model import MachineModel
from flexflow_tpu_torch.search.pcg import ATTENTION_OPS, PCG, PCGNode
from flexflow_tpu_torch.search.strategy import (
    OpStrategy, Spec, Strategy, shard_bytes, spec_degree,
)


@dataclasses.dataclass
class CostMetrics:
    """Per-candidate costs (reference simulator.h:55 CostMetrics)."""

    forward_time: float = 0.0
    backward_time: float = 0.0
    comm_time: float = 0.0
    sync_time: float = 0.0          # gradient allreduce
    memory: float = 0.0             # per-device bytes
    # overlap-aware schedule length (reference simulate_runtime,
    # simulator.cc:797): when set, this — not the serial sum — is the
    # candidate's step-time estimate
    makespan: float = 0.0

    @property
    def total(self) -> float:
        if self.makespan > 0.0:
            return self.makespan
        return (self.forward_time + self.backward_time + self.comm_time
                + self.sync_time)


class CostModel:
    def __init__(self, machine: MachineModel, axis_degrees: Dict[str, int],
                 training: bool = True, profile: bool = False,
                 overlap: bool = True, branch_concurrency: bool = False,
                 device=None, compute_dtype=None):
        self.machine = machine
        self.axes = dict(axis_degrees)
        self.training = training
        self.profile = profile
        # overlap=True: simulate() schedules the task graph over compute,
        # intra-node and inter-node links (reference
        # Simulator::simulate_runtime, simulator.cc:797) so collectives
        # hidden under compute — and
        # branch-parallel subgraphs running concurrently — are costed
        # honestly. False: the legacy serial sum.
        self.overlap = overlap
        # branch_concurrency=True: branch-pinned (nonsequence split) ops
        # run on concurrent per-branch timelines, the reference's Legion
        # per-branch MachineView semantics
        # (find_optimal_nonsequence_graph_time, graph.h:181-196), where
        # disjoint device subsets really do run different tasks. The
        # port's executor (core/branch_exec.py) runs each branch only on
        # its own ranks, which is this form. False (default, the JAX
        # package's, so that both searches give one strategy): branch ops
        # serialize on the shared compute timeline while still paying
        # their scaled-axes durations; under this costing a nonsequence
        # split only wins when per-op overheads dominate, and the search
        # keeps DP for compute-dense fork-joins.
        self.branch_concurrency = branch_concurrency
        self._compute_memo: Dict[Tuple, Tuple[PCGNode, CostMetrics]] = {}
        self._profile_cache: Dict[str, float] = {}
        # measure_node: the device its forwards run on (None: the CPU),
        # the dtype they compute in (the model's compute_dtype; None: each
        # node's own), each key's measured and analytic seconds, and the
        # count of keys that fell back to the analytic time
        self.device = device
        self.compute_dtype = compute_dtype
        self.profile_records: Dict[str, Dict] = {}
        self.profile_fallbacks = 0

    def _axes_for(self, st: OpStrategy) -> Dict[str, int]:
        """Effective axis degrees for an op: a branch-pinned op (nonsequence
        split) sees only its slice of the branch axis — an equal 1/nb
        slice, or its ``branch_alloc`` device count for unequal
        (vertical(i)/horizontal(i), reference graph.cc:220-244) splits."""
        if st.branch is None:
            return self.axes
        _, nb = st.branch
        axes = dict(self.axes)
        ax = st.branch_axis
        if st.branch_alloc is not None:
            axes[ax] = max(1, st.branch_alloc[0])
        else:
            axes[ax] = max(1, axes.get(ax, 1) // nb)
        return axes

    # ---- per-node compute ------------------------------------------------
    def node_compute_time(self, node: PCGNode, st: OpStrategy) -> CostMetrics:
        """The node's costs under ``st``: a pure function of the two under
        this model, which the search asks for again and again (every
        beam, memory-λ retry and rewritten graph), so each pair is
        computed once. The memo holds the node, so its id stays its own;
        callers only read the metrics."""
        try:     # the fields of st.key(), as a tuple: cheaper than JSON
            key = (id(node), st.input_specs, st.output_spec,
                   tuple(sorted(st.weight_specs.items())), st.partial_axes,
                   st.branch, st.branch_alloc, st.branch_axis)
            hit = self._compute_memo.get(key)
        except TypeError:                 # a spec held as a list
            key = (id(node), st.key())
            hit = self._compute_memo.get(key)
        if hit is not None:
            return hit[1]
        m = self._node_compute_time(node, st)
        self._compute_memo[key] = (node, m)
        return m

    def _node_compute_time(self, node: PCGNode, st: OpStrategy
                           ) -> CostMetrics:
        axes = self._axes_for(st)
        shards = max(spec_degree(st.output_spec, axes), 1)
        # weight sharding reduces per-device gemm work for tp-row/col too;
        # output-spec degree already captures col/dp; row-parallel shards
        # the contraction dim (visible via partial_axes).
        for a in st.partial_axes:
            shards *= axes.get(a, 1)
        flops = node.flops() / shards
        bytes_moved = node.io_bytes() / shards
        fwd = self.machine.op_time(flops, bytes_moved)
        m = CostMetrics(forward_time=fwd)
        if self.training and node.weight_shapes:
            m.backward_time = 2.0 * fwd       # dgrad + wgrad
        elif self.training:
            m.backward_time = fwd
        # psum of partial outputs
        out_bytes = shard_bytes(node.output_shapes[0] if node.output_shapes
                                else (), node.dtype_bytes, st.output_spec,
                                axes)
        for a in st.partial_axes:
            m.comm_time += self.machine.all_reduce_time(
                out_bytes, axes.get(a, 1))
        # spatially-sharded convs exchange (kernel-1) halo rows with both
        # neighbors every step (the halo exchange with each neighbor);
        # without this charge conv-sp would look free and dominate dp even
        # when the halo exceeds the per-shard extent
        if node.op_type == OpType.CONV2D and node.input_shapes:
            in_shape = node.input_shapes[0]
            in_spec = (st.input_specs[0] if st.input_specs
                       else (None,) * len(in_shape))
            for d, k_attr in ((2, "kernel_h"), (3, "kernel_w")):
                if d >= len(in_spec) or in_spec[d] is None:
                    continue
                deg = axes.get(in_spec[d], 1)
                halo = node.attrs.get(k_attr, 1) - 1
                if deg <= 1 or halo <= 0:
                    continue
                halo_shape = list(in_shape)
                halo_shape[d] = halo
                spec_wo = list(in_spec) + [None] * (len(in_shape)
                                                    - len(in_spec))
                spec_wo[d] = None
                hb = shard_bytes(tuple(halo_shape), node.dtype_bytes,
                                 tuple(spec_wo), axes)
                m.comm_time += 2.0 * self.machine.ppermute_time(hb)
        # sequence-sharded attention rings its K/V blocks around the seq
        # group (parallel/ring_attention.py): deg-1 neighbor rotations of
        # the LOCAL K and V blocks each step. Without this charge a
        # seq-sharded layout would look communication-free and always
        # dominate — the exact blow-up the conv halo charge prevents for
        # conv-sp. Unlike a TP psum (a dependency barrier after the op),
        # the rotations PIPELINE with the per-block attention compute
        # (Liu et al. blockwise ring), so only the part the compute
        # cannot hide is exposed.
        if node.op_type in ATTENTION_OPS and node.input_shapes:
            in_spec = (tuple(st.input_specs[0]) if st.input_specs
                       else (None,) * len(node.input_shapes[0]))
            seq_ax = in_spec[1] if len(in_spec) > 1 else None
            deg = axes.get(seq_ax, 1) if seq_ax is not None else 1
            if deg > 1:
                local = shard_bytes(node.input_shapes[0], node.dtype_bytes,
                                    in_spec, axes)
                ring = (deg - 1) * self.machine.ppermute_time(2.0 * local)
                m.comm_time += max(0.0, ring - fwd)
                if self.training:
                    # backward re-rings K/V plus their grads, hidden
                    # under the (2x) backward compute
                    m.comm_time += max(0.0, 2.0 * ring - m.backward_time)
        # gradient sync: a weight's grads must be allreduced over every
        # mesh axis the weight is REPLICATED over while the op's
        # activations are sharded over it — the data axis (classic DP
        # grad sync) and any activation-sharding axis the weight spec
        # does not carry (attr-dim dense, spatially-sharded convs: each
        # model shard computes a partial dL/dW over its activation
        # slice, so a full-weight allreduce over that axis is needed)
        if self.training and node.weight_shapes:
            act_axes = {a for spec in ((tuple(st.output_spec),)
                                       + tuple(st.input_specs))
                        for a in spec if a is not None}
            data_deg = axes.get("data", 1)
            for w, shape in node.weight_shapes.items():
                wspec = st.weight_specs.get(w, (None,) * len(shape))
                waxes = {a for a in wspec if a is not None}
                group = data_deg if data_deg > 1 else 1
                # partial_axes are psum'd on the FORWARD output, so the
                # incoming grads are replicated over them — a tp-row
                # bias's grads need only the data-axis sync
                for a in act_axes - waxes - {"data"} - set(st.partial_axes):
                    group *= axes.get(a, 1)
                if group > 1:
                    wb = shard_bytes(shape, node.dtype_bytes, wspec, axes)
                    m.sync_time += self.machine.all_reduce_time(wb, group)
        m.memory = self.node_memory(node, st)
        return m

    def node_memory(self, node: PCGNode, st: OpStrategy) -> float:
        axes = self._axes_for(st)
        mem = 0.0
        for w, shape in node.weight_shapes.items():
            wspec = st.weight_specs.get(w, (None,) * len(shape))
            wb = shard_bytes(shape, node.dtype_bytes, wspec, axes)
            mem += wb * (3.0 if self.training else 1.0)   # + grad + opt state
        for shape in node.output_shapes:
            mem += shard_bytes(shape, node.dtype_bytes, st.output_spec,
                               axes)
        return mem

    # ---- edge resharding -------------------------------------------------
    def reshard_time(self, shape: Tuple[int, ...], dtype_bytes: float,
                     src: Spec, dst: Spec) -> float:
        """Cost of moving a tensor from layout src to layout dst.

        The moves are all-gathers, slices and all-to-alls; we charge
        the standard lower bounds. src partial-ness is charged at the
        producer (node_compute_time), so here both are final layouts.
        """
        src = tuple(src) + (None,) * (len(shape) - len(src))
        dst = tuple(dst) + (None,) * (len(shape) - len(dst))
        if src == dst:
            return 0.0
        t = 0.0
        src_bytes = shard_bytes(shape, dtype_bytes, src, self.axes)
        gathered = list(src)
        # axes sharded at src but not at dst in the same dim: all-gather
        for d, a in enumerate(src):
            if a is not None and dst[d] != a:
                g = self.axes.get(a, 1)
                t += self.machine.all_gather_time(src_bytes, g)
                src_bytes *= g / 1.0 if g else 1.0
                gathered[d] = None
        # dims newly sharded at dst: local slice — free. Same axis moved
        # between dims would be an all-to-all; charge it when axis appears
        # in dst on a dim where src had it elsewhere.
        src_axes = {a for a in src if a}
        for d, a in enumerate(dst):
            if a is not None and src[d] != a and a in src_axes:
                t += self.machine.all_to_all_time(
                    shard_bytes(shape, dtype_bytes, dst, self.axes),
                    self.axes.get(a, 1))
        return t

    # ---- whole-graph simulation -----------------------------------------
    def simulate(self, pcg: PCG, strategy: Strategy) -> CostMetrics:
        if self.overlap:
            return self.simulate_overlap(pcg, strategy)
        return self.simulate_serial(pcg, strategy)

    def simulate_serial(self, pcg: PCG, strategy: Strategy) -> CostMetrics:
        """Legacy serial sum: every op and collective charged back-to-back.
        Systematically over-costs strategies whose collectives hide under
        compute — kept for comparison and as the overlap=False mode."""
        total = CostMetrics()
        for node in pcg.nodes:
            st = strategy.ops.get(node.name)
            if st is None:
                continue
            m = self.node_compute_time(node, st)
            total.forward_time += m.forward_time
            total.backward_time += m.backward_time
            total.comm_time += m.comm_time
            total.sync_time += m.sync_time
            total.memory += m.memory
            # edges: producer output spec → this node's expected input spec
            for k, src_idx in enumerate(node.in_edges):
                src_node = pcg.nodes[src_idx]
                src_st = strategy.ops.get(src_node.name)
                if src_st is None or k >= len(node.input_shapes):
                    continue
                want = (st.input_specs[k] if k < len(st.input_specs)
                        else None)
                if want is None:
                    continue
                total.comm_time += self.reshard_time(
                    node.input_shapes[k], src_node.dtype_bytes,
                    src_st.output_spec, want)
        return total

    def simulate_overlap(self, pcg: PCG, strategy: Strategy) -> CostMetrics:
        """Event-driven schedule over (compute, NVLink, network) resources,
        the counterpart of the reference's task-graph simulation
        (``Simulator::simulate_runtime``, src/runtime/simulator.cc:797).

        Three resource classes, each a greedy list-scheduled timeline:
        * compute — one timeline per device group. Branch-pinned ops
          (``OpStrategy.branch``, nonsequence splits) get per-branch
          timelines that run CONCURRENTLY; unpinned ops span all devices
          and act as a barrier across branch timelines.
        * ici — collectives whose group fits inside a node (NVLink).
        * dcn — collectives spanning nodes (InfiniBand).

        Forward tasks run in topo order (reshard tasks on the comm
        timeline feeding them); backward tasks in reverse topo order; each
        op's gradient allreduce is issued the moment its wgrad finishes
        and overlaps with earlier layers' backward compute — exactly the
        schedule a latency-hiding scheduler produces, and the reason
        a serial sum over-costs data parallelism."""
        total = CostMetrics()
        per_slice = (self.machine.devices_per_slice
                     or self.machine.num_devices)

        def comm_res(group: int) -> str:
            return "dcn" if group > per_slice else "ici"

        ALL = "__all__"
        comp_free: Dict[object, float] = {ALL: 0.0}
        comm_free: Dict[str, float] = {"ici": 0.0, "dcn": 0.0}

        def run_comp(branch, ready: float, dur: float) -> float:
            if branch is not None and not self.branch_concurrency:
                branch = None        # SPMD-executable: all devices run it
            if branch is None:
                start = max(ready, max(comp_free.values()))
                end = start + dur
                for k in comp_free:
                    comp_free[k] = end
            else:
                key = ("br",) + tuple(branch)
                start = max(ready, comp_free.get(key, comp_free[ALL]))
                end = start + dur
                comp_free[key] = end
            return end

        def run_comm(res: str, ready: float, dur: float) -> float:
            start = max(ready, comm_free[res])
            comm_free[res] = start + dur
            return comm_free[res]

        mcache: Dict[int, CostMetrics] = {}

        def metrics_of(node, st):
            if node.idx not in mcache:
                mcache[node.idx] = self.node_compute_time(node, st)
            return mcache[node.idx]

        out_ready: Dict[int, float] = {}
        # per-device memory: branch-pinned ops live on DISJOINT slices, so
        # a device holds the base (unpinned) footprint plus only ITS
        # branch-slice's ops — max over slices, not the sum
        base_mem = 0.0
        branch_mem: Dict[int, float] = {}
        # ---- forward ----
        for node in pcg.nodes:
            st = strategy.ops.get(node.name)
            if st is None:
                out_ready[node.idx] = 0.0
                continue
            m = metrics_of(node, st)
            if st.branch is None or not self.branch_concurrency:
                # SPMD-executable form: every device materializes every
                # branch, so branch memory is base memory
                base_mem += m.memory
            else:
                bi = st.branch[0]
                branch_mem[bi] = branch_mem.get(bi, 0.0) + m.memory
            ready = 0.0
            for k, src_idx in enumerate(node.in_edges):
                src_node = pcg.nodes[src_idx]
                src_st = strategy.ops.get(src_node.name)
                dep = out_ready.get(src_idx, 0.0)
                dur = 0.0
                want = None
                if src_st is not None and k < len(node.input_shapes):
                    want = (st.input_specs[k] if k < len(st.input_specs)
                            else None)
                    if want is not None:
                        dur = self.reshard_time(
                            node.input_shapes[k], src_node.dtype_bytes,
                            src_st.output_spec, want)
                if dur > 0:
                    # route by the widest axis group the transfer touches:
                    # cross-slice reshards belong on the DCN timeline
                    axes = self._axes_for(st)
                    g = max([axes.get(a, 1)
                             for a in tuple(src_st.output_spec) + tuple(want)
                             if a is not None], default=1)
                    dep = run_comm(comm_res(g), dep, dur)
                    total.comm_time += dur
                ready = max(ready, dep)
            end = run_comp(st.branch, ready, m.forward_time)
            total.forward_time += m.forward_time
            if m.comm_time > 0:          # psum of partial outputs
                axes = self._axes_for(st)
                group = max([axes.get(a, 1) for a in st.partial_axes],
                            default=1)
                end = run_comm(comm_res(group), end, m.comm_time)
                total.comm_time += m.comm_time
            out_ready[node.idx] = end
        makespan = max(out_ready.values(), default=0.0)

        if self.training:
            # ---- backward (reverse topo) ----
            sink_ready = makespan        # loss seeds grads after full fwd
            grad_ready: Dict[int, float] = {}
            for node in reversed(pcg.nodes):
                st = strategy.ops.get(node.name)
                if st is None:
                    continue
                m = metrics_of(node, st)
                ready = grad_ready.get(node.idx, sink_ready)
                end = run_comp(st.branch, ready, m.backward_time)
                total.backward_time += m.backward_time
                for src_idx in node.in_edges:
                    grad_ready[src_idx] = max(grad_ready.get(src_idx, 0.0),
                                              end)
                makespan = max(makespan, end)
                if m.sync_time > 0:      # grad allreduce, overlaps bwd
                    axes = self._axes_for(st)
                    g = axes.get("data", 1)
                    send = run_comm(comm_res(g), end, m.sync_time)
                    total.sync_time += m.sync_time
                    makespan = max(makespan, send)
        total.memory = base_mem + (max(branch_mem.values())
                                   if branch_mem else 0.0)
        total.makespan = max([makespan] + list(comm_free.values()))
        return total

    # ---- profiled refinement (measure_operator_cost equivalent) ---------
    def measure_node(self, node: PCGNode, st: OpStrategy) -> float:
        """The measured forward seconds of one shard of ``node`` under
        ``st``, cached by (op, shapes, sharding): reference
        Op::measure_operator_cost (e.g. linear.cc:1163) with the
        params-hash cache in simulator.cc.

        The port op's ``forward`` runs alone on ``self.device`` with zeros
        as inputs and parameters at the node's per-shard shapes, as the
        model runs it: parameters in the node's dtype, activations and the
        forward's arithmetic in ``self.compute_dtype`` (the model's
        ``compute_dtype``; the node's dtype when None): each
        input and weight cut by its spec over the op's axes (the split
        that ``node_compute_time``'s shard count describes; a row-parallel
        linear's contraction dim included), the op's attributes made the
        shard's. On the card it is timed with CUDA events after a warm-up,
        over enough repetitions to take about a millisecond, behind a
        ``torch.cuda.synchronize``; on the CPU with ``perf_counter``.
        Communication is not measured (the caller adds the analytic
        collectives). An op that cannot run alone is timed analytically:
        each such fallback is counted in ``profile_fallbacks`` and printed
        to stderr with its reason. ``profile_records`` keeps every key's
        measured and analytic seconds."""
        key = f"{node.op_type}:{node.input_shapes}:{st.key()}"
        if key in self._profile_cache:
            return self._profile_cache[key]
        analytic = self.node_compute_time(node, st).forward_time
        try:
            t = _time_shard(node, st, self._axes_for(st), self.device,
                            self.compute_dtype)
            reason = "" if t > 0.0 else f"non-positive time {t}"
        except Exception as err:          # an op that cannot run alone
            t, reason = 0.0, f"{type(err).__name__}: {err}"
        measured = t > 0.0
        if not measured:
            self.profile_fallbacks += 1
            print(f"measure_node: {node.name} ({node.op_type.name}, "
                  f"{st.name or 'unnamed'}) timed analytically: {reason}",
                  file=sys.stderr)
            t = analytic
        self.profile_records[key] = {
            "node": node.name, "op": node.op_type.name, "strategy": st.name,
            "measured_s": t if measured else None, "analytic_s": analytic}
        self._profile_cache[key] = t
        return t


def _local_shape(shape, spec, axes: Dict[str, int]) -> Tuple[int, ...]:
    """``shape`` cut by ``spec`` over ``axes`` (one shard's shape)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // axes.get(a, 1) if a is not None else d
                 for d, a in zip(shape, spec))


def _shard_attrs(node: PCGNode, params, out_shape) -> Dict:
    """``node.attrs`` made one shard's: the sizes an op reads from its
    attributes follow its cut weights and output."""
    attrs = dict(node.attrs)
    t = node.op_type
    if t == OpType.LINEAR and "kernel" in params:
        attrs["out_dim"] = params["kernel"].shape[1]
    elif t == OpType.EMBEDDING and "weight" in params:
        attrs["num_entries"], attrs["out_dim"] = params["weight"].shape
    elif t == OpType.MULTIHEAD_ATTENTION and "wq" in params:
        nh = attrs["num_heads"]
        kd = (attrs.get("kdim") or attrs["embed_dim"]) // nh
        vd = (attrs.get("vdim") or attrs["embed_dim"]) // nh
        heads = params["wq"].shape[1] // kd
        attrs.update(num_heads=heads, kdim=heads * kd, vdim=heads * vd)
    elif t == OpType.CONV2D and "kernel" in params:
        attrs["out_channels"] = params["kernel"].shape[0]
    elif t == OpType.EXPERTS and params:
        attrs["num_experts"] = next(iter(params.values())).shape[0]
    elif t in (OpType.RESHAPE, OpType.BROADCAST_TO):
        attrs["shape"] = tuple(out_shape)
    return attrs


def _time_shard(node: PCGNode, st: OpStrategy, axes: Dict[str, int],
                device, compute_dtype=None) -> float:
    """Seconds of one forward of ``node``'s shard under ``st`` (see
    ``CostModel.measure_node``)."""
    import time

    import torch

    from flexflow_tpu_torch.ffconst import torch_dtype
    from flexflow_tpu_torch.ops.base import OpContext, get_op_impl

    dev = torch.device(device if device is not None else "cpu")
    wdt = node.dtype.to_torch()
    cdt = torch_dtype(compute_dtype) if compute_dtype is not None else wdt
    impl = get_op_impl(node.op_type)
    specs = tuple(st.input_specs) + ((),) * len(node.input_shapes)
    ins = []
    for i, shape in enumerate(node.input_shapes):
        local = _local_shape(shape, specs[i], axes)
        index = node.op_type == OpType.EMBEDDING and i == 0
        ins.append(torch.zeros(local, device=dev,
                               dtype=torch.long if index else cdt))
    params = {w: torch.zeros(_local_shape(s, st.weight_specs.get(w, ()),
                                          axes), device=dev, dtype=wdt)
              for w, s in node.weight_shapes.items()}
    if node.op_type == OpType.MULTIHEAD_ATTENTION:
        # head-parallel: a shard's biases are its heads' (the op's own
        # split, which the executed form takes too)
        for b, w in (("bq", "wq"), ("bk", "wk"), ("bv", "wv")):
            if b in params and params[b].shape[0] != params[w].shape[1]:
                params[b] = torch.zeros(params[w].shape[1], device=dev,
                                        dtype=wdt)
    out_shape = (_local_shape(node.output_shapes[0], st.output_spec, axes)
                 if node.output_shapes else ())
    attrs = _shard_attrs(node, params, out_shape)
    ctx = OpContext(training=False, compute_dtype=cdt, device=dev)
    cuda = dev.type == "cuda"

    def fence():
        if cuda:
            torch.cuda.synchronize(dev)

    with torch.no_grad():
        for _ in range(3):                      # warm-up
            impl.forward(attrs, params, ins, ctx)
        fence()
        t0 = time.perf_counter()
        impl.forward(attrs, params, ins, ctx)
        fence()
        once = time.perf_counter() - t0
        reps = int(min(200, max(5, 1e-3 / max(once, 1e-6))))
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                impl.forward(attrs, params, ins, ctx)
            end.record()
            torch.cuda.synchronize(dev)
            return start.elapsed_time(end) * 1e-3 / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            impl.forward(attrs, params, ins, ctx)
        return (time.perf_counter() - t0) / reps
