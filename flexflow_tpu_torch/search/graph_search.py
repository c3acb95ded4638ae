"""The Unity search: joint choice of per-op sharding over the PCG
(counterpart of ``flexflow_tpu/search/graph_search.py``; the search logic is
the JAX package's line for line, so the same graph under the same machine
model gives the same strategy).

Mirrors the reference's search architecture (reference src/runtime/graph.cc
Graph::graph_optimize_task:2107, SearchHelper DP graph.h:170-196,
FFModel::mcmc_optimize model.cc:3791):

* **sequence split**: the PCG is cut at post-dominator bottlenecks
  (`PCG.bottleneck_nodes`), and each segment is optimized independently —
  exactly `find_optimal_sequence_graph_time`, with the simplification that
  resharding at the cut is costed on the edge rather than enumerated as a
  (source view, sink view) pair (the executor reshards anywhere, so the DP
  doesn't need to pin boundary layouts).
* **within a segment**: beam search over per-node candidate configs in topo
  order (the reference enumerates MachineViews per node inside its DP leaves);
  elementwise nodes inherit their producer's layout and add no branching.
* **MCMC refinement**: Metropolis over (node, config) rewrites on the full
  graph — the MLSys'19 search, used as a polish pass and as the fallback for
  graphs with no bottleneck structure.
* **memory-aware λ**: if the best strategy oversubscribes HBM, re-search with
  cost = time + λ·memory, growing λ geometrically until it fits (reference
  graph.cc:2126-2192 binary-searches λ the same way).

Under a process group of several ranks, rank 0 searches and broadcasts its
strategy, so every rank executes the same one (``optimize_model``).
"""

from __future__ import annotations

import math
import random
import time
from typing import Dict, List, Optional, Tuple

import torch

from flexflow_tpu_torch.search.cost_model import CostModel, CostMetrics
from flexflow_tpu_torch.search.machine_model import GPU_CHIPS, MachineModel
from flexflow_tpu_torch.search.pcg import ELEMENTWISE_OPS, PCG, PCGNode
from flexflow_tpu_torch.search.strategy import OpStrategy, Strategy, replicated


class UnitySearch:
    def __init__(self, pcg: PCG, cost_model: CostModel,
                 axis_degrees: Dict[str, int], beam_width: int = 32,
                 budget: int = -1, alpha: float = 1.2,
                 mem_lambda: float = 0.0, rules=None,
                 enable_substitutions: bool = True,
                 enable_nonsequence: bool = True,
                 deadline_s: Optional[float] = None):
        self.pcg = pcg
        self.cm = cost_model
        self.axes = dict(axis_degrees)
        self.beam_width = beam_width
        # budget = graph candidates the joint loop may evaluate; alpha = the
        # tolerance for exploring slightly-worse rewrites (reference
        # GraphSearchHelper::base_optimize, substitution.cc:2245)
        self.budget = budget if budget > 0 else 64
        self.alpha = alpha
        # hard wall-clock bound on optimize(): with the full JSON rule
        # vocabulary as the default, budget alone does not bound the match
        # loop on large graphs — the deadline does (None = unbounded)
        self.deadline_s = deadline_s
        # nonsequence-split trials are full per-branch DPs + simulations;
        # they share the joint budget (ADVICE.md: ungated unequal-split
        # enumeration multiplied search time on large data axes)
        self._nsq_trials = 0
        self.mem_lambda = mem_lambda
        self.enable_substitutions = enable_substitutions
        # sequence-only ablation switch: skip nonsequence (branch) splits
        # entirely (reference SplitType, include/flexflow/graph.h:156)
        self.enable_nonsequence = enable_nonsequence
        self.rules = rules
        # graph the winning strategy is keyed on (== pcg unless a
        # substitution won)
        self.best_graph: PCG = pcg
        # (analytic cost, graph, strategy) of every graph the joint loop
        # evaluated, best first — the pool the profiled re-rank draws from
        self.top_candidates: List[Tuple[float, PCG, Strategy]] = []

    # ------------------------------------------------------------------
    def _node_candidates(self, node: PCGNode,
                         chosen: Dict[int, OpStrategy]) -> List[OpStrategy]:
        """Candidates for `node` given already-chosen producers. Elementwise/
        shape ops follow their first producer's layout (zero-cost inheritance,
        like the reference propagating parallel dims through these ops)."""
        if node.op_type in ELEMENTWISE_OPS and node.in_edges:
            src = chosen.get(node.in_edges[0])
            if src is not None:
                out_nd = (len(node.output_shapes[0])
                          if node.output_shapes else 0)
                spec = tuple(src.output_spec[:out_nd]) + (None,) * max(
                    0, out_nd - len(src.output_spec))
                return [OpStrategy(
                    input_specs=tuple(spec[:len(s)] + (None,) * max(
                        0, len(s) - len(spec)) for s in node.input_shapes),
                    output_spec=spec,
                    weight_specs={w: replicated(len(s))
                                  for w, s in node.weight_shapes.items()},
                    name="follow")]
        return node.candidates(self.axes)

    def _score(self, m: CostMetrics) -> float:
        return m.total + self.mem_lambda * m.memory

    # ------------------------------------------------------------------
    def _candidate_delta(self, node: PCGNode, cand: OpStrategy,
                         chosen: Dict[int, OpStrategy]) -> float:
        """Incremental score of appending (node, cand) to a partial
        assignment: the node's own cost plus resharding on its in-edges
        (all producers are already chosen — topo order)."""
        m = self.cm.node_compute_time(node, cand)
        t = m.total + self.mem_lambda * m.memory
        for k, src_idx in enumerate(node.in_edges):
            src_st = chosen.get(src_idx)
            if src_st is None or k >= len(node.input_shapes):
                continue
            want = cand.input_specs[k] if k < len(cand.input_specs) else None
            if want is None:
                continue
            t += self.cm.reshard_time(
                node.input_shapes[k], self.pcg.nodes[src_idx].dtype_bytes,
                src_st.output_spec, want)
        return t

    def _optimize_segment(self, nodes: List[PCGNode],
                          boundary: Dict[int, OpStrategy]
                          ) -> Dict[int, OpStrategy]:
        """Beam search over one segment, scores carried incrementally (one
        _candidate_delta per candidate, not a full-prefix re-simulation).
        `boundary` carries configs of nodes outside the segment feeding it."""
        beams: List[Tuple[float, Dict[int, OpStrategy]]] = [(0.0, dict(boundary))]
        for node in nodes:
            nxt: List[Tuple[float, Dict[int, OpStrategy]]] = []
            for score, chosen in beams:
                for cand in self._node_candidates(node, chosen):
                    c2 = dict(chosen)
                    c2[node.idx] = cand
                    nxt.append((score + self._candidate_delta(
                        node, cand, chosen), c2))
            nxt.sort(key=lambda x: x[0])
            beams = nxt[: self.beam_width]
        best = beams[0][1]
        return {i: s for i, s in best.items() if i not in boundary}

    def optimize_graph(self, pcg: PCG) -> Strategy:
        """DP over one fixed graph: sequence-split at bottlenecks, beam
        within each segment (the inner `Graph::optimal_cost` of the joint
        search)."""
        splits = set(pcg.bottleneck_nodes())
        segments: List[List[PCGNode]] = []
        cur: List[PCGNode] = []
        for node in pcg.nodes:
            cur.append(node)
            if node.idx in splits:
                segments.append(cur)
                cur = []
        if cur:
            segments.append(cur)

        outer_pcg = self.pcg
        self.pcg = pcg            # _candidate_delta reads producer nodes
        try:
            chosen: Dict[int, OpStrategy] = {}
            for seg in segments:
                boundary = {i: chosen[i] for n in seg for i in n.in_edges
                            if i in chosen}
                chosen.update(self._optimize_segment(seg, boundary))
        finally:
            self.pcg = outer_pcg

        strategy = Strategy(ops={pcg.nodes[i].name: s
                                 for i, s in chosen.items()})
        metrics = self.cm.simulate(pcg, strategy)
        strategy.cost = metrics.total
        strategy.peak_memory = metrics.memory
        # The segment DP commits to each segment's locally-best boundary
        # layout, so a strategy that only pays off globally (pure data
        # parallelism when model-axis collectives cross a slow DCN
        # boundary) can be walked past. Always score the canonical DP
        # baseline (the reference's get_basic_data_parallel_config,
        # model.h:303) and keep the cheaper of the two.
        dp = self._dp_baseline(pcg)
        if dp is not None and dp.cost + self.mem_lambda * dp.peak_memory < \
                strategy.cost + self.mem_lambda * strategy.peak_memory:
            strategy = dp
        if not self.enable_nonsequence:
            return strategy
        return self._try_nonsequence_splits(pcg, strategy)

    def _branch_trial(self, pcg: PCG, base: Strategy, branches,
                      allocs, axis: str) -> Strategy:
        """Build one nonsequence-split trial: branch ``bi`` re-optimized
        under ``axis`` scaled to ``allocs[bi]`` devices and tagged."""
        import dataclasses as _dc

        nb = len(branches)
        total = self.axes.get(axis, 1)
        trial = Strategy(ops=dict(base.ops))
        saved_cm, saved_axes, saved_pcg = self.cm, self.axes, self.pcg
        try:
            for bi, comp in enumerate(branches):
                scaled = dict(saved_axes)
                scaled[axis] = allocs[bi]
                self.cm = CostModel(
                    saved_cm.machine, scaled, training=saved_cm.training,
                    overlap=saved_cm.overlap,
                    branch_concurrency=saved_cm.branch_concurrency)
                self.axes = scaled
                self.pcg = pcg           # _candidate_delta reads producers
                chosen = self._optimize_segment(
                    [pcg.nodes[i] for i in comp], boundary={})
                equal = all(a == total // nb for a in allocs)
                for i, st in chosen.items():
                    trial.ops[pcg.nodes[i].name] = _dc.replace(
                        st, branch=(bi, nb), branch_axis=axis,
                        branch_alloc=(None if equal
                                      else (allocs[bi], total)))
        finally:
            self.cm, self.axes, self.pcg = saved_cm, saved_axes, saved_pcg
        return trial

    def _try_nonsequence_splits(self, pcg: PCG,
                                strategy: Strategy) -> Strategy:
        """Nonsequence splits (reference NonsequenceSplit, graph.h:156;
        find_optimal_nonsequence_graph_time graph.h:181-196): for every
        fork-join region whose branches are independent, try pinning each
        branch to a DISJOINT slice of a mesh axis. Candidate forms:

        * equal slices of the data axis (nb-way, any branch count);
        * equal slices of the MODEL or EXPERT axis (branch pinning is not
          data-only — a branch can own a tensor/expert-parallel group);
        * for 2-branch regions, UNEQUAL i-vs-(n-i) device partitions of
          the data axis — the reference's VERTICAL(i) (node units) and
          HORIZONTAL(i) (within-node units) params, graph.cc:220-244;
          slice-aligned counts are the vertical form, others horizontal.

        Branch ops are re-optimized under the scaled axes and tagged with
        ``OpStrategy.branch`` (+``branch_alloc``/``branch_axis``); the
        overlap simulator runs branch timelines concurrently (under
        ``branch_concurrency=True`` — the executable default serializes
        them, see CostModel). A split is kept only when the simulated
        step time improves."""
        fork_joins = pcg.fork_joins()
        if not fork_joins:
            return strategy
        best = strategy
        m = self.cm.simulate(pcg, best)
        best_score = m.total + self.mem_lambda * m.memory
        for (f, j, branches) in fork_joins:
            nb = len(branches)
            if nb < 2:
                continue
            trials = []
            for axis in ("data", "model", "expert"):
                deg = self.axes.get(axis, 1)
                if deg >= 2 and deg % nb == 0:
                    trials.append(([deg // nb] * nb, axis))
            d = self.axes.get("data", 1)
            if nb == 2 and d >= 2:
                # unequal vertical/horizontal params (i, d - i), capped per
                # ADVICE.md: only power-of-two and slice-aligned device
                # counts — the reference's VERTICAL (node-unit) splits are
                # slice-aligned and its HORIZONTAL ones power-of-two, and
                # the full range made a d=256 axis cost hundreds of
                # branch DPs per fork-join
                per_slice = self.cm.machine.devices_per_slice or 0
                counts = set()
                i = 1
                while i < d:
                    counts.update((i, d - i))
                    i *= 2
                if per_slice and d % per_slice == 0:
                    counts.update(range(per_slice, d, per_slice))
                for i in sorted(counts):
                    if 0 < i < d and i != d - i:   # equal case covered above
                        trials.append(([i, d - i], "data"))
            for allocs, axis in trials:
                # each trial is a full per-branch DP + simulation: charge
                # it against the joint budget so fork-join-rich graphs
                # stay bounded
                if self._nsq_trials >= self.budget:
                    return best
                self._nsq_trials += 1
                trial = self._branch_trial(pcg, best, branches, allocs,
                                           axis)
                mt = self.cm.simulate(pcg, trial)
                score = mt.total + self.mem_lambda * mt.memory
                if score < best_score:
                    trial.cost = mt.total
                    trial.peak_memory = mt.memory
                    best, best_score = trial, score
        return best

    def _dp_baseline(self, pcg: PCG) -> Optional[Strategy]:
        """Batch dim on 'data' everywhere, weights replicated — scored
        under this search's cost model (None if the graph's batch dims
        don't divide the data axis)."""
        from flexflow_tpu_torch.search.strategy import data_parallel_strategy

        deg = self.axes.get("data", 1)
        specs = []
        for n in pcg.nodes:
            out_nd = len(n.output_shapes[0]) if n.output_shapes else 0
            if (out_nd and n.output_shapes[0]
                    and n.output_shapes[0][0] % max(deg, 1) != 0):
                return None
            specs.append((n.name, out_nd,
                          {w: len(s) for w, s in n.weight_shapes.items()}))
        dp = data_parallel_strategy(specs)
        # input specs follow the producers (batch-sharded everywhere)
        for n in pcg.nodes:
            st = dp.ops[n.name]
            st.input_specs = tuple(
                (("data",) + (None,) * (len(s) - 1)) if len(s) else ()
                for s in n.input_shapes)
        m = self.cm.simulate(pcg, dp)
        dp.cost = m.total
        dp.peak_memory = m.memory
        return dp

    def optimize(self) -> Strategy:
        """Joint substitution + parallelization search (reference
        GraphSearchHelper::graph_optimize → base_optimize best-first over
        GraphXfers, substitution.cc:1914/2245): pop the cheapest candidate
        graph, try every rewrite, keep children within ``alpha`` of the
        best, stop after ``budget`` DP evaluations. The winning graph is
        left in ``self.best_graph`` (its nodes' ``covers`` map the strategy
        back onto original layer names)."""
        import heapq

        t0 = time.monotonic()

        def expired() -> bool:
            return (self.deadline_s is not None
                    and time.monotonic() - t0 > self.deadline_s)

        best_s = self.optimize_graph(self.pcg)
        self.best_graph = self.pcg
        self.top_candidates = [(best_s.cost, self.pcg, best_s)]
        if not self.enable_substitutions:
            return best_s
        from flexflow_tpu_torch.search.substitution import GraphXfer, builtin_rules

        rules = self.rules if self.rules is not None else builtin_rules()
        xfers = [GraphXfer(r) for r in rules]
        # Pre-filter the vocabulary: a rule whose src pattern names an op
        # type no reachable graph can contain never matches, and with the
        # full JSON rule set as the default most of the 600+ rules fall
        # here. Fixpoint over dst-introduced types so a rule enabled only
        # by another rule's rewrite still survives the filter.
        types = {n.op_type for n in self.pcg.nodes}
        remaining, active = list(xfers), []
        changed = True
        while changed:
            changed = False
            still = []
            for x in remaining:
                if x.src_types <= types:
                    active.append(x)
                    if not x.dst_types <= types:
                        types |= x.dst_types
                        changed = True
                else:
                    still.append(x)
            remaining = still
        xfers = active
        counter = 0
        heap = [(best_s.cost, counter, self.pcg)]
        seen = {_graph_signature(self.pcg)}
        evals = 1
        while heap and evals < self.budget and not expired():
            cost, _, g = heapq.heappop(heap)
            if cost > self.alpha * best_s.cost:
                break                 # heap-ordered: the rest are worse
            for xfer in xfers:
                if expired():
                    break
                for m in xfer.find_matches(g):
                    g2 = xfer.apply(g, m)
                    if g2 is None:
                        continue
                    sig = _graph_signature(g2)
                    if sig in seen:
                        continue
                    seen.add(sig)
                    s2 = self.optimize_graph(g2)
                    evals += 1
                    self.top_candidates.append((s2.cost, g2, s2))
                    if s2.cost < best_s.cost:
                        best_s = s2
                        self.best_graph = g2
                    if s2.cost <= self.alpha * best_s.cost:
                        counter += 1
                        heapq.heappush(heap, (s2.cost, counter, g2))
                    if evals >= self.budget or expired():
                        break
                if evals >= self.budget:
                    break
        return best_s


def _graph_signature(pcg: PCG):
    """Structural hash for the joint search's dedup of rewritten graphs.
    Includes attrs so parameter-only rewrites (e.g. two fusions differing
    only in fused_activation) stay distinct candidates."""
    return hash(tuple(
        (n.op_type, tuple(n.covered_names), tuple(n.in_edges),
         tuple(sorted((k, repr(v)) for k, v in n.attrs.items())))
        for n in pcg.nodes))


def profile_rerank(candidates: List[Tuple[float, PCG, Strategy]],
                   cm: CostModel, topk: int = 4
                   ) -> Tuple[PCG, Strategy]:
    """Re-rank the analytically-best strategies by MEASURED per-op time
    (``CostModel.measure_node`` runs and times each distinct (op, shapes,
    sharding) leaf on the model's device, cached by key — the reference's
    ``Op::measure_operator_cost`` + simulator.cc cache). Communication stays
    analytic: collectives can't be measured in isolation on one host.

    The cache bounds total time: a transformer's repeated layer blocks all
    hit the same (op, shapes, sharding) keys, so k candidates cost only a
    handful of timings."""
    scored = []
    for cost, g, s in sorted(candidates, key=lambda c: c[0])[:topk]:
        t = 0.0
        for node in g.nodes:
            st = s.ops.get(node.name)
            if st is None:
                continue
            t += cm.measure_node(node, st)
            m = cm.node_compute_time(node, st)
            t += m.comm_time + m.sync_time
        scored.append((t, g, s))
    _, g, s = min(scored, key=lambda x: x[0])
    return g, s


def expand_strategy(graph: PCG, strategy: Strategy) -> Strategy:
    """Map a strategy keyed on (possibly rewritten) PCG node names back onto
    the original layer names via each node's ``covers`` provenance, so
    compile() can look up every real layer."""
    ops: Dict[str, OpStrategy] = {}
    for n in graph.nodes:
        st = strategy.ops.get(n.name)
        if st is None:
            continue
        for cname in n.covered_names:
            ops[cname] = st
    return Strategy(ops=ops, cost=strategy.cost,
                    peak_memory=strategy.peak_memory)


def mcmc_optimize(pcg: PCG, cost_model: CostModel,
                  axis_degrees: Dict[str, int], start: Strategy,
                  budget: int = 200, temperature: float = 0.25,
                  seed: int = 0,
                  memory_bound: Optional[float] = None) -> Strategy:
    """Metropolis refinement (reference FFModel::mcmc_optimize model.cc:3791:
    random op → random ParallelConfig, accept by simulated-runtime rule).
    Moves that would exceed `memory_bound` per-device bytes are rejected, so
    refinement cannot undo the memory-aware λ search that produced `start`."""
    rng = random.Random(seed)
    search = UnitySearch(pcg, cost_model, axis_degrees)
    current = Strategy(ops=dict(start.ops))
    cur_m = cost_model.simulate(pcg, current)
    cur_cost = cur_m.total
    best = Strategy(ops=dict(current.ops), cost=cur_cost,
                    peak_memory=cur_m.memory)
    idx_by_name = {n.name: n for n in pcg.nodes}
    names = [n.name for n in pcg.nodes if n.name in current.ops]
    if not names:
        return best
    for it in range(budget):
        name = rng.choice(names)
        node = idx_by_name[name]
        chosen_by_idx = {idx_by_name[k].idx: v for k, v in current.ops.items()}
        cands = search._node_candidates(node, chosen_by_idx)
        if len(cands) <= 1:
            continue
        cand = rng.choice(cands)
        trial = Strategy(ops=dict(current.ops))
        trial.ops[name] = cand
        m = cost_model.simulate(pcg, trial)
        if memory_bound is not None and m.memory > memory_bound:
            continue
        delta = m.total - cur_cost
        if delta <= 0 or rng.random() < math.exp(
                -delta / max(temperature * cur_cost, 1e-12)):
            current, cur_cost = trial, m.total
            if m.total < best.cost:
                best = Strategy(ops=dict(trial.ops), cost=m.total,
                                peak_memory=m.memory)
    return best


def _machine_for(config, chip: str, n: int) -> MachineModel:
    """Machine model with the config's multi-node geometry: num_nodes
    splits the devices into slices (mesh-axis groups larger than a slice
    pay DCN, optionally through a routed dcn_topology's bottleneck)."""
    per_slice = (n // config.num_nodes
                 if config.num_nodes and config.num_nodes > 1 else None)
    per_node = GPU_CHIPS[chip].devices_per_node
    if per_slice is None and per_node and n > per_node:
        per_slice = per_node          # e.g. 16 H100s are two HGX nodes
    dcn_model = None
    if config.dcn_topology is not None:
        from flexflow_tpu_torch.search.network import NetworkedMachineModel

        dcn_model = NetworkedMachineModel(config.dcn_topology)
    return MachineModel.from_name(chip, n, devices_per_slice=per_slice,
                                  dcn_model=dcn_model)


def optimize_model(model, chip: str = "cpu-sim",
                   num_devices: Optional[int] = None,
                   training: bool = True,
                   mcmc_budget: Optional[int] = None,
                   enable_nonsequence: bool = True,
                   search_mesh: Optional[bool] = None) -> Strategy:
    """``_search_model`` on rank 0 of the process group, its strategy
    broadcast to the other ranks (as JSON), so that every rank executes
    the same one whatever its own search deadline would have cut; a single
    process searches alone. ``config.export_strategy_file`` receives the
    strategy's JSON (rank 0 writes it)."""
    import torch.distributed as dist

    many = dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1
    first = not many or dist.get_rank() == 0
    strategy = None
    if first:
        strategy = _search_model(model, chip, num_devices, training,
                                 mcmc_budget, enable_nonsequence,
                                 search_mesh)
    if many:
        box = [strategy.to_json() if first else None]
        dist.broadcast_object_list(box, src=0)
        if not first:
            strategy = Strategy.from_json(box[0])
    if first and model.config.export_strategy_file:
        strategy.save(model.config.export_strategy_file)
    return strategy


def _search_model(model, chip: str, num_devices: Optional[int],
                  training: bool, mcmc_budget: Optional[int],
                  enable_nonsequence: bool,
                  search_mesh: Optional[bool]) -> Strategy:
    """Entry point — reference FFModel::graph_optimize via
    GRAPH_OPTIMIZE_TASK (model.cc:3327). Reads parallelism axes from the
    model's config, builds PCG + cost model, runs DP+beam then MCMC, and
    re-searches with growing memory λ if HBM oversubscribes.

    ``search_mesh`` (default ``config.search_mesh``): also search the
    MESH FACTORIZATION — every (data x model) split of the device count
    is searched and the cheapest strategy wins, with its winning axes
    recorded in ``Strategy.axis_degrees`` for compile to adopt. The
    reference's search covers this dimension through MachineView degrees
    (graph.cc:2107); with a fixed factorization the search cannot e.g.
    prefer pure DP over the user's dp x tp mesh even when DP is cheaper
    (the JAX package measured it on BERT-tiny on its virtual mesh: the
    dp4 x tp2 hybrid lost to dp8 by wall clock, PARITY.md round 5)."""
    config = model.config
    n = num_devices if num_devices is not None else config.resolve_num_devices()
    machine = _machine_for(config, chip, n)
    cfg_axes = {"data": config.data_parallelism_degree,
                "model": config.tensor_parallelism_degree,
                "expert": config.expert_parallelism_degree,
                "seq": config.sequence_parallelism_degree}
    if config.only_data_parallel:
        cfg_axes["model"] = 1
        cfg_axes["expert"] = 1
        cfg_axes["seq"] = 1
    pcg = PCG.from_model(model)
    budget = config.search_budget
    # Substitution vocabulary: an explicit JSON path wins; otherwise the
    # PACKAGED full rule file (reference graph_subst_3_v2.json schema) is
    # the default — budget/alpha pruning, the per-search deadline, and
    # optimize()'s reachable-op-type pre-filter keep the 600+ rules
    # wall-clock-bounded. use_json_rules=False reverts to the 5 builtins.
    rules = None
    if config.substitution_json_path:
        from flexflow_tpu_torch.search.substitution import (
            builtin_rules, load_rules_json)

        rules = builtin_rules() + load_rules_json(
            config.substitution_json_path)
    elif getattr(config, "use_json_rules", True):
        from flexflow_tpu_torch.search.substitution import (
            builtin_rules, default_rules)

        rules = builtin_rules() + default_rules()
    deadline = (config.search_deadline_s
                if getattr(config, "search_deadline_s", 0) > 0 else None)
    # profiled re-rank (reference measure_operator_cost): default on when
    # the model lives on the card, off on the CPU
    profile = config.search_profile
    if profile is None:
        profile = torch.device(model.device).type == "cuda"

    def search_under(axes: Dict[str, int]) -> Strategy:
        cm = CostModel(machine, axes, training=training,
                       device=model.device,
                       compute_dtype=config.compute_dtype)
        lam = 0.0
        strategy = None
        graph = pcg
        cand_graphs = None
        # one analytic model for every λ attempt: its memo of node costs
        # carries across them (each attempt re-scores the same graphs)
        cm_l = CostModel(machine, axes, training=training)
        for _attempt in range(6):
            search = UnitySearch(
                pcg, cm_l, axes, budget=budget,
                alpha=config.search_alpha, mem_lambda=lam, rules=rules,
                enable_substitutions=config.enable_substitutions,
                enable_nonsequence=enable_nonsequence,
                deadline_s=deadline)
            if cand_graphs is None:
                # first attempt: full joint rewrite discovery
                strategy = search.optimize()
                graph = search.best_graph
                # keep only the best few graphs for λ retries: each retry
                # runs a full DP per graph, so re-scoring the whole
                # discovered pool would multiply search cost ~budget×
                # exactly when memory pressure already makes compile slow
                cand_graphs = [g for _, g, _ in sorted(
                    search.top_candidates, key=lambda c: c[0])[:8]]
            else:
                # λ retries: the rewrite pool is λ-independent — only
                # re-score the discovered graphs under the new pressure
                scored = []
                for g in cand_graphs:
                    s = search.optimize_graph(g)
                    scored.append((s.cost + lam * s.peak_memory, g, s))
                scored.sort(key=lambda c: c[0])
                _, graph, strategy = scored[0]
                search.best_graph = graph
                search.top_candidates = [(s.cost, g, s)
                                         for _, g, s in scored]
            if strategy.peak_memory <= machine.memory_per_device() \
                    or lam > 1e6:
                break
            lam = max(lam * 8, 1e-9)  # grow λ until the strategy fits HBM
        candidates = list(search.top_candidates)
        n_mcmc = mcmc_budget if mcmc_budget is not None else (
            budget if budget > 0 else 100)
        strategy = mcmc_optimize(graph, cm, axes, strategy, budget=n_mcmc,
                                 seed=config.seed,
                                 memory_bound=machine.memory_per_device())
        candidates.append((strategy.cost, graph, strategy))
        if profile:
            # never let the re-rank resurrect a strategy the λ search
            # rejected for oversubscribing HBM
            fit = [c for c in candidates
                   if c[2].peak_memory <= machine.memory_per_device()]
            graph, strategy = profile_rerank(fit or candidates, cm)
        # a substitution may have won: expand fused nodes' strategies back
        # onto the original layer names compile() looks up
        strategy = expand_strategy(graph, strategy)
        strategy.axis_degrees = dict(axes)
        return strategy

    do_mesh = (config.search_mesh if search_mesh is None else search_mesh)
    factorizations = [cfg_axes]
    if do_mesh and cfg_axes["expert"] <= 1 and not config.only_data_parallel:
        for d in range(1, n + 1):
            if n % d != 0:
                continue
            # each divisor pairs the remaining devices with either the
            # SEQUENCE axis or the tensor-parallel axis — the
            # factorization the long-context (batch starves DP) regime
            # needs. seq first: on a cost tie the adopted mesh then
            # carries a real "seq" axis, which is what the executing
            # attention path keys ring attention off
            # (ops/attention.py mha_forward, serve decode/prefill).
            for extra in ("seq", "model"):
                cand = {"data": d, "model": 1, "expert": 1, "seq": 1}
                cand[extra] = n // d
                if cand not in factorizations:
                    factorizations.append(cand)
    searched = [search_under(a) for a in factorizations]
    # never adopt a factorization whose λ search gave up over HBM when a
    # fitting one exists (the single-factorization path's "never
    # resurrect an HBM-rejected strategy" guard, applied across meshes)
    fits = [s for s in searched
            if s.peak_memory <= machine.memory_per_device()]
    strategy = min(fits or searched, key=lambda s: s.cost)
    if strategy.axis_degrees == cfg_axes:
        strategy.axis_degrees = None     # nothing for compile to adopt
    return strategy


def data_parallel_model_strategy(model, chip: str = "cpu-sim",
                                 num_devices: Optional[int] = None,
                                 training: bool = True) -> Optional[Strategy]:
    """The canonical pure-DP strategy for ``model``, scored (not searched)
    under the analytic cost model — the reference's
    get_basic_data_parallel_config (model.h:303), exposed so a measured
    searched-vs-DP A/B can compile BOTH placements through the same
    runtime (search/measure.py)."""
    config = model.config
    n = num_devices if num_devices is not None else \
        config.resolve_num_devices()
    machine = _machine_for(config, chip, n)   # same geometry as the search
    # canonical DP = batch over ALL devices, model/expert/seq axes unused
    axes = {"data": n, "model": 1, "expert": 1, "seq": 1}
    pcg = PCG.from_model(model)
    search = UnitySearch(pcg, CostModel(machine, axes, training=training),
                         axes, enable_substitutions=False,
                         enable_nonsequence=False)
    dp = search._dp_baseline(pcg)
    return expand_strategy(pcg, dp) if dp is not None else None
