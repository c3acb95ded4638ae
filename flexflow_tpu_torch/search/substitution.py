"""Graph substitutions: algebraic rewrites of the PCG (counterpart of
``flexflow_tpu/search/substitution.py``).

Role-equivalent of the reference's ``GraphXfer`` engine (reference
src/runtime/substitution.cc: find_matches:519, run:605, create_new_graph:791)
and its JSON rule loader (substitution_loader.h:174 ``Rule``; rule file
``substitutions/graph_subst_3_v2.json``). Differences by design:

* *Parallelization* rewrites (partition/combine/replicate insertion, the
  bulk of the reference's hand-coded xfers, substitution.cc:70-117) are
  not graph rewrites here: they are sharding choices already enumerated by
  ``PCGNode.candidates``. What remains for the substitution engine is the
  *algebraic* family: fusing/reassociating ops so the cost model sees the
  cheaper form.
* The JSON loader accepts the reference rule schema (srcOp/dstOp/mappedOutput
  with ``PM_*`` parameters) so existing rule files can be dropped in; rules
  whose op types we don't implement are skipped, and OP_PARTITION/OP_COMBINE/
  OP_REPLICATE/OP_REDUCE patterns are interpreted as sharding-equivalences
  (validated, then discarded as no-ops for the cost model).

The packaged rule file (``substitutions/graph_subst_default.json``) is a
copy of the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Optional, Tuple

from flexflow_tpu_torch.ffconst import OpType
from flexflow_tpu_torch.search.pcg import PCG, PCGNode

# Reference OperatorType names (substitution JSON) → our OpType
_JSON_OP_TYPES = {
    "OP_LINEAR": OpType.LINEAR,
    "OP_CONV2D": OpType.CONV2D,
    "OP_EW_ADD": OpType.EW_ADD,
    "OP_EW_MUL": OpType.EW_MUL,
    "OP_RELU": OpType.RELU,
    "OP_SIGMOID": OpType.SIGMOID,
    "OP_TANH": OpType.TANH,
    "OP_CONCAT": OpType.CONCAT,
    "OP_SPLIT": OpType.SPLIT,
    "OP_RESHAPE": OpType.RESHAPE,
    "OP_TRANSPOSE": OpType.TRANSPOSE,
    "OP_SOFTMAX": OpType.SOFTMAX,
    "OP_BATCHMATMUL": OpType.BATCH_MATMUL,
    "OP_DROPOUT": OpType.DROPOUT,
    "OP_EMBEDDING": OpType.EMBEDDING,
    "OP_MULTIHEAD_ATTENTION": OpType.MULTIHEAD_ATTENTION,
}
_PARALLEL_OP_TYPES = {
    "OP_PARTITION": OpType.REPARTITION,
    "OP_COMBINE": OpType.COMBINE,
    "OP_REPLICATE": OpType.REPLICATE,
    "OP_REDUCE": OpType.REDUCTION,
}


@dataclasses.dataclass
class OpX:
    """Pattern node (reference substitution.h OpX): an op type + symbolic
    input tensor slots. Slot = (op_idx_in_pattern | -1 for external, ts_id)."""

    op_type: Optional[OpType]            # None = wildcard
    inputs: List[Tuple[int, int]]
    params: Dict[str, int] = dataclasses.field(default_factory=dict)
    # attrs keys that must be ABSENT (or falsy) on a matched graph node —
    # e.g. a fusion rule must not re-match an already-fused op, which would
    # silently drop an activation pass from the searched graph
    forbid: Tuple[str, ...] = ()


@dataclasses.dataclass
class Rule:
    name: str
    src: List[OpX]
    dst: List[OpX]
    # (dst_op_idx, dst_ts, src_op_idx, src_ts) — which dst output replaces
    # which src output for consumers outside the match
    mapped_outputs: List[Tuple[int, int, int, int]]


def _attr_present(v) -> bool:
    """True if an attr value represents a real setting (AC_MODE_NONE and
    other *_NONE enum members count as absent)."""
    if v is None or v == 0 or v == "" or v is False:
        return False
    name = getattr(v, "name", None)
    if isinstance(name, str) and name.endswith("NONE"):
        return False
    return True


_ELEMENTWISE_DST = {OpType.RELU, OpType.SIGMOID, OpType.TANH,
                    OpType.EW_ADD, OpType.EW_MUL, OpType.SOFTMAX,
                    OpType.DROPOUT}


def _infer_output_shapes(node) -> Optional[List[Tuple[int, ...]]]:
    """Output shapes of a materialized dst node from its wired inputs;
    None = keep the proto's shapes (unknown op form)."""
    ins = node.input_shapes
    if not ins:
        return None
    t = node.op_type
    if t in _ELEMENTWISE_DST:
        if len(ins) >= 2 and len(ins[0]) == len(ins[1]):
            # numpy-style broadcast: per-dim max (dims of 1 broadcast)
            return [tuple(max(a, b) for a, b in zip(ins[0], ins[1]))]
        return [tuple(ins[0])]
    if t == OpType.CONCAT:
        ax = node.attrs.get("axis", 1) % max(len(ins[0]), 1)
        if any(len(s) != len(ins[0]) for s in ins):
            return None
        out = list(ins[0])
        out[ax] = sum(s[ax] for s in ins)
        return [tuple(out)]
    if t == OpType.LINEAR and "out_dim" in node.attrs:
        return [tuple(ins[0][:-1]) + (node.attrs["out_dim"],)]
    return None


import itertools as _it

# synthetic tensor ids for unmapped dst outputs: strictly decreasing so
# no two apply() calls ever mint the same id
_SYNTH_TIDS = _it.count(-1_000_000, -1)


def _slot_srcs(node) -> List[Optional[int]]:
    """Per-slot producer node idxs. PCGNode.in_edges dedupes repeated
    producers and drops graph-input slots, so slot-aligned matching must
    use input_srcs; hand-built test nodes without slot info fall back to
    the positional in_edges view."""
    if len(node.input_srcs) == len(node.input_shapes):
        return node.input_srcs
    return list(node.in_edges) + [None] * (len(node.input_shapes)
                                           - len(node.in_edges))


def _slot_tids(node) -> List[Optional[int]]:
    if len(node.input_tids) == len(node.input_shapes):
        return node.input_tids
    return [None] * len(node.input_shapes)


class GraphXfer:
    """Match a Rule's src pattern in a PCG and produce the rewritten graph."""

    def __init__(self, rule: Rule):
        self.rule = rule

    @property
    def src_types(self) -> set:
        """Op types the src pattern requires — the joint search pre-filters
        rules whose src types no reachable graph contains."""
        return {x.op_type for x in self.rule.src if x.op_type is not None}

    @property
    def dst_types(self) -> set:
        return {x.op_type for x in self.rule.dst if x.op_type is not None}

    def find_matches(self, pcg: PCG) -> List[Dict[int, int]]:
        """All mappings pattern-op-idx → graph-node-idx. Backtracking over
        topo order, wildcard-free (reference find_matches substitution.cc:519
        does the same with Legion node iterators)."""
        matches: List[Dict[int, int]] = []
        pat = self.rule.src

        def backtrack(pi: int, binding: Dict[int, int],
                      ext_bind: Dict[Tuple[int, int], int]):
            if pi == len(pat):
                matches.append(dict(binding))
                return
            px = pat[pi]
            for node in pcg.nodes:
                if node.idx in binding.values():
                    continue
                if px.op_type is not None and node.op_type != px.op_type:
                    continue
                if any(_attr_present(node.attrs.get(k)) for k in px.forbid):
                    continue
                srcs = _slot_srcs(node)
                tids = _slot_tids(node)
                if px.inputs and len(px.inputs) != len(srcs):
                    continue               # arity must match the pattern
                # inputs must line up with already-bound pattern
                # producers; a REUSED external (same negative opId in two
                # slots — reference same-TensorX semantics) must bind the
                # same concrete tensor everywhere
                ok = True
                added: List[Tuple[int, int]] = []
                for slot, (src_op, ts) in enumerate(px.inputs):
                    if src_op < 0:
                        key = (src_op, ts)
                        tid = tids[slot]
                        if key in ext_bind:
                            if tid is None or ext_bind[key] != tid:
                                ok = False
                                break
                        elif tid is not None:
                            ext_bind[key] = tid
                            added.append(key)
                        continue
                    bound = binding.get(src_op)
                    if bound is None or srcs[slot] != bound:
                        ok = False
                        break
                if ok:
                    binding[pi] = node.idx
                    backtrack(pi + 1, binding, ext_bind)
                    del binding[pi]
                for key in added:
                    ext_bind.pop(key, None)

        backtrack(0, {}, {})
        return matches

    def apply(self, pcg: PCG, match: Dict[int, int]) -> Optional[PCG]:
        """Build the rewritten graph (reference create_new_graph:791).
        Returns None if the rewrite would orphan a consumed tensor."""
        import copy

        matched = set(match.values())
        src_nodes = [pcg.nodes[match[pi]] for pi in range(len(self.rule.src))]
        # External pattern tensors (reference TensorX), identified by the
        # (negative opId, tsId) PAIR — the reference's JSON rules number
        # distinct externals -1, -2, ... each with tsId 0, so keying by
        # ts id alone would collide them. Value: producing graph node
        # (None = a graph input) and tensor shape.
        ext_producer: Dict[Tuple[int, int], Optional[int]] = {}
        ext_shape: Dict[Tuple[int, int], Tuple[int, ...]] = {}
        ext_tid: Dict[Tuple[int, int], Optional[int]] = {}
        for pi, px in enumerate(self.rule.src):
            g = pcg.nodes[match[pi]]
            srcs = _slot_srcs(g)
            tids = _slot_tids(g)
            for slot, (src_op, ts) in enumerate(px.inputs):
                if src_op >= 0:
                    continue
                key = (src_op, ts)
                prod = srcs[slot] if slot < len(srcs) else None
                tid = tids[slot] if slot < len(tids) else None
                # a reused external must bind ONE concrete tensor: tensor
                # identity, not just producer (two distinct graph inputs
                # both have producer None)
                if key in ext_tid and (tid is None or ext_tid[key] != tid):
                    return None          # inconsistent external binding
                ext_producer[key] = prod
                ext_tid[key] = tid
                if slot < len(g.input_shapes):
                    ext_shape[key] = g.input_shapes[slot]

        new_nodes: List[PCGNode] = []
        remap: Dict[int, int] = {}
        for node in pcg.nodes:
            if node.idx in matched:
                continue
            n2 = copy.deepcopy(node)
            remap[node.idx] = len(new_nodes)
            n2.idx = len(new_nodes)
            new_nodes.append(n2)
        # Materialize dst pattern ops. Output shape/dtype come from the src
        # op whose output this dst op replaces; for single-dst (fusion)
        # rules the node also absorbs every matched op's weights and attrs,
        # and `covers` unions their provenance so the final strategy can be
        # expanded back onto the original layers.
        single_dst = len(self.rule.dst) == 1
        dst_graph_idx: Dict[int, int] = {}
        for di, dx in enumerate(self.rule.dst):
            proto = None
            for (dop, dts, sop, sts) in self.rule.mapped_outputs:
                if dop == di:
                    proto = pcg.nodes[match[sop]]
                    break
            if proto is None and dx.op_type is not None:
                # inherit semantic attrs (axis, out_dim, ...) from a
                # matched src op of the SAME type — JSON rules carry dims
                # in the reference's reversed order, so the matched
                # node's attrs are the trustworthy source. The inheritance
                # must be UNIQUE: with two same-type src ops (e.g. a TASO
                # linear-merge rule) picking either would cost the
                # rewritten node on the wrong out_dim/weights, and a dst
                # type absent from src has no faithful proto at all —
                # refuse such rewrites rather than fire them with phantom
                # attrs/weight shapes.
                same = [s for s in src_nodes if s.op_type == dx.op_type]
                if len(same) != 1:
                    return None
                proto = same[0]
            if proto is None:
                return None
            n2 = copy.deepcopy(proto)
            n2.idx = len(new_nodes)
            n2.name = f"{proto.name}__xfer{di}"
            if dx.op_type is not None:
                n2.op_type = dx.op_type
            if single_dst:
                weights: Dict[str, Tuple[int, ...]] = {}
                attrs: Dict = {}
                covers: List[str] = []
                for s in src_nodes:
                    for w, shape in s.weight_shapes.items():
                        if w in weights:
                            return None      # ambiguous fused weight name
                        weights[w] = shape
                    attrs.update(s.attrs)
                    covers.extend(s.covered_names)
                n2.weight_shapes = weights
                n2.attrs = attrs
                n2.covers = covers
            else:
                n2.covers = list(proto.covered_names)
            n2.attrs = dict(n2.attrs)
            n2.attrs.update(dx.params)
            # input shapes/slots follow the dst wiring, resolved below
            n2.input_shapes = []
            n2.in_edges = []
            n2.out_edges = []
            n2.input_srcs = []
            n2.input_tids = []
            # output tensor ids: a mapped output INHERITS the replaced
            # src output's tid, so surviving consumers' per-slot tids
            # stay valid in the rewritten graph; unmapped outputs get
            # fresh synthetic ids from a global countdown (per-apply
            # indices would collide across successive rewrites of the
            # same graph and falsely unify distinct tensors)
            n2.output_tids = [next(_SYNTH_TIDS)
                              for _ in range(max(len(n2.output_shapes), 1))]
            for (dop, dts, sop, sts) in self.rule.mapped_outputs:
                if dop == di and dts < len(n2.output_tids):
                    src_t = pcg.nodes[match[sop]].output_tids
                    if sts < len(src_t):
                        n2.output_tids[dts] = src_t[sts]
            dst_graph_idx[di] = n2.idx
            new_nodes.append(n2)
        # Wire dst inputs (externals by (opId, tsId); graph inputs carry
        # no edge), then infer each dst node's output shapes from its
        # wired inputs — a materialized node (e.g. a new CONCAT) must not
        # keep its proto's shapes or the rewritten graph would be costed
        # on phantom sizes. dst ops are listed producers-first in both
        # the builtin and reference rule formats.
        for di, dx in enumerate(self.rule.dst):
            n2 = new_nodes[dst_graph_idx[di]]
            for slot, (src_op, ts) in enumerate(dx.inputs):
                if src_op < 0:
                    key = (src_op, ts)
                    if key in ext_shape:
                        n2.input_shapes.append(ext_shape[key])
                    n2.input_tids.append(ext_tid.get(key))
                    prod = ext_producer.get(key)
                    if prod is None:
                        n2.input_srcs.append(None)
                        continue             # a graph input: no edge
                    src_graph = remap.get(prod)
                    if src_graph is None:
                        return None          # external produced inside match
                else:
                    src_graph = dst_graph_idx.get(src_op)
                    if src_graph is None:
                        return None
                    src_out = new_nodes[src_graph].output_shapes
                    if ts < len(src_out):
                        n2.input_shapes.append(src_out[ts])
                    src_t = new_nodes[src_graph].output_tids
                    n2.input_tids.append(src_t[ts] if ts < len(src_t)
                                         else None)
                n2.input_srcs.append(src_graph)
                if src_graph not in n2.in_edges:
                    n2.in_edges.append(src_graph)
                    new_nodes[src_graph].out_edges.append(n2.idx)
            inferred = _infer_output_shapes(n2)
            if inferred is not None:
                n2.output_shapes = inferred
        # multi-dst provenance completeness: every matched src layer must
        # appear in SOME dst node's covers, or expand_strategy would emit
        # no OpStrategy for its real layer and compile would fall back to
        # a sharding the winning cost estimate never modeled
        if not single_dst:
            covered = {nm for d in dst_graph_idx.values()
                       for nm in new_nodes[d].covered_names}
            missing = [nm for s in src_nodes for nm in s.covered_names
                       if nm not in covered]
            if missing:
                primary = (dst_graph_idx[self.rule.mapped_outputs[0][0]]
                           if self.rule.mapped_outputs
                           else next(iter(dst_graph_idx.values())))
                pn = new_nodes[primary]
                pn.covers = list(pn.covered_names) + missing
        # Re-route surviving nodes' inputs: unmatched producers keep their
        # remapped index; matched producers must be mapped outputs → dst op.
        replace: Dict[int, int] = {}
        for (dop, dts, sop, sts) in self.rule.mapped_outputs:
            replace[match[sop]] = dst_graph_idx[dop]
        dst_idx_set = set(dst_graph_idx.values())
        for n2 in new_nodes:
            if n2.idx in dst_idx_set:
                continue                   # wired above
            edges = []
            for old in n2.in_edges:
                if old in remap:
                    edges.append(remap[old])
                elif old in replace:
                    edges.append(replace[old])
                else:
                    return None            # consumed a non-mapped matched output
            n2.in_edges = edges
            slots = []
            for old in n2.input_srcs:
                if old is None:
                    slots.append(None)
                elif old in remap:
                    slots.append(remap[old])
                elif old in replace:
                    slots.append(replace[old])
                else:
                    return None
            n2.input_srcs = slots
        # rebuild out_edges
        for n2 in new_nodes:
            n2.out_edges = []
        for n2 in new_nodes:
            for e in n2.in_edges:
                new_nodes[e].out_edges.append(n2.idx)
        # Renumber into topological order: dst nodes were appended after the
        # survivors, but PCG consumers (bottleneck_nodes, the beam's
        # producers-first walk) require build order == topo order.
        indeg = [len(n.in_edges) for n in new_nodes]
        ready = [i for i, d in enumerate(indeg) if d == 0]
        order: List[int] = []
        while ready:
            i = ready.pop(0)
            order.append(i)
            for j in new_nodes[i].out_edges:
                indeg[j] -= 1
                if indeg[j] == 0:
                    ready.append(j)
        if len(order) != len(new_nodes):
            return None                    # rewrite introduced a cycle
        pos = {old: new for new, old in enumerate(order)}
        sorted_nodes = [new_nodes[i] for i in order]
        for n2 in sorted_nodes:
            n2.idx = pos[n2.idx]
            n2.in_edges = [pos[e] for e in n2.in_edges]
            n2.out_edges = [pos[e] for e in n2.out_edges]
            n2.input_srcs = [pos[e] if e is not None else None
                             for e in n2.input_srcs]
        return PCG(sorted_nodes)


# ---------------------------------------------------------------------------
# Built-in algebraic rules
# ---------------------------------------------------------------------------
def builtin_rules() -> List[Rule]:
    """The algebraic core the search benefits from. (The reference
    ships 600+ TASO-generated rules; most are parallelization forms that the
    candidate enumeration already covers. These are the fusion-shaped ones.)"""
    rules = []
    # linear → activation  ⇒  fused linear(act): the cost model sees one op
    # and stops paying the activation's memory-roofline pass (the Linear
    # op applies its activation in its forward; the rewrite lets the
    # search reason about it).
    no_act = ("fused_activation", "activation")
    for act_op, act in ((OpType.RELU, "relu"), (OpType.GELU, "gelu"),
                        (OpType.SIGMOID, "sigmoid"), (OpType.TANH, "tanh")):
        rules.append(Rule(
            name=f"fuse_linear_{act}",
            src=[OpX(OpType.LINEAR, [(-1, 0)], forbid=no_act),
                 OpX(act_op, [(0, 0)])],
            dst=[OpX(OpType.LINEAR, [(-1, 0)],
                     params={"fused_activation": act})],
            mapped_outputs=[(0, 0, 1, 0)]))
    # conv → relu  ⇒  fused conv(relu) (reference fuse_conv_relu family)
    rules.append(Rule(
        name="fuse_conv_relu",
        src=[OpX(OpType.CONV2D, [(-1, 0)], forbid=no_act),
             OpX(OpType.RELU, [(0, 0)])],
        dst=[OpX(OpType.CONV2D, [(-1, 0)],
                 params={"fused_activation": "relu"})],
        mapped_outputs=[(0, 0, 1, 0)]))
    return rules


def load_rules_json(path: str, include_parallel: bool = False) -> List[Rule]:
    """Load reference-format substitution rules (graph_subst_3_v2.json;
    schema per src/runtime/substitution_loader.cc).

    Algebraic rules (the TASO fusion/reassociation core) load always.
    With ``include_parallel=True`` the parallel-op rules (OP_PARTITION /
    OP_COMBINE / OP_REPLICATE / OP_REDUCE chains — the reference's
    mechanism for exploring parallelization as graph rewrites) ALSO load,
    mapped onto this framework's parallel op types; they can only match
    graphs that contain explicit parallel-op nodes (the builder's
    repartition/combine/replicate/reduction verbs) — spec-based PCGs
    never do, since sharding specs subsume their role (see module
    docstring). Default off to keep the joint search's match loop tight.

    ``PM_*`` parameters are NOT copied onto dst attrs: the reference
    encodes dims in its reversed Legion order, so dst nodes inherit
    semantic attrs (axis, out_dim, ...) from the matched same-op-type
    src node instead (GraphXfer.apply proto selection)."""
    with open(path) as f:
        raw = json.load(f)
    known = dict(_JSON_OP_TYPES)
    if include_parallel:
        known.update(_PARALLEL_OP_TYPES)
    out: List[Rule] = []
    for r in raw.get("rule", []):
        ops = {o["type"] for o in r.get("srcOp", []) + r.get("dstOp", [])}
        if not ops <= set(known):
            continue                       # unimplemented op type

        def conv(olist) -> List[OpX]:
            res = []
            for o in olist:
                res.append(OpX(
                    op_type=known[o["type"]],
                    inputs=[(t["opId"], t["tsId"])
                            for t in o.get("input", [])]))
            return res

        out.append(Rule(
            name=r.get("name", "json_rule"),
            src=conv(r.get("srcOp", [])),
            dst=conv(r.get("dstOp", [])),
            mapped_outputs=[(m["dstOpId"], m["dstTsId"], m["srcOpId"],
                             m["srcTsId"]) for m in r.get("mappedOutput", [])],
        ))
    return out


_DEFAULT_RULES_CACHE: Optional[List[Rule]] = None


def default_rules_path() -> str:
    """The packaged full-vocabulary rule file (reference
    graph_subst_3_v2.json schema, regenerated by
    tools/gen_default_rules.py)."""
    import os

    return os.path.join(os.path.dirname(__file__), "substitutions",
                        "graph_subst_default.json")


def default_rules() -> List[Rule]:
    """The default substitution vocabulary for ``optimize_model``: the
    packaged JSON rule set, parsed once per process. Missing/corrupt file
    degrades to the empty list (the caller still has builtin_rules())."""
    global _DEFAULT_RULES_CACHE
    if _DEFAULT_RULES_CACHE is None:
        try:
            _DEFAULT_RULES_CACHE = load_rules_json(default_rules_path())
        except (OSError, ValueError, KeyError):
            _DEFAULT_RULES_CACHE = []
    return _DEFAULT_RULES_CACHE


def apply_substitutions(pcg: PCG, rules: Optional[List[Rule]] = None,
                        cost_fn: Optional[Callable[[PCG], float]] = None,
                        max_rounds: int = 2) -> PCG:
    """Greedy improvement loop (a bounded version of the reference's
    best-first `base_optimize`, substitution.cc:2245): apply any rule whose
    rewrite lowers cost_fn; stop when no rule improves or rounds exhausted."""
    rules = rules if rules is not None else builtin_rules()
    if cost_fn is None:
        def cost_fn(g: PCG) -> float:
            return sum(n.flops() for n in g.nodes)
    best = pcg
    best_cost = cost_fn(pcg)
    for _ in range(max_rounds):
        improved = False
        for rule in rules:
            xfer = GraphXfer(rule)
            for match in xfer.find_matches(best):
                cand = xfer.apply(best, match)
                if cand is None:
                    continue
                c = cost_fn(cand)
                if c < best_cost:
                    best, best_cost = cand, c
                    improved = True
                    break
            if improved:
                break
        if not improved:
            break
    return best
