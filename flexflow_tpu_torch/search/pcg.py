"""Parallel Computation Graph: the search's IR (counterpart of
``flexflow_tpu/search/pcg.py``).

Role-equivalent of the reference's ``Graph`` over ``Node``/``Edge`` (reference
src/runtime/graph.cc, include/flexflow/graph.h:293). Nodes wrap the frontend
``Layer`` list of the port's ``FFModel``; edges carry tensor shapes. Each node
knows its compute/memory footprint (for the roofline cost model) and can
enumerate its candidate parallelization configs, the counterpart of the
reference's ``Op::get_valid_machine_views``. Names, shapes, edges and
candidates equal the JAX package's for the same graph.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

from flexflow_tpu_torch.ffconst import DataType, OpType
from flexflow_tpu_torch.search.strategy import OpStrategy, Spec, replicated

DTYPE_BYTES = {
    DataType.DT_BOOLEAN: 1, DataType.DT_INT32: 4, DataType.DT_INT64: 8,
    DataType.DT_HALF: 2, DataType.DT_BFLOAT16: 2, DataType.DT_FLOAT: 4,
    DataType.DT_DOUBLE: 8, DataType.DT_INT4: 0.5, DataType.DT_INT8: 1,
}

ATTENTION_OPS = (
    OpType.MULTIHEAD_ATTENTION,
    OpType.INC_MULTIHEAD_SELF_ATTENTION,
    OpType.SPEC_INC_MULTIHEAD_SELF_ATTENTION,
    OpType.TREE_INC_MULTIHEAD_SELF_ATTENTION,
)

# Ops that admit sequence-dim (dim 1) sharding: attention rings its K/V
# blocks (parallel/ring_attention.py), batch_matmul's M rows are
# independent, and the norms reduce over the hidden dim only — so all of
# them compute shard-locally once dim 1 is split. LINEAR and EMBEDDING
# join so a pure data×seq mesh is viable END-TO-END (their dim-1 tokens
# are independent; weights replicated): without them the long-context
# factorization would leave every projection replicated and never win.
SEQ_SHARD_OPS = set(ATTENTION_OPS) | {
    OpType.BATCH_MATMUL, OpType.LAYERNORM, OpType.RMS_NORM,
    OpType.LINEAR, OpType.EMBEDDING,
}

# Ops whose output follows their (first) input elementwise — they inherit
# the producer's sharding at zero cost and add no decision of their own.
ELEMENTWISE_OPS = {
    OpType.EW_ADD, OpType.EW_SUB, OpType.EW_MUL, OpType.EW_DIV,
    OpType.EW_MAX, OpType.EW_MIN, OpType.RELU, OpType.IDENTITY,
    OpType.SIGMOID, OpType.TANH, OpType.ELU, OpType.GELU, OpType.EXP,
    OpType.SIN, OpType.COS, OpType.RSQRT, OpType.POW,
    OpType.SCALAR_MULTIPLY, OpType.SCALAR_ADD, OpType.SCALAR_SUB,
    OpType.SCALAR_TRUE_DIV, OpType.DROPOUT, OpType.CAST, OpType.SOFTMAX,
    OpType.LAYERNORM, OpType.RMS_NORM, OpType.BATCHNORM,
    OpType.SIGMOID_SILU_MULTI,
}


@dataclasses.dataclass
class PCGNode:
    idx: int
    name: str
    op_type: OpType
    input_shapes: List[Tuple[int, ...]]
    output_shapes: List[Tuple[int, ...]]
    weight_shapes: Dict[str, Tuple[int, ...]]
    dtype: DataType
    attrs: Dict = dataclasses.field(default_factory=dict)
    in_edges: List[int] = dataclasses.field(default_factory=list)   # node idxs
    out_edges: List[int] = dataclasses.field(default_factory=list)
    # per-INPUT-SLOT producer node idx (None = a graph input) and tensor
    # id — in_edges dedupes and drops graph-input slots, so slot-aligned
    # pattern matching (substitution.py) must read these instead
    input_srcs: List[Optional[int]] = dataclasses.field(default_factory=list)
    input_tids: List[int] = dataclasses.field(default_factory=list)
    output_tids: List[int] = dataclasses.field(default_factory=list)
    # Original layer names this node stands for. A substitution that fuses
    # k ops into one node unions their covers, so the searched strategy can
    # be expanded back onto the model's real layers after the joint search.
    covers: Optional[List[str]] = None

    @property
    def covered_names(self) -> List[str]:
        return self.covers if self.covers is not None else [self.name]

    # ---- footprint -------------------------------------------------------
    @property
    def dtype_bytes(self) -> float:
        return DTYPE_BYTES.get(self.dtype, 4)

    def out_elems(self) -> float:
        return float(sum(math.prod(s) if s else 1
                         for s in self.output_shapes))

    def weight_elems(self) -> float:
        return float(sum(math.prod(s) for s in self.weight_shapes.values()))

    def flops(self) -> float:
        """Forward flops (backward modeled as 2x in the cost model)."""
        t = self.op_type
        if t == OpType.LINEAR:
            out = self.output_shapes[0]
            in_dim = self.input_shapes[0][-1]
            return 2.0 * math.prod(out) * in_dim
        if t == OpType.CONV2D:
            out = self.output_shapes[0]            # NCHW
            kh, kw = self.attrs.get("kernel_h", 1), self.attrs.get("kernel_w", 1)
            cin = self.input_shapes[0][1]
            return 2.0 * math.prod(out) * cin * kh * kw
        if t == OpType.BATCH_MATMUL:
            a, b = self.input_shapes[0], self.input_shapes[1]
            return 2.0 * math.prod(a) * b[-1]
        if t in (OpType.MULTIHEAD_ATTENTION,
                 OpType.INC_MULTIHEAD_SELF_ATTENTION,
                 OpType.SPEC_INC_MULTIHEAD_SELF_ATTENTION,
                 OpType.TREE_INC_MULTIHEAD_SELF_ATTENTION):
            x = self.input_shapes[0]               # [B, S, H]
            b_, s, h = x[0], x[1], x[-1]
            proj = 4 * 2.0 * b_ * s * h * h        # qkv + out projections
            attn = 2 * 2.0 * b_ * s * s * h        # qk^T + av
            return proj + attn
        if t == OpType.EMBEDDING:
            return self.out_elems()                # a gather, not a gemm
        if t == OpType.EXPERTS:
            hidden = self.attrs.get("experts_internal_dim_size", 0)
            n_exp = self.attrs.get("num_experts", 1)
            tok = math.prod(self.input_shapes[0][:-1])
            in_dim = self.input_shapes[0][-1]
            return 2.0 * tok * in_dim * hidden * 2 / max(n_exp, 1)
        # elementwise / shape / norm ops: ~1 flop per output element
        return self.out_elems()

    def io_bytes(self) -> float:
        ins = sum(math.prod(s) if s else 1 for s in self.input_shapes)
        return (float(ins) + self.out_elems()
                + self.weight_elems()) * self.dtype_bytes

    # ---- candidate configs ----------------------------------------------
    def candidates(self, axis_degrees: Dict[str, int]) -> List[OpStrategy]:
        """Enumerate parallelization configs over the available mesh axes.

        Replaces Op::get_valid_machine_views + the hand-coded parallel
        substitutions (reference substitution.cc:70-117: partition_linear_
        combine, replicate_linear_combine, partition_attention_combine, ...).
        Axis names: "data" (batch), "model" (tensor parallel). Degrees of 1
        mean the axis doesn't exist — only the replicated config remains.
        """
        data = "data" if axis_degrees.get("data", 1) > 1 else None
        model = "model" if axis_degrees.get("model", 1) > 1 else None
        # sequence axis: a dedicated "seq" mesh axis when present, else
        # ring over the TP group (the reference mesh only factors so many
        # ways; sequence sharding over 'model' is still a valid layout)
        seq = "seq" if axis_degrees.get("seq", 1) > 1 else model
        out_nd = len(self.output_shapes[0]) if self.output_shapes else 0
        in_specs = tuple(replicated(len(s)) for s in self.input_shapes)
        cands: List[OpStrategy] = [OpStrategy(
            input_specs=in_specs, output_spec=replicated(out_nd),
            weight_specs={w: replicated(len(s))
                          for w, s in self.weight_shapes.items()},
            name="replicate")]

        def batch_spec(nd: int, axis) -> Spec:
            if nd == 0 or axis is None:
                return replicated(nd)
            return tuple([axis] + [None] * (nd - 1))

        def add(strategy: OpStrategy):
            # batch dim must divide the data degree, sharded dims the axis
            cands.append(strategy)

        if data is not None and out_nd >= 1 and self.input_shapes:
            # data parallel: batch dim of every activation on "data"
            add(OpStrategy(
                input_specs=tuple(batch_spec(len(s), data)
                                  for s in self.input_shapes),
                output_spec=batch_spec(out_nd, data),
                weight_specs={w: replicated(len(s))
                              for w, s in self.weight_shapes.items()},
                name="dp"))

        t = self.op_type
        if model is not None:
            if t == OpType.LINEAR and "kernel" in self.weight_shapes:
                add_linear_candidates(self, cands, data, model)
            elif t in (OpType.MULTIHEAD_ATTENTION,
                       OpType.INC_MULTIHEAD_SELF_ATTENTION,
                       OpType.SPEC_INC_MULTIHEAD_SELF_ATTENTION,
                       OpType.TREE_INC_MULTIHEAD_SELF_ATTENTION):
                add_attention_candidates(self, cands, data, model)
            elif t == OpType.EMBEDDING and self.weight_shapes:
                add_embedding_candidates(self, cands, data, model)
            elif t == OpType.CONV2D and "kernel" in self.weight_shapes:
                add_conv_candidates(self, cands, data, model)
            elif t == OpType.EXPERTS:
                add_expert_candidates(self, cands, data, model,
                                      axis_degrees)
        if seq is not None and t in SEQ_SHARD_OPS:
            # sequence-dim sharding + the data×sequence composite view
            add_seq_candidates(self, cands, data, seq)
        # validity filter: a sharded dim must DIVIDE its axis degree —
        # the executor refuses any other spec at compile
        # (parallel/placement.py), so a non-dividing candidate would be
        # costed for a program that never runs
        def _divides(spec, shape):
            return all(ax is None or (dim % axis_degrees.get(ax, 1) == 0)
                       for dim, ax in zip(shape, tuple(spec)))

        def _valid(c: OpStrategy) -> bool:
            if self.output_shapes and not _divides(c.output_spec,
                                                   self.output_shapes[0]):
                return False
            for spec, shape in zip(c.input_specs, self.input_shapes):
                if not _divides(spec, shape):
                    return False
            for w, shape in self.weight_shapes.items():
                if w in c.weight_specs and not _divides(c.weight_specs[w],
                                                        shape):
                    return False
            return True

        # cands[0] is the all-None replicate strategy, which _divides
        # trivially, so the filtered list is never empty — the invariant
        # "everything returned divides its axes" holds unconditionally
        return [c for c in cands if _valid(c)]


def _batch(nd: int, axis) -> Spec:
    if nd == 0 or axis is None:
        return (None,) * nd
    return tuple([axis] + [None] * (nd - 1))


def add_linear_candidates(node: PCGNode, cands: List[OpStrategy],
                          data: Optional[str], model: str):
    """Megatron column/row parallel linear, with and without batch DP.
    Reference equivalents: create_partition_linear_combine /
    create_replicate_linear_combine (substitution.cc:86/80)."""
    out_nd = len(node.output_shapes[0])
    has_bias = "bias" in node.weight_shapes
    for dax in ({None, data} if data else {None}):
        ins = tuple(_batch(len(s), dax) for s in node.input_shapes)
        # column parallel: weight [in, out] sharded on out; output last dim
        col_out = list(_batch(out_nd, dax))
        col_out[-1] = model
        cands.append(OpStrategy(
            input_specs=ins, output_spec=tuple(col_out),
            weight_specs={"kernel": (None, model),
                          **({"bias": (model,)} if has_bias else {})},
            name=f"tp-col{'+dp' if dax else ''}"))
        # row parallel: input last dim sharded, weight sharded on in,
        # output partial over model (psum)
        row_ins = []
        for s in node.input_shapes:
            spec = list(_batch(len(s), dax))
            spec[-1] = model
            row_ins.append(tuple(spec))
        cands.append(OpStrategy(
            input_specs=tuple(row_ins), output_spec=_batch(out_nd, dax),
            weight_specs={"kernel": (model, None),
                          **({"bias": (None,)} if has_bias else {})},
            partial_axes=(model,),
            name=f"tp-row{'+dp' if dax else ''}"))
        # attribute-dim parallelism — the A of SOAP for dense layers
        # (reference enable_attribute_parallel, config.h:148-150): an
        # INTERIOR activation dim (DLRM/XDL feature fields, sequence)
        # sharded over 'model'; the gemm stays shard-local with weights
        # replicated, so only edge resharding is paid.
        if out_nd >= 3 and node.input_shapes \
                and len(node.input_shapes[0]) >= 3:
            at_out = list(_batch(out_nd, dax))
            at_out[1] = model
            at_ins = []
            for s in node.input_shapes:
                spec = list(_batch(len(s), dax))
                if len(s) >= 3:
                    spec[1] = model
                at_ins.append(tuple(spec))
            cands.append(OpStrategy(
                input_specs=tuple(at_ins), output_spec=tuple(at_out),
                weight_specs={"kernel": (None, None),
                              **({"bias": (None,)} if has_bias else {})},
                name=f"attr-dim{'+dp' if dax else ''}"))


def add_attention_candidates(node: PCGNode, cands: List[OpStrategy],
                             data: Optional[str], model: str):
    """Head-parallel attention (reference create_partition_attention_combine,
    substitution.cc:99). Weights are per-projection [hidden, hidden]-ish;
    head parallelism shards the projection output dims, output proj input dim,
    making the block's output partial over `model`."""
    heads = node.attrs.get("num_heads", node.attrs.get("embed_dim", 0))
    out_nd = len(node.output_shapes[0])
    for dax in ({None, data} if data else {None}):
        ins = tuple(_batch(len(s), dax) for s in node.input_shapes)
        wspecs = {}
        for w, s in node.weight_shapes.items():
            nd = len(s)
            if w in ("wq", "wk", "wv", "w_qkv"):
                wspecs[w] = tuple([None] * (nd - 1) + [model])
            elif w in ("wo", "w_out"):
                wspecs[w] = tuple([model] + [None] * (nd - 1))
            else:
                wspecs[w] = (None,) * nd
        cands.append(OpStrategy(
            input_specs=ins, output_spec=_batch(out_nd, dax),
            weight_specs=wspecs, partial_axes=(model,),
            name=f"tp-heads{'+dp' if dax else ''}"))


def add_seq_candidates(node: PCGNode, cands: List[OpStrategy],
                       data: Optional[str], seq: str):
    """Sequence-dim parallelism — the missing attribute-dim family for the
    long-context regime where batch=1 starves pure DP. Dim 1 (sequence /
    batch_matmul M rows) is sharded over ``seq``; weights stay replicated
    and there are no partial axes. Attention pays the K/V ring rotation
    (parallel/ring_attention.py), charged by the cost model; batch_matmul
    and layer/rms norms compute shard-locally (norms reduce over the
    hidden dim only). The '+dp' variants are the two-axis composite
    (data×sequence) views.

    Requires a rank-3+ output: on a rank-2 [batch, feature] tensor dim 1
    is a REDUCTION/feature dim (linear contraction, norm reduction) and
    sharding it would need a partial-sum the strategy doesn't carry."""
    out_nd = len(node.output_shapes[0]) if node.output_shapes else 0
    if out_nd < 3:
        return
    t = node.op_type
    for dax in ({None, data} if data else {None}):
        def seq_spec(nd: int, shard_seq: bool = True) -> Spec:
            spec = list(_batch(nd, dax))
            if shard_seq and nd >= 2:
                spec[1] = seq
            return tuple(spec)

        if t == OpType.BATCH_MATMUL:
            # [B,M,K] @ [B,K,N]: output rows are independent, so only the
            # M operand shards dim 1; the K×N operand rides replicated.
            ins = tuple(seq_spec(len(s), shard_seq=(i == 0))
                        for i, s in enumerate(node.input_shapes))
        else:
            ins = tuple(seq_spec(len(s)) for s in node.input_shapes)
        cands.append(OpStrategy(
            input_specs=ins, output_spec=seq_spec(out_nd),
            weight_specs={w: replicated(len(s))
                          for w, s in node.weight_shapes.items()},
            name=f"seq{'+dp' if dax else ''}"))


def add_embedding_candidates(node: PCGNode, cands: List[OpStrategy],
                             data: Optional[str], model: str):
    """Hidden-dim-parallel embedding table (shard out_dim; gather stays
    local). Vocab-parallel (partial output) also offered — reference
    src/ops/embedding.cc "weight sharded on vocab or replica"."""
    # the op's weight leaf is "weight" (ops/embedding.py); older graphs
    # may carry "kernel"
    wname = "weight" if "weight" in node.weight_shapes else "kernel"
    out_nd = len(node.output_shapes[0])
    for dax in ({None, data} if data else {None}):
        ins = tuple(_batch(len(s), dax) for s in node.input_shapes)
        out = list(_batch(out_nd, dax))
        out[-1] = model
        cands.append(OpStrategy(
            input_specs=ins, output_spec=tuple(out),
            weight_specs={wname: (None, model)},
            name=f"tp-hidden{'+dp' if dax else ''}"))
        cands.append(OpStrategy(
            input_specs=ins, output_spec=_batch(out_nd, dax),
            weight_specs={wname: (model, None)},
            partial_axes=(model,),
            name=f"tp-vocab{'+dp' if dax else ''}"))


def add_conv_candidates(node: PCGNode, cands: List[OpStrategy],
                        data: Optional[str], model: str):
    """Output-channel-parallel conv — the Parameter/Channel dims of the
    SOAP space applied to convolutions (reference
    enable_parameter_parallel, config.h:148-150; conv machine views).
    Kernel OIHW shards O over 'model', the output channel dim follows;
    consumers that need full channels pay an all-gather on the edge
    (costed as resharding), while weight-gradient allreduces shrink by
    the degree — the hybrid that beats pure DP on multi-node conv nets
    whose grad sync crosses DCN."""
    out_nd = len(node.output_shapes[0])
    if out_nd < 2 or node.attrs.get("groups", 1) != 1:
        return
    for dax in ({None, data} if data else {None}):
        ins = tuple(_batch(len(s), dax) for s in node.input_shapes)
        out = list(_batch(out_nd, dax))
        out[1] = model
        wspecs = {"kernel": (model,) + (None,) * (
            len(node.weight_shapes["kernel"]) - 1)}
        if "bias" in node.weight_shapes:
            wspecs["bias"] = (model,)
        cands.append(OpStrategy(
            input_specs=ins, output_spec=tuple(out), weight_specs=wspecs,
            name=f"conv-oc{'+dp' if dax else ''}"))
        # attribute (spatial) parallelism — the A of SOAP for convs
        # (reference enable_attribute_parallel): the H dim sharded over
        # 'model'; the executor gathers H whole for the conv and splits
        # its output. Weights replicated.
        h_out = node.output_shapes[0][2] if out_nd >= 3 else 0
        if h_out and node.input_shapes and len(node.input_shapes[0]) >= 3:
            sp_out = list(_batch(out_nd, dax))
            sp_out[2] = model
            sp_ins = []
            for s in node.input_shapes:
                spec = list(_batch(len(s), dax))
                if len(s) >= 3:
                    spec[2] = model
                sp_ins.append(tuple(spec))
            cands.append(OpStrategy(
                input_specs=tuple(sp_ins), output_spec=tuple(sp_out),
                weight_specs={w: replicated(len(s))
                              for w, s in node.weight_shapes.items()},
                name=f"conv-sp{'+dp' if dax else ''}"))


def add_expert_candidates(node: PCGNode, cands: List[OpStrategy],
                          data: Optional[str], model: str,
                          axis_degrees: Dict[str, int]):
    """Expert parallelism: expert dim of stacked expert weights sharded on
    'expert' (or 'model' when no expert axis), tokens all-to-all'd."""
    axis = "expert" if axis_degrees.get("expert", 1) > 1 else model
    out_nd = len(node.output_shapes[0])
    for dax in ({None, data} if data else {None}):
        ins = tuple(_batch(len(s), dax) for s in node.input_shapes)
        wspecs = {w: tuple([axis] + [None] * (len(s) - 1))
                  for w, s in node.weight_shapes.items()}
        cands.append(OpStrategy(
            input_specs=ins, output_spec=_batch(out_nd, dax),
            weight_specs=wspecs, name=f"ep{'+dp' if dax else ''}"))


class PCG:
    """Graph over PCGNodes, built from an FFModel's layer list."""

    def __init__(self, nodes: List[PCGNode]):
        self.nodes = nodes
        self.by_name = {n.name: n for n in nodes}

    @classmethod
    def from_model(cls, model) -> "PCG":
        tensor_producer: Dict[int, int] = {}     # tensor_id -> node idx
        nodes: List[PCGNode] = []
        for i, layer in enumerate(model.layers):
            node = PCGNode(
                idx=i, name=layer.name, op_type=layer.op_type,
                input_shapes=[tuple(t.dims) for t in layer.inputs],
                output_shapes=[tuple(t.dims) for t in layer.outputs],
                weight_shapes={w.name: tuple(w.shape) for w in layer.weights},
                dtype=(layer.outputs[0].dtype if layer.outputs
                       else DataType.DT_FLOAT),
                attrs=dict(layer.attrs),
            )
            for t in layer.inputs:
                src = tensor_producer.get(t.tensor_id)
                node.input_srcs.append(src)
                node.input_tids.append(t.tensor_id)
                if src is not None and src not in node.in_edges:
                    node.in_edges.append(src)
                    nodes[src].out_edges.append(i)
            for t in layer.outputs:
                tensor_producer[t.tensor_id] = i
                node.output_tids.append(t.tensor_id)
            nodes.append(node)
        return cls(nodes)

    # ---- dominator analysis (for sequence splits) ------------------------
    def topo_order(self) -> List[int]:
        return [n.idx for n in self.nodes]       # build order is topological

    def bottleneck_nodes(self) -> List[int]:
        """Positions p where node p post-dominates everything before it: no
        edge jumps from a node < p to a node > p, so the graph splits into
        [0..p] and [p+1..] connected only through p's outputs. These are the
        sequence-split points of the reference's DP (reference
        SearchHelper::find_optimal_sequence_graph_time, graph.h:181;
        post-dominator computation in src/runtime/graph.cc)."""
        n = len(self.nodes)
        if n == 0:
            return []
        # max_reach[p] = furthest-back source feeding any node > p
        splits = []
        min_src_after = [n] * (n + 1)
        for p in range(n - 1, -1, -1):
            srcs = [u for u in self.nodes[p].in_edges]
            m = min(srcs) if srcs else p
            min_src_after[p] = min(min_src_after[p + 1], m)
        for p in range(n - 1):
            if min_src_after[p + 1] >= p:
                splits.append(p)
        return splits

    def fork_joins(self) -> List[Tuple[int, int, List[List[int]]]]:
        """(fork, join, branches) triples: the nodes strictly between
        ``fork`` and its nearest post-dominator ``join`` partition into
        >= 2 internally-connected components, each wired only to
        fork/join/itself — the structures the reference's nonsequence
        split parallelizes across disjoint device subsets
        (include/flexflow/graph.h:156 NonsequenceSplit;
        find_optimal_nonsequence_graph_time graph.h:181-196). Detection
        scans joins outward from each multi-consumer fork; nested forks
        surface as their own (inner) triples. Computed once for each
        edge structure (the search asks at every ``optimize_graph``, for
        every mesh factorization, and the scan is cubic in the nodes); the
        answer is the JAX package's, which scans at every call."""
        return _scan_fork_joins(tuple(
            (tuple(nd.in_edges), tuple(nd.out_edges)) for nd in self.nodes))


@functools.lru_cache(maxsize=64)
def _scan_fork_joins(edges) -> List[Tuple[int, int, List[List[int]]]]:
    """``PCG.fork_joins`` of a graph whose node i has the (in, out) edges
    ``edges[i]``."""
    out = []
    n = len(edges)
    for f in range(n):
        if len(set(edges[f][1])) < 2:
            continue
        for j in range(f + 2, n):
            mids = range(f + 1, j)
            ok = all(
                all(e == f or f < e < j for e in edges[m][0])
                and all(f < e <= j for e in edges[m][1])
                for m in mids)
            ok = ok and all(f <= e < j for e in edges[j][0])
            ok = ok and bool(mids)
            if not ok:
                continue
            # union-find over edges internal to the region
            parent = {m: m for m in mids}

            def find(x):
                while parent[x] != x:
                    parent[x] = parent[parent[x]]
                    x = parent[x]
                return x

            for m in mids:
                for e in edges[m][0]:
                    if e in parent:
                        parent[find(e)] = find(m)
            comps: Dict[int, List[int]] = {}
            for m in mids:
                comps.setdefault(find(m), []).append(m)
            if len(comps) >= 2:
                out.append((f, j, sorted(comps.values())))
                break             # nearest REAL join only: a contained
                # single-component region (a chain hanging off the
                # fork) must not end the scan before the true
                # post-dominator is reached (r5 regression)
    return out
