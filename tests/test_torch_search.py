"""The port's Unity search (``flexflow_tpu_torch/search``) against the JAX
package's, on the CPU.

Five graphs are built alike through both packages (one builder each,
``ff`` either package): ``tests/test_unity_search.py``'s MLP, fusible
MLP, BERT-tiny and two-branch conv net, and a DLRM-like graph (embedding
bags of sparse features and a bottom MLP of dense ones, concatenated into
a top MLP). Under the ``"cpu-sim"`` chip, which both packages carry
unchanged, the PCGs, every candidate's costs, both simulators, the
search's strategy JSON (joint substitution search, mesh factorizations,
MCMC) and the rule file must equal the JAX package's: costs within 1e-12
relative, JSON byte for byte. The port's own additions are checked on
their own: the H100 machine model, the profiled re-rank on the CPU with
its counted fallback, and the cost-annotated dot.
"""

import json
import re

import pytest

import flexflow_tpu as jff
import flexflow_tpu.search as jsearch
from flexflow_tpu.search import graph_search as jgs
from flexflow_tpu.search import substitution as jsub
from flexflow_tpu.utils.dot import model_to_dot as jmodel_to_dot
from flexflow_tpu.utils.dot import pcg_to_dot as jpcg_to_dot
import flexflow_tpu_torch as tff
import flexflow_tpu_torch.search as tsearch
from flexflow_tpu_torch.search import graph_search as tgs
from flexflow_tpu_torch.search import substitution as tsub
from flexflow_tpu_torch.utils.dot import model_to_dot, pcg_to_dot

REL = 1e-12
AXES = {"data": 2, "model": 4}


# ----------------------------------------------------------------------
# the graphs (ff: either package)
# ----------------------------------------------------------------------
def _cfg(ff, **kw):
    if ff is tff:
        kw["device"] = "cpu"
    kw.setdefault("search_deadline_s", 0)
    kw.setdefault("search_profile", False)
    return ff.FFConfig(**kw)


def mlp(ff):
    m = ff.FFModel(_cfg(ff, batch_size=32))
    t = m.create_tensor([32, 64], ff.DataType.DT_FLOAT)
    x = m.dense(t, 512, ff.ActiMode.AC_MODE_RELU)
    x = m.dense(x, 512, ff.ActiMode.AC_MODE_RELU)
    m.softmax(m.dense(x, 8))
    return m


def fusible_mlp(ff):
    m = ff.FFModel(_cfg(ff, batch_size=32, data_parallelism_degree=2,
                        tensor_parallelism_degree=2))
    t = m.create_tensor([32, 64], ff.DataType.DT_FLOAT)
    x = m.relu(m.dense(t, 256))
    x = m.gelu(m.dense(x, 256))
    m.softmax(m.dense(x, 8))
    return m


def bert_tiny(ff):
    m = ff.FFModel(_cfg(ff, batch_size=16))
    toks = m.create_tensor([16, 8], ff.DataType.DT_INT32)
    h = m.embedding(toks, 64, 32)
    a = m.multihead_attention(h, h, h, embed_dim=32, num_heads=4)
    h = m.layer_norm(m.add(a, h), axes=[-1])
    f = m.dense(h, 128, ff.ActiMode.AC_MODE_GELU)
    h = m.layer_norm(m.add(m.dense(f, 32), h), axes=[-1])
    m.softmax(m.dense(m.mean(h, dims=[1]), 8))
    return m


def two_branch(ff):
    m = ff.FFModel(_cfg(ff, batch_size=48, data_parallelism_degree=8,
                        seed=1))
    t = m.create_tensor([48, 32, 16, 16], ff.DataType.DT_FLOAT)
    x = m.conv2d(t, 32, 3, 3, 1, 1, 1, 1, ff.ActiMode.AC_MODE_RELU)
    a = m.conv2d(x, 48, 3, 3, 1, 1, 1, 1, ff.ActiMode.AC_MODE_RELU)
    a = m.conv2d(a, 48, 3, 3, 1, 1, 1, 1, ff.ActiMode.AC_MODE_RELU)
    a = m.conv2d(a, 16, 1, 1, 1, 1, 0, 0, ff.ActiMode.AC_MODE_RELU)
    b = m.conv2d(x, 16, 3, 3, 1, 1, 1, 1, ff.ActiMode.AC_MODE_RELU)
    b = m.conv2d(b, 16, 1, 1, 1, 1, 0, 0, ff.ActiMode.AC_MODE_RELU)
    m.softmax(m.dense(m.flat(m.concat([a, b], axis=1)), 10))
    return m


def dlrm_like(ff):
    m = ff.FFModel(_cfg(ff, batch_size=64))
    dense_in = m.create_tensor([64, 16], ff.DataType.DT_FLOAT)
    bot = m.dense(m.dense(dense_in, 64, ff.ActiMode.AC_MODE_RELU), 32,
                  ff.ActiMode.AC_MODE_RELU)
    feats = [bot]
    for i in range(3):
        ids = m.create_tensor([64, 4], ff.DataType.DT_INT32)
        feats.append(m.embedding(ids, 1000, 32, ff.AggrMode.AGGR_MODE_SUM))
    top = m.concat(feats, axis=1)
    top = m.dense(top, 128, ff.ActiMode.AC_MODE_RELU)
    m.softmax(m.dense(top, 2))
    return m


GRAPHS = {"mlp": mlp, "fusible_mlp": fusible_mlp, "bert_tiny": bert_tiny,
          "two_branch": two_branch, "dlrm_like": dlrm_like}


@pytest.fixture(scope="module")
def models():
    """{graph: (JAX model, port model)}, built once (uncompiled)."""
    return {name: (build(jff), build(tff)) for name, build in GRAPHS.items()}


def _close(a, b):
    return abs(a - b) <= REL * max(abs(a), abs(b), 1e-300)


def _metrics(m):
    return (m.forward_time, m.backward_time, m.comm_time, m.sync_time,
            m.memory, m.makespan, m.total)


# ----------------------------------------------------------------------
# the PCG
# ----------------------------------------------------------------------
def _pcg_view(pcg):
    return [(n.idx, n.name, n.op_type.name, n.input_shapes, n.output_shapes,
             n.weight_shapes, n.dtype.name, n.in_edges, n.out_edges,
             n.input_srcs, n.flops(), n.io_bytes(),
             [c.key() + c.name for c in n.candidates(AXES)])
            for n in pcg.nodes]


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_pcg_equals_jax(models, graph):
    """Names, op types, shapes, edges, footprints and candidates; the
    bottlenecks and the fork-joins."""
    jm, tm = models[graph]
    jp, tp = jsearch.PCG.from_model(jm), tsearch.PCG.from_model(tm)
    assert _pcg_view(tp) == _pcg_view(jp)
    assert tp.bottleneck_nodes() == jp.bottleneck_nodes()
    assert tp.fork_joins() == jp.fork_joins()
    if graph == "two_branch":
        assert tp.fork_joins()


# ----------------------------------------------------------------------
# the cost model
# ----------------------------------------------------------------------
def _machines(pkg, n=8):
    return [pkg.MachineModel.from_name("cpu-sim", n),
            pkg.MachineModel.from_name("cpu-sim", n, devices_per_slice=2)]


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_node_and_reshard_costs_equal_jax(models, graph):
    """``node_compute_time`` (every field) for every candidate of every
    node, ``reshard_time`` from every producer candidate to every
    consumer candidate on each edge, on one node and across nodes."""
    jm, tm = models[graph]
    jp, tp = jsearch.PCG.from_model(jm), tsearch.PCG.from_model(tm)
    n_checked = 0
    for jmach, tmach in zip(_machines(jsearch), _machines(tsearch)):
        for training in (True, False):
            jcm = jsearch.CostModel(jmach, AXES, training=training)
            tcm = tsearch.CostModel(tmach, AXES, training=training)
            for jn, tn in zip(jp.nodes, tp.nodes):
                jc, tc = jn.candidates(AXES), tn.candidates(AXES)
                for a, b in zip(jc, tc):
                    for x, y in zip(_metrics(jcm.node_compute_time(jn, a)),
                                    _metrics(tcm.node_compute_time(tn, b))):
                        assert _close(x, y), (tn.name, b.name)
                    n_checked += 1
                for k, src in enumerate(tn.in_edges):
                    if k >= len(tn.input_shapes):
                        continue
                    for a in tp.nodes[src].candidates(AXES):
                        for b in tc:
                            if k >= len(b.input_specs):
                                continue
                            args = (tn.input_shapes[k], tn.dtype_bytes,
                                    a.output_spec, b.input_specs[k])
                            assert _close(jcm.reshard_time(*args),
                                          tcm.reshard_time(*args))
    assert n_checked > 0


def _dp(search_mod, pcg, machine):
    s = search_mod.UnitySearch(
        pcg, search_mod.CostModel(machine, AXES), AXES,
        enable_substitutions=False)
    return s._dp_baseline(pcg), s.optimize_graph(pcg)


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_simulators_equal_jax(models, graph):
    """``simulate_serial`` and ``simulate_overlap`` (with and without
    branch concurrency) on the DP baseline and the DP-searched strategy;
    the strategies themselves equal."""
    jm, tm = models[graph]
    jp, tp = jsearch.PCG.from_model(jm), tsearch.PCG.from_model(tm)
    for jmach, tmach in zip(_machines(jsearch), _machines(tsearch)):
        jst, tst = _dp(jsearch, jp, jmach), _dp(tsearch, tp, tmach)
        for a, b in zip(jst, tst):
            if a is None:
                assert b is None
                continue
            assert b.to_json() == a.to_json()
            for conc in (False, True):
                jcm = jsearch.CostModel(jmach, AXES, branch_concurrency=conc)
                tcm = tsearch.CostModel(tmach, AXES, branch_concurrency=conc)
                for meth in ("simulate_serial", "simulate_overlap"):
                    x = _metrics(getattr(jcm, meth)(jp, a))
                    y = _metrics(getattr(tcm, meth)(tp, b))
                    assert all(_close(u, v) for u, v in zip(x, y)), meth


# ----------------------------------------------------------------------
# the search
# ----------------------------------------------------------------------
@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("mesh", [False, True])
def test_optimize_model_json_equals_jax(models, graph, mesh):
    """``optimize_model`` at a fixed budget with no deadline: the joint
    substitution search over the packaged rules, the λ retries and MCMC
    (seed 0), over the config's degrees or every mesh factorization of 8
    devices. ``Strategy.to_json`` (the substitution-rewritten graph's
    strategy expanded onto the layers, ``axis_degrees`` included) is the
    JAX package's byte for byte."""
    jm, tm = models[graph]
    out = []
    for m, mod in ((jm, jgs), (tm, tgs)):
        m.config.search_budget = 6
        s = mod.optimize_model(m, chip="cpu-sim", num_devices=8,
                               search_mesh=mesh)
        out.append(s.to_json())
    assert out[1] == out[0]
    if mesh:
        assert json.loads(out[1]).get("axis_degrees") or \
            json.loads(out[1])["ops"]


@pytest.mark.parametrize("graph", ["bert_tiny", "dlrm_like"])
def test_mcmc_and_joint_search_equal_jax(models, graph):
    """``UnitySearch.optimize`` (its best graph's node names included) and
    ``mcmc_optimize`` from the DP baseline at a fixed budget and seed."""
    jm, tm = models[graph]
    res = []
    for pkg, m in ((jsearch, jm), (tsearch, tm)):
        pcg = pkg.PCG.from_model(m)
        machine = pkg.MachineModel.from_name("cpu-sim", 8)
        search = pkg.UnitySearch(pcg, pkg.CostModel(machine, AXES), AXES,
                                 budget=6)
        best = search.optimize()
        start = search._dp_baseline(pcg)
        mc = pkg.mcmc_optimize(pcg, pkg.CostModel(machine, AXES), AXES,
                               start, budget=40, seed=3)
        res.append((best.to_json(), [n.name for n in search.best_graph.nodes],
                    mc.to_json()))
    assert res[1] == res[0]


def test_rule_files_load_alike():
    """The packaged rule file is a copy of the JAX package's, and
    ``load_rules_json`` reads the same rules from each."""
    with open(jsub.default_rules_path(), "rb") as f:
        jbytes = f.read()
    with open(tsub.default_rules_path(), "rb") as f:
        assert f.read() == jbytes

    def view(rules):
        return [(r.name, [(x.op_type.name if x.op_type else None, x.inputs,
                           x.params, x.forbid) for x in r.src],
                 [(x.op_type.name if x.op_type else None, x.inputs,
                   x.params, x.forbid) for x in r.dst], r.mapped_outputs)
                for r in rules]

    jr = jsub.load_rules_json(jsub.default_rules_path())
    tr = tsub.load_rules_json(tsub.default_rules_path())
    assert len(tr) == len(jr) > 100
    assert view(tr) == view(jr)
    assert view(tsub.builtin_rules()) == view(jsub.builtin_rules())


def test_strategy_files_cross_packages(models, tmp_path):
    """A strategy saved by either package loads in the other."""
    jm, tm = models["bert_tiny"]
    js = jgs.optimize_model(jm, chip="cpu-sim", num_devices=8,
                            search_mesh=True)
    ts = tgs.optimize_model(tm, chip="cpu-sim", num_devices=8,
                            search_mesh=True)
    js.save(str(tmp_path / "j.json"))
    ts.save(str(tmp_path / "t.json"))
    assert tsearch.Strategy.load(str(tmp_path / "j.json")).to_json() == \
        js.to_json()
    assert jsearch.Strategy.load(str(tmp_path / "t.json")).to_json() == \
        ts.to_json()


# ----------------------------------------------------------------------
# the port's own: machine model, profiled re-rank, costs in the dot
# ----------------------------------------------------------------------
def test_h100_machine_model():
    """The H100 SXM spec-sheet values, NVLink within an 8-GPU node and
    NDR InfiniBand beyond it; 16 GPUs are two nodes."""
    chip = tsearch.GPU_CHIPS["h100-sxm"]
    assert (chip.bf16_flops, chip.hbm_bandwidth, chip.hbm_capacity) == \
        (989e12, 3.35e12, 80e9)
    assert chip.ici_bandwidth == chip.ici_link_bandwidth == 450e9
    assert chip.dcn_bandwidth == 50e9 and chip.devices_per_node == 8
    assert set(tsearch.GPU_CHIPS) == {"h100-sxm", "cpu-sim"}
    m = tgs._machine_for(tff.FFConfig(device="cpu"), "h100-sxm", 16)
    assert m.devices_per_slice == 8 and m.num_slices == 2
    one = 1 << 30
    assert m.all_reduce_time(one, 8) == 2 * one * 7 / 8 / 450e9
    assert m.all_reduce_time(one, 16) == 2 * one * 15 / 16 / 50e9
    assert tgs._machine_for(tff.FFConfig(device="cpu"), "h100-sxm",
                            8).devices_per_slice is None
    assert tgs._machine_for(tff.FFConfig(device="cpu"), "cpu-sim",
                            16).devices_per_slice is None


def test_profiled_rerank_on_the_cpu(models, capsys):
    """``measure_node`` times the ops' shards on the CPU (cached by key,
    per-shard inputs), and an op that cannot run alone falls back to the
    analytic time, counted and printed. ``profile_rerank`` picks from
    the pool."""
    _jm, tm = models["fusible_mlp"]
    pcg = tsearch.PCG.from_model(tm)
    cm = tsearch.CostModel(tsearch.MachineModel.from_name("cpu-sim", 8),
                           AXES, training=False, device="cpu")
    search = tsearch.UnitySearch(pcg, cm, AXES, budget=4)
    search.optimize()
    g, s = tgs.profile_rerank(search.top_candidates, cm, topk=2)
    assert any(s is c[2] for c in search.top_candidates)
    n = len(cm._profile_cache)
    assert n and cm.profile_fallbacks == 0
    assert all(r["measured_s"] > 0 for r in cm.profile_records.values())
    tgs.profile_rerank(search.top_candidates, cm, topk=2)
    assert len(cm._profile_cache) == n          # all cache hits
    # a serving attention needs its KV cache and batch: not alone
    node = tsearch.PCGNode(
        idx=0, name="attn", op_type=tff.OpType.INC_MULTIHEAD_SELF_ATTENTION,
        input_shapes=[(8, 16)], output_shapes=[(8, 16)], weight_shapes={},
        dtype=tff.DataType.DT_FLOAT)
    st = node.candidates({"data": 1})[0]
    t = cm.measure_node(node, st)
    assert t == cm.node_compute_time(node, st).forward_time
    assert cm.profile_fallbacks == 1
    assert "attn (INC_MULTIHEAD_SELF_ATTENTION, replicate) timed " \
        "analytically" in capsys.readouterr().err


@pytest.mark.parametrize("compute", [None, "bfloat16"])
def test_measure_node_runs_in_the_compute_dtype(monkeypatch, compute):
    """``measure_node`` runs the forward as the model does: parameters in
    the node's dtype, activations and ``ctx.compute_dtype`` in the
    cost model's ``compute_dtype`` (the node's dtype when None)."""
    import torch

    from flexflow_tpu_torch.ops.base import get_op_impl

    impl = get_op_impl(tff.OpType.LINEAR)
    seen = []
    orig = impl.forward

    def spy(attrs, params, inputs, ctx):
        seen.append((params["kernel"].dtype, inputs[0].dtype,
                     ctx.compute_dtype))
        return orig(attrs, params, inputs, ctx)

    monkeypatch.setattr(impl, "forward", spy)
    node = tsearch.PCGNode(
        idx=0, name="fc", op_type=tff.OpType.LINEAR,
        input_shapes=[(8, 16)], output_shapes=[(8, 32)],
        weight_shapes={"kernel": (16, 32), "bias": (32,)},
        dtype=tff.DataType.DT_FLOAT, attrs={"out_dim": 32})
    cm = tsearch.CostModel(tsearch.MachineModel.from_name("cpu-sim", 1),
                           {"data": 1}, training=False, device="cpu",
                           compute_dtype=compute)
    assert cm.measure_node(node, node.candidates({"data": 1})[0]) > 0
    assert cm.profile_fallbacks == 0
    want = torch.bfloat16 if compute else torch.float32
    assert seen and set(seen) == {(torch.float32, want, want)}


def test_profile_defaults_off_on_the_cpu(models, monkeypatch):
    """``search_profile=None`` profiles only a model on the card."""
    _jm, tm = models["mlp"]
    monkeypatch.setattr(tm.config, "search_profile", None)
    calls = []
    orig = tgs.profile_rerank
    monkeypatch.setattr(tgs, "profile_rerank",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    tgs.optimize_model(tm, chip="cpu-sim", num_devices=2)
    assert not calls


@pytest.mark.parametrize("graph", ["bert_tiny", "two_branch"])
def test_costs_and_pcg_dot_equal_jax(models, graph):
    """``_estimate_layer_costs`` and ``pcg_to_dot`` with a searched
    strategy and those costs: the JAX package's, byte for byte."""
    jm, tm = models[graph]
    texts = []
    for m, pkg, to_dot, gs in ((jm, jsearch, jpcg_to_dot, jgs),
                               (tm, tsearch, pcg_to_dot, tgs)):
        costs = m._estimate_layer_costs()
        st = gs.data_parallel_model_strategy(m, num_devices=8)
        texts.append((costs, to_dot(pkg.PCG.from_model(m), strategy=st,
                                    costs=costs)))
    assert texts[1][0] == texts[0][0]
    assert texts[1][1] == texts[0][1]
    assert texts[1][1].count("cost: ") == len(tm.layers)


def test_include_costs_dot_graph_at_compile(tmp_path):
    """``include_costs_dot_graph`` with ``export_strategy_file``: compile
    writes the JAX package's costed dot text."""
    texts = []
    for ff, to_dot in ((jff, jmodel_to_dot), (tff, model_to_dot)):
        path = tmp_path / f"{ff.__name__}.dot"
        m = mlp(ff)
        m.config.export_strategy_file = str(path)
        m.config.include_costs_dot_graph = True
        m.compile()
        text = path.read_text()
        for i, t in enumerate(m.input_tensors):
            text = re.sub(rf'"input_{t.tensor_id}"', f'"input_#{i}"', text)
        texts.append(text)
    assert texts[1] == texts[0]
    assert texts[1].count("cost: ") == 4


def test_from_args_stores_the_search_flags():
    argv = ["--budget", "7", "--alpha", "1.5", "--only-data-parallel",
            "--nodes", "2", "-ll:gpu", "16"]
    j = jff.FFConfig.from_args(argv)
    p = tff.FFConfig.from_args(argv, device="cpu")
    keys = ("search_budget", "search_alpha", "only_data_parallel",
            "num_nodes", "num_devices")
    assert {k: getattr(p, k) for k in keys} == \
        {k: getattr(j, k) for k in keys}
    assert p.resolve_num_devices() == 16


def test_search_fields_default_as_jax():
    j, p = jff.FFConfig(), tff.FFConfig(device="cpu")
    for k in ("auto_parallel", "only_data_parallel", "search_budget",
              "search_alpha", "search_overlap_backward_update",
              "substitution_json_path", "enable_substitutions",
              "use_json_rules", "search_deadline_s", "search_profile",
              "search_mesh", "mem_search_budget", "dcn_topology",
              "num_nodes", "num_devices", "include_costs_dot_graph",
              "export_strategy_file"):
        assert getattr(p, k) == getattr(j, k), k
    assert p.search_chip == j.tpu_chip == "cpu-sim"
