"""The port's parallel layer against the JAX package's, on the CPU.

The mesh layout, the slice of every weight a rank holds, the collectives,
sequence-sharded and ring attention and the pipeline schedule. The port's
ranks run as spawned gloo processes (``parallel/launch.run_ranks``, a
``FileStore`` under ``tmp_path``, a timeout on every process and every
collective) that import no jax; the JAX side runs here, on the 8 virtual
CPU devices of ``tests/conftest.py``. Each launch is made once per module
and read by many cases.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flexflow_tpu as ff
from flexflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
from flexflow_tpu.parallel.spec import ShardingPolicy as JPolicy
import flexflow_tpu_torch as fft
from flexflow_tpu_torch.models.llama import LLAMAConfig, create_llama_model
from flexflow_tpu_torch.parallel.launch import run_ranks
from flexflow_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_layout
from flexflow_tpu_torch.parallel.spec import ShardingPolicy, shard_params

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
JOB = str(pathlib.Path(__file__).with_name("torch_rank_jobs.py"))


# ----------------------------------------------------------------------
# mesh layout
# ----------------------------------------------------------------------
@pytest.mark.parametrize("degrees,n", [
    (dict(), 1), (dict(), 8), (dict(tensor_parallelism_degree=2), 2),
    (dict(tensor_parallelism_degree=2), 8),
    (dict(pipeline_parallelism_degree=2), 2),
    (dict(pipeline_parallelism_degree=2, tensor_parallelism_degree=2), 4),
    (dict(pipeline_parallelism_degree=4), 4),
    (dict(sequence_parallelism_degree=2, tensor_parallelism_degree=2), 8),
    (dict(pipeline_parallelism_degree=2, sequence_parallelism_degree=2,
          tensor_parallelism_degree=2), 8),
    (dict(tensor_parallelism_degree=3), 8),
    (dict(mesh_shape=(2, 4), mesh_axis_names=("data", "model")), 8),
])
def test_make_mesh_matches_jax(degrees, n):
    jm = jax_make_mesh(ff.FFConfig(**degrees), jax.devices()[:n])
    shape, names = mesh_layout(fft.FFConfig(device="cpu", **degrees), n)
    assert names == tuple(jm.axis_names)
    assert shape == tuple(jm.devices.shape)
    m = make_mesh(fft.FFConfig(device="cpu", **degrees), n)
    assert m.shape == dict(jm.shape) and m.device_mesh is None


def test_make_mesh_refuses_too_few_devices():
    with pytest.raises(ValueError, match="need 4 devices"):
        mesh_layout(fft.FFConfig(device="cpu", tensor_parallelism_degree=4),
                    2)


def test_mesh_coordinates_are_row_major():
    m = Mesh((2, 2), ("pipe", "model"), rank=3)
    assert m.coord == {"pipe": 1, "model": 1}
    assert m.rank_at(pipe=0) == 1 and m.rank_at(model=0) == 2
    assert Mesh((2, 2), ("pipe", "model"), rank=1).coord == \
        {"pipe": 0, "model": 1}


# ----------------------------------------------------------------------
# the slice each rank holds
# ----------------------------------------------------------------------
_port_models = {}


def _port_full(qtype):
    """A compiled single-process port model (the full weights)."""
    if qtype not in _port_models:
        m = fft.FFModel(fft.FFConfig(device="cpu", max_requests_per_batch=2,
                                     max_sequence_length=64,
                                     kv_cache_dtype="float32",
                                     quantization_type=qtype))
        create_llama_model(m, LLAMAConfig(**TINY))
        m.compile()
        _port_models[qtype] = m
    return _port_models[qtype]


@pytest.mark.parametrize("qtype", [None, "int8", "int4"])
@pytest.mark.parametrize("degrees,n", [
    (dict(tensor_parallelism_degree=2), 2),
    (dict(tensor_parallelism_degree=4), 4),    # KH=2: wk/wv replicate
    (dict(sequence_parallelism_degree=2, tensor_parallelism_degree=2), 4),
])
def test_shard_params_matches_jax_shardings(qtype, degrees, n):
    """For every weight spec of the tiny LLaMA, the slice shard_params
    gives the rank at each coordinate equals the JAX NamedSharding's
    devices_indices_map slice for the device there (a quantized leaf's
    payload by its float weight's spec, scale by the column spec)."""
    pm = _port_full(qtype)
    jmesh = jax_make_mesh(ff.FFConfig(**degrees), jax.devices()[:n])
    jpol = JPolicy(jmesh)
    shape, names = mesh_layout(fft.FFConfig(device="cpu", **degrees), n)
    specs = {layer.name: {w.name: w for w in layer.weights}
             for layer in pm.layers if layer.weights}
    checked = 0
    for r in range(n):
        mesh = Mesh(shape, names, rank=r)
        part = shard_params(pm.params, pm, ShardingPolicy(mesh), mesh.coord)
        dev = jmesh.devices.flat[r]
        for lname, lp in pm.params.items():
            for wname, leaf in lp.items():
                w = specs[lname][wname]
                js = jpol.weight_sharding(w.shape, w.sharding_dims,
                                          w.shard_multiples)
                got = part[lname][wname]
                if hasattr(leaf, "q"):
                    qidx = type(js)(jmesh, js.spec).devices_indices_map(
                        tuple(leaf.q.shape))[dev]
                    np.testing.assert_array_equal(got.q.numpy(),
                                                  leaf.q.numpy()[qidx])
                    sspec = jax.sharding.PartitionSpec(
                        *(tuple(js.spec) + (None, None))[1:2])
                    sidx = jax.sharding.NamedSharding(
                        jmesh, sspec).devices_indices_map(
                        tuple(leaf.scale.shape))[dev]
                    np.testing.assert_array_equal(got.scale.numpy(),
                                                  leaf.scale.numpy()[sidx])
                else:
                    idx = js.devices_indices_map(tuple(leaf.shape))[dev]
                    np.testing.assert_array_equal(got.numpy(),
                                                  leaf.numpy()[idx])
                checked += 1
    assert checked == n * sum(len(lp) for lp in pm.params.values())


def test_int4_row_shard_must_start_on_even_row():
    from flexflow_tpu_torch.parallel.spec import Sharding, shard_leaf
    from flexflow_tpu_torch.quant import quantize_array

    w = quantize_array(torch.randn(6, 8), "int4")
    odd = Sharding(("model", None), (("model", 2),))
    with pytest.raises(ValueError, match="even rows"):
        shard_leaf(w, odd, {"model": 1})


# ----------------------------------------------------------------------
# collectives, attention and the pipeline on spawned ranks
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def collective_runs(tmp_path_factory):
    out = {}
    for name, n, deg, axis in [
            ("model4", 4, dict(tensor_parallelism_degree=4), "model"),
            ("pipe2x2", 4, dict(pipeline_parallelism_degree=2,
                                tensor_parallelism_degree=2), "pipe")]:
        out[name] = run_ranks(
            f"{JOB}:collectives", n,
            {"device": "cpu", "degrees": deg, "axis": axis},
            workdir=tmp_path_factory.mktemp(name), timeout=120)
    return out


def _expected(res, everyone):
    """numpy expectations of one rank's collectives; ``everyone`` the
    peers' inputs in axis order."""
    n, i = res["n"], res["index"]
    allx = np.stack(everyone)                       # [n, 4n]
    x = allx[i]
    return {
        "psum": allx.sum(0), "pmax": allx.max(0), "pmean": allx.mean(0),
        "all_gather": np.concatenate([a.reshape(n, 4) for a in everyone],
                                     axis=1),
        "all_gather_stacked": allx,
        "reduce_scatter": np.split(allx.sum(0), n)[i],
        "ppermute": allx[(i - 1) % n],
        "all_to_all": np.concatenate(
            [a.reshape(n, 4)[i:i + 1] for a in everyone], axis=1),
        "send_recv": allx[(i - 1) % n],
        "broadcast": None, "x": x,
    }


@pytest.mark.parametrize("name", ["model4", "pipe2x2"])
@pytest.mark.parametrize("op", ["psum", "pmax", "pmean", "all_gather",
                                "all_gather_stacked", "reduce_scatter",
                                "ppermute", "all_to_all", "send_recv",
                                "broadcast"])
def test_collective_matches_numpy(collective_runs, name, op):
    results = collective_runs[name]
    for res in results:
        n = res["n"]
        # the peers along the axis: every rank of the 4-rank model axis;
        # on the 2x2 mesh's pipe axis, the ranks of the same model index
        peers = [p for p in results if name == "model4"
                 or p["rank"] % 2 == res["rank"] % 2]
        peers.sort(key=lambda p: p["index"])
        xs = [p["rank"] * 10 + np.arange(4 * n, dtype=np.float32)
              for p in peers]
        want = _expected(res, xs)[op]
        if op == "broadcast":
            want = np.arange(4 * n, dtype=np.float32)   # rank 0's x
        np.testing.assert_allclose(np.asarray(res[op], np.float32), want,
                                   rtol=1e-6)


def _attend_inputs(rng, S, H=4, KH=2, D=16, R=2, Q=5):
    q = rng.standard_normal((R, Q, H, D)).astype(np.float32)
    k = rng.standard_normal((R, KH, S, D)).astype(np.float32)
    v = rng.standard_normal((R, KH, S, D)).astype(np.float32)
    lengths = np.array([min(S, 37), 12], np.int32)
    qpos = np.stack([np.arange(min(S, 37) - Q, min(S, 37)),
                     np.arange(7, 7 + Q)]).astype(np.int32)
    bias = (rng.standard_normal((R, Q, S)) * 0.1).astype(np.float32)
    return q, k, v, lengths, qpos, bias


_CASES = [("causal", True, False, False, 64),
          ("bias", False, True, False, 64),
          ("alibi", True, False, True, 64),
          ("decode", True, False, False, 64),
          ("nodivide", True, False, False, 10)]


@pytest.fixture(scope="module")
def attend_runs(tmp_path_factory):
    """The same seeded inputs through the port on sp ranks (2 and 4) and
    through the JAX seq_sharded_attend on a seq mesh of the same size."""
    from flexflow_tpu.ops.inc_attention import alibi_slopes
    from flexflow_tpu.parallel.ring_attention import \
        seq_sharded_attend as jax_ssa

    rng = np.random.default_rng(0)
    arrays, cases = {}, []
    for name, causal, with_bias, with_alibi, S in _CASES:
        q, k, v, lengths, qpos, bias = _attend_inputs(rng, S)
        if name == "decode":
            q, qpos = q[:, :1], qpos[:, :1]
        arrays.update({f"{name}_q": q, f"{name}_k": k, f"{name}_v": v,
                       f"{name}_lengths": lengths, f"{name}_qpos": qpos})
        if with_bias:
            arrays[f"{name}_bias"] = bias
        if with_alibi:
            arrays[f"{name}_alibi"] = np.asarray(alibi_slopes(4))
        cases.append({"name": name, "causal": causal})
    out = {}
    for sp in (2, 4):
        work = tmp_path_factory.mktemp(f"attend{sp}")
        np.savez(work / "in.npz", **arrays)
        run_ranks(f"{JOB}:seq_attend", sp,
                  {"device": "cpu", "inputs": str(work / "in.npz"),
                   "out": str(work / "out.npz"), "cases": cases,
                   "degrees": {"sequence_parallelism_degree": sp}},
                  workdir=work, timeout=120)
        port = dict(np.load(work / "out.npz"))
        jmesh = jax_make_mesh(ff.FFConfig(sequence_parallelism_degree=sp),
                              jax.devices()[:sp])
        jref = {}
        for name, causal, *_ in _CASES:
            a = {k.split("_", 1)[1]: jnp.asarray(v)
                 for k, v in arrays.items() if k.startswith(name + "_")}
            jref[name] = np.asarray(jax_ssa(
                a["q"], a["k"], a["v"], a["lengths"], a["qpos"], jmesh,
                bias=a.get("bias"), alibi=a.get("alibi"), causal=causal))
        out[sp] = (port, jref, arrays)
    return out


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("case", ["causal", "bias", "alibi", "decode"])
def test_seq_sharded_attend_matches_jax(attend_runs, sp, case):
    """fp32, atol 1e-5: the port's pmax/psum reconcile over sp ranks
    against the JAX shard_map one over sp devices."""
    port, jref, arrays = attend_runs[sp]
    lengths = arrays[f"{case}_lengths"]
    live = lengths > 0
    np.testing.assert_allclose(port[f"out_{case}"][live], jref[case][live],
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("sp", [2, 4])
def test_seq_sharded_attend_nondividing_falls_back(attend_runs, sp):
    """S = 10: at sp=2 the rows split in two; at sp=4 the degree does
    not divide S, every rank holds the whole cache and the dense
    reference runs, as in the JAX package. Both equal JAX's."""
    port, jref, _arrays = attend_runs[sp]
    np.testing.assert_allclose(port["out_nodivide"], jref["nodivide"],
                               atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def pipeline_runs(tmp_path_factory):
    out = {}
    for P, M in ((2, 2), (4, 3), (2, 1)):
        out[(P, M)] = run_ranks(
            f"{JOB}:pipeline", P,
            {"device": "cpu", "layers": 4, "width": 16, "batch": 6,
             "microbatches": M,
             "degrees": {"pipeline_parallelism_degree": P}},
            workdir=tmp_path_factory.mktemp(f"pp{P}_{M}"), timeout=120)
    return out


@pytest.mark.parametrize("P,M", [(2, 2), (4, 3), (2, 1)])
def test_pipeline_spmd_matches_sequential(pipeline_runs, P, M):
    """M microbatches through P stages (M + P - 1 ticks, send/recv
    handoffs, a broadcast from the last stage) give every stage the
    blocks applied in turn."""
    for res in pipeline_runs[(P, M)]:
        assert res["max_err"] < 1e-5, res


def test_stack_and_shard_stacked_params():
    from flexflow_tpu_torch.parallel.pipeline import (block_slice,
                                                      shard_stacked_params,
                                                      stack_stage_params)
    from flexflow_tpu_torch.quant import quantize_array

    g = torch.Generator().manual_seed(0)
    per = [{"w": torch.randn(8, 4, generator=g),
            "q": quantize_array(torch.randn(8, 4, generator=g), "int8")}
           for _ in range(4)]
    st = stack_stage_params(per)
    assert tuple(st["w"].shape) == (4, 8, 4)
    assert tuple(st["q"].q.shape) == (4, 8, 4) and st["q"].rows == 8
    mesh = Mesh((2,), ("pipe",), rank=1)
    local = shard_stacked_params(st, mesh)
    assert torch.equal(block_slice(local, 0)["w"], per[2]["w"])
    assert torch.equal(block_slice(local, 1)["q"].q, per[3]["q"].q)


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    """Port ring attention on sp ranks vs JAX ring_attention on sp
    devices (whole sequences in; each port rank computes its slice)."""
    from flexflow_tpu.parallel.ring_attention import ring_attention

    rng = np.random.default_rng(3)
    b, s, h, kh, d = 2, 16, 4, 2, 8
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    out = {}
    for sp in (2, 4):
        work = tmp_path_factory.mktemp(f"ring{sp}")
        np.savez(work / "in.npz", q=q, k=k, v=v)
        run_ranks(f"{JOB}:ring", sp,
                  {"device": "cpu", "inputs": str(work / "in.npz"),
                   "out": str(work / "out.npz"),
                   "degrees": {"sequence_parallelism_degree": sp}},
                  workdir=work, timeout=120)
        jmesh = jax_make_mesh(ff.FFConfig(sequence_parallelism_degree=sp),
                              jax.devices()[:sp])
        out[sp] = (dict(np.load(work / "out.npz")),
                   {c: np.asarray(ring_attention(
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jmesh, causal=c)) for c in (True, False)})
    return out


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_jax(ring_runs, sp, causal):
    port, jref = ring_runs[sp]
    np.testing.assert_allclose(port[f"causal{int(causal)}"], jref[causal],
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("op", ["repartition", "combine", "reduction",
                                "allreduce", "replicate"])
def test_parallel_ops_on_ranks(collective_runs, op):
    """The parallel-op nodes on the model4 ranks (x as the collectives
    job's): repartition keeps the rank's chunk, combine gathers the
    chunks back in axis order, reduction reduce-scatters, allreduce sums,
    replicate keeps x."""
    results = collective_runs["model4"]
    xs = np.stack([r["rank"] * 10 + np.arange(16, dtype=np.float32)
                   for r in results])
    for res in results:
        i = res["index"]
        want = {"repartition": np.split(xs[i], 4)[i],
                # each rank's chunk i of its own x, gathered in order
                "combine": np.concatenate([np.split(xs[j], 4)[j]
                                           for j in range(4)]),
                "reduction": np.split(xs.sum(0), 4)[i],
                "allreduce": xs.sum(0), "replicate": xs[i]}[op]
        np.testing.assert_allclose(res["op_" + op], want, rtol=1e-6)


def test_dead_peer_raises(tmp_path):
    """A rank that dies makes the launch raise with its peer's error, well
    inside the job's timeout (no hang)."""
    with pytest.raises(RuntimeError, match="rank"):
        run_ranks(f"{JOB}:dead_peer", 2, {"device": "cpu"},
                  workdir=tmp_path, timeout=60)


def test_distributed_initialize_rules(monkeypatch):
    from flexflow_tpu_torch import distributed

    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
              "FF_DISABLE_DISTRIBUTED"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False          # nothing configured
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="no rendezvous"):
        distributed.initialize()
    monkeypatch.setenv("FF_DISABLE_DISTRIBUTED", "1")
    assert distributed.initialize() is False          # the kill switch
    assert distributed.choose_backend("cpu", 2) == "gloo"
    assert distributed.process_info()[:2] == (0, 1)
    assert distributed.host_local_batch(8) == 8


def test_from_args_parallel_and_offload_flags():
    c = fft.FFConfig.from_args(["-tp", "2", "-pp", "2", "-sp", "2",
                                "--offload"], device="cpu")
    assert (c.tensor_parallelism_degree, c.pipeline_parallelism_degree,
            c.sequence_parallelism_degree) == (2, 2, 2) and c.cpu_offload
    assert c.total_parallelism_degree == 8
    assert fft.FFConfig().device == "cuda"


_NEW_MODULES = ["distributed.py", "offload.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/collectives.py",
                "parallel/spec.py", "parallel/ops.py",
                "parallel/ring_attention.py", "parallel/pipeline.py",
                "parallel/launch.py", "parallel/rank_jobs.py",
                "serve/pipeline_plan.py", "../tests/torch_rank_jobs.py"]


@pytest.mark.parametrize("rel", _NEW_MODULES)
def test_new_modules_import_no_jax(rel):
    tree = ast.parse((REPO / "flexflow_tpu_torch" / rel).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flexflow_tpu"), (rel, name)
