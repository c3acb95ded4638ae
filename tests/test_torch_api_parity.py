"""Every public name of the JAX package has its counterpart in the port.

For each module of ``flexflow_tpu`` the port's module of the same dotted
path must exist and hold each public module-level name (a package's every
public name: its re-exports are its API; a module's names defined there,
its constants and its ``__all__``), and each public attribute of every
such class, by ``getattr``, so inherited ones count. The names that stay
TPU-only are listed below, each group with the port's replacement; the
list must stay exactly the names missing, so a later JAX-side name fails
here rather than a user. Also the cheap behaviour of the ported names.
"""

import importlib
import inspect
import pkgutil
import types

import numpy as np
import pytest

import flexflow_tpu

_JAX, _PORT = "flexflow_tpu", "flexflow_tpu_torch"

# reason -> the JAX names (module path, then class and attribute) that the
# port does not have
NOT_PORTED = {
    "the Pallas dispatch switches and counters: the port counts kernel "
    "launches (kernels.counts) and switches with FFConfig.use_kernels": [
        "flexflow_tpu.kernels.use_pallas",
        "flexflow_tpu.kernels.pallas_interpret_forced",
        "flexflow_tpu.kernels.record_fast_path",
        "flexflow_tpu.kernels.record_fallback",
        "flexflow_tpu.kernels.reset_dispatch_stats",
        "flexflow_tpu.kernels.fast_path_count",
        "flexflow_tpu.kernels.fallback_counts"],
    "TPU tiles and the Pallas kernel's shape rule: the port has "
    "kernels.attention.supports_shapes and kernel_takes": [
        "flexflow_tpu.kernels.attention.round_up",
        "flexflow_tpu.kernels.attention.supports_seq_len",
        "flexflow_tpu.kernels.attention.SUBLANE",
        "flexflow_tpu.kernels.attention.LANE"],
    "the XLA/TPU config fields: the port has use_kernels and search_chip": [
        "flexflow_tpu.FFConfig.use_pallas",
        "flexflow_tpu.FFConfig.tpu_chip",
        "flexflow_tpu.FFConfig.decode_auto_layout",
        "flexflow_tpu.config.FFConfig.use_pallas",
        "flexflow_tpu.config.FFConfig.tpu_chip",
        "flexflow_tpu.config.FFConfig.decode_auto_layout"],
    "XLA's auto-layout decode block: the port's decode block has no "
    "layouts to choose (serve/engine.make_decode_block)": [
        "flexflow_tpu.serve.engine.make_decode_block_auto"],
    "the TPU chips of the cost model: the port's are search.GPU_CHIPS": [
        "flexflow_tpu.search.TPU_CHIPS",
        "flexflow_tpu.search.graph_search.TPU_CHIPS",
        "flexflow_tpu.search.machine_model.TPU_CHIPS"],
    "JAX pytree hooks: a torch QuantizedWeight is a plain object": [
        "flexflow_tpu.quant.QuantizedWeight.tree_flatten",
        "flexflow_tpu.quant.QuantizedWeight.tree_unflatten"],
    "PartitionSpec.UNCONSTRAINED: the port's placement walk has no "
    "sharding propagation to leave a dim to": [
        "flexflow_tpu.parallel.ops.UNC"],
}
# JAX modules with no port module, and why
NO_MODULE = {
    "flexflow_tpu.utils.shard_map_compat":
        "a shim over one jax version's shard_map",
}


def _public(mod):
    """(name, value) of the module's public names (see the docstring)."""
    is_pkg = hasattr(mod, "__path__")
    exported = set(getattr(mod, "__all__", ()))
    for k, v in vars(mod).items():
        if k.startswith("_") or isinstance(v, types.ModuleType):
            continue
        if inspect.isclass(v) or inspect.isfunction(v):
            owner = getattr(v, "__module__", "") or ""
            if not owner.startswith(_JAX):
                continue        # a library's name imported here
            if not is_pkg and owner != mod.__name__ and k not in exported:
                continue        # imported from a sibling module
        elif type(v).__module__.startswith("typing"):
            continue
        yield k, v


def _missing():
    missing, no_module = [], []
    names = [_JAX] + [m.name for m in pkgutil.walk_packages(
        flexflow_tpu.__path__, _JAX + ".")]
    for name in names:
        if name.endswith("__main__"):
            continue
        jm = importlib.import_module(name)
        try:
            pm = importlib.import_module(_PORT + name[len(_JAX):])
        except ModuleNotFoundError:
            no_module.append(name)
            continue
        for k, v in _public(jm):
            if not hasattr(pm, k):
                missing.append(f"{name}.{k}")
            elif inspect.isclass(v):
                pv = getattr(pm, k)
                missing += [f"{name}.{k}.{a}" for a in dir(v)
                            if not a.startswith("_") and not hasattr(pv, a)]
    return missing, no_module


@pytest.fixture(scope="module")
def missing():
    return _missing()


def test_every_jax_public_name_is_in_the_port(missing):
    names, _ = missing
    excluded = [n for group in NOT_PORTED.values() for n in group]
    assert sorted(set(names) - set(excluded)) == []


def test_exclusion_list_is_exactly_what_is_missing(missing):
    names, no_module = missing
    excluded = [n for group in NOT_PORTED.values() for n in group]
    assert len(excluded) == len(set(excluded))
    assert sorted(set(excluded) - set(names)) == []
    assert sorted(no_module) == sorted(NO_MODULE)
    assert all(reason.strip() for reason in NOT_PORTED)


def test_step_timer_summary_matches_jax():
    from flexflow_tpu.utils.profiling import StepTimer as JTimer
    from flexflow_tpu_torch.utils.profiling import StepTimer as TTimer

    j, t = JTimer(), TTimer()
    for s in (0.002, 0.004, 0.003):
        j.record("train_step", s)
        t.record("train_step", s)
    assert t.summary() == j.summary()
    assert t.report() == j.report()
    off = TTimer(enabled=False)
    off.record("x", 1.0)
    assert off.summary() == {}


def test_slope_timers_on_the_cpu():
    import time

    from flexflow_tpu_torch.utils.profiling import (adaptive_slope_time,
                                                    slope_time, timed_call)

    out, s = timed_call(lambda a: a * 2, np.ones(3))
    assert out.tolist() == [2, 2, 2] and s >= 0

    def run(trips):
        time.sleep(0.001 * trips)

    assert 0.0005 < slope_time(run, 1, 5, reps=3) < 0.01
    assert 0.0005 < adaptive_slope_time(run, cap=64, reps=3) < 0.01


def test_get_request_manager_is_one_object():
    from flexflow_tpu_torch.serve import (RequestManager,
                                          get_request_manager)

    rm = get_request_manager()
    assert isinstance(rm, RequestManager) and get_request_manager() is rm
    assert rm.native_shadow_empty()


def test_batch_meta_shapes_and_constants():
    import flexflow_tpu.serve as js
    import flexflow_tpu_torch.serve as ts
    from flexflow_tpu_torch.serve.batch_config import (
        DEFAULT_PIPELINE_DEPTH, make_batch_meta)

    for k in ("MAX_NUM_REQUESTS", "MAX_NUM_TOKENS", "MAX_BEAM_WIDTH",
              "MAX_BEAM_DEPTH"):
        assert getattr(ts, k) == getattr(js, k), k
    assert DEFAULT_PIPELINE_DEPTH == 4
    meta = make_batch_meta(3, 5)
    assert (meta.max_requests, meta.q_width) == (3, 5)


def test_layer_naming_and_tensor_aliases():
    import flexflow_tpu_torch as ff
    from flexflow_tpu_torch.core.layer import Layer
    from flexflow_tpu_torch.ffconst import OpType

    Layer.reset_naming()
    names = [Layer(OpType.RELU, None, [], {}).name for _ in range(2)]
    assert names == ["relu", "relu_1"]
    Layer.reset_naming()
    assert Layer(OpType.RELU, None, [], {}).name == "relu"

    m = ff.FFModel(ff.FFConfig(batch_size=2, device="cpu"))
    x = m.create_tensor([2, 4], ff.DataType.DT_FLOAT)
    m.dense(x, 3, name="d")
    m.compile()
    w = m.get_parameter_tensor("d", "kernel")
    new = np.arange(12, dtype=np.float32).reshape(w.get_tensor().shape)
    w.set_tensor(m, new)
    assert np.array_equal(w.get_tensor(), new)


def test_op_context_layer_rng_is_per_layer_and_repeats():
    import torch

    from flexflow_tpu_torch.ops.base import OpContext

    a = OpContext(rng=7, layer_name="attn_0")
    b = OpContext(rng=7, layer_name="attn_1")
    draw = lambda c, salt=0: torch.rand(4, generator=c.layer_rng(salt))
    assert torch.equal(draw(a), draw(a))
    assert not torch.equal(draw(a), draw(b))
    assert not torch.equal(draw(a), draw(a, 1))
    assert OpContext().layer_rng() is None


def test_fit_prints_step_times_under_profiling(capsys):
    import flexflow_tpu_torch as ff

    m = ff.FFModel(ff.FFConfig(batch_size=4, device="cpu", profiling=True))
    x = m.create_tensor([4, 8], ff.DataType.DT_FLOAT)
    m.softmax(m.dense(x, 3))
    m.compile(optimizer=ff.SGDOptimizer(m, 0.1),
              loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              metrics=[ff.MetricsType.METRICS_ACCURACY])
    rng = np.random.RandomState(0)
    X = rng.randn(12, 8).astype(np.float32)
    y = rng.randint(0, 3, (12, 1)).astype(np.int32)
    m.fit(x=X, y=y, epochs=1)
    m.fit(x=X, y=y, epochs=1, steps_per_call=3)
    out = capsys.readouterr().out
    assert "[train_step=" in out and "ms(x3)]" in out and "ms(x6)]" in out
    assert m._step_timer.summary()["train_step"]["count"] == 6
