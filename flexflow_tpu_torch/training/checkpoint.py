"""Checkpoint and resume of a training run, and flat weight export
(counterpart of ``flexflow_tpu/training/checkpoint.py``).

``CheckpointManager`` keeps the whole training state under
``directory/step_N/``, as the JAX package's orbax manager does, without
orbax: ``state.pt`` (``torch.save`` of CPU tensors: the parameters, the
optimizer state, the op state such as BatchNorm's running statistics and
the Cache rings, and the model's ``torch.Generator`` state) and
``meta.json`` (the step, the data loader's position and the caller's
``extra``). Restoring it and training on gives, bit for bit, what
training straight through gives. ``fit_with_recovery`` resumes a
``fit`` from the last finished epoch.

Under a mesh, rank 0 writes whole tensors, each gathered over the axes
its weight is split over (``model``, ``expert``) in a fixed order, and
every rank restores its own slice of each, so a checkpoint restores at
any degree (a tp=2 run's at tp=1), as orbax restores into the template's
sharding. A weight the layout keeps whole on every rank is neither
gathered nor sliced.

``save_weights_npz``/``load_weights_npz`` are the flat weight export and
import, the reference's FileDataLoader layout: one ``np.savez`` archive
with a ``<layer>.<weight>`` entry per parameter. Quantized leaves are
exported dequantized, at full precision. numpy has no bfloat16, so a
bf16 parameter is written widened to float32 (exact); the JAX package
loads such an entry in its parameter's dtype, and the port reads the JAX
package's ml_dtypes bf16 entries. Both directions load in both
packages.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_STEP_DIR = re.compile(r"^step_(\d+)$")


def _dist_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _barrier(model):
    import torch.distributed as dist

    if model.mesh is not None and model.mesh.device_mesh is not None:
        dist.barrier()


def _whole(model, layer: str, weight: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` (this rank's slice of ``layer.weight``, or of a tensor laid
    out like it) gathered over the axes it is split over, on the CPU."""
    from flexflow_tpu_torch.parallel.collectives import all_gather

    sh = model._weight_sharding(layer, weight)
    if sh is not None:
        for d, axis in enumerate(sh.spec):
            if axis is not None:
                t = all_gather(t, model.mesh, axis, axis=d)
    return t.detach().to("cpu", copy=True)


def _mine(model, layer: str, weight: str, full: torch.Tensor):
    """This rank's slice of a whole tensor laid out like
    ``layer.weight``."""
    from flexflow_tpu_torch.parallel.spec import shard_leaf

    sh = model._weight_sharding(layer, weight)
    if sh is None or sh.is_replicated:
        return full
    return shard_leaf(full, sh, model.mesh.coord)


@torch.no_grad()
def training_state(model) -> Dict[str, Any]:
    """The whole training state of ``model`` as CPU tensors: parameters
    and per-parameter optimizer slots gathered whole over the mesh."""
    params = {ln: {w: _whole(model, ln, w, p) for w, p in lp.items()}
              for ln, lp in model.params.items()}
    state: Dict[str, Any] = {"params": params}
    if model.opt_state is not None:
        state["opt_state"] = {
            k: ({ln: {w: _whole(model, ln, w, t) for w, t in lp.items()}
                 for ln, lp in v.items()} if isinstance(v, dict)
                else v.detach().to("cpu", copy=True))
            for k, v in model.opt_state.items()}
    state["op_state"] = {
        ln: {k: v.detach().to("cpu", copy=True) for k, v in st.items()}
        for ln, st in model.op_state.items()}
    state["generator"] = model.generator.get_state()
    return state


@torch.no_grad()
def load_training_state(model, state: Dict[str, Any]) -> None:
    """Copy ``training_state``'s result into ``model`` in place, each
    rank keeping its slices. A parameter or state entry the model does
    not have, or one of another shape, raises."""
    for ln, lp in state["params"].items():
        for w, full in lp.items():
            model.set_parameter_by_key((ln, w), full)
    if "opt_state" in state:
        if model.opt_state is None:
            raise ValueError("the checkpoint has optimizer state; compile "
                             "the model with an optimizer to restore it")
        for k, v in state["opt_state"].items():
            live = model.opt_state[k]
            if not isinstance(v, dict):     # step, lr
                live.copy_(v)
                continue
            for ln, lp in v.items():
                for w, full in lp.items():
                    part = _mine(model, ln, w, full)
                    if tuple(part.shape) != tuple(live[ln][w].shape):
                        raise ValueError(
                            f"optimizer {k} of ({ln}, {w}): shape "
                            f"{tuple(part.shape)} != "
                            f"{tuple(live[ln][w].shape)}")
                    live[ln][w].copy_(part)
    for ln, st in state["op_state"].items():
        for k, v in st.items():
            live = model.op_state[ln][k]
            if tuple(v.shape) != tuple(live.shape):
                raise ValueError(f"op state ({ln}, {k}): shape "
                                 f"{tuple(v.shape)} != {tuple(live.shape)}")
            live.copy_(v)
    model.generator.set_state(state["generator"])


class CheckpointManager:
    """Save and restore an FFModel's training state to ``directory/
    step_N``, with orbax's ``max_to_keep`` and ``save_interval_steps``
    (a step off the interval is not saved unless ``force``)."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = max(1, int(save_interval_steps))
        os.makedirs(self.directory, exist_ok=True)

    def _dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}")

    def save(self, step: int, model, dataloader_state: Optional[Dict] = None,
             extra: Optional[Dict[str, Any]] = None,
             force: bool = False) -> bool:
        """Write ``model``'s state as step ``step``; returns whether it
        was written. Under a mesh every rank calls it (the gathers are
        collectives) and rank 0 writes."""
        if not force and (step % self.save_interval_steps
                          or step in self.all_steps()):
            return False
        state = training_state(model)
        if _dist_rank() == 0:
            meta = {"step": int(step),
                    "dataloader_state": dataloader_state or {},
                    "extra": extra or {}}
            final = self._dir(step)
            tmp = final + ".partial"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(state, os.path.join(tmp, "state.pt"))
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            if self.max_to_keep:
                for old in self.all_steps()[:-self.max_to_keep]:
                    shutil.rmtree(self._dir(old), ignore_errors=True)
        _barrier(model)
        return True

    def restore(self, model, step: Optional[int] = None) -> Dict[str, Any]:
        """Restore step ``step`` (default the latest) into ``model`` in
        place; returns the metadata dict."""
        if step is None:
            step = self.latest_step()
        if step is None or step not in self.all_steps():
            raise FileNotFoundError(
                f"no checkpoint {'' if step is None else step} under "
                f"{self.directory}")
        d = self._dir(step)
        state = torch.load(os.path.join(d, "state.pt"), map_location="cpu",
                           weights_only=False)
        load_training_state(model, state)
        with open(os.path.join(d, "meta.json")) as f:
            return json.load(f)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_DIR.match(name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def close(self):
        """Nothing stays open between calls (orbax's API)."""


def fit_with_recovery(model, x, y, epochs: int, manager: CheckpointManager,
                      batch_size: Optional[int] = None,
                      save_every_epochs: int = 1, shuffle: bool = False):
    """``fit`` that resumes from ``manager``'s latest checkpoint and saves
    every ``save_every_epochs`` epochs (and after the last). Running the
    same call again after a crash continues from the epoch after the
    last saved one. Returns the history of the epochs this call ran."""
    if save_every_epochs < 1:
        raise ValueError(f"save_every_epochs must be >= 1, "
                         f"got {save_every_epochs}")
    start_epoch = 0
    if manager.latest_step() is not None:
        meta = manager.restore(model)
        epoch_meta = meta.get("extra", {}).get("epoch")
        if epoch_meta is None:
            raise ValueError(
                f"checkpoint step {meta['step']} in {manager.directory} was "
                f"not written by fit_with_recovery (no 'epoch' in extra): "
                f"refusing to guess the resume epoch from a batch-step id")
        start_epoch = int(epoch_meta) + 1
    history = []
    for epoch in range(start_epoch, epochs):
        recs = model.fit(x, y, batch_size=batch_size, epochs=1,
                         shuffle=shuffle, initial_epoch=epoch)
        history += [{**r, "epoch": epoch} for r in recs]
        if (epoch - start_epoch) % save_every_epochs == 0 \
                or epoch == epochs - 1:
            manager.save(epoch, model, extra={"epoch": epoch}, force=True)
    return history


def save_weights_npz(path: str, model) -> None:
    """Every parameter of ``model`` to ``path``."""
    from flexflow_tpu_torch.quant import dequantize_array, is_quantized
    from flexflow_tpu_torch.utils.debugging import as_numpy

    flat = {}
    for lname, lp in model.params.items():
        for wname, w in lp.items():
            if is_quantized(w):
                w = dequantize_array(w)
            flat[f"{lname}.{wname}"] = as_numpy(w)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_weights_npz(path: str, model) -> None:
    """Copy every ``<layer>.<weight>`` of ``path`` into the compiled
    ``model``, in place and in each parameter's dtype (a quantized
    parameter is re-quantized). A missing entry raises ``KeyError``, a
    shape difference ``ValueError``."""
    from flexflow_tpu_torch.utils.debugging import as_float32

    with np.load(path) as data:
        for lname, lp in model.params.items():
            for wname in list(lp):
                key = f"{lname}.{wname}"
                if key not in data:
                    raise KeyError(f"checkpoint missing weight {key}")
                model.set_parameter_by_key((lname, wname),
                                           np.array(as_float32(data[key])))
