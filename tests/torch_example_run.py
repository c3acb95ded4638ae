"""Runs one of the JAX package's example scripts against the port.

As a script (``python tests/torch_example_run.py [--device D] [--report]
<script> [args...]``, from the repo root) it puts an import alias in
front of ``sys.meta_path`` so that ``flexflow_tpu`` and each
``flexflow_tpu.<sub>`` resolve to the port's ``flexflow_tpu_torch``
modules, makes ``D`` (default ``cpu``) every ``FFConfig``'s default
device (the examples, the Keras models and ``LLM`` build their own
configs, and the port's default is the card), and runs the script as
``__main__``. The alias maps the JAX name to the port and never the
reverse; it lives in this process only. With ``--report`` the process
prints, at exit, one line ``PORT_RUN {...}``: the kernels' launch
counts, their launch shapes (``kernels.record_shapes``) and every
loaded module of ``jax`` or ``flexflow_tpu`` that is not the port's.

The test files ``test_torch_examples_*.py`` start one such process a
script on the CPU (``run_example``, two at a time through
``Prefetcher``), with ``tests/test_examples.py``'s arguments;
``chip_smoke.py`` starts the serving scripts on the card with
``--report``.
"""

from __future__ import annotations

import concurrent.futures
import glob
import importlib
import importlib.abc
import importlib.util
import json
import os
import runpy
import subprocess
import sys
from typing import List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX, _PORT = "flexflow_tpu", "flexflow_tpu_torch"


def _matrix_args():
    """``tests/test_examples.py``'s default and per-script arguments."""
    spec = importlib.util.spec_from_file_location(
        "_jax_example_matrix", os.path.join(ROOT, "tests", "test_examples.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._ARGS, mod._SMALL_BATCH


def scripts(*dirs: str) -> List[str]:
    """The example scripts under ``dirs`` (relative to the repo root)."""
    return sorted(os.path.relpath(p, ROOT) for d in dirs
                  for p in glob.glob(os.path.join(ROOT, d, "*.py")))


def run_example(script: str, timeout: float = 300.0):
    """Run ``script`` against the port in a fresh process; returns the
    ``CompletedProcess`` (stdout and stderr together in ``stdout``)."""
    default, per_script = _matrix_args()
    args = per_script.get(script, default)
    # one thread: the test workers run side by side, and torch's default
    # of one thread a core, times the workers, stalls them all
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return subprocess.run(
        [sys.executable, os.path.abspath(__file__), script, *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=timeout)


class Prefetcher:
    """Runs the scripts of a matrix ``ahead`` at a time: asking for one
    script's result also starts the next ``ahead - 1`` in the list, so a
    test file's processes overlap without starting scripts that no
    selected test asks for."""

    def __init__(self, scripts: List[str], ahead: int = 2):
        self.scripts = list(scripts)
        self.ahead = ahead
        self._pool = concurrent.futures.ThreadPoolExecutor(ahead)
        self._runs = {}

    def result(self, script: str):
        i = self.scripts.index(script)
        for s in self.scripts[i:i + self.ahead]:
            if s not in self._runs:
                self._runs[s] = self._pool.submit(run_example, s)
        return self._runs.pop(script).result()


class _PortAlias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """``flexflow_tpu[.x]`` -> the already imported ``flexflow_tpu_torch[.x]``
    module object, under both names."""

    def __init__(self):
        self._specs = {}

    def find_spec(self, name, path=None, target=None):
        if name != _JAX and not name.startswith(_JAX + "."):
            return None
        real = importlib.import_module(_PORT + name[len(_JAX):])
        self._specs[name] = real.__spec__
        return importlib.util.spec_from_loader(
            name, self, is_package=hasattr(real, "__path__"))

    def create_module(self, spec):
        return importlib.import_module(_PORT + spec.name[len(_JAX):])

    def exec_module(self, module):
        # module_from_spec stamped the alias spec on the real module; give
        # it its own back (a spawned child re-imports by __spec__.name)
        module.__spec__ = self._specs.pop(module.__spec__.name)


def install_alias(device: str = "cpu"):
    """The ``flexflow_tpu`` -> port alias, and ``device`` as every
    ``FFConfig``'s default."""
    sys.meta_path.insert(0, _PortAlias())
    from flexflow_tpu_torch.config import FFConfig

    init = FFConfig.__init__

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("device", device)
        init(self, *args, **kwargs)

    FFConfig.__init__ = __init__


def _report():
    """The ``PORT_RUN`` line's object (see the module docstring)."""
    from flexflow_tpu_torch import kernels

    foreign = sorted(n for n, m in list(sys.modules.items())
                     if n.split(".")[0] in (_JAX, "jax")
                     and not getattr(m, "__name__", "").startswith(_PORT))
    return {"counts": dict(kernels.counts),
            "shapes": {k: [list(s) for s in v]
                       for k, v in kernels.shapes.items()},
            "foreign": foreign}


def main(argv: List[str]):
    device, report = "cpu", False
    while argv and argv[0] in ("--device", "--report"):
        if argv[0] == "--device":
            device, argv = argv[1], argv[2:]
        else:
            report, argv = True, argv[1:]
    script = argv[0]
    install_alias(device)
    sys.argv = [script] + list(argv[1:])
    sys.path.insert(0, os.path.dirname(os.path.join(ROOT, script)))
    from flexflow_tpu_torch import kernels

    try:
        with kernels.record_shapes():
            runpy.run_path(os.path.join(ROOT, script), run_name="__main__")
    finally:
        if report:
            print("PORT_RUN " + json.dumps(_report()), flush=True)


if __name__ == "__main__":
    # the runner's own directory (tests/) must not shadow the script's
    sys.path[0] = ROOT
    main(sys.argv[1:])
