"""The JAX package's functional-API Keras example scripts
(``examples/python/keras/func_*``) run against the port on the CPU, one
process a script, through the ``flexflow_tpu`` -> ``flexflow_tpu_torch``
alias of ``torch_example_run.py`` and ``tests/test_examples.py``'s
arguments. The Keras scripts are split over two files by the ``func_``
prefix, so that each file stays short under ``--dist loadfile``."""

import os

import pytest

from torch_example_run import Prefetcher, scripts

SCRIPTS = [s for s in scripts("examples/python/keras")
           if os.path.basename(s).startswith("func_") == True]
_RUNS = Prefetcher(SCRIPTS)


def test_matrix_is_whole():
    assert len(SCRIPTS) == 13, SCRIPTS


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_runs_on_port(script):
    proc = _RUNS.result(script)
    assert proc.returncode == 0, proc.stdout[-4000:]
