"""The JAX package's ONNX and torch.fx example scripts
(``examples/python/onnx``, ``examples/python/pytorch``) run against the
port on the CPU, one process a script, through the ``flexflow_tpu`` ->
``flexflow_tpu_torch`` alias of ``torch_example_run.py`` and
``tests/test_examples.py``'s arguments."""

import pytest

from torch_example_run import Prefetcher, scripts

SCRIPTS = scripts("examples/python/onnx", "examples/python/pytorch")
_RUNS = Prefetcher(SCRIPTS)


def test_matrix_is_whole():
    assert len(SCRIPTS) == 13, SCRIPTS


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_runs_on_port(script):
    proc = _RUNS.result(script)
    assert proc.returncode == 0, proc.stdout[-4000:]
