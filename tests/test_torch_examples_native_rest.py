"""The JAX package's native-API example scripts (``examples/python/native``,
the second half of them in name order) run against the port on the CPU,
one process a script, through the ``flexflow_tpu`` ->
``flexflow_tpu_torch`` alias of ``torch_example_run.py`` and
``tests/test_examples.py``'s arguments. The native scripts are split over
two files so that each file stays short under ``--dist loadfile``."""

import pytest

from torch_example_run import Prefetcher, scripts

SCRIPTS = scripts("examples/python/native")[10:]
_RUNS = Prefetcher(SCRIPTS)


def test_matrix_is_whole():
    assert len(scripts("examples/python/native")) == 20
    assert len(SCRIPTS) == 10, SCRIPTS


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_runs_on_port(script):
    proc = _RUNS.result(script)
    assert proc.returncode == 0, proc.stdout[-4000:]
