"""The port's dot export (``flexflow_tpu_torch.utils.dot``,
``FFModel.export_dot``, ``FFConfig.export_strategy_file``) against the JAX
package's, on the CPU.

The text is the JAX package's for the same graph. Input nodes are named
after their tensor ids, which come from a process-wide counter in each
package, so the comparison renames each ``input_<id>`` after the input's
position before comparing.
"""

import re

import pytest
import torch.nn as nn

import flexflow_tpu as jff
from flexflow_tpu.torch import PyTorchModel as JPyTorchModel
from flexflow_tpu.utils.dot import model_to_dot as jmodel_to_dot
import flexflow_tpu_torch as tff
from flexflow_tpu_torch.torch import PyTorchModel
from flexflow_tpu_torch.utils.dot import model_to_dot


def small_model(ff, batch=16, **kw):
    if ff is tff:
        kw["device"] = "cpu"
    model = ff.FFModel(ff.FFConfig(batch_size=batch, **kw))
    t = model.create_tensor([batch, 32], ff.DataType.DT_FLOAT)
    x = model.dense(t, 32, ff.ActiMode.AC_MODE_RELU, name="fc1")
    x = model.dense(x, 8, name="fc2")
    model.softmax(x, name="sm")
    return model


class ConvHead(nn.Module):
    """A conv, a slice and a scalar op on one input (a helper function
    traced through)."""

    def __init__(self):
        super().__init__()
        self.a = nn.Linear(6, 4)
        self.conv = nn.Conv2d(2, 3, 3, padding=1)

    def forward(self, x):
        h = torch_relu_conv(self.conv, x)
        return self.a(h.flatten(1)[:, :6]) * 2.0


def torch_relu_conv(conv, x):
    return conv(x).relu()


def fx_model(ff):
    cls = PyTorchModel if ff is tff else JPyTorchModel
    cfg = {"device": "cpu"} if ff is tff else {}
    m = ff.FFModel(ff.FFConfig(batch_size=4, **cfg))
    t = m.create_tensor([4, 2, 5, 5], ff.DataType.DT_FLOAT)
    cls(ConvHead()).torch_to_ff(m, [t])
    return m


def by_position(text, model):
    for i, t in enumerate(model.input_tensors):
        text = re.sub(rf'"input_{t.tensor_id}"', f'"input_#{i}"', text)
    return text


@pytest.mark.parametrize("build", ["small", "fx"])
@pytest.mark.parametrize("costs", [None, {"fc1": 1.5e-4, "a": 2e-6}])
def test_dot_text_equals_jax(build, costs):
    make = small_model if build == "small" else fx_model
    texts = []
    for ff, render in ((tff, model_to_dot), (jff, jmodel_to_dot)):
        m = make(ff)
        m.compile()
        texts.append(by_position(render(m, include_costs=costs is not None,
                                        costs=costs), m))
    assert texts[0] == texts[1]
    assert texts[0].startswith("digraph taskgraph {")
    assert texts[0].count('" -> "') >= 3


def test_export_dot_writes_costs(tmp_path):
    model = small_model(tff)
    model.compile()
    path = tmp_path / "sub" / "graph.dot"
    assert model.export_dot(str(path), include_costs=True,
                            costs={"fc1": 1.5e-4}) == str(path)
    text = path.read_text()
    assert '"fc1" -> "fc2"' in text and '"fc2" -> "sm"' in text
    assert "cost: 1.500e-04s" in text
    assert text == model_to_dot(model, include_costs=True,
                                costs={"fc1": 1.5e-4})
    # one node a layer, one for the input
    assert len(re.findall(r"\[label=", text)) == len(model.layers) + 1


def test_export_strategy_file_on_compile(tmp_path):
    path = tmp_path / "strategy.dot"
    model = small_model(tff, export_strategy_file=str(path))
    assert not path.exists()
    model.compile()
    assert path.read_text() == model_to_dot(model)
    assert model.strategy is None


def test_include_costs_dot_graph_waits_for_the_search(tmp_path):
    """The cost fields come from the search's cost model, which the port
    now has: compile writes each layer's estimated seconds, the JAX
    package's text for the same graph."""
    texts = []
    for ff in (tff, jff):
        path = tmp_path / f"{ff.__name__}.dot"
        model = small_model(ff, export_strategy_file=str(path),
                            include_costs_dot_graph=True)
        model.compile()
        texts.append(by_position(path.read_text(), model))
    assert texts[0] == texts[1]
    assert texts[0].count("cost: ") == 3


def test_strategy_specs_render_as_jax():
    """A strategy's output specs add a field, as the JAX package's."""
    class Op:
        output_spec = "('data', None)"

    class Strategy:
        ops = {"fc2": Op()}

    texts = []
    for ff, render in ((tff, model_to_dot), (jff, jmodel_to_dot)):
        m = small_model(ff)
        texts.append(by_position(render(m, strategy=Strategy()), m))
    assert texts[0] == texts[1]
    assert "spec: ('data', None)" in texts[0]
    assert texts[0].count("spec:") == 1
