"""Graphviz (dot) export of a model's layer graph (counterpart of
``flexflow_tpu/utils/dot.py``: ``model_to_dot`` and ``export_model_dot``).

Every layer becomes a record node with its name, op type and output
shape, and an edge from the producer of each of its inputs; the model's
inputs are grey nodes. The text is the JAX package's for the same graph.
A ``strategy`` (the search's per-op sharding specs) or caller-supplied
``costs`` (seconds a layer) add a field to the layers they name. The port
has no search yet: ``FFModel.strategy`` is None, and the cost model that
``FFConfig.include_costs_dot_graph`` and ``pcg_to_dot`` need arrives with
it.
"""

from __future__ import annotations

import os
from typing import Dict, Optional


def _esc(s) -> str:
    return str(s).replace('"', r'\"').replace("{", r"\{").replace("}", r"\}") \
        .replace("<", r"\<").replace(">", r"\>").replace("|", r"\|")


def model_to_dot(model, include_costs: bool = False,
                 costs: Optional[Dict[str, float]] = None,
                 strategy=None) -> str:
    """An FFModel's layer graph as a dot digraph."""
    if strategy is None:
        strategy = getattr(model, "strategy", None)
    lines = ["digraph taskgraph {",
             '  node [shape=record, fontsize=10, fontname="helvetica"];']
    producer = {}
    for layer in model.layers:
        for t in layer.outputs:
            producer[t.tensor_id] = layer.name
    for t in model.input_tensors:
        nid = f"input_{t.tensor_id}"
        lines.append(f'  "{nid}" [label="{{input|{_esc(tuple(t.dims))}}}", '
                     f"style=filled, fillcolor=lightgrey];")
        producer[t.tensor_id] = nid
    for layer in model.layers:
        fields = [_esc(layer.name), _esc(layer.op_type.name.lower()),
                  _esc(tuple(layer.outputs[0].dims) if layer.outputs else ())]
        if strategy is not None:
            op = getattr(strategy, "ops", {}).get(layer.name)
            if op is not None:
                fields.append("spec: " + _esc(getattr(op, "output_spec", "")))
        if include_costs and costs and layer.name in costs:
            fields.append(f"cost: {costs[layer.name]:.3e}s")
        label = "{" + "|".join(fields) + "}"
        lines.append(f'  "{layer.name}" [label="{label}"];')
        for t in layer.inputs:
            src = producer.get(t.tensor_id)
            if src is not None:
                lines.append(f'  "{src}" -> "{layer.name}";')
    lines.append("}")
    return "\n".join(lines) + "\n"


def export_model_dot(model, path: str, include_costs: bool = False,
                     costs: Optional[Dict[str, float]] = None,
                     strategy=None) -> str:
    """Write ``model_to_dot``'s text to ``path`` (its directory made if
    missing); returns ``path``."""
    text = model_to_dot(model, include_costs=include_costs, costs=costs,
                        strategy=strategy)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return path
