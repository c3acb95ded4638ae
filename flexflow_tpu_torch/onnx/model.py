"""The ONNX frontend of the PyTorch/CUDA port (counterpart of
``flexflow_tpu/onnx/model.py``): ONNX graph -> FFModel op-builder.

``ONNXModel.apply`` walks the graph in order and translates each node to
a builder call of the port's FFModel, recording initializer-backed
weights; ``import_initializers`` copies them into the compiled model's
parameters (on its device, in its dtypes). Works from a file path, raw
bytes, or (if the ``onnx`` package happens to be installed) a ModelProto;
parsing is done by the dependency-free codec in
:mod:`flexflow_tpu_torch.onnx.proto`. BatchNormalization becomes the
port's ``batch_norm`` at its own initial scale and bias; its scale, bias,
mean and variance initializers are not imported (as in the JAX package).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from flexflow_tpu_torch.ffconst import DataType, PoolType
from flexflow_tpu_torch.onnx.proto import NodeProto, OnnxGraph, load_model


def _attr(node: NodeProto, name: str, default=None):
    return node.attrs.get(name, default)


class ONNXModel:
    """Translate an ONNX model onto an FFModel (the JAX package's
    ``ONNXModel``)."""

    def __init__(self, model):
        if isinstance(model, OnnxGraph):
            self.graph = model
        elif hasattr(model, "graph"):        # onnx.ModelProto duck-type
            self.graph = _from_onnx_package(model)
        else:
            self.graph = load_model(model)
        self._weight_imports: Dict = {}

    # ------------------------------------------------------------------
    def apply(self, ffmodel, input_tensors: Dict[str, object]) -> List:
        """Build ops; returns output ff tensors (reference .apply :287).

        ``input_tensors`` maps graph-input names to ff tensors. Initializer-
        backed weights are recorded and written into the model's params by
        :meth:`import_initializers` after ``ffmodel.compile()``.
        """
        env: Dict[str, object] = dict(input_tensors)
        init = self.graph.initializers
        self._weight_imports = {}
        self._used_names: set = set()
        for node in self.graph.nodes:
            self._apply_node(ffmodel, node, env, init)
        return [env[o.name] for o in self.graph.outputs]

    def import_initializers(self, ffmodel):
        """Copy ONNX initializer weights into compiled model params (on
        the model's device, in its dtypes). The recorded arrays are
        writable copies: the decoder's arrays view the model's bytes."""
        for key, arr in self._weight_imports.items():
            ffmodel.set_parameter_by_key(key, arr)

    # ------------------------------------------------------------------
    def _apply_node(self, ff, node: NodeProto, env, init):
        op = node.op_type
        name = node.name or f"{op.lower()}_{len(env)}"
        if name in self._used_names:  # ONNX allows duplicate node names
            i = 1
            while f"{name}_{i}" in self._used_names:
                i += 1
            name = f"{name}_{i}"
        self._used_names.add(name)

        def data(i):
            return env[node.inputs[i]]

        def conv_pads():
            # ONNX pads are [top, left, bottom, right]; the builder takes one
            # (ph, pw) pair, so asymmetric padding cannot be represented.
            auto_pad = _attr(node, "auto_pad", b"NOTSET")
            if isinstance(auto_pad, bytes):
                auto_pad = auto_pad.decode()
            if auto_pad == "":          # protobuf string default == NOTSET
                auto_pad = "NOTSET"
            if auto_pad not in ("NOTSET", "VALID"):
                raise NotImplementedError(
                    f"{op} auto_pad={auto_pad!r} is not supported "
                    "(only NOTSET/VALID)")
            pads = _attr(node, "pads", [0, 0, 0, 0])
            if auto_pad == "VALID":
                return [0, 0]
            if pads[0] != pads[2] or pads[1] != pads[3]:
                raise NotImplementedError(
                    f"{op} asymmetric pads {pads} are not supported")
            return [pads[0], pads[1]]

        if op == "Gemm":
            w = init[node.inputs[1]]
            trans_b = _attr(node, "transB", 0)
            kernel = w.T if trans_b else w
            out_dim = kernel.shape[1]
            use_bias = len(node.inputs) > 2
            t = ff.dense(data(0), int(out_dim), use_bias=use_bias, name=name)
            self._weight_imports[(name, "kernel")] = \
                np.array(kernel, dtype=np.float32)
            if use_bias:
                self._weight_imports[(name, "bias")] = \
                    np.array(init[node.inputs[2]],
                                         dtype=np.float32)
        elif op == "MatMul" and node.inputs[1] in init:
            w = init[node.inputs[1]]
            t = ff.dense(data(0), int(w.shape[1]), use_bias=False, name=name)
            self._weight_imports[(name, "kernel")] = \
                np.array(w, dtype=np.float32)
        elif op == "MatMul":
            t = ff.batch_matmul(data(0), data(1), name=name)
        elif op == "Conv":
            w = init[node.inputs[1]]
            kh, kw = _attr(node, "kernel_shape", list(w.shape[2:]))
            sh, sw = _attr(node, "strides", [1, 1])
            pads = conv_pads()
            groups = _attr(node, "group", 1)
            use_bias = len(node.inputs) > 2
            t = ff.conv2d(data(0), int(w.shape[0]), int(kh), int(kw),
                          int(sh), int(sw), int(pads[0]), int(pads[1]),
                          groups=int(groups), use_bias=use_bias, name=name)
            self._weight_imports[(name, "kernel")] = \
                np.array(w, dtype=np.float32)
            if use_bias:
                self._weight_imports[(name, "bias")] = \
                    np.array(init[node.inputs[2]],
                                         dtype=np.float32)
        elif op in ("MaxPool", "AveragePool"):
            kh, kw = _attr(node, "kernel_shape")
            # ONNX defaults strides to 1 per spatial axis (NOT kernel_shape)
            sh, sw = _attr(node, "strides", [1, 1])
            pads = conv_pads()
            pool = PoolType.POOL_MAX if op == "MaxPool" else PoolType.POOL_AVG
            t = ff.pool2d(data(0), int(kh), int(kw), int(sh), int(sw),
                          int(pads[0]), int(pads[1]), pool_type=pool,
                          name=name)
        elif op == "GlobalAveragePool":
            _, _, h, w = data(0).dims
            t = ff.pool2d(data(0), h, w, 1, 1, 0, 0,
                          pool_type=PoolType.POOL_AVG, name=name)
        elif op == "Flatten":
            t = ff.flat(data(0), name=name)
        elif op == "Relu":
            t = ff.relu(data(0), name=name)
        elif op == "Sigmoid":
            t = ff.sigmoid(data(0), name=name)
        elif op == "Tanh":
            t = ff.tanh(data(0), name=name)
        elif op == "Elu":
            t = ff.elu(data(0), name=name)
        elif op == "Softmax":
            t = ff.softmax(data(0), axis=int(_attr(node, "axis", -1)),
                           name=name)
        elif op == "Add":
            if node.inputs[1] in init:
                b = init[node.inputs[1]]
                if b.size == 1:
                    t = ff.scalar_add(data(0), float(b.ravel()[0]), name=name)
                else:
                    raise NotImplementedError(
                        "Add with tensor initializer unsupported")
            else:
                t = ff.add(data(0), data(1), name=name)
        elif op == "Sub":
            t = ff.subtract(data(0), data(1), name=name)
        elif op == "Mul":
            if node.inputs[1] in init and init[node.inputs[1]].size == 1:
                t = ff.scalar_multiply(
                    data(0), float(init[node.inputs[1]].ravel()[0]),
                    name=name)
            else:
                t = ff.multiply(data(0), data(1), name=name)
        elif op == "Div":
            t = ff.divide(data(0), data(1), name=name)
        elif op == "Concat":
            ins = [env[i] for i in node.inputs]
            t = ff.concat(ins, int(_attr(node, "axis", 0)), name=name)
        elif op == "Split":
            sizes = _attr(node, "split")
            if sizes is None and len(node.inputs) > 1 and node.inputs[1]:
                # opset >= 13 carries split sizes as a second input
                if node.inputs[1] not in init:
                    raise NotImplementedError(
                        "Split with dynamic (non-initializer) sizes")
                sizes = [int(s) for s in init[node.inputs[1]]]
            axis = int(_attr(node, "axis", 0))
            if sizes is None:     # equal split over the declared outputs
                total = data(0).dims[axis]
                k = len(node.outputs)
                if total % k:
                    raise NotImplementedError(
                        f"Split without sizes: {total} not divisible by {k}")
                sizes = [total // k] * k
            outs = ff.split(data(0), [int(s) for s in sizes], axis, name=name)
            for o_name, o_t in zip(node.outputs, outs):
                env[o_name] = o_t
            return
        elif op == "Reshape":
            shape = [int(s) for s in init[node.inputs[1]]]
            if -1 in shape:
                total = int(np.prod(data(0).dims))
                known = int(np.prod([d for d in shape if d != -1] or [1]))
                shape[shape.index(-1)] = total // known
            t = ff.reshape(data(0), shape, name=name)
        elif op == "Transpose":
            t = ff.transpose(data(0), [int(p) for p in _attr(node, "perm")],
                             name=name)
        elif op == "BatchNormalization":
            t = ff.batch_norm(data(0), relu=False, name=name)
        elif op == "Dropout":
            rate = _attr(node, "ratio", 0.5)
            t = ff.dropout(data(0), float(rate), name=name)
            env[node.outputs[0]] = t
            for extra in node.outputs[1:]:   # mask output, unused
                env[extra] = t
            return
        elif op == "Identity":
            t = data(0)
        elif op == "Cast":
            to = int(_attr(node, "to", 1))
            dt = {1: DataType.DT_FLOAT, 6: DataType.DT_INT32,
                  7: DataType.DT_INT64, 10: DataType.DT_HALF,
                  11: DataType.DT_DOUBLE}.get(to, DataType.DT_FLOAT)
            t = ff.cast(data(0), dt, name=name)
        elif op == "Gather" and node.inputs[0] in init:
            w = init[node.inputs[0]]
            t = ff.embedding(data(1), int(w.shape[0]), int(w.shape[1]),
                             name=name)
            self._weight_imports[(name, "weight")] = \
                np.array(w, dtype=np.float32)
        elif op == "Constant":
            # value tensor attr; expose as initializer for later consumers
            val = _attr(node, "value")
            init[node.outputs[0]] = np.asarray(val)
            env[node.outputs[0]] = None
            return
        else:
            raise NotImplementedError(f"ONNX op {op}")
        env[node.outputs[0]] = t


def _from_onnx_package(model) -> OnnxGraph:
    """Convert an onnx.ModelProto (if the package exists) to OnnxGraph."""
    return load_model(model.SerializeToString())
