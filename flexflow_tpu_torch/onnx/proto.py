"""Minimal, dependency-free ONNX protobuf wire-format codec (the port's
copy of ``flexflow_tpu/onnx/proto.py``, which has no JAX in it: the two
packages read and write the same bytes).

The environment has no ``onnx`` package (and nothing may be installed), so
this module hand-decodes the stable subset of the ONNX ModelProto wire format
the frontend needs: graph nodes (op_type/inputs/outputs/attributes),
initializers (as numpy arrays), and graph input/output value infos. An
encoder for the same subset exists so tests can synthesize real ``.onnx``
bytes without torch.onnx (which itself requires the onnx package).

Wire format: each field is a (tag = field_number << 3 | wire_type, payload)
pair; wire types used by ONNX are 0 (varint), 1 (fixed64), 2 (length-
delimited), 5 (fixed32).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# --- low-level wire helpers -------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message's fields."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wtype == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _field(fnum: int, wtype: int, payload: bytes) -> bytes:
    return _write_varint(fnum << 3 | wtype) + payload


def _ld(fnum: int, payload: bytes) -> bytes:       # length-delimited
    return _field(fnum, 2, _write_varint(len(payload)) + payload)


def _vi(fnum: int, value: int) -> bytes:           # varint field
    return _field(fnum, 0, _write_varint(value))


# --- ONNX data model (decoded) ---------------------------------------------

# TensorProto.DataType values (onnx.proto enum)
DT_FLOAT, DT_UINT8, DT_INT8, DT_INT32, DT_INT64 = 1, 2, 3, 6, 7
DT_BOOL, DT_FLOAT16, DT_DOUBLE, DT_BF16 = 9, 10, 11, 16

_NP_DTYPES = {
    DT_FLOAT: np.float32, DT_UINT8: np.uint8, DT_INT8: np.int8,
    DT_INT32: np.int32, DT_INT64: np.int64, DT_BOOL: np.bool_,
    DT_FLOAT16: np.float16, DT_DOUBLE: np.float64,
}
_DT_FROM_NP = {np.dtype(v): k for k, v in _NP_DTYPES.items()}


@dataclass
class Attribute:
    name: str
    value: Any      # int, float, bytes, list, or np.ndarray (tensor attr)


@dataclass
class NodeProto:
    op_type: str
    name: str = ""
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    attrs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ValueInfo:
    name: str
    elem_type: int = DT_FLOAT
    shape: List[Optional[int]] = field(default_factory=list)


@dataclass
class OnnxGraph:
    name: str = ""
    nodes: List[NodeProto] = field(default_factory=list)
    initializers: Dict[str, np.ndarray] = field(default_factory=dict)
    inputs: List[ValueInfo] = field(default_factory=list)
    outputs: List[ValueInfo] = field(default_factory=list)


# --- decoding ---------------------------------------------------------------


def _decode_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype = DT_FLOAT
    name = ""
    raw = None
    float_data: List[float] = []
    int32_data: List[int] = []
    int64_data: List[int] = []
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            dims.append(val)
        elif fnum == 2:
            dtype = val
        elif fnum == 4:      # packed float_data
            if wtype == 2:
                float_data.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                float_data.append(struct.unpack("<f", val)[0])
        elif fnum == 5:      # packed int32_data (negatives sign-extend to
            #                  64-bit varints, same as int64_data)
            def _signed(v):
                return v - (1 << 64) if v >= (1 << 63) else v
            if wtype == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    int32_data.append(_signed(v))
            else:
                int32_data.append(_signed(val))
        elif fnum == 7:      # packed int64_data
            if wtype == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    int64_data.append(v)
            else:
                int64_data.append(val)
        elif fnum == 8:
            name = val.decode()
        elif fnum == 9:
            raw = val
    np_dtype = _NP_DTYPES.get(dtype, np.float32)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype).reshape(dims)
    elif float_data:
        arr = np.asarray(float_data, dtype=np_dtype).reshape(dims)
    elif int64_data:
        arr = np.asarray(
            [v - (1 << 64) if v >= (1 << 63) else v for v in int64_data],
            dtype=np_dtype).reshape(dims)
    elif int32_data:
        arr = np.asarray(int32_data, dtype=np_dtype).reshape(dims)
    else:
        arr = np.zeros(dims, dtype=np_dtype)
    return name, arr


def _decode_attribute(buf: bytes) -> Attribute:
    name = ""
    value: Any = None
    ints: List[int] = []
    floats: List[float] = []
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            name = val.decode()
        elif fnum == 2:      # f (fixed32)
            value = struct.unpack("<f", val)[0]
        elif fnum == 3:      # i
            value = val - (1 << 64) if val >= (1 << 63) else val
        elif fnum == 4:      # s
            value = val
        elif fnum == 5:      # t
            value = _decode_tensor(val)[1]
        elif fnum == 7:      # floats
            if wtype == 2:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                floats.append(struct.unpack("<f", val)[0])
        elif fnum == 8:      # ints
            if wtype == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    ints.append(v - (1 << 64) if v >= (1 << 63) else v)
            else:
                ints.append(val - (1 << 64) if val >= (1 << 63) else val)
    if ints:
        value = ints
    elif floats:
        value = floats
    return Attribute(name, value)


def _decode_node(buf: bytes) -> NodeProto:
    node = NodeProto(op_type="")
    for fnum, _, val in _iter_fields(buf):
        if fnum == 1:
            node.inputs.append(val.decode())
        elif fnum == 2:
            node.outputs.append(val.decode())
        elif fnum == 3:
            node.name = val.decode()
        elif fnum == 4:
            node.op_type = val.decode()
        elif fnum == 5:
            a = _decode_attribute(val)
            node.attrs[a.name] = a.value
    return node


def _decode_value_info(buf: bytes) -> ValueInfo:
    vi = ValueInfo(name="")
    for fnum, _, val in _iter_fields(buf):
        if fnum == 1:
            vi.name = val.decode()
        elif fnum == 2:      # TypeProto
            for f2, _, v2 in _iter_fields(val):
                if f2 == 1:  # tensor_type
                    for f3, _, v3 in _iter_fields(v2):
                        if f3 == 1:
                            vi.elem_type = v3
                        elif f3 == 2:  # TensorShapeProto
                            for f4, _, v4 in _iter_fields(v3):
                                if f4 == 1:  # Dimension
                                    dim_val: Optional[int] = None
                                    for f5, _, v5 in _iter_fields(v4):
                                        if f5 == 1:
                                            dim_val = v5
                                    vi.shape.append(dim_val)
    return vi


def _decode_graph(buf: bytes) -> OnnxGraph:
    g = OnnxGraph()
    for fnum, _, val in _iter_fields(buf):
        if fnum == 1:
            g.nodes.append(_decode_node(val))
        elif fnum == 2:
            g.name = val.decode()
        elif fnum == 5:
            name, arr = _decode_tensor(val)
            g.initializers[name] = arr
        elif fnum == 11:
            g.inputs.append(_decode_value_info(val))
        elif fnum == 12:
            g.outputs.append(_decode_value_info(val))
    return g


def load_model_bytes(data: bytes) -> OnnxGraph:
    """Decode a serialized ModelProto into an OnnxGraph."""
    for fnum, _, val in _iter_fields(data):
        if fnum == 7:        # ModelProto.graph
            return _decode_graph(val)
    raise ValueError("no graph found in ONNX model bytes")


def load_model(path_or_bytes) -> OnnxGraph:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return load_model_bytes(bytes(path_or_bytes))
    with open(path_or_bytes, "rb") as f:
        return load_model_bytes(f.read())


# --- encoding (test/synthesis utility) --------------------------------------


def encode_tensor(name: str, arr: np.ndarray) -> bytes:
    out = b""
    for d in arr.shape:
        out += _vi(1, d)
    out += _vi(2, _DT_FROM_NP[np.dtype(arr.dtype)])
    out += _ld(8, name.encode())
    out += _ld(9, np.ascontiguousarray(arr).tobytes())
    return out


def _encode_attribute(name: str, value: Any) -> bytes:
    out = _ld(1, name.encode())
    if isinstance(value, (list, tuple)) and value \
            and isinstance(value[0], int):
        packed = b"".join(_write_varint(v & ((1 << 64) - 1)) for v in value)
        out += _ld(8, packed) + _vi(20, 7)           # INTS
    elif isinstance(value, (list, tuple)):
        out += _ld(7, struct.pack(f"<{len(value)}f", *value)) + _vi(20, 6)
    elif isinstance(value, bool) or isinstance(value, int):
        out += _vi(3, int(value) & ((1 << 64) - 1)) + _vi(20, 2)   # INT
    elif isinstance(value, float):
        out += _field(2, 5, struct.pack("<f", value)) + _vi(20, 1)  # FLOAT
    elif isinstance(value, bytes):
        out += _ld(4, value) + _vi(20, 3)            # STRING
    elif isinstance(value, np.ndarray):
        out += _ld(5, encode_tensor(name + "_t", value)) + _vi(20, 4)
    else:
        raise TypeError(f"attr {name}: {type(value)}")
    return out


def encode_node(op_type: str, inputs: List[str], outputs: List[str],
                name: str = "", **attrs) -> bytes:
    out = b""
    for i in inputs:
        out += _ld(1, i.encode())
    for o in outputs:
        out += _ld(2, o.encode())
    out += _ld(3, (name or op_type.lower()).encode())
    out += _ld(4, op_type.encode())
    for k, v in attrs.items():
        out += _ld(5, _encode_attribute(k, v))
    return out


def encode_value_info(name: str, shape: List[int],
                      elem_type: int = DT_FLOAT) -> bytes:
    dims = b"".join(_ld(1, _vi(1, d)) for d in shape)
    tensor_type = _vi(1, elem_type) + _ld(2, dims)
    return _ld(1, name.encode()) + _ld(2, _ld(1, tensor_type))


def encode_model(nodes: List[bytes], inputs: List[bytes],
                 outputs: List[bytes],
                 initializers: Dict[str, np.ndarray],
                 graph_name: str = "g") -> bytes:
    g = b""
    for n in nodes:
        g += _ld(1, n)
    g += _ld(2, graph_name.encode())
    for name, arr in initializers.items():
        g += _ld(5, encode_tensor(name, arr))
    for i in inputs:
        g += _ld(11, i)
    for o in outputs:
        g += _ld(12, o)
    # ir_version=8, graph, opset import {version 17}
    return _vi(1, 8) + _ld(7, g) + _ld(8, _vi(2, 17))
