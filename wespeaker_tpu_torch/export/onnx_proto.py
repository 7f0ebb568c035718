"""Dependency-free ONNX protobuf writer + reader.

The port's own copy of wespeaker_tpu/export/onnx_proto.py: the same wire
bytes for the same graph, except that a 0-d tensor keeps no dims (the JAX
package's writer gives it dims [1]; its converter emits none, the port's
does: symbolic sizes are 0-d int64 values).

The environment ships no `onnx` package, so the ModelProto wire format is
encoded directly (protobuf encoding is varint tags + length-delimited
submessages; field numbers below follow the public onnx.proto3 schema).
The reader exists so tests can round-trip the serialized artifact through
an independent decode path before executing it with export/onnx_numpy.py.

Reference behavior being reproduced: wespeaker/bin/export_onnx.py:64-99
(opset 14, input 'feats' (B, T, F) float32 -> output 'embs' (B, D), dynamic
B/T axes).
"""

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

# --- TensorProto.DataType enum (onnx.proto3) ---
FLOAT, UINT8, INT8, INT32, INT64, BOOL, FLOAT16, DOUBLE = \
    1, 2, 3, 6, 7, 9, 10, 11

NP_TO_ONNX = {
    np.dtype(np.float32): FLOAT, np.dtype(np.float64): DOUBLE,
    np.dtype(np.int64): INT64, np.dtype(np.int32): INT32,
    np.dtype(np.bool_): BOOL, np.dtype(np.float16): FLOAT16,
    np.dtype(np.uint8): UINT8, np.dtype(np.int8): INT8,
}
ONNX_TO_NP = {v: k for k, v in NP_TO_ONNX.items()}

# --- AttributeProto.AttributeType enum ---
A_FLOAT, A_INT, A_STRING, A_TENSOR, A_GRAPH = 1, 2, 3, 4, 5
A_FLOATS, A_INTS, A_STRINGS = 6, 7, 8


# ---------------- wire-format primitives ----------------

def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(fieldnum: int, wire: int) -> bytes:
    return _varint((fieldnum << 3) | wire)


def _len_field(fieldnum: int, payload: bytes) -> bytes:
    return _tag(fieldnum, 2) + _varint(len(payload)) + payload


def _int_field(fieldnum: int, value: int) -> bytes:
    if value < 0:
        value += 1 << 64  # two's-complement varint
    return _tag(fieldnum, 0) + _varint(value)


def _str_field(fieldnum: int, value: str) -> bytes:
    return _len_field(fieldnum, value.encode())


def _float_field(fieldnum: int, value: float) -> bytes:
    return _tag(fieldnum, 5) + struct.pack("<f", value)


# ---------------- model structures ----------------

@dataclass
class Tensor:
    name: str
    array: np.ndarray

    def encode(self) -> bytes:
        shape = np.shape(self.array)
        a = np.ascontiguousarray(self.array)  # 0-d comes back as (1,)
        out = b"".join(_int_field(1, int(d)) for d in shape)
        out += _int_field(2, NP_TO_ONNX[a.dtype])
        out += _str_field(8, self.name)
        out += _len_field(9, a.tobytes())  # raw_data, little-endian
        return out


@dataclass
class Attr:
    name: str
    value: Union[int, float, bytes, list, Tensor]

    def encode(self) -> bytes:
        out = _str_field(1, self.name)
        v = self.value
        if isinstance(v, bool):
            v = int(v)
        if isinstance(v, int):
            out += _int_field(3, v) + _int_field(20, A_INT)
        elif isinstance(v, float):
            out += _float_field(2, v) + _int_field(20, A_FLOAT)
        elif isinstance(v, bytes):
            out += _len_field(4, v) + _int_field(20, A_STRING)
        elif isinstance(v, str):
            out += _len_field(4, v.encode()) + _int_field(20, A_STRING)
        elif isinstance(v, Tensor):
            out += _len_field(5, v.encode()) + _int_field(20, A_TENSOR)
        elif isinstance(v, (list, tuple)):
            if all(isinstance(x, int) for x in v):
                out += b"".join(_int_field(8, int(x)) for x in v)
                out += _int_field(20, A_INTS)
            elif all(isinstance(x, float) for x in v):
                out += b"".join(_tag(7, 5) + struct.pack("<f", x) for x in v)
                out += _int_field(20, A_FLOATS)
            else:
                raise TypeError(f"attr list {self.name}: {v!r}")
        else:
            raise TypeError(f"attr {self.name}: {v!r}")
        return out


@dataclass
class Node:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Union[int, float, bytes, list, Tensor]] = \
        field(default_factory=dict)
    name: str = ""

    def encode(self) -> bytes:
        out = b"".join(_str_field(1, i) for i in self.inputs)
        out += b"".join(_str_field(2, o) for o in self.outputs)
        if self.name:
            out += _str_field(3, self.name)
        out += _str_field(4, self.op_type)
        out += b"".join(_len_field(5, Attr(k, v).encode())
                        for k, v in sorted(self.attrs.items()))
        return out


@dataclass
class ValueInfo:
    name: str
    elem_type: int
    # dims: int for fixed, str for a named dynamic dim
    dims: Sequence[Union[int, str]]

    def encode(self) -> bytes:
        shape = b""
        for d in self.dims:
            if isinstance(d, str):
                dim = _str_field(2, d)  # dim_param
            else:
                dim = _int_field(1, int(d))  # dim_value
            shape += _len_field(1, dim)
        ttype = _int_field(1, self.elem_type) + _len_field(2, shape)
        return _str_field(1, self.name) + _len_field(2, _len_field(1, ttype))


@dataclass
class Graph:
    name: str
    nodes: List[Node]
    inputs: List[ValueInfo]
    outputs: List[ValueInfo]
    initializers: List[Tensor]

    def encode(self) -> bytes:
        out = b"".join(_len_field(1, n.encode()) for n in self.nodes)
        out += _str_field(2, self.name)
        out += b"".join(_len_field(5, t.encode())
                        for t in self.initializers)
        out += b"".join(_len_field(11, v.encode()) for v in self.inputs)
        out += b"".join(_len_field(12, v.encode()) for v in self.outputs)
        return out


def encode_model(graph: Graph, opset: int = 14, ir_version: int = 8,
                 producer: str = "wespeaker-tpu") -> bytes:
    opset_msg = _str_field(1, "") + _int_field(2, opset)
    out = _int_field(1, ir_version)
    out += _str_field(2, producer)
    out += _len_field(7, graph.encode())
    out += _len_field(8, opset_msg)
    return out


# ---------------- reader (independent decode path for tests) ----------------

def _read_varint(buf: bytes, pos: int):
    result, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _read_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message payload."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        fieldnum, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = buf[pos:pos + 4]
            pos += 4
        elif wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"wire type {wire}")
        yield fieldnum, wire, val


def _unpack_varints(buf: bytes):
    """Packed repeated scalar payload -> list of varints (canonical proto3
    serializers pack repeated int64/int32; our writer emits them unpacked —
    a conforming reader must accept both)."""
    out, pos = [], 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(v)
    return out


def _unpack_f32(buf: bytes):
    return list(struct.unpack(f"<{len(buf) // 4}f", buf))


def _decode_tensor(buf: bytes) -> Tensor:
    dims, dtype, name, raw = [], FLOAT, "", b""
    floats, int64s, int32s = [], [], []
    for f, w, v in _read_fields(buf):
        if f == 1:
            dims.extend(_unpack_varints(v) if w == 2 else [v])
        elif f == 2:
            dtype = v
        elif f == 8:
            name = v.decode()
        elif f == 9:
            raw = v
        elif f == 4:
            floats.extend(_unpack_f32(v) if w == 2
                          else [struct.unpack("<f", v)[0]])
        elif f == 7:
            int64s.extend(_unpack_varints(v) if w == 2 else [v])
        elif f == 5:
            int32s.extend(_unpack_varints(v) if w == 2 else [v])
    np_dtype = ONNX_TO_NP[dtype]
    if raw:
        arr = np.frombuffer(raw, dtype=np_dtype).reshape(dims)
    elif floats:
        arr = np.asarray(floats, np_dtype).reshape(dims)
    elif int64s or int32s:
        arr = np.asarray(int64s or int32s, np_dtype).reshape(dims)
    else:
        arr = np.zeros(dims, np_dtype)
    return Tensor(name, arr)


def _decode_attr(buf: bytes):
    name, atype = "", None
    ival, fval, sval, tval, ints, floats = None, None, None, None, [], []
    for f, w, v in _read_fields(buf):
        if f == 1:
            name = v.decode()
        elif f == 20:
            atype = v
        elif f == 3:
            ival = v if v < (1 << 63) else v - (1 << 64)
        elif f == 2:
            fval = struct.unpack("<f", v)[0]
        elif f == 4:
            sval = v
        elif f == 5:
            tval = _decode_tensor(v)
        elif f == 8:
            vs = _unpack_varints(v) if w == 2 else [v]
            ints.extend(x if x < (1 << 63) else x - (1 << 64) for x in vs)
        elif f == 7:
            floats.extend(_unpack_f32(v) if w == 2
                          else [struct.unpack("<f", v)[0]])
    if atype == A_INT:
        return name, ival
    if atype == A_FLOAT:
        return name, fval
    if atype == A_STRING:
        return name, sval
    if atype == A_TENSOR:
        return name, tval
    if atype == A_INTS:
        return name, ints
    if atype == A_FLOATS:
        return name, floats
    return name, ival if ival is not None else (ints or fval or sval)


def _decode_node(buf: bytes) -> Node:
    node = Node("", [], [])
    for f, w, v in _read_fields(buf):
        if f == 1:
            node.inputs.append(v.decode())
        elif f == 2:
            node.outputs.append(v.decode())
        elif f == 3:
            node.name = v.decode()
        elif f == 4:
            node.op_type = v.decode()
        elif f == 5:
            k, val = _decode_attr(v)
            node.attrs[k] = val
    return node


def _decode_value_info(buf: bytes) -> ValueInfo:
    name, elem, dims = "", FLOAT, []
    for f, w, v in _read_fields(buf):
        if f == 1:
            name = v.decode()
        elif f == 2:  # TypeProto
            for f2, w2, v2 in _read_fields(v):
                if f2 == 1:  # tensor_type
                    for f3, w3, v3 in _read_fields(v2):
                        if f3 == 1:
                            elem = v3
                        elif f3 == 2:  # shape
                            for f4, w4, v4 in _read_fields(v3):
                                if f4 == 1:  # dim
                                    d: Union[int, str, None] = None
                                    for f5, w5, v5 in _read_fields(v4):
                                        if f5 == 1:
                                            d = v5
                                        elif f5 == 2:
                                            d = v5.decode()
                                    dims.append(d)
    return ValueInfo(name, elem, dims)


def _decode_graph(buf: bytes) -> Graph:
    g = Graph("", [], [], [], [])
    for f, w, v in _read_fields(buf):
        if f == 1:
            g.nodes.append(_decode_node(v))
        elif f == 2:
            g.name = v.decode()
        elif f == 5:
            g.initializers.append(_decode_tensor(v))
        elif f == 11:
            g.inputs.append(_decode_value_info(v))
        elif f == 12:
            g.outputs.append(_decode_value_info(v))
    return g


@dataclass
class Model:
    graph: Graph
    opset: int
    ir_version: int
    producer: str


def decode_model(buf: bytes) -> Model:
    graph: Optional[Graph] = None
    opset, ir_version, producer = 0, 0, ""
    for f, w, v in _read_fields(buf):
        if f == 1:
            ir_version = v
        elif f == 2:
            producer = v.decode()
        elif f == 7:
            graph = _decode_graph(v)
        elif f == 8:
            for f2, w2, v2 in _read_fields(v):
                if f2 == 2:
                    opset = v2
    assert graph is not None, "no graph in model"
    return Model(graph, opset, ir_version, producer)
