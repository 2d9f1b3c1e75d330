"""Dependency-free ONNX protobuf serialisation.

A copy of `nanowakeword_tpu/export/onnx_proto.py` (numpy only): the
protobuf wire format (varint and length-delimited encoding) for the subset
of onnx.proto that the exporter writes and the runtimes read back:
ModelProto, GraphProto, NodeProto, AttributeProto, TensorProto,
ValueInfoProto and the type and shape messages. The only difference is
`model()`'s default producer, "nanowakeword_tpu_torch".

Field numbers follow onnx/onnx.proto (apache-2.0, stable since IR v3):
  ModelProto:    ir_version=1  producer_name=2 producer_version=3 domain=4
                 model_version=5 doc_string=6 graph=7 opset_import=8
  OperatorSetId: domain=1 version=2
  GraphProto:    node=1 name=2 initializer=5 doc_string=10 input=11
                 output=12 value_info=13
  NodeProto:     input=1 output=2 name=3 op_type=4 attribute=5 doc_string=6
                 domain=7
  AttributeProto name=1 f=2 i=3 s=4 t=5 floats=7 ints=8 strings=9 type=20
                 (type enum: FLOAT=1 INT=2 STRING=3 TENSOR=4 FLOATS=6
                  INTS=7 STRINGS=8)
  TensorProto:   dims=1 data_type=2 float_data=4 int64_data=7 name=8
                 raw_data=9   (data_type enum: FLOAT=1 INT8=3 INT64=7)
  ValueInfo:     name=1 type=2
  TypeProto:     tensor_type=1 ; Tensor: elem_type=1 shape=2
  TensorShape:   dim=1 ; Dimension: dim_value=1 dim_param=2

The reader half lets an export be checked without the `onnx` package (the
numpy evaluator, onnx_eval.py, runs the re-parsed graph) and feeds the
torch runtime (onnx_torch.py); it also reads files of other tools for the
ops those support.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np

# wire types
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5

FLOAT, INT8, INT64 = 1, 3, 7  # TensorProto.DataType
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR = 1, 2, 3, 4
ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS = 6, 7, 8


# -- low-level protobuf encoding ------------------------------------------------

def _varint(value: int) -> bytes:
    if value < 0:
        value += 1 << 64     # protobuf negative int64 -> 10-byte varint
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def f_varint(field: int, value: int) -> bytes:
    return _tag(field, _VARINT) + _varint(int(value))


def f_bytes(field: int, value: Union[bytes, str]) -> bytes:
    if isinstance(value, str):
        value = value.encode("utf-8")
    return _tag(field, _LEN) + _varint(len(value)) + value


def f_msg(field: int, encoded: bytes) -> bytes:
    return f_bytes(field, encoded)


def f_float(field: int, value: float) -> bytes:
    return _tag(field, _I32) + np.float32(value).tobytes()


def f_packed_floats(field: int, values) -> bytes:
    raw = np.asarray(values, np.float32).tobytes()
    return _tag(field, _LEN) + _varint(len(raw)) + raw


def f_packed_varints(field: int, values) -> bytes:
    raw = b"".join(_varint(int(v)) for v in values)
    return _tag(field, _LEN) + _varint(len(raw)) + raw


# -- low-level protobuf decoding --------------------------------------------------

def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    if result >= 1 << 63:     # negative int64
        result -= 1 << 64
    return result, pos


def parse_message(buf: bytes) -> Dict[int, list]:
    """Decode one message into {field_number: [raw values in order]}.

    Varint fields decode to int; 32/64-bit to bytes; length-delimited to
    bytes (caller re-parses sub-messages / strings / packed arrays).
    """
    fields: Dict[int, list] = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 0x7
        if wire == _VARINT:
            value, pos = _read_varint(buf, pos)
        elif wire == _LEN:
            length, pos = _read_varint(buf, pos)
            value = buf[pos:pos + length]
            pos += length
        elif wire == _I32:
            value = buf[pos:pos + 4]
            pos += 4
        elif wire == _I64:
            value = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(field, []).append(value)
    return fields


def _unpack_varints(raw: bytes) -> List[int]:
    out, pos = [], 0
    while pos < len(raw):
        v, pos = _read_varint(raw, pos)
        out.append(v)
    return out


# -- ONNX message constructors -----------------------------------------------------

def tensor(name: str, array: np.ndarray) -> bytes:
    array = np.asarray(array)
    if array.dtype == np.int64:
        dtype = INT64
    elif array.dtype == np.int8:
        dtype = INT8
    else:
        array = array.astype(np.float32)
        dtype = FLOAT
    return (f_packed_varints(1, array.shape)
            + f_varint(2, dtype)
            + f_bytes(8, name)
            + f_bytes(9, array.tobytes()))


def attribute(name: str, value) -> bytes:
    out = f_bytes(1, name)
    if isinstance(value, float):
        out += f_float(2, value) + f_varint(20, ATTR_FLOAT)
    elif isinstance(value, bool) or isinstance(value, int):
        out += f_varint(3, int(value)) + f_varint(20, ATTR_INT)
    elif isinstance(value, str):
        out += f_bytes(4, value) + f_varint(20, ATTR_STRING)
    elif isinstance(value, bytes):                  # encoded TensorProto
        out += f_msg(5, value) + f_varint(20, ATTR_TENSOR)
    elif isinstance(value, (list, tuple, np.ndarray)):
        values = list(value)
        if values and isinstance(values[0], float):
            out += b"".join(f_float(7, v) for v in values)
            out += f_varint(20, ATTR_FLOATS)
        elif values and isinstance(values[0], str):
            out += b"".join(f_bytes(9, v) for v in values)
            out += f_varint(20, ATTR_STRINGS)
        else:
            out += b"".join(f_varint(8, int(v)) for v in values)
            out += f_varint(20, ATTR_INTS)
    else:
        raise TypeError(f"unsupported attribute value: {value!r}")
    return out


def node(op_type: str, inputs, outputs, name: str = "", **attrs) -> bytes:
    out = b"".join(f_bytes(1, i) for i in inputs)
    out += b"".join(f_bytes(2, o) for o in outputs)
    if name:
        out += f_bytes(3, name)
    out += f_bytes(4, op_type)
    out += b"".join(f_msg(5, attribute(k, v)) for k, v in attrs.items())
    return out


def value_info(name: str, shape, elem_type: int = FLOAT) -> bytes:
    dims = b""
    for d in shape:
        if isinstance(d, str):
            dims += f_msg(1, f_bytes(2, d))       # symbolic dim_param
        else:
            dims += f_msg(1, f_varint(1, int(d)))
    tensor_type = (f_varint(1, elem_type) + f_msg(2, dims))
    return f_bytes(1, name) + f_msg(2, f_msg(1, tensor_type))


def graph(nodes, name: str, inputs, outputs, initializers,
          doc: str = "") -> bytes:
    out = b"".join(f_msg(1, n) for n in nodes)
    out += f_bytes(2, name)
    out += b"".join(f_msg(5, t) for t in initializers)
    if doc:
        out += f_bytes(10, doc)
    out += b"".join(f_msg(11, vi) for vi in inputs)
    out += b"".join(f_msg(12, vi) for vi in outputs)
    return out


def model(graph_bytes: bytes, opset: int = 17, ir_version: int = 8,
          producer: str = "nanowakeword_tpu_torch", doc: str = "") -> bytes:
    out = f_varint(1, ir_version)
    out += f_bytes(2, producer)
    out += f_bytes(3, "2.0")
    if doc:
        out += f_bytes(6, doc)
    out += f_msg(7, graph_bytes)
    out += f_msg(8, f_bytes(1, "") + f_varint(2, opset))
    return out


# -- ONNX message readers (subset) ----------------------------------------------

class ParsedTensor:
    def __init__(self, raw: bytes):
        f = parse_message(raw)
        self.name = f.get(8, [b""])[0].decode("utf-8")
        dims = []
        for item in f.get(1, []):
            if isinstance(item, int):
                dims.append(item)
            else:                                  # packed
                dims.extend(_unpack_varints(item))
        self.dims = dims
        self.data_type = f.get(2, [FLOAT])[0]
        np_dtype = {INT64: np.int64, INT8: np.int8}.get(
            self.data_type, np.float32)
        if 9 in f:                                 # raw_data
            self.array = np.frombuffer(f[9][0], np_dtype).reshape(dims)
        elif 4 in f and self.data_type == FLOAT:   # packed float_data
            self.array = np.frombuffer(f[4][0], np.float32).reshape(dims)
        elif 7 in f and self.data_type == INT64:
            vals = []
            for item in f[7]:
                vals.extend(_unpack_varints(item)
                            if isinstance(item, bytes) else [item])
            self.array = np.asarray(vals, np.int64).reshape(dims)
        else:
            self.array = np.zeros(dims, np_dtype)


class ParsedAttribute:
    def __init__(self, raw: bytes):
        f = parse_message(raw)
        self.name = f[1][0].decode("utf-8")
        self.type = f.get(20, [0])[0]
        if self.type == ATTR_FLOAT:
            self.value = float(np.frombuffer(f[2][0], np.float32)[0])
        elif self.type == ATTR_INT:
            self.value = int(f[3][0])
        elif self.type == ATTR_STRING:
            self.value = f[4][0].decode("utf-8")
        elif self.type == ATTR_TENSOR:
            self.value = ParsedTensor(f[5][0]).array
        elif self.type == ATTR_FLOATS:
            self.value = [float(np.frombuffer(v, np.float32)[0])
                          for v in f.get(7, [])]
        elif self.type == ATTR_INTS:
            vals = []
            for item in f.get(8, []):
                vals.extend(_unpack_varints(item)
                            if isinstance(item, bytes) else [item])
            self.value = vals
        elif self.type == ATTR_STRINGS:
            self.value = [v.decode("utf-8") for v in f.get(9, [])]
        else:
            self.value = None


class ParsedNode:
    def __init__(self, raw: bytes):
        f = parse_message(raw)
        self.inputs = [v.decode("utf-8") for v in f.get(1, [])]
        self.outputs = [v.decode("utf-8") for v in f.get(2, [])]
        self.name = f.get(3, [b""])[0].decode("utf-8")
        self.op_type = f.get(4, [b""])[0].decode("utf-8")
        self.attrs = {a.name: a.value
                      for a in (ParsedAttribute(v) for v in f.get(5, []))}


class ParsedValueInfo:
    def __init__(self, raw: bytes):
        f = parse_message(raw)
        self.name = f[1][0].decode("utf-8")
        self.shape: List[Union[int, str]] = []
        type_f = parse_message(f[2][0]) if 2 in f else {}
        if 1 in type_f:
            tt = parse_message(type_f[1][0])
            if 2 in tt:
                for dim_raw in parse_message(tt[2][0]).get(1, []):
                    d = parse_message(dim_raw)
                    if 1 in d:
                        self.shape.append(int(d[1][0]))
                    elif 2 in d:
                        self.shape.append(d[2][0].decode("utf-8"))


class ParsedGraph:
    def __init__(self, raw: bytes):
        f = parse_message(raw)
        self.name = f.get(2, [b""])[0].decode("utf-8")
        self.nodes = [ParsedNode(v) for v in f.get(1, [])]
        self.initializers = {t.name: t.array
                             for t in (ParsedTensor(v) for v in f.get(5, []))}
        self.inputs = [ParsedValueInfo(v) for v in f.get(11, [])]
        self.outputs = [ParsedValueInfo(v) for v in f.get(12, [])]


class ParsedModel:
    def __init__(self, data: bytes):
        f = parse_message(data)
        self.ir_version = f.get(1, [0])[0]
        self.producer = f.get(2, [b""])[0].decode("utf-8")
        self.graph = ParsedGraph(f[7][0])
        self.opsets = {}
        for raw in f.get(8, []):
            op = parse_message(raw)
            domain = op.get(1, [b""])[0].decode("utf-8")
            self.opsets[domain] = op.get(2, [0])[0]


def load_model(path_or_bytes: Union[str, bytes]) -> ParsedModel:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return ParsedModel(bytes(path_or_bytes))
    with open(path_or_bytes, "rb") as f:
        return ParsedModel(f.read())
