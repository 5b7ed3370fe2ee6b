"""A reader and a writer of TensorFlow's frozen GraphDef, with no
TensorFlow and no protobuf package (the port's counterpart of
``tf_graph.load_graph_def``, vaw_tpu/evals/tf_graph.py:36, which parses
through TF's ``graph_pb2``).

The protobuf wire format is decoded directly for the subset of the schema
that a frozen inference graph uses and ``tf_graph.GraphDefFunction``
reads: ``GraphDef.{node, versions.producer}``, ``NodeDef.{name, op, input,
device, attr}``, ``AttrValue.{list, s, i, f, b, type, shape, tensor}``,
``TensorProto.{dtype, tensor_shape, tensor_content, float_val, double_val,
int_val, int64_val, bool_val}`` and ``TensorShapeProto.{dim.size,
unknown_rank}``. Any other field is skipped by its wire type, as protobuf
does with a field it does not know. ``FIELDS`` holds the field numbers,
those of TensorFlow's ``.proto`` files.

A constant's ``tensor_content`` stays a memoryview of the file's bytes
until ``TensorProto.numpy`` reads it with ``np.frombuffer``: no Python loop
runs over a payload (the InceptionV3 graph is 95 MB, nearly all of it
weights). A tensor given by fewer values than its shape holds repeats its
last value, as TensorFlow's ``MakeNdarray`` does (a splat constant).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

__all__ = ["FIELDS", "DTYPES", "GraphDef", "NodeDef", "AttrValue", "ListValue",
           "TensorProto", "TensorShape", "parse_graph_def", "load_graph_def",
           "serialize_graph_def", "tensor_proto"]

# Field numbers of each message (tensorflow/core/framework/*.proto).
FIELDS: Dict[str, Dict[str, int]] = {
    "GraphDef": {"node": 1, "versions": 4},
    "VersionDef": {"producer": 1},
    "NodeDef": {"name": 1, "op": 2, "input": 3, "device": 4, "attr": 5},
    "NodeDef.AttrEntry": {"key": 1, "value": 2},
    "AttrValue": {"list": 1, "s": 2, "i": 3, "f": 4, "b": 5, "type": 6, "shape": 7,
                  "tensor": 8},
    "AttrValue.ListValue": {"s": 2, "i": 3, "f": 4, "b": 5, "type": 6, "shape": 7,
                            "tensor": 8},
    "TensorProto": {"dtype": 1, "tensor_shape": 2, "tensor_content": 4, "float_val": 5,
                    "double_val": 6, "int_val": 7, "int64_val": 10, "bool_val": 11},
    "TensorShapeProto": {"dim": 2, "unknown_rank": 3},
    "TensorShapeProto.Dim": {"size": 1},
}

# DataType enum -> numpy dtype (tensorflow/core/framework/types.proto).
DTYPES: Dict[int, type] = {
    1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16, 6: np.int8,
    9: np.int64, 10: np.bool_, 17: np.uint16, 19: np.float16, 22: np.uint32,
    23: np.uint64,
}
_ENUM = {np.dtype(v): k for k, v in DTYPES.items()}
# Which TensorProto value list holds each dtype's values.
_VALUE_FIELD = {1: "float_val", 2: "double_val", 3: "int_val", 4: "int_val",
                5: "int_val", 6: "int_val", 9: "int64_val", 10: "bool_val"}

_VARINT, _FIXED64, _BYTES, _FIXED32 = 0, 1, 2, 5


@dataclasses.dataclass
class TensorShape:
    dims: List[int] = dataclasses.field(default_factory=list)
    unknown_rank: bool = False


@dataclasses.dataclass
class TensorProto:
    dtype: int = 0
    tensor_shape: TensorShape = dataclasses.field(default_factory=TensorShape)
    tensor_content: Union[bytes, memoryview] = b""
    float_val: List[float] = dataclasses.field(default_factory=list)
    double_val: List[float] = dataclasses.field(default_factory=list)
    int_val: List[int] = dataclasses.field(default_factory=list)
    int64_val: List[int] = dataclasses.field(default_factory=list)
    bool_val: List[bool] = dataclasses.field(default_factory=list)

    def numpy(self) -> np.ndarray:
        """The tensor's value; read-only when it is a view of the file."""
        dtype = DTYPES.get(self.dtype)
        if dtype is None:
            raise NotImplementedError(f"tensor dtype enum {self.dtype}")
        shape = tuple(self.tensor_shape.dims)
        if len(self.tensor_content):
            return np.frombuffer(self.tensor_content, dtype=dtype).reshape(shape)
        n = int(np.prod(shape))
        vals = np.asarray(getattr(self, _VALUE_FIELD.get(self.dtype, "float_val")),
                          dtype=dtype)
        if vals.size == 0:
            return np.zeros(shape, dtype)
        if vals.size < n:  # a splat: the last value fills the rest
            vals = np.concatenate([vals, np.full(n - vals.size, vals[-1], dtype)])
        return vals.reshape(shape)


@dataclasses.dataclass
class ListValue:
    s: List[bytes] = dataclasses.field(default_factory=list)
    i: List[int] = dataclasses.field(default_factory=list)
    f: List[float] = dataclasses.field(default_factory=list)
    b: List[bool] = dataclasses.field(default_factory=list)
    type: List[int] = dataclasses.field(default_factory=list)
    shape: List[TensorShape] = dataclasses.field(default_factory=list)
    tensor: List[TensorProto] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class AttrValue:
    """One of the fields is set; the others read as protobuf's defaults."""
    list: Optional[ListValue] = None
    s: bytes = b""
    i: int = 0
    f: float = 0.0
    b: bool = False
    type: int = 0
    shape: Optional[TensorShape] = None
    tensor: Optional[TensorProto] = None


@dataclasses.dataclass
class NodeDef:
    name: str = ""
    op: str = ""
    input: List[str] = dataclasses.field(default_factory=list)
    device: str = ""
    attr: Dict[str, AttrValue] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class GraphDef:
    node: List[NodeDef] = dataclasses.field(default_factory=list)
    producer: int = 0


# ----------------------------------------------------------------- reader


def _varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if byte < 0x80:
            return result, pos
        shift += 7


def _signed(v: int) -> int:
    """A varint of an int32/int64 field: negatives are 10-byte two's
    complement."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _fields(buf: memoryview) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of each field of one message: an int
    for a varint, a memoryview for the rest."""
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == _VARINT:
            val, pos = _varint(buf, pos)
        elif wire == _BYTES:
            n, pos = _varint(buf, pos)
            val, pos = buf[pos:pos + n], pos + n
        elif wire == _FIXED32:
            val, pos = buf[pos:pos + 4], pos + 4
        elif wire == _FIXED64:
            val, pos = buf[pos:pos + 8], pos + 8
        else:
            raise ValueError(f"unsupported protobuf wire type {wire} (field {num})")
        if pos > end:
            raise ValueError("truncated protobuf message")
        yield num, wire, val


def _varints(wire: int, val) -> List[int]:
    """A repeated varint field's values, packed or one at a time."""
    if wire == _VARINT:
        return [val]
    out, pos = [], 0
    while pos < len(val):
        v, pos = _varint(val, pos)
        out.append(v)
    return out


def _fixed(val, fmt: str) -> List[float]:
    """A repeated fixed-width field's values (packed or one element)."""
    return np.frombuffer(val, dtype=fmt).tolist()


def _str(val) -> str:
    return bytes(val).decode("utf-8")


def _shape(buf) -> TensorShape:
    f = FIELDS["TensorShapeProto"]
    shape = TensorShape()
    for num, wire, val in _fields(buf):
        if num == f["dim"]:
            size = 0
            for n2, _, v2 in _fields(val):
                if n2 == FIELDS["TensorShapeProto.Dim"]["size"]:
                    size = _signed(v2)
            shape.dims.append(size)
        elif num == f["unknown_rank"]:
            shape.unknown_rank = bool(val)
    return shape


def _tensor(buf) -> TensorProto:
    f = FIELDS["TensorProto"]
    t = TensorProto()
    for num, wire, val in _fields(buf):
        if num == f["dtype"]:
            t.dtype = val
        elif num == f["tensor_shape"]:
            t.tensor_shape = _shape(val)
        elif num == f["tensor_content"]:
            t.tensor_content = val
        elif num == f["float_val"]:
            t.float_val += _fixed(val, "<f4")
        elif num == f["double_val"]:
            t.double_val += _fixed(val, "<f8")
        elif num == f["int_val"]:
            t.int_val += [_signed(v) for v in _varints(wire, val)]
        elif num == f["int64_val"]:
            t.int64_val += [_signed(v) for v in _varints(wire, val)]
        elif num == f["bool_val"]:
            t.bool_val += [bool(v) for v in _varints(wire, val)]
    return t


def _list(buf) -> ListValue:
    f = FIELDS["AttrValue.ListValue"]
    out = ListValue()
    for num, wire, val in _fields(buf):
        if num == f["s"]:
            out.s.append(bytes(val))
        elif num == f["i"]:
            out.i += [_signed(v) for v in _varints(wire, val)]
        elif num == f["f"]:
            out.f += _fixed(val, "<f4")
        elif num == f["b"]:
            out.b += [bool(v) for v in _varints(wire, val)]
        elif num == f["type"]:
            out.type += _varints(wire, val)
        elif num == f["shape"]:
            out.shape.append(_shape(val))
        elif num == f["tensor"]:
            out.tensor.append(_tensor(val))
    return out


def _attr(buf) -> AttrValue:
    f = FIELDS["AttrValue"]
    a = AttrValue()
    for num, wire, val in _fields(buf):
        if num == f["list"]:
            a.list = _list(val)
        elif num == f["s"]:
            a.s = bytes(val)
        elif num == f["i"]:
            a.i = _signed(val)
        elif num == f["f"]:
            a.f = struct.unpack("<f", val)[0]
        elif num == f["b"]:
            a.b = bool(val)
        elif num == f["type"]:
            a.type = val
        elif num == f["shape"]:
            a.shape = _shape(val)
        elif num == f["tensor"]:
            a.tensor = _tensor(val)
    return a


def _node(buf) -> NodeDef:
    f, fe = FIELDS["NodeDef"], FIELDS["NodeDef.AttrEntry"]
    node = NodeDef()
    for num, _, val in _fields(buf):
        if num == f["name"]:
            node.name = _str(val)
        elif num == f["op"]:
            node.op = _str(val)
        elif num == f["input"]:
            node.input.append(_str(val))
        elif num == f["device"]:
            node.device = _str(val)
        elif num == f["attr"]:
            key, value = "", AttrValue()
            for n2, _, v2 in _fields(val):
                if n2 == fe["key"]:
                    key = _str(v2)
                elif n2 == fe["value"]:
                    value = _attr(v2)
            node.attr[key] = value
    return node


def parse_graph_def(data: Union[bytes, memoryview]) -> GraphDef:
    """A serialized GraphDef -> GraphDef. Constants' payloads stay views of
    `data`."""
    f = FIELDS["GraphDef"]
    gd = GraphDef()
    for num, _, val in _fields(memoryview(data)):
        if num == f["node"]:
            gd.node.append(_node(val))
        elif num == f["versions"]:
            for n2, _, v2 in _fields(val):
                if n2 == FIELDS["VersionDef"]["producer"]:
                    gd.producer = _signed(v2)
    return gd


def load_graph_def(path: str) -> GraphDef:
    """Parse the frozen GraphDef at `path`."""
    with open(path, "rb") as fh:
        return parse_graph_def(fh.read())


# ----------------------------------------------------------------- writer


def _enc_varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        byte = v & 0x7F
        v >>= 7
        if v:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _key(num: int, wire: int) -> bytes:
    return _enc_varint(num << 3 | wire)


def _put_bytes(num: int, payload: bytes) -> bytes:
    return _key(num, _BYTES) + _enc_varint(len(payload)) + payload


def _put_varint(num: int, v: int) -> bytes:
    return _key(num, _VARINT) + _enc_varint(int(v))


def _put_packed_varints(num: int, vals) -> bytes:
    return _put_bytes(num, b"".join(_enc_varint(int(v)) for v in vals)) if len(vals) else b""


def _put_packed(num: int, vals, fmt: str) -> bytes:
    return _put_bytes(num, np.asarray(vals, fmt).tobytes()) if len(vals) else b""


def _ser_shape(shape: TensorShape) -> bytes:
    f = FIELDS["TensorShapeProto"]
    out = b"".join(_put_bytes(f["dim"], _put_varint(FIELDS["TensorShapeProto.Dim"]["size"], d)
                              if d else b"") for d in shape.dims)
    if shape.unknown_rank:
        out += _put_varint(f["unknown_rank"], 1)
    return out


def _ser_tensor(t: TensorProto) -> bytes:
    f = FIELDS["TensorProto"]
    out = _put_varint(f["dtype"], t.dtype) + _put_bytes(f["tensor_shape"],
                                                        _ser_shape(t.tensor_shape))
    if len(t.tensor_content):
        out += _put_bytes(f["tensor_content"], bytes(t.tensor_content))
    out += _put_packed(f["float_val"], t.float_val, "<f4")
    out += _put_packed(f["double_val"], t.double_val, "<f8")
    out += _put_packed_varints(f["int_val"], t.int_val)
    out += _put_packed_varints(f["int64_val"], t.int64_val)
    out += _put_packed_varints(f["bool_val"], t.bool_val)
    return out


def _ser_list(lv: ListValue) -> bytes:
    f = FIELDS["AttrValue.ListValue"]
    return (b"".join(_put_bytes(f["s"], s) for s in lv.s)
            + _put_packed_varints(f["i"], lv.i) + _put_packed(f["f"], lv.f, "<f4")
            + _put_packed_varints(f["b"], lv.b) + _put_packed_varints(f["type"], lv.type)
            + b"".join(_put_bytes(f["shape"], _ser_shape(s)) for s in lv.shape)
            + b"".join(_put_bytes(f["tensor"], _ser_tensor(t)) for t in lv.tensor))


def _ser_attr(a: AttrValue) -> bytes:
    """The one field that is set (the first non-default one)."""
    f = FIELDS["AttrValue"]
    if a.list is not None:
        return _put_bytes(f["list"], _ser_list(a.list))
    if a.tensor is not None:
        return _put_bytes(f["tensor"], _ser_tensor(a.tensor))
    if a.shape is not None:
        return _put_bytes(f["shape"], _ser_shape(a.shape))
    if a.s:
        return _put_bytes(f["s"], a.s)
    if a.type:
        return _put_varint(f["type"], a.type)
    if a.f:
        return _key(f["f"], _FIXED32) + struct.pack("<f", a.f)
    if a.i:
        return _put_varint(f["i"], a.i)
    return _put_varint(f["b"], int(a.b))


def _ser_node(node: NodeDef) -> bytes:
    f, fe = FIELDS["NodeDef"], FIELDS["NodeDef.AttrEntry"]
    out = _put_bytes(f["name"], node.name.encode()) + _put_bytes(f["op"], node.op.encode())
    out += b"".join(_put_bytes(f["input"], i.encode()) for i in node.input)
    if node.device:
        out += _put_bytes(f["device"], node.device.encode())
    for key, value in node.attr.items():
        out += _put_bytes(f["attr"], _put_bytes(fe["key"], key.encode())
                          + _put_bytes(fe["value"], _ser_attr(value)))
    return out


def serialize_graph_def(gd: GraphDef) -> bytes:
    """GraphDef -> its wire bytes, which TensorFlow's ``ParseFromString``
    reads."""
    f = FIELDS["GraphDef"]
    out = b"".join(_put_bytes(f["node"], _ser_node(n)) for n in gd.node)
    return out + _put_bytes(f["versions"], _put_varint(FIELDS["VersionDef"]["producer"],
                                                       gd.producer))


def tensor_proto(value) -> TensorProto:
    """A numpy value as a TensorProto holding its bytes (tensor_content)."""
    arr = np.asarray(value, order="C")  # keeps a 0-d array 0-d
    dtype = _ENUM.get(arr.dtype)
    if dtype is None:
        raise NotImplementedError(f"numpy dtype {arr.dtype}")
    little = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
    return TensorProto(dtype=dtype, tensor_shape=TensorShape(list(arr.shape)),
                       tensor_content=little.tobytes())
