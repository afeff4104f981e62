"""Minimal protobuf wire-format writer/reader for the ONNX schema subset
the exporters emit (a copy of paddle_tpu/onnx/wire.py; reference:
python/paddle/onnx/export.py delegates to paddle2onnx and the onnx
package; the port needs neither, so the serialization is done directly
against the stable ONNX wire format).

Only what the exporters produce is supported: ModelProto /
GraphProto / NodeProto / TensorProto(raw_data) / AttributeProto /
ValueInfoProto with dense-tensor types. Field numbers follow
onnx/onnx.proto (IR version 7, stable since 2020).
"""
import struct

import numpy as np

# ONNX TensorProto.DataType
FLOAT, UINT8, INT8, UINT16, INT16, INT32, INT64 = 1, 2, 3, 4, 5, 6, 7
STRING, BOOL, FLOAT16, DOUBLE, UINT32, UINT64 = 8, 9, 10, 11, 12, 13
BFLOAT16 = 16

_NP2ONNX = {
    "float32": FLOAT, "uint8": UINT8, "int8": INT8, "uint16": UINT16,
    "int16": INT16, "int32": INT32, "int64": INT64, "bool": BOOL,
    "float16": FLOAT16, "float64": DOUBLE, "uint32": UINT32,
    "uint64": UINT64, "bfloat16": BFLOAT16,
}
_ONNX2NP = {v: k for k, v in _NP2ONNX.items()}

# AttributeProto.AttributeType
A_FLOAT, A_INT, A_STRING, A_TENSOR = 1, 2, 3, 4
A_FLOATS, A_INTS, A_STRINGS = 6, 7, 8


def onnx_dtype(np_dtype):
    name = np.dtype(np_dtype).name if not isinstance(np_dtype, str) else np_dtype
    if name not in _NP2ONNX:
        raise ValueError(f"dtype {name} has no ONNX mapping")
    return _NP2ONNX[name]


def np_dtype(onnx_type):
    return np.dtype(_ONNX2NP[onnx_type])


# ------------------------------------------------------------------ encode

def _varint(n):
    n &= (1 << 64) - 1  # negatives as 64-bit two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field, wire_type):
    return _varint((field << 3) | wire_type)


def f_int(field, value):
    return _key(field, 0) + _varint(int(value))


def f_float(field, value):
    return _key(field, 5) + struct.pack("<f", float(value))


def f_bytes(field, payload):
    if isinstance(payload, str):
        payload = payload.encode("utf-8")
    return _key(field, 2) + _varint(len(payload)) + payload


def tensor_proto(name, arr):
    arr = np.ascontiguousarray(arr)
    out = b"".join(f_int(1, d) for d in arr.shape)
    out += f_int(2, onnx_dtype(arr.dtype))
    out += f_bytes(8, name)
    out += f_bytes(9, arr.astype(arr.dtype.newbyteorder("<")).tobytes())
    return out


def attribute_proto(name, value):
    out = f_bytes(1, name)
    if isinstance(value, bool):
        out += f_int(3, int(value)) + f_int(20, A_INT)
    elif isinstance(value, int):
        out += f_int(3, value) + f_int(20, A_INT)
    elif isinstance(value, float):
        out += f_float(2, value) + f_int(20, A_FLOAT)
    elif isinstance(value, str):
        out += f_bytes(4, value) + f_int(20, A_STRING)
    elif isinstance(value, np.ndarray):
        out += f_bytes(5, tensor_proto(name, value)) + f_int(20, A_TENSOR)
    elif isinstance(value, (list, tuple)):
        if value and isinstance(value[0], float):
            out += b"".join(f_float(7, v) for v in value) + f_int(20, A_FLOATS)
        elif all(isinstance(v, str) for v in value) and value:
            out += b"".join(f_bytes(9, v) for v in value) + f_int(20, A_STRINGS)
        else:
            out += b"".join(f_int(8, int(v)) for v in value) + f_int(20, A_INTS)
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return out


def node_proto(op_type, inputs, outputs, name="", attrs=None):
    out = b"".join(f_bytes(1, i) for i in inputs)
    out += b"".join(f_bytes(2, o) for o in outputs)
    if name:
        out += f_bytes(3, name)
    out += f_bytes(4, op_type)
    for k, v in (attrs or {}).items():
        out += f_bytes(5, attribute_proto(k, v))
    return out


def value_info_proto(name, elem_type, shape):
    dims = b"".join(f_bytes(1, f_int(1, d)) for d in shape)  # dim_value only
    tensor_type = f_int(1, elem_type) + f_bytes(2, dims)
    type_proto = f_bytes(1, tensor_type)
    return f_bytes(1, name) + f_bytes(2, type_proto)


def graph_proto(name, nodes, initializers, inputs, outputs):
    """nodes: serialized NodeProto bytes; initializers: {name: ndarray};
    inputs/outputs: [(name, elem_type, shape)]."""
    out = b"".join(f_bytes(1, n) for n in nodes)
    out += f_bytes(2, name)
    out += b"".join(f_bytes(5, tensor_proto(k, v))
                    for k, v in initializers.items())
    out += b"".join(f_bytes(11, value_info_proto(*i)) for i in inputs)
    out += b"".join(f_bytes(12, value_info_proto(*o)) for o in outputs)
    return out


def model_proto(graph, opset_version, producer="paddle_tpu", ir_version=7):
    opset = f_bytes(1, "") + f_int(2, opset_version)
    return (f_int(1, ir_version) + f_bytes(2, producer) + f_bytes(3, "0.0")
            + f_bytes(7, graph) + f_bytes(8, opset))


# ------------------------------------------------------------------ decode

def _read_varint(buf, pos):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            if result >= 1 << 63:  # negative int64
                result -= 1 << 64
            return result, pos
        shift += 7


def _fields(buf):
    """Yield (field_number, wire_type, value) over a serialized message."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            value, pos = _read_varint(buf, pos)
        elif wt == 2:
            length, pos = _read_varint(buf, pos)
            value = buf[pos:pos + length]
            pos += length
        elif wt == 5:
            value = struct.unpack("<f", buf[pos:pos + 4])[0]
            pos += 4
        elif wt == 1:
            value = struct.unpack("<d", buf[pos:pos + 8])[0]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, value


def parse_tensor(buf):
    dims, dtype, name, raw = [], FLOAT, "", b""
    for field, _, value in _fields(buf):
        if field == 1:
            dims.append(value)
        elif field == 2:
            dtype = value
        elif field == 8:
            name = bytes(value).decode("utf-8")
        elif field == 9:
            raw = bytes(value)
    arr = np.frombuffer(raw, dtype=np_dtype(dtype)).reshape(dims)
    return name, arr


def parse_attribute(buf):
    name, atype, val = "", None, {}
    for field, _, value in _fields(buf):
        if field == 1:
            name = bytes(value).decode("utf-8")
        elif field == 2:
            val["f"] = value
        elif field == 3:
            val["i"] = value
        elif field == 4:
            val["s"] = bytes(value).decode("utf-8")
        elif field == 5:
            val["t"] = parse_tensor(value)[1]
        elif field == 7:
            val.setdefault("floats", []).append(value)
        elif field == 8:
            val.setdefault("ints", []).append(value)
        elif field == 9:
            val.setdefault("strings", []).append(
                bytes(value).decode("utf-8"))
        elif field == 20:
            atype = value
    if atype == A_FLOAT:
        return name, val["f"]
    if atype == A_INT:
        return name, val["i"]
    if atype == A_STRING:
        return name, val["s"]
    if atype == A_TENSOR:
        return name, val["t"]
    if atype == A_FLOATS:
        return name, val.get("floats", [])
    if atype == A_INTS:
        return name, val.get("ints", [])
    if atype == A_STRINGS:
        return name, val.get("strings", [])
    raise ValueError(f"attribute {name}: unsupported type {atype}")


def parse_node(buf):
    node = {"input": [], "output": [], "op_type": "", "name": "", "attrs": {}}
    for field, _, value in _fields(buf):
        if field == 1:
            node["input"].append(bytes(value).decode("utf-8"))
        elif field == 2:
            node["output"].append(bytes(value).decode("utf-8"))
        elif field == 3:
            node["name"] = bytes(value).decode("utf-8")
        elif field == 4:
            node["op_type"] = bytes(value).decode("utf-8")
        elif field == 5:
            k, v = parse_attribute(value)
            node["attrs"][k] = v
    return node


def _parse_value_info(buf):
    name, elem_type, shape = "", None, []
    for field, _, value in _fields(buf):
        if field == 1:
            name = bytes(value).decode("utf-8")
        elif field == 2:
            for f2, _, tt in _fields(value):
                if f2 == 1:  # tensor_type
                    for f3, _, v3 in _fields(tt):
                        if f3 == 1:
                            elem_type = v3
                        elif f3 == 2:  # shape
                            for f4, _, dim in _fields(v3):
                                if f4 == 1:
                                    for f5, _, v5 in _fields(dim):
                                        if f5 == 1:
                                            shape.append(v5)
    return {"name": name, "elem_type": elem_type, "shape": shape}


def parse_graph(buf):
    g = {"name": "", "nodes": [], "initializers": {}, "inputs": [],
         "outputs": []}
    for field, _, value in _fields(buf):
        if field == 1:
            g["nodes"].append(parse_node(value))
        elif field == 2:
            g["name"] = bytes(value).decode("utf-8")
        elif field == 5:
            name, arr = parse_tensor(value)
            g["initializers"][name] = arr
        elif field == 11:
            g["inputs"].append(_parse_value_info(value))
        elif field == 12:
            g["outputs"].append(_parse_value_info(value))
    return g


def parse_model(buf):
    model = {"ir_version": None, "opset": None, "graph": None,
             "producer": ""}
    for field, _, value in _fields(buf):
        if field == 1:
            model["ir_version"] = value
        elif field == 2:
            model["producer"] = bytes(value).decode("utf-8")
        elif field == 7:
            model["graph"] = parse_graph(value)
        elif field == 8:
            for f2, _, v2 in _fields(value):
                if f2 == 2:
                    model["opset"] = v2
    return model
