"""Reference-format importers and exporters: binary ProgramDesc
protobufs and saved tensors. Port of ``paddle_tpu/compat.py``, whole.

The reference serializes programs with protobuf (reference:
paddle/fluid/framework/framework.proto — ProgramDesc/BlockDesc/VarDesc/
OpDesc messages) and parameters with a versioned tensor stream
(reference: paddle/fluid/framework/lod_tensor.cc SerializeToStream +
tensor_util.cc TensorToStream). This module reads and writes BOTH
without a protobuf dependency: a minimal proto2 wire-format codec driven
by the schema's field numbers, so a reference `save_inference_model`
directory (`__model__` + per-var files) loads directly, and the port's
models export to it. The encoder is the JAX package's, so the same
program serializes to the same bytes in both packages.

numpy has no bfloat16: a BF16 tensor stream loads as a CPU
``torch.bfloat16`` tensor, and a ``torch.bfloat16`` tensor saves as one.
The misc ``load`` op reads saved-variable files through
``load_reference_var``.
"""

import os
import struct

import numpy as np
import torch

from paddle_tpu_torch.core.desc import (BlockDescData, OpDesc,
                                        ProgramDescData, VarDescData)
from paddle_tpu_torch.core.types import (VarType, convert_dtype_to_np,
                                         convert_np_dtype_to_dtype_)

__all__ = ["parse_program_desc", "load_reference_program",
           "load_reference_inference_model", "load_reference_var"]


# -- protobuf wire-format primitives ---------------------------------------

def _read_varint(buf, off):
    result = 0
    shift = 0
    while True:
        b = buf[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, off
        shift += 7


def _fields(buf):
    """Yield (field_number, wire_type, value) over a message's bytes."""
    off = 0
    n = len(buf)
    while off < n:
        key, off = _read_varint(buf, off)
        field, wt = key >> 3, key & 7
        if wt == 0:                      # varint
            val, off = _read_varint(buf, off)
        elif wt == 1:                    # 64-bit
            val = buf[off:off + 8]
            off += 8
        elif wt == 2:                    # length-delimited
            ln, off = _read_varint(buf, off)
            val = buf[off:off + ln]
            off += ln
        elif wt == 5:                    # 32-bit
            val = buf[off:off + 4]
            off += 4
        else:
            raise ValueError("unsupported wire type %d" % wt)
        yield field, wt, val


def _group(buf):
    out = {}
    for field, wt, val in _fields(buf):
        out.setdefault(field, []).append((wt, val))
    return out


def _f32(val):
    return struct.unpack("<f", val)[0]


def _i64(v):
    # proto int64 varints are two's complement in 64 bits
    return v - (1 << 64) if v >= (1 << 63) else v


def _packed_varints(entries):
    out = []
    for wt, val in entries:
        if wt == 0:
            out.append(val)
        else:                            # packed
            off = 0
            while off < len(val):
                v, off = _read_varint(val, off)
                out.append(v)
    return out


def _packed_floats(entries):
    out = []
    for wt, val in entries:
        if wt == 5:
            out.append(_f32(val))
        else:
            out.extend(struct.unpack("<%df" % (len(val) // 4), val))
    return out


# -- framework.proto decoding ----------------------------------------------

# OpDesc.Attr fields (framework.proto:44-59)
_ATTR_DECODERS = {
    0: lambda g: _sint32(_one(g, 3)),                 # INT
    1: lambda g: _f32_field(g),                       # FLOAT
    2: lambda g: _one(g, 5).decode("utf-8"),          # STRING
    3: lambda g: [_sint32(v) for v in _packed_varints(g.get(6, []))],
    4: lambda g: _packed_floats(g.get(7, [])),        # FLOATS
    5: lambda g: [v.decode("utf-8") for _, v in g.get(8, [])],
    6: lambda g: bool(_one(g, 10)),                   # BOOLEAN
    7: lambda g: [bool(v) for v in _packed_varints(g.get(11, []))],
    8: lambda g: _sint32(_one(g, 12)),                # BLOCK (block_idx)
    9: lambda g: _i64(_one(g, 13)),                   # LONG
    10: lambda g: [_sint32(v) for v in _packed_varints(g.get(14, []))],
    11: lambda g: [_i64(v) for v in _packed_varints(g.get(15, []))],
}


def _one(g, field, default=None):
    vals = g.get(field)
    return vals[0][1] if vals else default


def _sint32(v):
    if v is None:
        return None
    v = int(v)
    return v - (1 << 64) if v >= (1 << 63) else v


def _f32_field(g):
    v = _one(g, 4)
    return _f32(v) if isinstance(v, (bytes, bytearray)) else float(v)


def _decode_attr(buf):
    g = _group(buf)
    name = _one(g, 1).decode("utf-8")
    atype = int(_one(g, 2))
    dec = _ATTR_DECODERS.get(atype)
    if dec is None:
        raise ValueError("unsupported attr type %d for %r" % (atype, name))
    value = dec(g)
    # BLOCK attrs reference sub-blocks by index — keep the int; our engine
    # looks sub-blocks up by the same "sub_block" attr name
    return name, value


def _decode_op(buf):
    g = _group(buf)
    op_type = _one(g, 3).decode("utf-8")

    def slots(field):
        out = {}
        for _, var_buf in g.get(field, []):
            vg = _group(var_buf)
            slot = _one(vg, 1).decode("utf-8")
            out[slot] = [v.decode("utf-8") for _, v in vg.get(2, [])]
        return out

    attrs = {}
    for _, attr_buf in g.get(4, []):
        name, value = _decode_attr(attr_buf)
        attrs[name] = value
    return OpDesc(op_type, slots(1), slots(2), attrs)


def _decode_tensor_desc(buf):
    g = _group(buf)
    dtype = VarType(int(_one(g, 1)))
    dims = [_i64(v) for v in _packed_varints(g.get(2, []))]
    return dtype, dims


def _decode_var(buf):
    g = _group(buf)
    name = _one(g, 1).decode("utf-8")
    persistable = bool(_one(g, 3, 0))
    tg = _group(_one(g, 2))              # VarType message
    vtype = VarType(int(_one(tg, 1)))
    dtype, shape, lod_level = None, None, 0
    tensor_field = {VarType.SELECTED_ROWS: 2, VarType.LOD_TENSOR: 3,
                    VarType.LOD_TENSOR_ARRAY: 4}.get(vtype)
    if tensor_field is not None and _one(tg, tensor_field) is not None:
        sub = _group(_one(tg, tensor_field))
        if vtype == VarType.SELECTED_ROWS:
            dtype, shape = _decode_tensor_desc(_one(tg, tensor_field))
        else:
            dtype, shape = _decode_tensor_desc(_one(sub, 1))
            lod_level = int(_one(sub, 2, 0))
    vd = VarDescData(
        name,
        shape=[(-1 if d == -1 else int(d)) for d in (shape or [])] or None,
        dtype=dtype if dtype is not None else VarType.FP32,
        type=vtype,
        persistable=persistable,
        lod_level=lod_level,
    )
    return vd


def parse_program_desc(data):
    """Binary framework.proto ProgramDesc -> ProgramDescData."""
    g = _group(data)
    prog = ProgramDescData.__new__(ProgramDescData)
    prog.version = 0
    ver = _one(g, 2)
    if ver is not None:
        prog.version = int(_one(_group(ver), 1, 0))
    prog.blocks = []
    for _, block_buf in g.get(1, []):
        bg = _group(block_buf)
        b = BlockDescData(prog, int(_one(bg, 1, 0)),
                          _sint32(_one(bg, 2, 0)))
        b.forward_block_idx = _sint32(_one(bg, 5, -1))
        for _, var_buf in bg.get(3, []):
            vd = _decode_var(var_buf)
            b.vars[vd.name] = vd
        b.ops = [_decode_op(op_buf) for _, op_buf in bg.get(4, [])]
        prog.blocks.append(b)
    prog.blocks.sort(key=lambda b: b.idx)
    return prog


def load_reference_program(path_or_bytes):
    """Load a reference-serialized program (`__model__` file) as a
    port Program."""
    from paddle_tpu_torch.framework import Block, Program, Variable

    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    desc = parse_program_desc(data)
    program = Program()
    program.desc = desc
    desc._version_token = 1
    program.blocks = [Block.__new__(Block) for _ in desc.blocks]
    for i, b in enumerate(program.blocks):
        b.program = program
        b.desc = desc.block(i)
        b.idx = i
        b.ops = []
        b.vars = {}
        for name, vd in b.desc.vars.items():
            v = Variable.__new__(Variable)
            v.block = b
            v.desc = vd
            b.vars[name] = v
    program._bump_version()
    return program


# -- reference tensor stream -----------------------------------------------

def load_reference_var(path):
    """One variable saved by the reference's save op (reference:
    lod_tensor.cc SerializeToStream: uint32 version, lod levels, then
    tensor_util.cc TensorToStream: uint32 version, int32 proto size,
    TensorDesc proto, raw data). A numpy array; a BF16 variable comes back
    as a CPU ``torch.bfloat16`` tensor."""
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    (version,) = struct.unpack_from("<I", data, off)
    off += 4
    if version != 0:
        raise ValueError("unsupported tensor stream version %d" % version)
    (lod_level,) = struct.unpack_from("<Q", data, off)
    off += 8
    for _ in range(lod_level):
        (nbytes,) = struct.unpack_from("<Q", data, off)
        off += 8 + nbytes
    (tversion,) = struct.unpack_from("<I", data, off)
    off += 4
    if tversion != 0:
        raise ValueError("unsupported tensor version %d" % tversion)
    (psize,) = struct.unpack_from("<i", data, off)
    off += 4
    dtype, dims = _decode_tensor_desc(data[off:off + psize])
    off += psize
    np_dtype = np.int16 if dtype == VarType.BF16 else \
        convert_dtype_to_np(dtype)
    count = int(np.prod(dims)) if dims else 1
    arr = np.frombuffer(
        data, dtype=np_dtype, count=count, offset=off).reshape(dims)
    if dtype == VarType.BF16:
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    return arr.copy()


def load_reference_inference_model(dirname, executor, scope=None,
                                   model_filename="__model__"):
    """Load a reference save_inference_model directory: the protobuf
    program plus every persistable var from its same-named file
    (reference: io.py load_inference_model + load_persistables). Returns
    (program, feed_names, fetch_vars) like fluid.io.load_inference_model;
    feed/fetch are recovered from the program's feed/fetch ops. The
    persistables land in the scope on the executor's device."""
    from paddle_tpu_torch.executor import global_scope

    scope = scope if scope is not None else global_scope()
    program = load_reference_program(os.path.join(dirname, model_filename))
    gb = program.desc.global_block()
    feed_names, fetch_names = [], []
    for op in gb.ops:
        if op.type == "feed":
            feed_names.append(op.outputs["Out"][0])
        elif op.type == "fetch":
            fetch_names.append(op.inputs["X"][0])
    for name, vd in gb.vars.items():
        if not vd.persistable or vd.type not in (
                VarType.LOD_TENSOR, VarType.SELECTED_ROWS):
            continue
        if name in ("feed", "fetch"):
            continue
        path = os.path.join(dirname, name)
        if os.path.exists(path):
            val = load_reference_var(path)
            if not isinstance(val, torch.Tensor):
                val = torch.from_numpy(val)
            scope.set(name, val.to(executor.device))
    program._is_test = True
    fetch_vars = [program.global_block().vars[n] for n in fetch_names]
    return program, feed_names, fetch_vars


# -- framework.proto ENCODING (export) --------------------------------------
#
# The write side of the same schema (reference: framework.proto:24-188):
# emits proto2 wire format the reference's C++ protobuf parser accepts, so
# repo-saved models load in reference tooling. Scalars use the schema's
# field numbers mirrored from the decoder tables above.

def _w_varint(v):
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _w_tag(field, wt):
    return _w_varint((field << 3) | wt)


def _w_len(field, payload):
    return _w_tag(field, 2) + _w_varint(len(payload)) + payload


def _w_int(field, v):
    return _w_tag(field, 0) + _w_varint(int(v))


def _w_f32(field, v):
    return _w_tag(field, 5) + struct.pack("<f", float(v))


def _w_str(field, s):
    return _w_len(field, s.encode("utf-8"))


def _encode_attr(name, value):
    """One OpDesc.Attr message, or None for non-representable values
    (engine-internal dict/None attrs are dropped from the export)."""
    head = _w_str(1, name)
    if isinstance(value, np.bool_):
        value = bool(value)
    elif isinstance(value, np.integer):
        value = int(value)
    elif isinstance(value, np.floating):
        value = float(value)
    if isinstance(value, bool):
        return head + _w_int(2, 6) + _w_int(10, int(value))
    if isinstance(value, int):
        if name == "sub_block":
            return head + _w_int(2, 8) + _w_int(12, value)
        if -(1 << 31) <= value < (1 << 31):
            return head + _w_int(2, 0) + _w_int(3, value)
        return head + _w_int(2, 9) + _w_int(13, value)
    if isinstance(value, float):
        return head + _w_int(2, 1) + _w_f32(4, value)
    if isinstance(value, str):
        return head + _w_int(2, 2) + _w_str(5, value)
    if isinstance(value, (list, tuple)):
        vals = list(value)
        if all(isinstance(v, bool) for v in vals) and vals:
            return head + _w_int(2, 7) + b"".join(
                _w_int(11, int(v)) for v in vals)
        if all(isinstance(v, (int, np.integer)) for v in vals):
            if all(-(1 << 31) <= int(v) < (1 << 31) for v in vals):
                return head + _w_int(2, 3) + b"".join(
                    _w_int(6, int(v)) for v in vals)
            return head + _w_int(2, 11) + b"".join(
                _w_int(15, int(v)) for v in vals)
        if all(isinstance(v, (float, np.floating)) for v in vals):
            return head + _w_int(2, 4) + b"".join(
                _w_f32(7, v) for v in vals)
        if all(isinstance(v, str) for v in vals):
            return head + _w_int(2, 5) + b"".join(
                _w_str(8, v) for v in vals)
    return None


def _encode_op(op):
    out = bytearray()

    def slots(field, mapping):
        for slot, names in mapping.items():
            var = _w_str(1, slot) + b"".join(_w_str(2, n) for n in names)
            out.extend(_w_len(field, var))

    slots(1, op.inputs)
    slots(2, op.outputs)
    out.extend(_w_str(3, op.type))
    for name, value in sorted(op.attrs.items()):
        enc = _encode_attr(name, value)
        if enc is not None:
            out.extend(_w_len(4, enc))
    return bytes(out)


def _encode_tensor_desc(dtype, dims):
    out = _w_int(1, int(dtype))
    for d in (dims or []):
        out += _w_int(2, -1 if d in (None, -1) else int(d))
    return out


def _encode_var(vd):
    vtype = vd.type
    tdesc = _encode_tensor_desc(
        vd.dtype if vd.dtype is not None else VarType.FP32, vd.shape)
    if vtype == VarType.SELECTED_ROWS:
        type_msg = _w_int(1, int(vtype)) + _w_len(2, tdesc)
    elif vtype == VarType.LOD_TENSOR_ARRAY:
        sub = _w_len(1, tdesc) + _w_int(2, int(vd.lod_level or 0))
        type_msg = _w_int(1, int(vtype)) + _w_len(4, sub)
    elif vtype == VarType.LOD_TENSOR:
        sub = _w_len(1, tdesc) + _w_int(2, int(vd.lod_level or 0))
        type_msg = _w_int(1, int(vtype)) + _w_len(3, sub)
    else:
        # RAW / READER / marker types carry no tensor desc
        type_msg = _w_int(1, int(vtype))
    return (_w_str(1, vd.name) + _w_len(2, type_msg)
            + _w_int(3, int(bool(vd.persistable))))


def serialize_program_desc(prog):
    """ProgramDescData -> binary framework.proto ProgramDesc bytes."""
    out = bytearray()
    for b in prog.blocks:
        bb = bytearray()
        bb.extend(_w_int(1, b.idx))
        bb.extend(_w_int(2, max(b.parent_idx, 0) if b.idx else 0))
        for vd in b.vars.values():
            bb.extend(_w_len(3, _encode_var(vd)))
        for op in b.ops:
            bb.extend(_w_len(4, _encode_op(op)))
        fwd = getattr(b, "forward_block_idx", -1)
        bb.extend(_w_tag(5, 0) + _w_varint(fwd))
        out.extend(_w_len(1, bytes(bb)))
    out.extend(_w_len(2, _w_int(1, getattr(prog, "version", 0))))
    return bytes(out)


def save_reference_var(arr, path, lod_level=0):
    """Write one tensor in the reference save-op stream format
    (lod_tensor.cc SerializeToStream + tensor_util.cc TensorToStream) so
    reference load ops can read it. ``arr`` is an array or a tensor
    (a ``torch.bfloat16`` one saves as BF16)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu()
        dtype = convert_np_dtype_to_dtype_(t.dtype)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arr = np.ascontiguousarray(t.numpy())
    else:
        arr = np.ascontiguousarray(arr)
        dtype = convert_np_dtype_to_dtype_(arr.dtype)
    proto = _encode_tensor_desc(dtype, list(arr.shape))
    with open(path, "wb") as f:
        f.write(struct.pack("<I", 0))          # lod stream version
        f.write(struct.pack("<Q", int(lod_level)))
        f.write(struct.pack("<I", 0))          # tensor version
        f.write(struct.pack("<i", len(proto)))
        f.write(proto)
        f.write(arr.tobytes())


def save_reference_inference_model(dirname, feeded_var_names, target_vars,
                                   executor, main_program=None,
                                   model_filename="__model__", scope=None):
    """Export an inference model in the REFERENCE on-disk format — binary
    framework.proto `__model__` with feed/fetch ops plus one reference
    tensor-stream file per persistable var — loadable by both reference
    tooling and load_reference_inference_model above (reference: io.py
    save_inference_model + save_persistables)."""
    import paddle_tpu_torch.io as ptio
    from paddle_tpu_torch.executor import global_scope
    from paddle_tpu_torch.framework import default_main_program

    main_program = main_program or default_main_program()
    scope = scope if scope is not None else global_scope()
    fetch_names = [v.name for v in target_vars]
    pruned = ptio._prune_for_inference(main_program, feeded_var_names,
                                       fetch_names)
    gb = pruned.desc.global_block()
    # feed/fetch ops as the reference prepends/appends them
    # (io.py prepend_feed_ops/append_fetch_ops)
    gb.vars["feed"] = VarDescData("feed", type=VarType.FEED_MINIBATCH,
                                  persistable=True)
    gb.vars["fetch"] = VarDescData("fetch", type=VarType.FETCH_LIST,
                                   persistable=True)
    feed_ops = [
        OpDesc("feed", {"X": ["feed"]}, {"Out": [n]}, {"col": i})
        for i, n in enumerate(feeded_var_names)
    ]
    fetch_ops = [
        OpDesc("fetch", {"X": [n]}, {"Out": ["fetch"]}, {"col": i})
        for i, n in enumerate(fetch_names)
    ]
    gb.ops = feed_ops + gb.ops + fetch_ops
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, model_filename), "wb") as f:
        f.write(serialize_program_desc(pruned.desc))
    for name, vd in gb.vars.items():
        if not vd.persistable or name in ("feed", "fetch"):
            continue
        val = scope.get(name)
        if val is None:
            continue
        save_reference_var(val, os.path.join(dirname, name))
    return fetch_names
