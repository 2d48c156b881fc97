"""Type system: Fluid-compatible VarType enum <-> numpy/torch dtypes.

Port of ``paddle_tpu/core/types.py``: the same IntEnum values (they are
serialized into program descs), plus the VarType <-> ``torch.dtype`` maps
the torch lowerings need.
"""

import enum

import numpy as np
import torch


class VarType(enum.IntEnum):
    # Tensor element dtypes
    BOOL = 0
    INT16 = 1
    INT32 = 2
    INT64 = 3
    FP16 = 4
    FP32 = 5
    FP64 = 6
    SIZE_T = 19
    UINT8 = 20
    INT8 = 21
    BF16 = 22

    # Non-tensor variable kinds
    LOD_TENSOR = 7
    SELECTED_ROWS = 8
    FEED_MINIBATCH = 9
    FETCH_LIST = 10
    STEP_SCOPES = 11
    LOD_RANK_TABLE = 12
    LOD_TENSOR_ARRAY = 13
    PLACE_LIST = 14
    READER = 15
    RAW = 17
    TUPLE = 18


class VarDesc:
    """Namespace shim so ``core.VarDesc.VarType.FP32`` works like the pybind
    enum in the reference (paddle/fluid/pybind/protobuf.cc)."""

    VarType = VarType


_NP_TO_VARTYPE = {
    np.dtype("bool"): VarType.BOOL,
    np.dtype("int16"): VarType.INT16,
    np.dtype("int32"): VarType.INT32,
    np.dtype("int64"): VarType.INT64,
    np.dtype("float16"): VarType.FP16,
    np.dtype("float32"): VarType.FP32,
    np.dtype("float64"): VarType.FP64,
    np.dtype("uint8"): VarType.UINT8,
    np.dtype("int8"): VarType.INT8,
}

_VARTYPE_TO_NP = {v: k for k, v in _NP_TO_VARTYPE.items()}

_STR_TO_VARTYPE = {
    "bool": VarType.BOOL,
    "int16": VarType.INT16,
    "int32": VarType.INT32,
    "int64": VarType.INT64,
    "float16": VarType.FP16,
    "float32": VarType.FP32,
    "float64": VarType.FP64,
    "uint8": VarType.UINT8,
    "int8": VarType.INT8,
    "bfloat16": VarType.BF16,
}

_TORCH_TO_VARTYPE = {
    torch.bool: VarType.BOOL,
    torch.int16: VarType.INT16,
    torch.int32: VarType.INT32,
    torch.int64: VarType.INT64,
    torch.float16: VarType.FP16,
    torch.float32: VarType.FP32,
    torch.float64: VarType.FP64,
    torch.uint8: VarType.UINT8,
    torch.int8: VarType.INT8,
    torch.bfloat16: VarType.BF16,
}

_VARTYPE_TO_TORCH = {v: k for k, v in _TORCH_TO_VARTYPE.items()}


def convert_np_dtype_to_dtype_(np_dtype):
    """numpy dtype / dtype string / torch dtype / VarType -> VarType."""
    if isinstance(np_dtype, VarType):
        return np_dtype
    if isinstance(np_dtype, torch.dtype):
        return _TORCH_TO_VARTYPE[np_dtype]
    if isinstance(np_dtype, str):
        if np_dtype in _STR_TO_VARTYPE:
            return _STR_TO_VARTYPE[np_dtype]
    dtype = np.dtype(np_dtype)
    if dtype in _NP_TO_VARTYPE:
        return _NP_TO_VARTYPE[dtype]
    raise ValueError("Unsupported dtype: %s" % np_dtype)


def convert_dtype_to_np(var_type):
    """VarType (or anything convertible) -> numpy dtype."""
    vt = convert_np_dtype_to_dtype_(var_type)
    if vt in _VARTYPE_TO_NP:
        return _VARTYPE_TO_NP[vt]
    raise ValueError("VarType %s has no numpy dtype" % vt)


def convert_dtype_to_torch(var_type):
    """VarType (or anything convertible) -> torch dtype."""
    return _VARTYPE_TO_TORCH[convert_np_dtype_to_dtype_(var_type)]


def dtype_str(var_type):
    """VarType -> canonical dtype string used by the lowering engine."""
    if isinstance(var_type, str):
        return var_type
    return convert_dtype_to_np(var_type).name
