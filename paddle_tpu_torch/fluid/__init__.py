"""``paddle_tpu_torch.fluid`` — the Fluid-compatible namespace of the port.

Port of ``paddle_tpu/fluid/__init__.py`` for the subset the port
carries, under the same names: ``import paddle_tpu_torch.fluid as fluid``
builds, initialises, trains, saves and serves the same programs as the
JAX package's ``fluid``.
"""

import numpy as np

from paddle_tpu_torch import ops as _ops  # noqa: F401  (registers lowerings)
from paddle_tpu_torch import layers  # noqa: F401
from paddle_tpu_torch import initializer  # noqa: F401
from paddle_tpu_torch import unique_name  # noqa: F401
from paddle_tpu_torch import io  # noqa: F401
from paddle_tpu_torch import optimizer  # noqa: F401
from paddle_tpu_torch import regularizer  # noqa: F401
from paddle_tpu_torch import clip  # noqa: F401
from paddle_tpu_torch import backward  # noqa: F401
from paddle_tpu_torch import contrib  # noqa: F401
from paddle_tpu_torch import metrics  # noqa: F401
from paddle_tpu_torch import observability  # noqa: F401
from paddle_tpu_torch import profiler  # noqa: F401
from paddle_tpu_torch import nets  # noqa: F401
from paddle_tpu_torch import flags  # noqa: F401
from paddle_tpu_torch.flags import set_flags  # noqa: F401
from paddle_tpu_torch import reader  # noqa: F401
from paddle_tpu_torch import recordio  # noqa: F401
from paddle_tpu_torch import recordio_writer  # noqa: F401
from paddle_tpu_torch.core_shim import (  # noqa: F401
    LoDTensor,
    LoDTensorArray,
)
from paddle_tpu_torch.data_feeder import DataFeeder  # noqa: F401
from paddle_tpu_torch.data_feed_desc import DataFeedDesc  # noqa: F401
from paddle_tpu_torch.layers.io import py_reader, PyReader  # noqa: F401
from paddle_tpu_torch.backward import append_backward, calc_gradient  # noqa: F401
from paddle_tpu_torch.framework import (  # noqa: F401
    Program,
    Variable,
    Operator,
    program_guard,
    name_scope,
    default_main_program,
    default_startup_program,
    grad_var_name,
)
from paddle_tpu_torch.executor import (  # noqa: F401
    EOFException,
    Executor,
    global_scope,
    scope_guard,
)
from paddle_tpu_torch.core.scope import Scope  # noqa: F401
from paddle_tpu_torch.compiler import (  # noqa: F401
    BuildStrategy,
    CompiledProgram,
    ExecutionStrategy,
)
from paddle_tpu_torch.parallel_executor import ParallelExecutor  # noqa: F401
from paddle_tpu_torch import transpiler  # noqa: F401
from paddle_tpu_torch.transpiler import (  # noqa: F401
    DistributeTranspiler,
    DistributeTranspilerConfig,
)
from paddle_tpu_torch.platform import (  # noqa: F401
    CPUPlace,
    CUDAPlace,
    CUDAPinnedPlace,
    is_compiled_with_cuda,
)
from paddle_tpu_torch.layers.control_flow import (  # noqa: F401
    While,
    StaticRNN,
    Switch,
)
from paddle_tpu_torch.param_attr import ParamAttr, WeightNormParamAttr  # noqa: F401
from paddle_tpu_torch.io import (  # noqa: F401
    save_params,
    save_persistables,
    load_params,
    load_persistables,
    save_inference_model,
    load_inference_model,
)

__all__ = [
    "layers", "initializer", "optimizer", "regularizer", "clip", "contrib",
    "unique_name", "io", "append_backward", "Program", "Variable", "Operator", "program_guard",
    "default_main_program", "default_startup_program",
    "Executor", "global_scope", "scope_guard", "Scope",
    "CPUPlace", "CUDAPlace", "ParamAttr", "metrics", "DataFeeder",
    "CompiledProgram", "ParallelExecutor", "BuildStrategy",
    "ExecutionStrategy", "DistributeTranspiler",
    "DistributeTranspilerConfig", "profiler",
]


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """(reference: lod_tensor.py create_lod_tensor). A list of rows is
    concatenated into a column; its row lengths must agree with the LAST
    level of ``recursive_seq_lens`` (the reference asserts the same), and
    are that level when none is given."""
    if isinstance(data, list):
        row_lens = [len(np.asarray(r).reshape(-1)) for r in data]
        if (recursive_seq_lens
                and list(recursive_seq_lens[-1]) != row_lens):
            raise ValueError(
                "create_lod_tensor: recursive_seq_lens[-1]=%s does not "
                "match the data row lengths %s"
                % (recursive_seq_lens[-1], row_lens))
        data = np.concatenate(
            [np.asarray(row).reshape(-1, 1) for row in data], axis=0)
        recursive_seq_lens = recursive_seq_lens or [row_lens]
    t = LoDTensor()
    t.set(np.asarray(data), place)
    t.set_recursive_sequence_lengths(recursive_seq_lens)
    return t


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place,
                                low, high):
    """(reference: lod_tensor.py create_random_int_lodtensor): int64
    values drawn from numpy's global stream, uniform in [low, high]."""
    total = sum(recursive_seq_lens[-1])
    arr = np.random.randint(low, high + 1,
                            [total] + list(base_shape)).astype("int64")
    return create_lod_tensor(arr, recursive_seq_lens, place)
