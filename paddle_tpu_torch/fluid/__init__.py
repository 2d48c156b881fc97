"""``paddle_tpu_torch.fluid`` — the Fluid-compatible namespace of the port.

Port of ``paddle_tpu/fluid/__init__.py`` for the subset the port
carries, under the same names: ``import paddle_tpu_torch.fluid as fluid``
builds, initialises, trains, saves and serves the same programs as the
JAX package's ``fluid``.
"""

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
from paddle_tpu_torch import nets  # noqa: F401
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
    Executor,
    global_scope,
    scope_guard,
)
from paddle_tpu_torch.core.scope import Scope  # noqa: F401
from paddle_tpu_torch.platform import (  # noqa: F401
    CPUPlace,
    CUDAPlace,
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
    "CPUPlace", "CUDAPlace", "ParamAttr", "metrics",
]
