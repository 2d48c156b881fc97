from paddle_tpu_torch.core.types import (  # noqa: F401
    VarDesc,
    convert_np_dtype_to_dtype_,
)
from paddle_tpu_torch.core.desc import (  # noqa: F401
    OpDesc,
    VarDescData,
    BlockDescData,
    ProgramDescData,
)
from paddle_tpu_torch.core.registry import (  # noqa: F401
    OpRegistry,
    register_op,
    LowerContext,
)
from paddle_tpu_torch.core.scope import Scope  # noqa: F401
