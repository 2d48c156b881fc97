from paddle_tpu_torch.contrib.slim.core.compress_pass import (  # noqa: F401
    CompressPass,
    Context,
    build_compressor,
)
from paddle_tpu_torch.contrib.slim.core.graph import ImitationGraph  # noqa: F401

__all__ = ["CompressPass", "Context", "build_compressor",
           "ImitationGraph"]
