from paddle_tpu_torch.contrib.quantize.quantize_transpiler import (  # noqa: F401
    QuantizeTranspiler,
)

__all__ = ["QuantizeTranspiler"]
