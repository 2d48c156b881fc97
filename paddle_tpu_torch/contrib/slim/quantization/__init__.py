from paddle_tpu_torch.contrib.slim.quantization.quantization_pass import (  # noqa: F401
    QuantizationTransformPass,
    QuantizationFreezePass,
)
