from paddle_tpu_torch.contrib.slim import quantization  # noqa: F401
from paddle_tpu_torch.contrib.slim import core  # noqa: F401
from paddle_tpu_torch.contrib.slim import prune  # noqa: F401
