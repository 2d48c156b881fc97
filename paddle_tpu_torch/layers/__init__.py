from paddle_tpu_torch.layers.tensor import *  # noqa: F401,F403
from paddle_tpu_torch.layers.nn import *  # noqa: F401,F403
from paddle_tpu_torch.layers.loss import *  # noqa: F401,F403
from paddle_tpu_torch.layers import nn  # noqa: F401
from paddle_tpu_torch.layers.io import data  # noqa: F401
from paddle_tpu_torch.layers.metric_op import accuracy  # noqa: F401
