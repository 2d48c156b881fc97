from paddle_tpu_torch.layers.tensor import *  # noqa: F401,F403
from paddle_tpu_torch.layers.nn import *  # noqa: F401,F403
from paddle_tpu_torch.layers.control_flow import (  # noqa: F401
    While,
    StaticRNN,
    DynamicRNN,
    IfElse,
    Switch,
    create_array,
    array_write,
    array_read,
    array_length,
    increment,
)
from paddle_tpu_torch.layers.ops import *  # noqa: F401,F403
from paddle_tpu_torch.layers.loss import *  # noqa: F401,F403
from paddle_tpu_torch.layers import nn  # noqa: F401
from paddle_tpu_torch.layers.io import data  # noqa: F401
from paddle_tpu_torch.layers.metric_op import accuracy, auc  # noqa: F401
from paddle_tpu_torch.layers import learning_rate_scheduler  # noqa: F401
from paddle_tpu_torch.layers.learning_rate_scheduler import (  # noqa: F401
    append_LARS,
    exponential_decay,
    natural_exp_decay,
    inverse_time_decay,
    polynomial_decay,
    piecewise_decay,
    noam_decay,
    cosine_decay,
    linear_lr_warmup,
)
