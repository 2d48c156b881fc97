"""Operator library: torch lowerings for the Fluid op set the port runs.

Importing this package registers every ported op. The modules mirror
``paddle_tpu/ops/`` by name; each holds the counterparts of the JAX
lowerings it cites, with the direct grad lowerings the JAX package
registers for them (other grads are derived by the engine). Which op
families are still to port is listed in ROADMAP.md (Queue 1).
"""

from paddle_tpu_torch.ops import math_ops  # noqa: F401
from paddle_tpu_torch.ops import activation_ops  # noqa: F401
from paddle_tpu_torch.ops import tensor_ops  # noqa: F401
from paddle_tpu_torch.ops import nn_ops  # noqa: F401
from paddle_tpu_torch.ops import loss_ops  # noqa: F401
from paddle_tpu_torch.ops import reduce_ops  # noqa: F401
from paddle_tpu_torch.ops import optimizer_ops  # noqa: F401
from paddle_tpu_torch.ops import metric_ops  # noqa: F401
