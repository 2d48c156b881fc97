"""Parallelism package: device meshes, sharding rules, and
sequence-parallel (ring) attention. Port of ``paddle_tpu/parallel/``.

The reference compiles one program under a device mesh and XLA's
partitioner inserts the collectives. The port runs one process a rank of
a ``torch.distributed`` world (NCCL on the card, gloo on the CPU) and
each rank runs the block on ``DTensor``s over a ``DeviceMesh``; torch's
sharding propagation inserts the collectives of the ops, and the engine
reduces each gradient to its parameter's placement
(``parallel/plan.py``).

Axes follow the scaling-book convention: ``dp`` (batch), ``tp``
(feature/model), ``sp`` (sequence/context).
"""

from paddle_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    get_default_mesh,
    set_default_mesh,
)
from paddle_tpu_torch.parallel.sharding import (  # noqa: F401
    Coverage,
    PartitionSpec,
    ShardingRules,
    Zero1Plan,
    batch_sharding,
    zero1_extend_spec,
    zero1_plan,
)
from paddle_tpu_torch.parallel.ring_attention import (  # noqa: F401
    ring_attention,
    reference_attention,
)
from paddle_tpu_torch.parallel.env import (  # noqa: F401
    init_distributed,
    get_world_info,
)
