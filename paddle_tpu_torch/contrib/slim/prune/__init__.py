from paddle_tpu_torch.contrib.slim.prune.prune_strategy import (  # noqa: F401
    SensitivePruneStrategy,
)
from paddle_tpu_torch.contrib.slim.prune.pruner import (  # noqa: F401
    MagnitudePruner,
    RatioPruner,
)

__all__ = ["SensitivePruneStrategy", "MagnitudePruner", "RatioPruner"]
