"""Program transpilers — port of ``paddle_tpu/transpiler/`` (reference:
python/paddle/fluid/transpiler/): the ``DistributeTranspiler`` and its
dispatchers. ``InferenceTranspiler``, ``memory_optimize`` and
``release_memory`` are ROADMAP Queue 1 item 12."""

from paddle_tpu_torch.transpiler.distribute_transpiler import (  # noqa: F401
    DistributeTranspiler,
    DistributeTranspilerConfig,
    HashName,
    RoundRobin,
)
