"""paddle_tpu_torch.analysis — static verification and desc-level
transforms of the Program IR; port of ``paddle_tpu/analysis/`` for the
def-use graph (graph.py), the pass registry and checkers (passes.py),
structured diagnostics (diagnostics.py) and the transform framework with
its level-1 attention fuse (transforms.py).

Opt in to the verifier at run time with ``PADDLE_GPU_VERIFY=1`` (or
``Executor.run(verify=True)``): it runs once per cache entry, before the
block is lowered, on the desc the transforms return, and raises on ERROR
findings. The transforms run at the same seam at ``opt_level`` 1, the
default. Memory planning, the SPMD analysis and the layout pass are
ROADMAP Queue 1 items 8 and 10.
"""

from paddle_tpu_torch.analysis.diagnostics import (  # noqa: F401
    DiagnosticReport,
    Finding,
    Severity,
    VerificationError,
)
from paddle_tpu_torch.analysis.graph import (  # noqa: F401
    Graph,
    OpNode,
    VarNode,
    build_graph,
)
from paddle_tpu_torch.analysis.passes import (  # noqa: F401
    DEFAULT_PASSES,
    PASS_REGISTRY,
    AnalysisContext,
    Pass,
    default_passes,
    register_pass,
    run_passes,
    verify_graph,
    verify_program,
)
from paddle_tpu_torch.analysis.transforms import (  # noqa: F401
    TRANSFORM_PIPELINE,
    TransformContext,
    TransformPass,
    TransformReport,
    optimize_program,
    transform_passes,
)

__all__ = [
    "AnalysisContext", "DEFAULT_PASSES", "DiagnosticReport", "Finding",
    "Graph", "OpNode", "PASS_REGISTRY", "Pass", "Severity",
    "TRANSFORM_PIPELINE", "TransformContext", "TransformPass",
    "TransformReport", "VarNode", "VerificationError", "build_graph",
    "default_passes", "optimize_program", "register_pass",
    "transform_passes", "run_passes", "verify_graph", "verify_program",
]
