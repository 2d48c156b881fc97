"""paddle_tpu_torch.analysis — static verification and desc-level
transforms of the Program IR; port of ``paddle_tpu/analysis/`` for the
def-use graph (graph.py), the pass registry and checkers (passes.py),
structured diagnostics (diagnostics.py) and the transform framework with
its passes at levels 1-4 (transforms.py), the memory planner
(memory.py) and the NHWC layout pass (layout.py).

Opt in to the verifier at run time with ``PADDLE_GPU_VERIFY=1`` (or
``Executor.run(verify=True)``): it runs once per cache entry, before the
block is lowered, on the desc the transforms return, and raises on ERROR
findings. The transforms run at the same seam at ``opt_level`` 1 (the
default) and up; the memory planner after them at level 3 and up. The
SPMD analysis is ROADMAP Queue 1 item 10.
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
from paddle_tpu_torch.analysis.memory import (  # noqa: F401
    DonationPlan,
    LivenessReport,
    MemoryPlan,
    RematPlan,
    analyze_liveness,
    plan_donation,
    plan_memory,
    plan_remat,
    replan_segments,
)
from paddle_tpu_torch.analysis.layout import (  # noqa: F401
    LayoutAssignPass,
    LayoutPlan,
    apply_layout,
    plan_layout,
    resolved_layout_mode,
)

__all__ = [
    "AnalysisContext", "DEFAULT_PASSES", "DiagnosticReport",
    "DonationPlan", "Finding", "Graph", "LayoutAssignPass", "LayoutPlan",
    "LivenessReport", "MemoryPlan", "OpNode", "PASS_REGISTRY", "Pass",
    "RematPlan", "Severity", "TRANSFORM_PIPELINE", "TransformContext",
    "TransformPass", "TransformReport", "VarNode", "VerificationError",
    "analyze_liveness", "apply_layout", "build_graph", "default_passes",
    "optimize_program", "plan_donation", "plan_layout", "plan_memory",
    "plan_remat", "register_pass", "replan_segments",
    "resolved_layout_mode", "transform_passes", "run_passes",
    "verify_graph", "verify_program",
]
