"""paddle_tpu_torch.inference — the serving side of the port (reference:
``paddle_tpu/inference/__init__.py``):

* the classic predictor API (predictor.py: AnalysisConfig /
  create_paddle_predictor), native model directories, the AOT artifact
  and the self-calibrating INT8 switch (``enable_mkldnn``);
* **freeze** (freeze.py): trained ProgramDesc -> verified
  inference-only desc — training ops stripped by role, pruned to the
  fetch cone, batch-norm folded into the preceding conv/fc weights;
* **quantize** (quantize.py): post-training INT8 — calibrate per-tensor
  ranges over representative batches, then rewrite conv/fc/matmul to
  ``quantize -> int8 GEMM (int32 accumulate) -> float`` with
  per-channel weight scales (ops/quant_ops.py);
* **serve** (serving.py): the continuous-batching ``InferenceServer`` —
  padded shape buckets, one engine cache entry per bucket, a max-wait
  timer bounding p99, SLO histograms in the metrics registry;
* overload policy (admission.py): typed admission errors (``Rejected`` /
  ``DeadlineExceeded``), the bounded-queue + predictive-wait
  ``AdmissionGate``, and the per-worker ``CircuitBreaker``. All
  default-off.
"""

from paddle_tpu_torch.inference.admission import (  # noqa: F401
    AdmissionError,
    AdmissionGate,
    CircuitBreaker,
    DeadlineExceeded,
    Rejected,
)
from paddle_tpu_torch.inference.freeze import (  # noqa: F401
    FoldBatchNormPass,
    FreezeReport,
    StripTrainingPass,
    freeze_program,
)
from paddle_tpu_torch.inference.predictor import (  # noqa: F401
    AnalysisConfig,
    AnalysisPredictor,
    PaddleTensor,
    create_paddle_predictor,
)
from paddle_tpu_torch.inference.quantize import (  # noqa: F401
    QUANTIZABLE_OPS,
    CalibrationStats,
    QuantReport,
    calibrate_program,
    post_training_quantize,
    quantize_program,
)
from paddle_tpu_torch.inference.serving import (  # noqa: F401
    InferenceServer,
    parse_buckets,
)

__all__ = [
    "AdmissionError", "AdmissionGate", "AnalysisConfig",
    "AnalysisPredictor", "CalibrationStats", "CircuitBreaker",
    "DeadlineExceeded", "FoldBatchNormPass", "FreezeReport",
    "InferenceServer", "PaddleTensor", "QUANTIZABLE_OPS", "QuantReport",
    "Rejected", "StripTrainingPass", "calibrate_program",
    "create_paddle_predictor", "freeze_program", "parse_buckets",
    "post_training_quantize", "quantize_program",
]
