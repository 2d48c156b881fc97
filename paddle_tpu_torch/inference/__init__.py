"""paddle_tpu_torch.inference — the serving side of the port (reference:
``paddle_tpu/inference/__init__.py``):

* the classic predictor API (predictor.py: AnalysisConfig /
  create_paddle_predictor), native model directories;
* **serve** (serving.py): the continuous-batching ``InferenceServer`` —
  padded shape buckets, one engine cache entry per bucket, a max-wait
  timer bounding p99, SLO histograms in the metrics registry;
* overload policy (admission.py): typed admission errors (``Rejected`` /
  ``DeadlineExceeded``), the bounded-queue + predictive-wait
  ``AdmissionGate``, and the per-worker ``CircuitBreaker``. All
  default-off.

``freeze`` and ``quantize`` are ROADMAP Queue 1 item 9.
"""

from paddle_tpu_torch.inference.admission import (  # noqa: F401
    AdmissionError,
    AdmissionGate,
    CircuitBreaker,
    DeadlineExceeded,
    Rejected,
)
from paddle_tpu_torch.inference.predictor import (  # noqa: F401
    AnalysisConfig,
    AnalysisPredictor,
    PaddleTensor,
    create_paddle_predictor,
)
from paddle_tpu_torch.inference.serving import (  # noqa: F401
    InferenceServer,
    parse_buckets,
)

__all__ = [
    "AdmissionError", "AdmissionGate", "AnalysisConfig",
    "AnalysisPredictor", "CircuitBreaker", "DeadlineExceeded",
    "InferenceServer", "PaddleTensor", "Rejected",
    "create_paddle_predictor", "parse_buckets",
]
