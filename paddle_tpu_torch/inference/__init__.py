from paddle_tpu_torch.inference.predictor import (  # noqa: F401
    AnalysisConfig,
    AnalysisPredictor,
    PaddleTensor,
    create_paddle_predictor,
)
