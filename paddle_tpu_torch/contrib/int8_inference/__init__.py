from paddle_tpu_torch.contrib.int8_inference.utility import Calibrator  # noqa: F401
