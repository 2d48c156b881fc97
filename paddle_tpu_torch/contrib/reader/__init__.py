from paddle_tpu_torch.contrib.reader import ctr_reader  # noqa: F401

__all__ = []
