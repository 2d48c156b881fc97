"""contrib — port of ``paddle_tpu/contrib/__init__.py`` for the subset the
port carries: ``mixed_precision`` (bfloat16 AMP) and the decoder API
(``InitState``, ``StateCell``, ``TrainingDecoder``,
``BeamSearchDecoder``) and ``reader.ctr_reader``. Quantization and the statistics tools are later
slices (ROADMAP Queue 1, items 9 and 12)."""

from paddle_tpu_torch.contrib import mixed_precision  # noqa: F401
from paddle_tpu_torch.contrib import decoder  # noqa: F401
from paddle_tpu_torch.contrib import reader  # noqa: F401
from paddle_tpu_torch.contrib.decoder import (  # noqa: F401
    BeamSearchDecoder,
    InitState,
    StateCell,
    TrainingDecoder,
)
