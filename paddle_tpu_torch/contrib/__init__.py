"""contrib — port of ``paddle_tpu/contrib/__init__.py`` for the subset the
port carries: ``mixed_precision`` (bfloat16 AMP), the decoder API
(``InitState``, ``StateCell``, ``TrainingDecoder``,
``BeamSearchDecoder``), ``reader.ctr_reader``, and quantization: slim's
QAT passes, pruning and compression core, ``QuantizeTranspiler`` and the
INT8 ``Calibrator``. The statistics tools and ``utils`` are ROADMAP
Queue 1 item 12."""

from paddle_tpu_torch.contrib import slim  # noqa: F401
from paddle_tpu_torch.contrib import int8_inference  # noqa: F401
from paddle_tpu_torch.contrib import mixed_precision  # noqa: F401
from paddle_tpu_torch.contrib import decoder  # noqa: F401
from paddle_tpu_torch.contrib import reader  # noqa: F401
from paddle_tpu_torch.contrib.decoder import (  # noqa: F401
    BeamSearchDecoder,
    InitState,
    StateCell,
    TrainingDecoder,
)
from paddle_tpu_torch.contrib import quantize  # noqa: F401
from paddle_tpu_torch.contrib.quantize import QuantizeTranspiler  # noqa: F401
from paddle_tpu_torch.contrib.int8_inference.utility import (  # noqa: F401
    Calibrator,
)
from paddle_tpu_torch.contrib.slim.core import (  # noqa: F401
    CompressPass,
    ImitationGraph,
    build_compressor,
)
from paddle_tpu_torch.contrib.slim.prune import (  # noqa: F401
    MagnitudePruner,
    RatioPruner,
    SensitivePruneStrategy,
)
