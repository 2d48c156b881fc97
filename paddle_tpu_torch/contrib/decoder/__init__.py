"""Decoder API — port of ``paddle_tpu/contrib/decoder/`` (reference:
python/paddle/fluid/contrib/decoder/)."""

from paddle_tpu_torch.contrib.decoder.beam_search_decoder import (  # noqa: F401
    BeamSearchDecoder,
    InitState,
    StateCell,
    TrainingDecoder,
)

__all__ = ["InitState", "StateCell", "TrainingDecoder",
           "BeamSearchDecoder"]
