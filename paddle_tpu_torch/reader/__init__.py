"""Reader composition (reference: python/paddle/reader/). Port of
``paddle_tpu/reader/``: a reader is a callable that returns an iterable
of samples; the creators make readers from arrays, text and RecordIO
files, and the decorators compose them."""

from paddle_tpu_torch.reader import creator  # noqa: F401
from paddle_tpu_torch.reader.decorator import (  # noqa: F401
    Fake,
    PipeReader,
    multiprocess_reader,
    batch,
    buffered,
    cache,
    chain,
    compose,
    firstn,
    map_readers,
    prefetch_to_device,
    shuffle,
    xmap_readers,
)
