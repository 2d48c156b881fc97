"""Reader creators (reference: python/paddle/reader/creator.py —
np_array:22, text_file:42, recordio:60). Port of
``paddle_tpu/reader/creator.py``."""

__all__ = ["np_array", "text_file", "recordio"]


def np_array(x):
    """Yield the rows (slices along the first dim) of a numpy array."""

    def reader():
        for e in x:
            yield e

    return reader


def text_file(path):
    """Yield the lines of a text file, without their newline."""

    def reader():
        with open(path) as f:
            for line in f:
                yield line.rstrip("\n")

    return reader


def recordio(paths, buf_size=100):
    """Yield the raw records of RecordIO files (a list, or one string of
    comma-separated paths), read ahead ``buf_size`` records by a
    background thread."""
    from paddle_tpu_torch import recordio as rio
    from paddle_tpu_torch.reader.decorator import buffered

    if isinstance(paths, str):
        paths = paths.split(",")

    def reader():
        for p in paths:
            with rio.Reader(p) as records:
                for rec in records:
                    yield rec

    return buffered(reader, buf_size)
