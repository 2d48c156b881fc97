"""Reader -> RecordIO conversion (reference:
python/paddle/fluid/recordio_writer.py — convert_reader_to_recordio_file
:42, convert_reader_to_recordio_files:84). Port of
``paddle_tpu/recordio_writer.py``: each sample's parts are flattened to
raw little-endian bytes, one after another, which is what
``layers.open_files(shapes=, dtypes=)`` parses back."""

import contextlib

import numpy as np

from paddle_tpu_torch import recordio

__all__ = ["convert_reader_to_recordio_file",
           "convert_reader_to_recordio_files"]


def _sample_bytes(sample, feeder=None):
    parts = sample if isinstance(sample, (list, tuple)) else [sample]
    return b"".join(np.ascontiguousarray(np.asarray(p)).tobytes()
                    for p in parts)


def convert_reader_to_recordio_file(filename, reader_creator, feeder=None,
                                    compressor=None, max_num_records=1000,
                                    feed_order=None):
    """Write every sample of ``reader_creator()`` to ``filename``, chunks
    of at most ``max_num_records`` records. Returns the record count."""
    counter = 0
    with contextlib.closing(recordio.Writer(
            filename, max_records=max_num_records)) as w:
        for sample in reader_creator():
            w.write(_sample_bytes(sample, feeder))
            counter += 1
    return counter


def convert_reader_to_recordio_files(filename, batch_per_file,
                                     reader_creator, feeder=None,
                                     compressor=None, max_num_records=1000,
                                     feed_order=None):
    """Split into ``name-00000.ext``-style shards of ``batch_per_file``
    records each. Returns the record count of each shard."""
    f_name, f_ext = (filename.rsplit(".", 1) + [""])[:2]
    lines = list(reader_creator())
    counters = []
    for i in range(0, len(lines), batch_per_file):
        shard = lines[i:i + batch_per_file]
        suffix = "-%05d" % (i // batch_per_file)
        path = (f_name + suffix + "." + f_ext) if f_ext else \
            (filename + suffix)
        counters.append(convert_reader_to_recordio_file(
            path, lambda s=shard: iter(s), feeder, compressor,
            max_num_records, feed_order))
    return counters
